"""PISO step for the averaged two-phase fluid (port of
``sedifoam_tpu/fluid/piso.py``).

Per fluid timestep (lammpsFoam.C:74-123):
  1. alphaEqn.H  — beta = 1 - alpha (alpha is imposed by the particles)
  2. UEqns.H     — assemble UbEqn (matrix only, never solved)
  3. pEqn.H      — PISO: momentum update from H/A, particle momentum
                   source entering the face flux (phiDragb), pressure
                   Poisson, flux/velocity reconstruction
  4. gradP.adjust — channel forcing feedback (chPressureGrad.C:221-300)
  5. DDtU.H      — material derivatives for the coupling forces

The Cvm virtual-mass block, the IBM relaxation term and the DNS forcing
term (fluid/bodyforce.py) are assembled as in the reference.

On a slab of a fluid split along grid-x (grid.SlabGrid) the means, the
solver's reductions and the Ubar forcing's sums are the grid's
plane-ordered ones, summed over the ranks, and the pressure reference
value comes from the rank that owns the reference cell.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from pbref import bc as _bc
from pbref import device_vector, linop, linsolve, ops
from pbref.config import FluidConfig
from pbref.fluid.state import FluidBCs, FluidState
from pbref.grid import FaceField, Grid

SMALL = 1e-300


def _interp_zg(c, grid):
    """Interpolate with zeroGradient BCs (OpenFOAM 'calculated' fields)."""
    return ops.face_interp(c, grid, _bc.zero_gradient())


def gravity_flux(grid: Grid, g, dtype=torch.float64, device=None) -> FaceField:
    """(g & Sf) as a face field."""
    zf = grid.zeros_faces(dtype, device)
    return FaceField(*(zf[a] + g[a] * grid.face_area_like(a, zf[a])
                       for a in range(3)))


def reconstruct(flux: FaceField, grid: Grid):
    """fvc::reconstruct on an orthogonal grid.

    Per axis: cell vector component = mean of the two face fluxes / area.
    """
    def _axis(fa, a):
        fm = ops._mv(fa, a)
        return ops._mvback(0.5 * (fm[1:] + fm[:-1]), a) \
            / grid.face_area_like(a, fa)

    return torch.stack([_axis(flux[a], a) for a in range(3)])


def ddt_corr(U_old, phi_old: FaceField, grid: Grid, vbc: _bc.FieldBC,
             dt: float, t=0.0) -> FaceField:
    """fvc::ddtCorr(U, phi) for the Euler scheme (Rhie-Chow temporal
    correction): coeff * (phi_old - interp(U_old)&Sf) / dt with
    coeff = 1 - min(|diff| / (|phi_old| + SMALL), 1)."""
    sf = ops.flux_of(U_old, grid, vbc, phi_old, t)
    out = []
    for a in range(3):
        diff = phi_old[a] - sf[a]
        coeff = 1.0 - torch.clamp(
            torch.abs(diff) / (torch.abs(phi_old[a]) + 1e-30), max=1.0)
        out.append(coeff * diff / dt)
    return FaceField(*out)


def _needs_reference(pbc: _bc.FieldBC) -> bool:
    """True if p has no fixed-value patch (pure Neumann -> pin a cell)."""
    return not any(
        pbc.patch(pn).kind in (_bc.FIXED_VALUE, _bc.INLET_OUTLET)
        for pn in _bc.PATCHES)


def dev2_T_grad(U, beta_nu_eff, grid: Grid, vbc: _bc.FieldBC, t=0.0):
    """beta*nuEff*dev2(T(grad(U))): S[i][j] = bn*(dU_i/dx_j - 2/3 div(U) d_ij).

    Returned indexed [deriv_row i][component j] ready for Gauss div.
    """
    g = ops.grad_vec(U, grid, vbc, t=t)  # g[j, i] = dU_j/dx_i
    divU = g[0, 0] + g[1, 1] + g[2, 2]
    return torch.stack([
        torch.stack([
            beta_nu_eff * (g[i, j] - (2.0 / 3.0) * divU
                           * (1.0 if i == j else 0.0))
            for j in range(3)])
        for i in range(3)])


def div_tensor(S, grid: Grid):
    """(div S)_j = (1/V) sum_f Sf_i S_ij, zeroGradient tensor extrapolation."""
    zg = _bc.zero_gradient()
    comps = []
    for j in range(3):
        acc = torch.zeros(grid.shape, dtype=S.dtype, device=S.device)
        for i in range(3):
            fv = ops._axis_faces(S[i, j], i, grid, zg, None, "interp")
            acc = acc + ops._face_diff(fv, i) * grid.face_area_like(i, acc)
        comps.append(acc / grid.cell_volume_like(acc))
    return torch.stack(comps)


class UbEqn(NamedTuple):
    """The assembled momentum matrix: one LinTerm per velocity component."""

    terms: Tuple[linop.LinTerm, linop.LinTerm, linop.LinTerm]

    def A(self, grid: Grid):
        # fvMatrix<vector>::A() folds per-component boundary coefficients
        # with cmptAv
        davg = (self.terms[0].diag + self.terms[1].diag
                + self.terms[2].diag) / 3.0
        return davg / grid.cell_volume_like(davg)

    def H(self, U, grid: Grid):
        return torch.stack([self.terms[j].H(U[j], grid) for j in range(3)])


def assemble_ub_eqn(fs: FluidState, grid: Grid, bcs: FluidBCs,
                    cfg: FluidConfig, nu_eff) -> UbEqn:
    """UEqns.H — the fluid-phase momentum matrix."""
    dt = cfg.dt
    t = fs.time
    beta = fs.beta
    beta_old = 1.0 - fs.alpha_old
    alpha = fs.alpha

    betaf = ops.face_interp(beta, grid, _invert_alpha_bc(bcs.alpha), t=t)
    beta_phib = FaceField(*(betaf[a] * fs.phib[a] for a in range(3)))

    wV = ops.limited_weights_vec(fs.Ub, grid, bcs.Ub, beta_phib, k=1.0, t=t)
    ddt_beta = (beta - beta_old) / dt
    div_beta_phib = ops.div_flux(beta_phib, grid)

    nu_eff_f = ops.face_interp(nu_eff, grid, _bc.zero_gradient())
    beta_nu_f = FaceField(*(betaf[a] * nu_eff_f[a] for a in range(3)))

    # explicit viscous pieces
    S = dev2_T_grad(fs.Ub, beta * nu_eff, grid, bcs.Ub, t)
    div_dev = div_tensor(S, grid)                       # fvc::div(...)
    grad_beta = ops.grad(beta, grid, _invert_alpha_bc(bcs.alpha), t=t)
    grad_Ub = ops.grad_vec(fs.Ub, grid, bcs.Ub, t=t)    # [j, i] = dUb_j/dx_i
    cross_diff = torch.stack([
        nu_eff * torch.sum(grad_beta * grad_Ub[j], dim=0) for j in range(3)])

    # Cvm block shares the scheme but uses the phase flux phib
    use_cvm = cfg.Cvm != 0.0
    if use_cvm:
        wV_phib = ops.limited_weights_vec(fs.Ub, grid, bcs.Ub, fs.phib,
                                          k=1.0, t=t)
        div_phib = ops.div_flux(fs.phib, grid)
        cvm_scale = cfg.Cvm * alpha * beta

    g_dir = device_vector(tuple(cfg.forcing.flow_direction), beta.dtype,
                          beta.device)
    avg_beta = ops.average_to_cells(betaf, grid, bcs.alpha)
    # RHS explicit: beta*alpha/rhob*(lift + Cvm*rhob*DDtUa) + channel
    # gradP below (the Cvm term is Python-gated: with Cvm == 0 it is
    # exact zeros, and DDtUa may be stale — see solver.need_ddtu)
    rhs_inner = fs.lift_coeff if not use_cvm else (
        fs.lift_coeff + cfg.Cvm * cfg.rhob * fs.DDtUa)
    rhs_exp = (beta * alpha / cfg.rhob)[None] * rhs_inner

    terms = []
    for j in range(3):
        cbc = bcs.Ub.component(j)
        tm = linop.ddt(fs.Ub_old[j], dt, grid, coeff=beta, coeff_old=beta_old)
        tm = tm + linop.div(beta_phib, fs.Ub[j], grid, cbc, wV, t=t)
        tm = tm - linop.Sp(ddt_beta + div_beta_phib, grid)
        if use_cvm:
            blk = linop.ddt(fs.Ub_old[j], dt, grid)
            blk = blk + linop.div(fs.phib, fs.Ub[j], grid, cbc, wV_phib, t=t)
            blk = blk - linop.Sp(div_phib, grid)
            tm = tm + cvm_scale * blk
        # divDevReff(Ub) = -laplacian(beta*nuEff, Ub) - div(beta*nuEff*dev2(T(grad Ub)))
        tm = tm - linop.laplacian(beta_nu_f, grid, cbc, phi=fs.phib, t=t)
        tm = tm - linop.source(-div_dev[j], grid)   # explicit LHS piece
        # + nuEff*(grad(beta) & grad(Ub))  (explicit LHS)
        tm = tm - linop.source(-cross_diff[j], grid)
        # RHS: - beta*Sp(dragCoef/rhob, Ub)  (implicit drag; Omega==0 in
        # the reference but kept — liftDragCoeffs.H:18)
        tm = tm + beta * linop.Sp(fs.drag_coef / cfg.rhob, grid)
        tm = tm + linop.source(
            rhs_exp[j] + avg_beta * g_dir[j] * fs.grad_p_value, grid)
        if cfg.add_ibm_force:
            # UEqns.H:38-41: implicit relaxation toward zero velocity
            relax_t = cfg.ibm_relax_time if cfg.ibm_relax_time > 0 \
                else 3.0 * dt
            tm = tm + linop.Sp(fs.ibm_indicator / relax_t, grid)
        if cfg.add_dns_force:
            # UEqns.H RANDOM_TURB branch: + avg(beta)*turbulenceForce
            tm = tm + linop.source(avg_beta * fs.turbulence_force[j], grid)
        tm = tm.relax(fs.Ub[j], cfg.piso.momentum_relax)
        terms.append(tm)

    return UbEqn(tuple(terms))


def _invert_patch(p):
    """BC of beta = 1 - alpha: fixedValue v -> fixedValue 1-v, rest same."""
    if isinstance(p, _bc.RegionPatchBC):
        return _bc.RegionPatchBC(_invert_patch(p.inside),
                                 _invert_patch(p.outside), p.region)
    if p.kind in (_bc.FIXED_VALUE, _bc.INLET_OUTLET):
        if isinstance(p.value, _bc.TimeTable):
            v = p.value.map_values(lambda x: 1.0 - x)
        else:
            v = (1.0 - p.value[0],)
        return _bc.PatchBC(p.kind, v)
    return p


def _invert_alpha_bc(alpha_bc: _bc.FieldBC) -> _bc.FieldBC:
    return _bc.FieldBC(*(_invert_patch(alpha_bc.patch(pn))
                         for pn in _bc.PATCHES))


def piso(fs: FluidState, eqn: UbEqn, grid: Grid, bcs: FluidBCs,
         cfg: FluidConfig, pprecond=None) -> FluidState:
    """pEqn.H — PISO pressure-velocity correction. `pprecond`, when given,
    is the prebuilt fastsolve.pressure_preconditioner for bcs.p."""
    dt = cfg.dt
    beta = fs.beta
    rUbA = beta / eqn.A(grid)
    g = device_vector(tuple(cfg.gravity), beta.dtype, beta.device)
    gflux = gravity_flux(grid, g, beta.dtype, beta.device)

    t = fs.time
    p = fs.p
    Ub = fs.Ub
    phia = fs.phia
    phib = fs.phib

    alphaf = ops.face_interp(fs.alpha, grid, bcs.alpha, t=t)
    betaf = FaceField(*(1.0 - alphaf[a] for a in range(3)))
    rUbAf = _interp_zg(rUbA, grid)
    rUbA_rhob_f = _interp_zg(rUbA / cfg.rhob, grid)

    # particle momentum source as a face flux (pEqn.H:21-23)
    asrc_flux = ops.flux_of(fs.Asrc, grid, _bc.zero_gradient())
    phi_dragb = FaceField(*(
        rUbA_rhob_f[a] * asrc_flux[a] + rUbAf[a] * gflux[a] for a in range(3)))
    phi_dragb = _zero_on_zero_gradient_p(phi_dragb, bcs.p, grid)

    dcorr = ddt_corr(fs.Ub_old, fs.phib_old, grid, bcs.Ub, dt, t)

    need_ref = _needs_reference(bcs.p)
    ijk_ref = np.unravel_index(cfg.piso.p_ref_cell,
                               (grid.whole_nx, grid.ny, grid.nz))

    from pbref.fluid.pprecond import make_preconditioner
    precond_raw = make_preconditioner(grid, bcs.p, need_ref,
                                      cfg.piso.p_ref_cell, p.dtype, p.device,
                                      solver=pprecond)

    for _ in range(cfg.piso.n_correctors):
        Ub = rUbA[None] * eqn.H(Ub, grid) / beta[None]

        phia = ops.flux_of(fs.Ua, grid, bcs.Ua, phia, t)
        phib_star = ops.flux_of(Ub, grid, bcs.Ub, phib, t)
        phib = FaceField(*(
            phib_star[a] + rUbAf[a] * dcorr[a] + phi_dragb[a]
            for a in range(3)))
        phi = FaceField(*(
            alphaf[a] * phia[a] + betaf[a] * phib[a] for a in range(3)))

        Dp = FaceField(*(betaf[a] * rUbAf[a] / cfg.rhob for a in range(3)))

        for _ in range(cfg.piso.n_non_orth + 1):
            p_term = linop.laplacian(Dp, grid, bcs.p, t=t)
            b = p_term.rhs + ops.div_flux(phi, grid) \
                * grid.cell_volume_like(p_term.rhs)
            if need_ref:
                # singular (all-Neumann/periodic) system: solve in the
                # consistent subspace and pin the constant afterwards
                b = b - grid.mean(b)
            dp_scale = sum(grid.mean(Dp[a], x_faces=a == 0)
                           for a in range(3)) / 3.0
            sol = linsolve.pcg(p_term.apply, b, p, p_term.diag,
                               tol=cfg.piso.p_tol,
                               rel_tol=cfg.piso.p_rel_tol,
                               max_iter=cfg.piso.p_max_iter,
                               precond=lambda r: precond_raw(r, dp_scale),
                               grid=grid)
            p = sol.x
            if need_ref:
                p = p - grid.cell_value(p, ijk_ref) + cfg.piso.p_ref_value

        # flux correction: SfGradp = pEqn.flux()/Dp = A_f * snGrad(p)
        sgp = ops.sn_grad(p, grid, bcs.p, t=t)
        sf_gradp = FaceField(*(sgp[a] * grid.face_area_like(a, sgp[a])
                               for a in range(3)))
        phib = FaceField(*(
            phib[a] - rUbAf[a] * sf_gradp[a] / cfg.rhob for a in range(3)))
        phi = FaceField(*(
            alphaf[a] * phia[a] + betaf[a] * phib[a] for a in range(3)))

        # velocity reconstruction
        corr_flux = FaceField(*(
            phi_dragb[a] - rUbAf[a] * sf_gradp[a] / cfg.rhob for a in range(3)))
        Ub = Ub + reconstruct(corr_flux, grid)

    return fs._replace(p=p, Ub=Ub, phia=phia, phib=phib, phi=phi)


def _zero_on_zero_gradient_p(flux: FaceField, pbc: _bc.FieldBC,
                             grid: Grid) -> FaceField:
    """pEqn.H:28-35: kill the drag/gravity flux on zeroGradient-p patches
    (the domain's: not on a slab's seams)."""
    out = [flux.x, flux.y, flux.z]
    for a in range(3):
        for lo, patch, seam in zip((True, False), pbc.axis(a),
                                   grid.seams(a)):
            if patch.kind not in (_bc.ZERO_GRADIENT, _bc.EMPTY) or seam:
                continue
            fm = ops._mv(out[a], a).clone()
            if lo:
                fm[:1] = 0.0
            else:
                fm[-1:] = 0.0
            out[a] = ops._mvback(fm, a)
    return FaceField(*out)


def ddtu(fs: FluidState, grid: Grid, bcs: FluidBCs, cfg: FluidConfig
         ) -> FluidState:
    """DDtU.H — DDtU = ddt(U) + div(phi, U) - div(phi)*U (per phase)."""
    dt = cfg.dt
    t = fs.time

    def _one(U, U_old, phi, vbc):
        w = ops.limited_weights_vec(U, grid, vbc, phi, k=1.0, t=t)
        divphi = ops.div_flux(phi, grid)
        comps = []
        for j in range(3):
            fv = ops.weighted_face_value(U[j], w, grid, vbc.component(j),
                                         phi, t)
            conv = ops.div_flux_field(phi, fv, grid)
            comps.append((U[j] - U_old[j]) / dt + conv - divphi * U[j])
        return torch.stack(comps)

    DDtUa = _one(fs.Ua, fs.Ua_old, fs.phia, bcs.Ua)
    DDtUb = _one(fs.Ub, fs.Ub_old, fs.phib, bcs.Ub)
    return fs._replace(DDtUa=DDtUa, DDtUb=DDtUb)


def adjust_channel_forcing(fs: FluidState, rUbA, grid: Grid,
                           cfg: FluidConfig) -> FluidState:
    """chPressureGrad::adjust (chPressureGrad.C:221-300)."""
    f = cfg.forcing
    if f.mode == "none":
        return fs
    if f.mode == "Ubar":
        # chPressureGrad.C:242-257: magUbarStar = (dir & U) weighted by
        # beta*V; gradPplus = (magUbar - magUbarStar)/avgV(rUA);
        # U += dir*rUA*gradPplus — U is the mixture, and alpha*Ua is
        # particle-imposed, so the increment lands on beta*Ub:
        # Ub += dir*rUA*gradPplus/beta.
        from pbref.utils.accum import stable_dot, stable_sum
        direction = device_vector(tuple(f.flow_direction), fs.p.dtype,
                                  fs.p.device)
        beta = fs.beta
        V = grid.cell_volume_like(beta) + torch.zeros_like(beta)
        # cell by cell, not a matmul: its rounding must not depend on
        # the field's size or layout (a slab's is the whole grid's)
        U = fs.U
        Udir = direction[0] * U[0] + direction[1] * U[1] \
            + direction[2] * U[2]
        bV = beta * V
        # compensated global means: the forcing feedback integrates this
        # error over thousands of steps (the reference does it in f64)
        pol = cfg.dtype_policy
        mag_ubar_star = stable_dot(Udir, bV, pol, grid) \
            / stable_sum(bV, pol, grid)
        rub_avg = stable_dot(rUbA, V, pol, grid) / stable_sum(V, pol, grid)
        grad_p_plus = (f.mag_ubar - mag_ubar_star) / rub_avg
        dU = rUbA * grad_p_plus / torch.clamp(beta, min=1e-6)
        Ub = fs.Ub + direction[:, None, None, None] * dU[None]
        return fs._replace(Ub=Ub, grad_p_value=fs.grad_p_value + grad_p_plus)
    if f.mode == "gradPbar":
        val = abs(f.grad_pbar) + abs(f.dpdt) * fs.time
        return fs._replace(grad_p_value=val)
    if f.mode == "varyingGradP":
        if f.varying_type == "sinusoidal":
            val = abs(f.grad_pbar) * torch.sin(
                2.0 * math.pi * fs.time / f.period + 0.5 * math.pi)
        else:  # square
            n = torch.round(fs.time / f.period + 0.5 - 1e-12)
            val = abs(f.grad_pbar) * torch.pow(-1.0, n)
        return fs._replace(grad_p_value=val)
    raise ValueError(f"unknown forcing mode {f.mode}")
