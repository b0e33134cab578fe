"""Turbulence models for the continuous phase (port of
``sedifoam_tpu/fluid/turbulence.py``).

Reference: lammpsFoamTurbulenceModels/ — RAS kEpsilon, LES Smagorinsky /
kEqn, and the custom beta-weighted mySmagorinsky. The momentum coupling is
entirely through nuEff (divDevReff is assembled in piso.py with whatever
nuEff the model returns) plus the transported k/epsilon fields.

The kEqn and kEpsilon transport equations use upwind convection and
BiCGStab solves (linsolve.bicgstab, a while_loop: a conditional node in
the captured step, a host read per iteration when run eagerly). The
kEpsilon wall-function mask depends only on the grid and the velocity
BCs; it is built once per (grid, BCs, dtype, device) and kept.
"""

from __future__ import annotations


import numpy as np
import torch

from pbref import bc as _bc
from pbref import linop, linsolve, ops
from pbref.config import FluidConfig
from pbref.fluid.state import FluidBCs, FluidState
from pbref.grid import FaceField, Grid


def reynolds_stress(fs: FluidState, grid: Grid, bcs: FluidBCs,
                    cfg: FluidConfig):
    """B = (2/3) k I - nuEff * twoSymm(grad(Ub)) — exactly the
    Reynolds-stress export of the reference (pEqn.H:100).

    Returns (6, nx, ny, nz): xx, xy, xz, yy, yz, zz.
    """
    g = ops.grad_vec(fs.Ub, grid, bcs.Ub)   # g[j, i] = dU_j/dx_i
    nueff = cfg.nub + fs.nut
    k = fs.k

    def comp(i, j):
        s = nueff * (g[i, j] + g[j, i])
        return ((2.0 / 3.0) * k - s) if i == j else -s

    return torch.stack([comp(0, 0), comp(0, 1), comp(0, 2),
                        comp(1, 1), comp(1, 2), comp(2, 2)])


def nu_eff(fs: FluidState, grid: Grid, cfg: FluidConfig):
    """Effective viscosity field for the momentum equation."""
    base = torch.full(grid.shape, cfg.nub, dtype=fs.p.dtype,
                      device=fs.p.device)
    if cfg.turbulence.model == "laminar":
        return base
    return base + fs.nut


def _strain_rate_sq(U, grid: Grid, vbc):
    """2*magSqr(symm(grad(U))) — used by Smagorinsky and kEpsilon G."""
    g = ops.grad_vec(U, grid, vbc)  # g[j, i] = dU_j/dx_i
    S2 = torch.zeros(grid.shape, dtype=U.dtype, device=U.device)
    for i in range(3):
        for j in range(3):
            sij = 0.5 * (g[i, j] + g[j, i])
            S2 = S2 + 2.0 * sij * sij
    return S2


def _upwind(phi: FaceField) -> FaceField:
    return FaceField(*(torch.where(p >= 0, torch.ones_like(p),
                                   torch.zeros_like(p)) for p in phi))


def correct(fs: FluidState, grid: Grid, bcs: FluidBCs, cfg: FluidConfig
            ) -> FluidState:
    """turbulence->correct(): update nut (and k/epsilon for RAS)."""
    t = cfg.turbulence
    if t.model == "laminar":
        return fs

    # cubeRootVol LES delta: cellwise on graded grids
    delta = grid.geom("cbrt_cell_volume",
                      lambda: grid.cell_volume ** (1.0 / 3.0), fs.p.dtype,
                      fs.p.device)

    if t.model in ("Smagorinsky", "mySmagorinsky"):
        # local-equilibrium Smagorinsky: k_sgs = (2 Ck/Ce) delta^2 |symm(grad U)|^2,
        # nut = Ck sqrt(k) delta  (OpenFOAM Smagorinsky.C closed form for
        # incompressible flow, trace term dropped)
        S2 = _strain_rate_sq(fs.Ub, grid, bcs.Ub)   # = 2|symm(grad U)|^2
        k = (2.0 * t.Ck / t.Ce) * delta ** 2 * (S2 / 2.0)
        nut = t.Ck * torch.sqrt(k) * delta
        if t.model == "mySmagorinsky":
            # beta-weighted variant (LES/mySmagorinsky/mySmagorinsky.C)
            nut = fs.beta * nut
        return fs._replace(nut=nut, k=k)

    if t.model == "kEqn":
        # one-equation eddy-viscosity LES: transport k_sgs with
        # production nut*|S|^2, dissipation Ce k^1.5/delta; nut=Ck sqrt(k) delta
        dt = cfg.dt
        kbc = _bc.zero_gradient()
        k = torch.clamp(fs.k, min=1e-12)
        nut = torch.clamp(fs.nut, min=0.0)
        S2 = _strain_rate_sq(fs.Ub, grid, bcs.Ub)
        G = nut * S2
        nu_k_f = ops.face_interp(cfg.nub + nut, grid, kbc)
        term_k = (linop.ddt(k, dt, grid)
                  + linop.div(fs.phib, k, grid, kbc, _upwind(fs.phib))
                  - linop.laplacian(nu_k_f, grid, kbc)
                  + linop.Sp(t.Ce * torch.sqrt(k) / delta, grid)
                  + linop.source(G, grid))  # production on the RHS
        sol = linsolve.bicgstab(term_k.apply, term_k.rhs, k, term_k.diag,
                                tol=1e-8, max_iter=500, grid=grid)
        k_new = torch.clamp(sol.x, min=1e-12)
        return fs._replace(k=k_new, nut=t.Ck * torch.sqrt(k_new) * delta)

    if t.model == "kEpsilon":
        return _k_epsilon(fs, grid, bcs, cfg)

    raise ValueError(f"unknown turbulence model {t.model}")


def _is_noslip(patch) -> bool:
    """True only for fixedValue (0,0,0): velocity INLETS are fixedValue
    too and must not get wall functions."""
    if patch.kind != _bc.FIXED_VALUE:
        return False
    v = patch.value
    if isinstance(v, _bc.TimeTable):
        return all(all(x == 0.0 for x in knot) for knot in v.values)
    return all(x == 0.0 for x in v)


def _wall_layers(grid: Grid, bcs: FluidBCs):
    """(mask (nx,ny,nz), y_half (nx,ny,nz)) numpy arrays of cells
    adjacent to no-slip walls, with their wall distance (half cell
    width); on a slab, the walls of its own sides (not its seams)."""
    mask = np.zeros(grid.shape, bool)
    yh = np.ones(grid.shape)
    for a in range(3):
        lo_p, hi_p = bcs.Ub.axis(a)
        w = grid.axis_widths(a)
        for is_lo, patch, seam in zip((True, False), (lo_p, hi_p),
                                      grid.seams(a)):
            if seam or not _is_noslip(patch):
                continue
            sl = [slice(None)] * 3
            sl[a] = slice(0, 1) if is_lo else slice(-1, None)
            mask[tuple(sl)] = True
            yh[tuple(sl)] = 0.5 * (w[0] if is_lo else w[-1])
    return mask, yh


def _wall_tensors(grid: Grid, bcs: FluidBCs, dtype, device):
    """(mask, y) of _wall_layers on the device, or None without no-slip
    walls; built once per Grid object, BCs, dtype and device (Grid.memo)."""
    def make():
        mask, yh = _wall_layers(grid, bcs)
        if not mask.any():
            return None
        return (torch.as_tensor(mask, device=device),
                torch.as_tensor(yh, dtype=dtype, device=device))

    return grid.memo(("wall_tensors", bcs.Ub, dtype, torch.device(device)),
                     make)


def _nut_wall(k, y, t, nub):
    """nutkWallFunction: nu*(y+ kappa/ln(E y+) - 1) above the laminar
    sublayer (y+ > 11.53), 0 inside it; returns (nut_w, u_tau_k)."""
    u_tau_k = t.Cmu ** 0.25 * torch.sqrt(k)
    yplus = u_tau_k * y / nub
    nut_w = nub * torch.clamp(
        yplus * t.kappa / torch.log(torch.clamp(t.E_wall * yplus,
                                                min=1.001)) - 1.0, min=0.0)
    return torch.where(yplus > 11.53, nut_w, torch.zeros_like(nut_w)), \
        u_tau_k


def _k_epsilon(fs: FluidState, grid: Grid, bcs: FluidBCs, cfg: FluidConfig
               ) -> FluidState:
    """Standard incompressible kEpsilon with upwind convection and
    (optionally) high-Re wall functions on no-slip patches:
    nutkWallFunction nut_w = nu*(y+ kappa/ln(E y+) - 1),
    epsilonWallFunction eps_w = Cmu^3/4 k^3/2/(kappa y),
    wall-cell production G_w = (nut_w+nu)*|Up|/y * Cmu^1/4 sqrt(k)/(kappa y).
    """
    t = cfg.turbulence
    dt = cfg.dt
    kbc = _bc.zero_gradient()
    ebc = _bc.zero_gradient()

    k = torch.clamp(fs.k, min=1e-12)
    eps = torch.clamp(fs.epsilon, min=1e-12)
    nut = torch.clamp(fs.nut, min=0.0)

    S2 = _strain_rate_sq(fs.Ub, grid, bcs.Ub)
    G = nut * S2

    walls = _wall_tensors(grid, bcs, k.dtype, k.device) \
        if t.wall_functions else None
    if walls is not None:
        wall, y = walls
        nut_w, u_tau_k = _nut_wall(k, y, t, cfg.nub)
        mag_up = torch.sqrt(sum(fs.Ub[c] ** 2 for c in range(3)))
        G_w = (nut_w + cfg.nub) * mag_up / y * u_tau_k / (t.kappa * y)
        eps_w = t.Cmu ** 0.75 * k ** 1.5 / (t.kappa * y)
        G = torch.where(wall, G_w, G)
        eps = torch.where(wall, eps_w, eps)

    phi = fs.phib
    w_up = _upwind(phi)

    # epsilon equation
    nu_eps_f = ops.face_interp(cfg.nub + nut / t.sigma_eps, grid, kbc)
    term_e = (linop.ddt(eps, dt, grid)
              + linop.div(phi, eps, grid, ebc, w_up)
              - linop.laplacian(nu_eps_f, grid, ebc)
              + linop.Sp(t.C2 * eps / k, grid)
              + linop.source(t.C1 * G * eps / k, grid))  # production RHS
    sol_e = linsolve.bicgstab(term_e.apply, term_e.rhs, eps, term_e.diag,
                              tol=1e-8, max_iter=500, grid=grid)
    eps_new = torch.clamp(sol_e.x, min=1e-12)
    if walls is not None:
        # epsilonWallFunction pins the wall-cell value
        eps_new = torch.where(wall, eps, eps_new)

    # k equation
    nu_k_f = ops.face_interp(cfg.nub + nut / t.sigma_k, grid, kbc)
    term_k = (linop.ddt(k, dt, grid)
              + linop.div(phi, k, grid, kbc, w_up)
              - linop.laplacian(nu_k_f, grid, kbc)
              + linop.Sp(eps_new / k, grid)
              + linop.source(G, grid))  # production on the RHS
    sol_k = linsolve.bicgstab(term_k.apply, term_k.rhs, k, term_k.diag,
                              tol=1e-8, max_iter=500, grid=grid)
    k_new = torch.clamp(sol_k.x, min=1e-12)

    nut_new = t.Cmu * k_new ** 2 / eps_new
    if walls is not None:
        # nutkWallFunction overrides the wall-cell eddy viscosity
        nut_w, _ = _nut_wall(k_new, y, t, cfg.nub)
        nut_new = torch.where(wall, nut_w, nut_new)
    return fs._replace(k=k_new, epsilon=eps_new, nut=nut_new)
