"""Matrix-free implicit FV operators (the fvm:: namespace); port of
``sedifoam_tpu/linop.py``.

OpenFOAM assembles sparse LDU matrices; here they are never materialized.
Each implicit term contributes (diag, apply, rhs) where ``apply``
evaluates the full volume-integrated operator on a trial field via
stencils. The discretized equation is  sum(apply)(x) == sum(rhs).

- UbEqn (lammpsFoam/UEqns.H) is assembled but never solved — PISO only
  consumes A() = diag/V and H() = (rhs - (apply(x) - diag*x))/V;
- the pressure Poisson is solved with the matrix-free PCG in linsolve.py.

Sign convention: terms appear with the sign they carry on the equation LHS.

On a slab of a fluid split along grid-x (grid.SlabGrid) a seam's face is
an internal face of the slab padded with the neighbour's ghost plane
(ops._seam_pad): its coefficients go to the slab's own cell in the order
the whole grid adds them, and the boundary-patch coefficients go to the
domain's own sides only.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from pbref import bc as _bc
from pbref import ops
from pbref.grid import FaceField, Grid


@dataclasses.dataclass
class LinTerm:
    """One volume-integrated implicit term: equation LHS piece."""

    diag: torch.Tensor                      # diagonal coefficient field
    apply: Callable[[torch.Tensor], torch.Tensor]  # full operator incl. diag
    rhs: torch.Tensor                       # explicit RHS contribution

    def __add__(self, other: "LinTerm") -> "LinTerm":
        sapply, oapply = self.apply, other.apply
        return LinTerm(
            self.diag + other.diag,
            lambda x: sapply(x) + oapply(x),
            self.rhs + other.rhs,
        )

    def __sub__(self, other: "LinTerm") -> "LinTerm":
        sapply, oapply = self.apply, other.apply
        return LinTerm(
            self.diag - other.diag,
            lambda x: sapply(x) - oapply(x),
            self.rhs - other.rhs,
        )

    def __mul__(self, field):
        """Row-scaling by a cell field (volScalarField * fvMatrix)."""
        sapply = self.apply
        return LinTerm(field * self.diag, lambda x: field * sapply(x),
                       field * self.rhs)

    __rmul__ = __mul__

    # --- the two quantities PISO consumes -----------------------------
    def A(self, grid: Grid):
        """Diagonal per unit volume (OpenFOAM fvMatrix::A)."""
        return self.diag / grid.cell_volume_like(self.diag)

    def H(self, x, grid: Grid):
        """(rhs - offdiag*x)/V (OpenFOAM fvMatrix::H)."""
        return (self.rhs - (self.apply(x) - self.diag * x)) \
            / grid.cell_volume_like(x)

    def relax(self, x, alpha: float) -> "LinTerm":
        """fvMatrix::relax(alpha): D /= alpha; rhs += (D' - D) * x_current."""
        if alpha >= 1.0:
            return self
        new_diag = self.diag / alpha
        delta = new_diag - self.diag
        sapply = self.apply
        return LinTerm(new_diag, lambda v: sapply(v) + delta * v,
                       self.rhs + delta * x)


def zero_term(grid: Grid, dtype=torch.float64, device=None) -> LinTerm:
    """The term that contributes nothing (diag, apply and rhs all 0)."""
    z = torch.zeros(grid.shape, dtype=dtype, device=device)
    return LinTerm(z, lambda x: torch.zeros_like(x), z)


def _hom_patch(p):
    if isinstance(p, _bc.RegionPatchBC):
        return _bc.RegionPatchBC(_hom_patch(p.inside), _hom_patch(p.outside),
                                 p.region)
    v = p.value
    n = v.n_comp if isinstance(v, _bc.TimeTable) else len(v)
    return _bc.PatchBC(p.kind, (0.0,) * n)


def _homogeneous(fbc: _bc.FieldBC) -> _bc.FieldBC:
    """Same BC kinds with zeroed values — the linear part of the operator."""
    return _bc.FieldBC(*(_hom_patch(fbc.patch(p)) for p in _bc.PATCHES))


# ---------------------------------------------------------------------------
# fvm::ddt
# ---------------------------------------------------------------------------


def ddt(field_old, dt: float, grid: Grid, coeff=None, coeff_old=None) -> LinTerm:
    """fvm::ddt(c) or fvm::ddt(coeff, c) with Euler scheme.

    diag = V*coeff/dt; rhs = V*coeff_old/dt*c_old.
    """
    V = grid.cell_volume_like(field_old)
    if coeff is None:
        coeff = torch.ones(grid.shape, dtype=field_old.dtype,
                           device=field_old.device)
        coeff_old = coeff
    if coeff_old is None:
        coeff_old = coeff
    diag = V / dt * coeff
    rhs = V / dt * coeff_old * field_old
    return LinTerm(diag, lambda x: diag * x, rhs)


# ---------------------------------------------------------------------------
# fvm::Sp  (implicit source)
# ---------------------------------------------------------------------------


def Sp(s, grid: Grid) -> LinTerm:
    """fvm::Sp(s, c): appears on LHS as +s*V*c."""
    V = grid.cell_volume_like(s)
    diag = s * V
    return LinTerm(diag, lambda x: diag * x, torch.zeros_like(diag))


def source(src, grid: Grid) -> LinTerm:
    """Explicit source on the RHS (volume-integrated): ... == src."""
    V = grid.cell_volume_like(src)
    z = torch.zeros_like(src)
    return LinTerm(z, lambda x: torch.zeros_like(x), src * V)


# ---------------------------------------------------------------------------
# fvm::div(phi, c)
# ---------------------------------------------------------------------------


def _bc_conv_coeffs(patch: _bc.PatchBC, lo: bool, phi_slab, t=0.0):
    """(internal_coeff, boundary_value) for a convected boundary face."""
    k = patch.kind
    zero = torch.zeros_like(phi_slab)
    one = torch.ones_like(phi_slab)
    if k == _bc.FIXED_VALUE:
        return zero, zero + patch.value_at(t)
    if k in (_bc.ZERO_GRADIENT, _bc.SLIP):
        return one, zero
    if k == _bc.EMPTY:
        return zero, zero
    if k == _bc.INLET_OUTLET:
        outflow = (phi_slab < 0) if lo else (phi_slab > 0)
        ic = torch.where(outflow, one, zero)
        bv = torch.where(outflow, zero, zero + patch.value_at(t))
        return ic, bv
    if k == _bc.CYCLIC:
        # handled as an internal (wrapping) face in div(); marker only
        return None, None
    raise ValueError(f"unknown BC kind {k}")


def _conv_coeffs(patch, lo: bool, phi_slab, grid, t=0.0):
    """_bc_conv_coeffs with RegionPatchBC blending (mask over the face)."""
    if isinstance(patch, _bc.RegionPatchBC):
        m = ops._region_mask(patch, grid, phi_slab)
        ic_i, bv_i = _conv_coeffs(patch.inside, lo, phi_slab, grid, t)
        ic_o, bv_o = _conv_coeffs(patch.outside, lo, phi_slab, grid, t)
        return (m * ic_i + (1.0 - m) * ic_o,
                m * bv_i + (1.0 - m) * bv_o)
    return _bc_conv_coeffs(patch, lo, phi_slab, t)


def div(phi: FaceField, field, grid: Grid, fbc: _bc.FieldBC,
        weights: Optional[FaceField] = None, t=0.0) -> LinTerm:
    """fvm::div(phi, c) with owner-side face weights (from ops.limited_weights
    or 0.5 for pure linear). Cyclic patches are wrap-around internal faces
    with central weighting.
    """
    if weights is None:
        weights = FaceField(*(torch.full_like(phi[a], 0.5) for a in range(3)))

    # boundary convection coefficients depend only on phi: compute once
    bcoef = []
    for a in range(3):
        pm = ops._mv(phi[a], a)
        lo_p, hi_p = fbc.axis(a)
        if lo_p.kind == _bc.CYCLIC:
            bcoef.append(None)
        else:
            bcoef.append((_conv_coeffs(lo_p, True, pm[:1], grid, t),
                          _conv_coeffs(hi_p, False, pm[-1:], grid, t)))
    seams = [grid.seams(a) for a in range(3)]

    def apply_fn(x):
        out = torch.zeros_like(x)
        for a in range(3):
            pm = ops._mv(phi[a], a)
            wm = ops._mv(weights[a], a)
            xm = ops._mv(x, a)
            xp, lo, hi, o_lo, o_hi = ops._seam_pad(xm, grid, a)
            inner = ops._inner(pm.shape[0], lo, hi)
            # internal faces
            fval = wm[inner] * xp[:-1] + (1.0 - wm[inner]) * xp[1:]
            Fint = pm[inner] * fval
            if bcoef[a] is None:
                # the cyclic patch: o_lo is the domain's last plane, o_hi
                # its first
                Flo = pm[:1] * (0.5 * (o_lo + xm[:1]))
                Fhi = pm[-1:] * (0.5 * (xm[-1:] + o_hi))
            else:
                # linear part only: boundary-value contributions live in rhs
                (ic_lo, _), (ic_hi, _) = bcoef[a]
                Flo = pm[:1] * ic_lo * xm[:1]
                Fhi = pm[-1:] * ic_hi * xm[-1:]
            F = ops._join_faces(None if lo else Flo, Fint,
                                None if hi else Fhi)
            out = out + ops._mvback(F[1:] - F[:-1], a)
        return out

    # diagonal: contribution of x_j to its own cells' divergence
    diag = torch.zeros(grid.shape, dtype=phi.x.dtype, device=phi.x.device)
    rhs = torch.zeros_like(diag)
    for a in range(3):
        pm = ops._mv(phi[a], a)
        wm = ops._mv(weights[a], a)
        lo, hi = (int(s) for s in seams[a])
        inner = ops._inner(pm.shape[0], lo, hi)
        # the cells of the axis, a seam's ghost cell included
        dp = pm.new_zeros((pm.shape[0] - 1 + lo + hi,) + pm.shape[1:])
        # internal faces: owner j gets +phi*w (its hi face), neighbor j+1
        # gets -phi*(1-w) (its lo face)
        dp[:-1] += pm[inner] * wm[inner]
        dp[1:] += -pm[inner] * (1.0 - wm[inner])
        dm = dp[lo:dp.shape[0] - hi]
        rm = torch.zeros_like(dm)
        if bcoef[a] is None:
            if not lo:
                dm[:1] += -pm[:1] * 0.5
            if not hi:
                dm[-1:] += pm[-1:] * 0.5
        else:
            (ic_lo, bv_lo), (ic_hi, bv_hi) = bcoef[a]
            if not lo:
                dm[:1] += -pm[:1] * ic_lo
                rm[:1] += pm[:1] * bv_lo
            if not hi:
                dm[-1:] += pm[-1:] * ic_hi
                rm[-1:] += -pm[-1:] * bv_hi
        diag = diag + ops._mvback(dm, a)
        rhs = rhs + ops._mvback(rm, a)

    return LinTerm(diag, apply_fn, rhs)


# ---------------------------------------------------------------------------
# fvm::laplacian(gamma, c)
# ---------------------------------------------------------------------------


def laplacian(gamma_face, grid: Grid, fbc: _bc.FieldBC,
              phi: Optional[FaceField] = None,
              dtype=None, t=0.0, device=None) -> LinTerm:
    """fvm::laplacian(gamma, c): LHS apply(x) = sum_f gamma_f A_f snGrad(x).

    gamma_face: FaceField or scalar diffusion coefficient.
    phi: flux for inletOutlet BC switching (rarely needed for laplacians).
    """
    if isinstance(gamma_face, FaceField):
        dtype = dtype or gamma_face.x.dtype
        device = gamma_face.x.device
    else:
        dtype = dtype or torch.float64
        g = gamma_face
        gamma_face = FaceField(
            torch.full((grid.nx + 1, grid.ny, grid.nz), g, dtype=dtype,
                       device=device),
            torch.full((grid.nx, grid.ny + 1, grid.nz), g, dtype=dtype,
                       device=device),
            torch.full((grid.nx, grid.ny, grid.nz + 1), g, dtype=dtype,
                       device=device),
        )
    hom = _homogeneous(fbc)

    def apply_fn(x):
        g = ops.sn_grad(x, grid, hom, phi)
        out = torch.zeros_like(x)
        for a in range(3):
            F = gamma_face[a] * g[a] * grid.face_area_like(a, x)
            Fm = ops._mv(F, a)
            out = out + ops._mvback(Fm[1:] - Fm[:-1], a)
        return out

    like = gamma_face.x
    diag = torch.zeros(grid.shape, dtype=dtype, device=like.device)
    rhs = torch.zeros_like(diag)
    for a in range(3):
        gm = ops._mv(gamma_face[a], a)
        if grid.uniform:
            area_m = grid.face_area[a]
            d = grid.spacing[a]
            inv_int = 1.0 / d
            inv_lo = inv_hi = 2.0 / d   # boundary delta = d/2
            inv_cyc = 1.0 / d
        else:
            area_m = grid.const(
                ("face_area_moved", a),
                lambda: np.moveaxis(grid.face_area[a], a, 0),
                like.dtype, like.device)
            inv_int = ops.inv_dist_internal(grid, a, like)
            # boundary deltas are half the end cells' widths
            _, _, d_lo, d_hi, d_cyc = ops._axis_geom(grid, a, like)
            inv_lo = 1.0 / (0.5 * d_lo)
            inv_hi = 1.0 / (0.5 * d_hi)
            inv_cyc = 1.0 / d_cyc
        lo, hi = (int(s) for s in grid.seams(a))
        coef_int = gm[ops._inner(gm.shape[0], lo, hi)] * area_m * inv_int
        # the cells of the axis, a seam's ghost cell included
        dp = torch.zeros((gm.shape[0] - 1 + lo + hi,) + gm.shape[1:],
                         dtype=diag.dtype, device=diag.device)
        dp[:-1] += -coef_int
        dp[1:] += -coef_int
        dm = dp[lo:dp.shape[0] - hi]
        rm = torch.zeros_like(dm)
        lo_p, hi_p = fbc.axis(a)

        def _bnd(patch, is_lo, gslab, inv_b, idx):
            """(diag_add, rhs_add) slabs for one boundary patch."""
            zero = torch.zeros_like(gslab * area_m)
            if isinstance(patch, _bc.RegionPatchBC):
                m = ops._region_mask(patch, grid, gslab)
                di, ri = _bnd(patch.inside, is_lo, gslab, inv_b, idx)
                do, ro = _bnd(patch.outside, is_lo, gslab, inv_b, idx)
                return (m * di + (1.0 - m) * do,
                        m * ri + (1.0 - m) * ro)
            if patch.kind == _bc.FIXED_VALUE:
                c = gslab * area_m * inv_b
                return -c, -c * patch.value_at(t)
            if patch.kind == _bc.CYCLIC:
                return -(gslab * area_m * inv_cyc), zero
            if patch.kind == _bc.INLET_OUTLET and phi is not None:
                pslab = ops._mv(phi[a], a)[idx]
                outflow = (pslab < 0) if is_lo else (pslab > 0)
                c = torch.where(outflow, zero, gslab * area_m * inv_b)
                return -c, -c * patch.value_at(t)
            # zeroGradient/empty/slip (and inletOutlet w/o flux context):
            # zero flux, nothing to add
            return zero, zero

        for is_lo, patch, gslab, inv_b, seam in (
                (True, lo_p, gm[:1], inv_lo, lo),
                (False, hi_p, gm[-1:], inv_hi, hi)):
            if seam:
                continue
            idx = slice(0, 1) if is_lo else slice(-1, None)
            d_add, r_add = _bnd(patch, is_lo, gslab, inv_b, idx)
            dm[idx] += d_add
            rm[idx] += r_add
        diag = diag + ops._mvback(dm, a)
        rhs = rhs + ops._mvback(rm, a)

    # equation convention: apply(x) == rhs; the boundary-value pieces were
    # accumulated with the sign they need on the RHS already.
    return LinTerm(diag, apply_fn, rhs)


def laplacian_flux(gamma_face, x, grid: Grid, fbc: _bc.FieldBC,
                   phi: Optional[FaceField] = None, t=0.0) -> FaceField:
    """fvMatrix::flux() of a laplacian matrix: gamma_f A_f snGrad(x) per
    face."""
    g = ops.sn_grad(x, grid, fbc, phi, t)
    if not isinstance(gamma_face, FaceField):
        gamma_face = FaceField(gamma_face, gamma_face, gamma_face)
    return FaceField(*(gamma_face[a] * g[a] * grid.face_area_like(a, g[a])
                       for a in range(3)))
