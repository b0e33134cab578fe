"""Finite-volume operators on the structured grid (port of the parts of
``sedifoam_tpu/ops.py`` that the PISO step and the cloud coupling call).

The equivalents of OpenFOAM's fvc:: namespace as used by the reference
solver (lammpsFoam/{UEqns.H,pEqn.H}): Gauss-linear interpolation/
gradient/divergence, snGrad, curl, and the limitedLinearV TVD convection
weights.

Every operator is a shift-and-add stencil on tensors; boundary conditions
are static (`bc.FieldBC`), so the branching is Python on the config.

Layout: scalar cell fields are (nx, ny, nz); vector fields are
(3, nx, ny, nz), component leading; face fields are `grid.FaceField` with
the +axis orientation convention.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from sedifoam_tpu_torch import bc as _bc
from sedifoam_tpu_torch.grid import FaceField, Grid

# OpenFOAM's SMALL/ROOTVSMALL analogues.
SMALL = 1e-15
ROOTVSMALL = 1e-18


def _const(x, like):
    """Cast a numpy geometry constant to the field's dtype and device
    (graded grids carry np.float64 volume/area/distance arrays)."""
    if isinstance(x, np.ndarray):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x


def _mv(a, axis):
    return torch.movedim(a, axis, 0)


def _mvback(a, axis):
    return torch.movedim(a, 0, axis)


def _sign(x):
    """OpenFOAM sign(): +1 for x >= 0 else -1."""
    one = torch.ones_like(x)
    return torch.where(x >= 0, one, -one)


def _full_like(x, v):
    """x-shaped tensor of a BC value (a float, or a 0-d tensor from a
    time table)."""
    return torch.zeros_like(x) + v


# ---------------------------------------------------------------------------
# boundary face values / gradients (per axis, per side)
# ---------------------------------------------------------------------------


def _boundary_face_value(cell_slab, patch: _bc.PatchBC, lo: bool,
                         other_slab=None, phi_slab=None, t=0.0):
    """Face value on a boundary patch given the adjacent cell slab."""
    k = patch.kind
    if k == _bc.FIXED_VALUE:
        return _full_like(cell_slab, patch.value_at(t))
    if k in (_bc.ZERO_GRADIENT, _bc.SLIP):
        return cell_slab
    if k == _bc.EMPTY:
        return torch.zeros_like(cell_slab)
    if k == _bc.CYCLIC:
        return 0.5 * (cell_slab + other_slab)
    if k == _bc.INLET_OUTLET:
        if phi_slab is None:
            # no flux context (explicit gradient ops): zeroGradient branch
            return cell_slab
        outflow = (phi_slab < 0) if lo else (phi_slab > 0)
        inlet = _full_like(cell_slab, patch.value_at(t))
        return torch.where(outflow, cell_slab, inlet)
    raise ValueError(f"unknown BC kind {k}")


def _boundary_sngrad(cell_slab, patch: _bc.PatchBC, lo: bool, d: float,
                     other_slab=None, phi_slab=None, t=0.0,
                     d_cyc: Optional[float] = None):
    """d(field)/d(axis) on a boundary face, along the +axis direction."""
    k = patch.kind
    if d_cyc is None:
        d_cyc = d
    if k == _bc.FIXED_VALUE:
        v = _full_like(cell_slab, patch.value_at(t))
        return (cell_slab - v) * (2.0 / d) if lo else (v - cell_slab) * (2.0 / d)
    if k in (_bc.ZERO_GRADIENT, _bc.EMPTY, _bc.SLIP):
        return torch.zeros_like(cell_slab)
    if k == _bc.CYCLIC:
        return ((cell_slab - other_slab) / d_cyc) if lo \
            else ((other_slab - cell_slab) / d_cyc)
    if k == _bc.INLET_OUTLET:
        if phi_slab is None:
            return torch.zeros_like(cell_slab)
        outflow = (phi_slab < 0) if lo else (phi_slab > 0)
        v = _full_like(cell_slab, patch.value_at(t))
        g_fix = (cell_slab - v) * (2.0 / d) if lo else (v - cell_slab) * (2.0 / d)
        return torch.where(outflow, torch.zeros_like(cell_slab), g_fix)
    raise ValueError(f"unknown BC kind {k}")


def _axis_geom(grid: Grid, axis: int, like):
    """(w_lin (n-1,1,1) owner weights, inv_d (n-1,1,1) internal inverse
    deltas, d_lo, d_hi, d_cyc) for one axis; scalars on uniform axes."""
    if grid.uniform:
        d = grid.spacing[axis]
        return 0.5, 1.0 / d, d, d, d
    w = grid.axis_widths(axis)
    dists = grid.axis_dists(axis)
    wl = _const(grid.axis_weights(axis)[:, None, None], like)
    inv_d = _const((1.0 / dists[1:-1])[:, None, None], like)
    d_cyc = 0.5 * (w[0] + w[-1])
    return wl, inv_d, float(w[0]), float(w[-1]), float(d_cyc)


def _region_mask(patch, grid, like):
    return _const(np.asarray(patch.region.mask(grid)), like)


def _axis_faces(c, axis: int, grid: Grid, fbc: _bc.FieldBC,
                phi: Optional[FaceField], mode: str, t=0.0):
    """Face values ('interp') or face +axis-gradients ('sngrad') along axis."""
    cm = _mv(c, axis)
    lo_patch, hi_patch = fbc.axis(axis)
    phi_ax = None if phi is None else _mv(phi[axis], axis)
    w_lin, inv_d, d_lo, d_hi, d_cyc = _axis_geom(grid, axis, cm)

    def bval(slab, patch, lo, other, phis):
        if isinstance(patch, _bc.RegionPatchBC):
            m = _region_mask(patch, grid, slab)
            return m * bval(slab, patch.inside, lo, other, phis) \
                + (1.0 - m) * bval(slab, patch.outside, lo, other, phis)
        return _boundary_face_value(slab, patch, lo, other, phis, t)

    def bgrad(slab, patch, lo, d, other, phis):
        if isinstance(patch, _bc.RegionPatchBC):
            m = _region_mask(patch, grid, slab)
            return m * bgrad(slab, patch.inside, lo, d, other, phis) \
                + (1.0 - m) * bgrad(slab, patch.outside, lo, d, other, phis)
        return _boundary_sngrad(slab, patch, lo, d, other, phis, t,
                                d_cyc=d_cyc)

    if mode == "interp":
        inner = w_lin * cm[:-1] + (1.0 - w_lin) * cm[1:]
        lo = bval(cm[:1], lo_patch, True, cm[-1:],
                  None if phi_ax is None else phi_ax[:1])
        hi = bval(cm[-1:], hi_patch, False, cm[:1],
                  None if phi_ax is None else phi_ax[-1:])
    else:
        inner = (cm[1:] - cm[:-1]) * inv_d
        lo = bgrad(cm[:1], lo_patch, True, d_lo, cm[-1:],
                   None if phi_ax is None else phi_ax[:1])
        hi = bgrad(cm[-1:], hi_patch, False, d_hi, cm[:1],
                   None if phi_ax is None else phi_ax[-1:])
    return _mvback(torch.cat([lo, inner, hi], dim=0), axis)


def face_interp(c, grid: Grid, fbc: _bc.FieldBC,
                phi: Optional[FaceField] = None, t=0.0) -> FaceField:
    """Linear (central) interpolation of a scalar cell field to faces."""
    return FaceField(*(_axis_faces(c, a, grid, fbc, phi, "interp", t)
                       for a in range(3)))


def sn_grad(c, grid: Grid, fbc: _bc.FieldBC,
            phi: Optional[FaceField] = None, t=0.0) -> FaceField:
    """Face-normal gradient (along +axis) of a scalar cell field."""
    return FaceField(*(_axis_faces(c, a, grid, fbc, phi, "sngrad", t)
                       for a in range(3)))


def _face_diff(fa, axis):
    """owner-neighbor difference of a face array along its axis -> cells."""
    fm = _mv(fa, axis)
    return _mvback(fm[1:] - fm[:-1], axis)


def div_flux(phi: FaceField, grid: Grid):
    """fvc::div(phi) for a face flux phi [m^3/s] -> cells [1/s]."""
    out = sum(_face_diff(phi[a], a) for a in range(3))
    return out / _const(grid.cell_volume, out)


def grad(c, grid: Grid, fbc: _bc.FieldBC, phi: Optional[FaceField] = None,
         t=0.0):
    """Gauss-linear cell gradient of a scalar -> (3, nx, ny, nz)."""
    fv = face_interp(c, grid, fbc, phi, t)
    area = grid.face_area
    comps = [_face_diff(fv[a], a) * _const(area[a] / grid.cell_volume, c)
             for a in range(3)]
    return torch.stack(comps)


def grad_vec(v, grid: Grid, vbc: _bc.FieldBC, phi: Optional[FaceField] = None,
             t=0.0):
    """Gradient of a vector field -> (3 comp, 3 deriv, nx, ny, nz).

    out[j, i] = d v_j / d x_i.
    """
    return torch.stack([grad(v[j], grid, vbc.component(j), phi, t)
                        for j in range(3)])


def curl(v, grid: Grid, vbc: _bc.FieldBC, t=0.0):
    """fvc::curl(U) -> (3, nx, ny, nz)."""
    g = grad_vec(v, grid, vbc, t=t)  # g[j, i] = d v_j / d x_i
    return torch.stack([
        g[2, 1] - g[1, 2],
        g[0, 2] - g[2, 0],
        g[1, 0] - g[0, 1],
    ])


def flux_of(v, grid: Grid, vbc: _bc.FieldBC,
            phi: Optional[FaceField] = None, t=0.0) -> FaceField:
    """(interp(U) & Sf): volumetric flux of a vector field -> FaceField."""
    area = grid.face_area
    return FaceField(*(
        _axis_faces(v[a], a, grid, vbc.component(a), phi, "interp", t)
        * _const(area[a], v)
        for a in range(3)
    ))


def average_to_cells(fv: FaceField, grid: Grid,
                     fbc: Optional[_bc.FieldBC] = None):
    """fvc::average analogue: mean of a cell's face values.

    Empty patches contribute no faces, so both the sum and the count
    skip them.
    """
    total = torch.zeros(grid.shape, dtype=fv.x.dtype, device=fv.x.device)
    count = torch.zeros_like(total)
    for a in range(3):
        fm = _mv(fv[a], a)
        ones = torch.ones_like(fm)
        if fbc is not None:
            lo_p, hi_p = fbc.axis(a)
            if lo_p.kind == _bc.EMPTY or hi_p.kind == _bc.EMPTY:
                fm, ones = fm.clone(), ones.clone()
            if lo_p.kind == _bc.EMPTY:
                fm[:1] = 0.0
                ones[:1] = 0.0
            if hi_p.kind == _bc.EMPTY:
                fm[-1:] = 0.0
                ones[-1:] = 0.0
        total = total + _mvback(0.5 * (fm[1:] + fm[:-1]), a)
        count = count + _mvback(0.5 * (ones[1:] + ones[:-1]), a)
    return total / torch.clamp(count, min=0.5)


# ---------------------------------------------------------------------------
# TVD limited convection weights (limitedLinear / limitedLinearV)
# ---------------------------------------------------------------------------


def _limited_weights_axis_vec(v, gradv, axis, grid, phi, k):
    """limitedLinearV owner weights on the internal faces of `axis`;
    boundary faces get weight 1 (unused)."""
    d = grid.spacing[axis]
    vm = torch.stack([_mv(v[j], axis) for j in range(3)])          # (3, n, ...)
    gm = torch.stack([_mv(gradv[j, axis], axis) for j in range(3)])
    phim = _mv(phi[axis], axis)[1:-1]

    dV = vm[:, 1:] - vm[:, :-1]                    # phiN - phiP (3, n-1, ...)
    gradf = torch.sum(dV * dV, dim=0)              # magSqr
    dgc = d * torch.where(phim > 0, gm[:, :-1], gm[:, 1:])
    gradcf = torch.sum(dV * dgc, dim=0)

    big = torch.abs(gradcf) >= 1000.0 * torch.abs(gradf)
    r = torch.where(
        big,
        2.0 * 1000.0 * _sign(gradcf) * _sign(gradf) - 1.0,
        2.0 * (gradcf / torch.where(gradf == 0.0, torch.ones_like(gradf),
                                    gradf)) - 1.0,
    )
    limiter = torch.clamp((2.0 / k) * r, 0.0, 1.0)
    w_up = (phim >= 0).to(gradf.dtype)
    w = limiter * 0.5 + (1.0 - limiter) * w_up
    pad = torch.ones_like(vm[0, :1])
    return _mvback(torch.cat([pad, w, pad], dim=0), axis)


def limited_weights_vec(v, grid: Grid, vbc: _bc.FieldBC, phi: FaceField,
                        k: float = 1.0, t=0.0) -> FaceField:
    """limitedLinearV-k owner weights for fvm::div(phi, U) (vector field)."""
    gradv = grad_vec(v, grid, vbc, phi, t)
    return FaceField(*(_limited_weights_axis_vec(v, gradv, a, grid, phi, k)
                       for a in range(3)))
