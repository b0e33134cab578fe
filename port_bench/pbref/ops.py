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

On a slab of a fluid split along grid-x (grid.SlabGrid) a side of axis 0
that is a seam with another rank's slab is a processor patch: the cell
array is padded there with the neighbour's ghost plane (`_seam_pad`), the
seam's face is computed as an internal face, and the boundary-patch
branch runs on the domain's own sides only. The arithmetic of every
cell and face is the whole grid's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from pbref import bc as _bc
from pbref.grid import FaceField, Grid, SlabGrid

# OpenFOAM's SMALL/ROOTVSMALL analogues.
SMALL = 1e-15
ROOTVSMALL = 1e-18


def inv_dist_internal(grid: Grid, axis: int, like):
    """(n-1, 1, 1) inverse center-to-center distances of the internal
    faces of a graded axis, on `like`'s dtype and device (Grid.const)."""
    return grid.const(
        ("inv_dist_internal", axis),
        lambda: grid.internal_inv_dists(axis)[:, None, None],
        like.dtype, like.device)


def _seam_pad(cm, grid: Grid, axis: int, dim: int = 0):
    """(cp, lo, hi, other_lo, other_hi) for a cell array cm whose `axis`
    lies along its dim `dim`: cp is cm with the ghost plane of each side
    that is a seam (lo, hi: 1 where padded, else 0); other_lo/hi are the
    planes across each end, the cyclic patch's other side (the domain's
    own last and first planes on a whole grid)."""
    if axis != 0 or not isinstance(grid, SlabGrid):
        n = cm.shape[dim]
        return cm, 0, 0, cm.narrow(dim, n - 1, 1), cm.narrow(dim, 0, 1)
    seam_lo, seam_hi = grid.seams(0)
    g_lo, g_hi = grid.halo(cm, dim)
    parts = ([g_lo] if seam_lo else []) + [cm] + ([g_hi] if seam_hi else [])
    cp = torch.cat(parts, dim=dim) if len(parts) > 1 else cm
    return cp, int(seam_lo), int(seam_hi), g_lo, g_hi


def _inner(n_faces: int, lo: int, hi: int):
    """The slice of an axis's n_faces faces that have a cell (or a ghost
    cell) on both sides: [1:-1] without seams."""
    return slice(1 - lo, n_faces - 1 + hi)


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
    deltas, d_lo, d_hi, d_cyc) for one axis; scalars on uniform axes. On
    a slab's axis 0 the internal faces include its seams' faces."""
    if grid.uniform:
        d = grid.spacing[axis]
        return 0.5, 1.0 / d, d, d, d
    wl = grid.const(("axis_weights", axis),
                    lambda: grid.internal_weights(axis)[:, None, None],
                    like.dtype, like.device)
    inv_d = inv_dist_internal(grid, axis, like)
    return (wl, inv_d) + grid.memo(("axis_ends", axis),
                                   lambda: grid.axis_ends(axis))


def _region_mask(patch, grid, like):
    return grid.const(("region_mask", patch.region),
                      lambda: np.asarray(patch.region.mask(grid)),
                      like.dtype, like.device)


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

    cp, s_lo, s_hi, o_lo, o_hi = _seam_pad(cm, grid, axis)
    phi_lo = None if phi_ax is None else phi_ax[:1]
    phi_hi = None if phi_ax is None else phi_ax[-1:]
    if mode == "interp":
        inner = w_lin * cp[:-1] + (1.0 - w_lin) * cp[1:]
        lo = None if s_lo else bval(cm[:1], lo_patch, True, o_lo, phi_lo)
        hi = None if s_hi else bval(cm[-1:], hi_patch, False, o_hi, phi_hi)
    else:
        inner = (cp[1:] - cp[:-1]) * inv_d
        lo = None if s_lo else bgrad(cm[:1], lo_patch, True, d_lo, o_lo,
                                     phi_lo)
        hi = None if s_hi else bgrad(cm[-1:], hi_patch, False, d_hi, o_hi,
                                     phi_hi)
    return _mvback(_join_faces(lo, inner, hi), axis)


def _join_faces(lo, inner, hi):
    """The faces of an axis: its boundary faces (None on a seam) around
    the internal ones."""
    return torch.cat([f for f in (lo, inner, hi) if f is not None], dim=0)


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
    return out / grid.cell_volume_like(out)


def div_flux_field(phi: FaceField, fv: FaceField, grid: Grid):
    """fvc::div(phi, psi) given precomputed face values of psi."""
    out = sum(_face_diff(phi[a] * fv[a], a) for a in range(3))
    return out / grid.cell_volume_like(out)


def grad(c, grid: Grid, fbc: _bc.FieldBC, phi: Optional[FaceField] = None,
         t=0.0):
    """Gauss-linear cell gradient of a scalar -> (3, nx, ny, nz)."""
    fv = face_interp(c, grid, fbc, phi, t)
    comps = [_face_diff(fv[a], a)
             * grid.geom(("area_over_volume", a),
                         lambda: grid.face_area[a] / grid.cell_volume,
                         c.dtype, c.device)
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


def laplacian(gamma_face, c, grid: Grid, fbc: _bc.FieldBC,
              phi: Optional[FaceField] = None, t=0.0):
    """Explicit fvc::laplacian(gamma, c); gamma_face is a FaceField or
    scalar."""
    g = sn_grad(c, grid, fbc, phi, t)
    if not isinstance(gamma_face, FaceField):
        gamma_face = FaceField(gamma_face, gamma_face, gamma_face)
    out = sum(_face_diff(gamma_face[a] * g[a], a) * grid.face_area_like(a, c)
              for a in range(3))
    return out / grid.cell_volume_like(c)


def flux_of(v, grid: Grid, vbc: _bc.FieldBC,
            phi: Optional[FaceField] = None, t=0.0) -> FaceField:
    """(interp(U) & Sf): volumetric flux of a vector field -> FaceField."""
    return FaceField(*(
        _axis_faces(v[a], a, grid, vbc.component(a), phi, "interp", t)
        * grid.face_area_like(a, v)
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
            seam_lo, seam_hi = grid.seams(a)
            lo_p, hi_p = fbc.axis(a)
            lo_empty = lo_p.kind == _bc.EMPTY and not seam_lo
            hi_empty = hi_p.kind == _bc.EMPTY and not seam_hi
            if lo_empty or hi_empty:
                fm, ones = fm.clone(), ones.clone()
            if lo_empty:
                fm[:1] = 0.0
                ones[:1] = 0.0
            if hi_empty:
                fm[-1:] = 0.0
                ones[-1:] = 0.0
        total = total + _mvback(0.5 * (fm[1:] + fm[:-1]), a)
        count = count + _mvback(0.5 * (ones[1:] + ones[:-1]), a)
    return total / torch.clamp(count, min=0.5)


# ---------------------------------------------------------------------------
# TVD limited convection weights (limitedLinear / limitedLinearV)
# ---------------------------------------------------------------------------


def _limited_weights_axis(c, gradc, axis, grid, fbc, phi, k):
    """limitedLinear owner weights on the internal faces of `axis` for a
    scalar cell field c with Gauss gradient gradc (3, ...); boundary
    faces get weight 1 (unused: boundary convection takes the BC
    coefficient path)."""
    cm, lo, hi, _, _ = _seam_pad(_mv(c, axis), grid, axis)
    # d c/d x_axis at cells
    gm = _seam_pad(_mv(gradc[axis], axis), grid, axis)[0]
    phim = _mv(phi[axis], axis)
    phim = phim[_inner(phim.shape[0], lo, hi)]  # internal faces
    w_lin, inv_d, _, _, _ = _axis_geom(grid, axis, cm)

    phiP, phiN = cm[:-1], cm[1:]  # owner (lower), neighbor (upper)
    gradf = phiN - phiP
    # d is owner->neighbor = +axis * center distance; upwind by flux sign
    gradcf = torch.where(phim > 0, gm[:-1], gm[1:]) / inv_d

    big = torch.abs(gradcf) >= 1000.0 * torch.abs(gradf)
    r = torch.where(
        big,
        2.0 * 1000.0 * _sign(gradcf) * _sign(gradf) - 1.0,
        2.0 * (gradcf / torch.where(gradf == 0.0, torch.ones_like(gradf),
                                    gradf)) - 1.0,
    )
    limiter = torch.clamp((2.0 / k) * r, 0.0, 1.0)
    w_up = (phim >= 0).to(cm.dtype)
    w = limiter * w_lin + (1.0 - limiter) * w_up
    pad = torch.ones_like(cm[:1])
    return _mvback(_join_faces(None if lo else pad, w, None if hi else pad),
                   axis)


def limited_weights(c, grid: Grid, fbc: _bc.FieldBC, phi: FaceField,
                    k: float = 1.0, t=0.0) -> FaceField:
    """limitedLinear-k owner weights for fvm::div(phi, c) (scalar field)."""
    gradc = grad(c, grid, fbc, phi, t)
    return FaceField(*(_limited_weights_axis(c, gradc, a, grid, fbc, phi, k)
                       for a in range(3)))


def _limited_weights_axis_vec(v, gradv, axis, grid, phi, k):
    """limitedLinearV owner weights on the internal faces of `axis`;
    boundary faces get weight 1 (unused)."""
    d = grid.spacing[axis]
    # (3, n, ...)
    vm, lo, hi, _, _ = _seam_pad(
        torch.stack([_mv(v[j], axis) for j in range(3)]), grid, axis, dim=1)
    gm = _seam_pad(torch.stack([_mv(gradv[j, axis], axis)
                                for j in range(3)]), grid, axis, dim=1)[0]
    phim = _mv(phi[axis], axis)
    phim = phim[_inner(phim.shape[0], lo, hi)]

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
    return _mvback(_join_faces(None if lo else pad, w, None if hi else pad),
                   axis)


def limited_weights_vec(v, grid: Grid, vbc: _bc.FieldBC, phi: FaceField,
                        k: float = 1.0, t=0.0) -> FaceField:
    """limitedLinearV-k owner weights for fvm::div(phi, U) (vector field)."""
    gradv = grad_vec(v, grid, vbc, phi, t)
    return FaceField(*(_limited_weights_axis_vec(v, gradv, a, grid, phi, k)
                       for a in range(3)))


def weighted_face_value(c, w: FaceField, grid: Grid, fbc: _bc.FieldBC,
                        phi: Optional[FaceField] = None, t=0.0) -> FaceField:
    """Face values using owner weights w on internal faces, BCs on boundary."""
    lin = face_interp(c, grid, fbc, phi, t)  # supplies boundary values

    def _axis(a):
        cm, lo, hi, _, _ = _seam_pad(_mv(c, a), grid, a)
        wm = _mv(w[a], a)
        wm = wm[_inner(wm.shape[0], lo, hi)]
        inner = wm * cm[:-1] + (1.0 - wm) * cm[1:]
        lm = _mv(lin[a], a)
        return _mvback(_join_faces(None if lo else lm[:1], inner,
                                   None if hi else lm[-1:]), a)

    return FaceField(*(_axis(a) for a in range(3)))
