"""Dense all-pairs granular contacts and the minimum-image helper (port of
``sedifoam_tpu/dem/pair.py``).

Each ordered pair (i, j) is evaluated on the (N, N) tile with its own
shear-history row: shear is (3, N, N) and antisymmetric by construction
(shear[:, i, j] accumulates vtr_ij * dt). O(N^2) compute and memory: the
backend of the small validation cases (xiaocase3 has one particle); the
binned table (dem/neighbor.py) takes larger counts.
"""

from __future__ import annotations

import torch

from pbref.config import PAIR_NONE, PairParams
from pbref.dem.forcelaws import contact_force, vcross


def min_image(delta, periodic_len):
    """Minimum-image convention per axis (LAMMPS domain->minimum_image;
    the particle side of the reference's cyclic transforms,
    lammpsFoam/softParticle.C:186-198). periodic_len: static 3-tuple of
    domain length (periodic axis) or None. torch.round rounds half to
    even, as jnp.round does."""
    if periodic_len is None or all(L is None for L in periodic_len):
        return delta
    return tuple(
        d - L * torch.round(d / L) if L is not None else d
        for d, L in zip(delta, periodic_len))


def own(t, rows):
    """Rows rows=(row0, n_rows) of a row array t (all of it when None):
    one rank's own block of a state split over ranks (parallel/)."""
    return t if rows is None else t[rows[0]:rows[0] + rows[1]]


def pair_kinematics(state, periodic_len=None, rows=None):
    """Contact geometry and relative surface motion of every ordered pair
    on the (N, N) tile: (touch, overlap, r, rinv, rsqinv, delta, vnnr,
    vtr, meff, poly_arg), the arguments of forcelaws.contact_force.
    Same-body pairs of rigid clumps are no contacts (dem/rigid.py).
    rows=(row0, n_rows): the (n_rows, N) tile of those rows against
    all N."""
    n = state.n_capacity
    x, v, w = state.pos, state.vel, state.omega
    rad, m = state.radius, state.mass
    xi, vi, wi = own(x, rows), own(v, rows), own(w, rows)
    radi, mi = own(rad, rows), own(m, rows)

    delta = min_image(tuple(xi[:, None, c] - x[None, :, c] for c in range(3)),
                      periodic_len)
    rsq = delta[0] ** 2 + delta[1] ** 2 + delta[2] ** 2
    radsum = radi[:, None] + rad[None, :]

    valid = own(state.active, rows)[:, None] & state.active[None, :]
    ii = torch.arange(n, device=x.device)
    valid &= own(ii, rows)[:, None] != ii[None, :]
    if state.rigid is not None:
        # exclude intra-body pairs: their granular forces are central
        # and cancel in the body sums
        moli = own(state.mol, rows)
        valid &= ~((moli[:, None] == state.mol[None, :])
                   & (moli[:, None] > 0))
    touch = valid & (rsq < radsum * radsum)

    rsq_safe = torch.where(touch, rsq, torch.ones_like(rsq))
    r = torch.sqrt(rsq_safe)
    rinv = 1.0 / r
    rsqinv = 1.0 / rsq_safe

    vr = tuple(vi[:, None, c] - v[None, :, c] for c in range(3))
    vnnr = sum(vr[c] * delta[c] for c in range(3))
    vn = tuple(delta[c] * vnnr * rsqinv for c in range(3))
    vt = tuple(vr[c] - vn[c] for c in range(3))
    # relative rotational surface velocity
    wr = tuple((radi[:, None] * wi[:, None, c] + rad[None, :] * w[None, :, c])
               * rinv for c in range(3))
    vtr = (vt[0] - (delta[2] * wr[1] - delta[1] * wr[2]),
           vt[1] - (delta[0] * wr[2] - delta[2] * wr[0]),
           vt[2] - (delta[1] * wr[0] - delta[0] * wr[1]))

    # 1e-300 rounds to 0 in f32, as in the reference
    meff = mi[:, None] * m[None, :] / torch.clamp(mi[:, None] + m[None, :],
                                                  min=1e-300)
    overlap = radsum - r
    poly_arg = overlap * radi[:, None] * rad[None, :] / \
        torch.clamp(radsum, min=1e-300)
    return touch, overlap, r, rinv, rsqinv, delta, vnnr, vtr, meff, poly_arg


def pair_forces(state, params: PairParams, dt: float,
                shearupdate: bool = True, periodic_len=None, rows=None):
    """Contact forces/torques for all active pairs.

    Returns (force (N,3), torque (N,3), new_shear (3,N,N)); with
    rows=(row0, n_rows) those rows' alone against all N (state.shear is
    then the rows' own (3, n_rows, N)).
    """
    if params.style == PAIR_NONE:
        z = torch.zeros_like(own(state.vel, rows))
        return z, z, state.shear

    rad = own(state.radius, rows)
    touch, overlap, r, rinv, rsqinv, delta, vnnr, vtr, meff, poly_arg = \
        pair_kinematics(state, periodic_len, rows)

    shear = (state.shear[0], state.shear[1], state.shear[2])
    force_pair, fs_vec, new_shear = contact_force(
        params, dt, touch, overlap, r, rinv, rsqinv, delta,
        vnnr, vtr, shear, meff, poly_arg, shearupdate)

    force = torch.stack([torch.sum(force_pair[c], dim=1) for c in range(3)],
                        dim=-1)
    # torque_i -= rad_i * cross(delta, fs)/r  (summed over j)
    tor = vcross(delta, fs_vec)
    torque = torch.stack(
        [-rad * torch.sum(tor[c] * rinv, dim=1) for c in range(3)], dim=-1)

    return force, torque, torch.stack(new_shear)
