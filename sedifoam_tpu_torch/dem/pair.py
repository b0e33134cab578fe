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

from sedifoam_tpu_torch.config import PAIR_NONE, PairParams
from sedifoam_tpu_torch.dem.forcelaws import contact_force, vcross


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


def pair_kinematics(state, periodic_len=None):
    """Contact geometry and relative surface motion of every ordered pair
    on the (N, N) tile: (touch, overlap, r, rinv, rsqinv, delta, vnnr,
    vtr, meff, poly_arg), the arguments of forcelaws.contact_force.
    Same-body pairs of rigid clumps are no contacts (dem/rigid.py)."""
    n = state.n_capacity
    x, v, w = state.pos, state.vel, state.omega
    rad, m = state.radius, state.mass

    delta = min_image(tuple(x[:, None, c] - x[None, :, c] for c in range(3)),
                      periodic_len)
    rsq = delta[0] ** 2 + delta[1] ** 2 + delta[2] ** 2
    radsum = rad[:, None] + rad[None, :]

    valid = state.active[:, None] & state.active[None, :]
    valid &= ~torch.eye(n, dtype=torch.bool, device=x.device)
    if state.rigid is not None:
        # exclude intra-body pairs: their granular forces are central
        # and cancel in the body sums
        valid &= ~((state.mol[:, None] == state.mol[None, :])
                   & (state.mol[:, None] > 0))
    touch = valid & (rsq < radsum * radsum)

    rsq_safe = torch.where(touch, rsq, torch.ones_like(rsq))
    r = torch.sqrt(rsq_safe)
    rinv = 1.0 / r
    rsqinv = 1.0 / rsq_safe

    vr = tuple(v[:, None, c] - v[None, :, c] for c in range(3))
    vnnr = sum(vr[c] * delta[c] for c in range(3))
    vn = tuple(delta[c] * vnnr * rsqinv for c in range(3))
    vt = tuple(vr[c] - vn[c] for c in range(3))
    # relative rotational surface velocity
    wr = tuple((rad[:, None] * w[:, None, c] + rad[None, :] * w[None, :, c])
               * rinv for c in range(3))
    vtr = (vt[0] - (delta[2] * wr[1] - delta[1] * wr[2]),
           vt[1] - (delta[0] * wr[2] - delta[2] * wr[0]),
           vt[2] - (delta[1] * wr[0] - delta[0] * wr[1]))

    # 1e-300 rounds to 0 in f32, as in the reference
    meff = m[:, None] * m[None, :] / torch.clamp(m[:, None] + m[None, :],
                                                 min=1e-300)
    overlap = radsum - r
    poly_arg = overlap * rad[:, None] * rad[None, :] / \
        torch.clamp(radsum, min=1e-300)
    return touch, overlap, r, rinv, rsqinv, delta, vnnr, vtr, meff, poly_arg


def pair_forces(state, params: PairParams, dt: float,
                shearupdate: bool = True, periodic_len=None):
    """Contact forces/torques for all active pairs.

    Returns (force (N,3), torque (N,3), new_shear (3,N,N)).
    """
    if params.style == PAIR_NONE:
        z = torch.zeros_like(state.vel)
        return z, z, state.shear

    rad = state.radius
    touch, overlap, r, rinv, rsqinv, delta, vnnr, vtr, meff, poly_arg = \
        pair_kinematics(state, periodic_len)

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
