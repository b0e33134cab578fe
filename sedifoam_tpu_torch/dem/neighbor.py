"""Binned Verlet neighbor lists + fixed-slot contact forces (port of
``sedifoam_tpu/dem/neighbor.py``).

Everything is fixed-shape, as in the reference:

- particles are binned on a cell grid of pitch >= cutoff and sorted by
  bin id (a stable sort, so ties keep particle order);
- each particle gathers candidates from its 27 neighbor bins (static
  27*max_per_bin slots), distance-filters, and keeps the K nearest;
- shear history lives per (slot, particle); on rebuild it is carried over
  by matching partner indices (LAMMPS per-contact shear semantics).

All (slots, particles) arrays keep N minor: idx is (K, N) int32 with
idx == N marking an empty slot, shear is (3, K, N). Torch indexing takes
int64, so indices are widened where they index.

The reference's TPU workarounds (searchsorted by sort, the n <= 32768
split between a packed and a per-component candidate gather) are one
code path here: plain torch.searchsorted and one packed (27M, N, 3)
gather (about 0.43 GB in f32 at 131k particles).
"""

from __future__ import annotations

from typing import Tuple

import torch

from sedifoam_tpu_torch.config import PairParams
from sedifoam_tpu_torch.dem.forcelaws import contact_force, vcross
from sedifoam_tpu_torch.dem.pair import min_image
from sedifoam_tpu_torch.dem.state import ParticleState


def make_binner(lo: Tuple[float, float, float], hi: Tuple[float, float, float],
                cutoff: float, k_neighbors: int, max_per_bin: int,
                periodic: Tuple[bool, bool, bool] = (False, False, False),
                audit_ring: float = 0.0):
    """Build a neighbor-rebuild function with static bin geometry.

    rebuild(pos (N,3), active (N,)) -> (idx (K, N) int32, dropped int32),
    where idx == N marks an empty slot. Periodic axes wrap their bin
    neighborhoods and candidate distances use the minimum image.

    audit_ring > 0 arms the K-truncation safety audit: `dropped` counts
    in-ring candidates (distance < audit_ring) the K-nearest selection
    had to discard. With audit_ring == 0 `dropped` is always 0.
    """
    nbx = max(int((hi[0] - lo[0]) / cutoff), 1)
    nby = max(int((hi[1] - lo[1]) / cutoff), 1)
    nbz = max(int((hi[2] - lo[2]) / cutoff), 1)
    n_bins = nbx * nby * nbz
    if n_bins + 1 >= 2 ** 31:
        raise ValueError(
            f"bin grid {nbx}x{nby}x{nbz} overflows int32 ids; "
            "increase the cutoff or shrink the domain")
    K = k_neighbors
    M = max_per_bin
    nb = (nbx, nby, nbz)
    plen = tuple((hi[a] - lo[a]) if periodic[a] else None for a in range(3))

    def axis_offsets(a: int):
        # on a periodic axis with <3 bins, +1 and -1 wrap to the same bin:
        # deduplicate statically so a candidate never appears twice
        if not periodic[a] or nb[a] >= 3:
            return (-1, 0, 1)
        return (-1, 0) if nb[a] == 2 else (0,)

    offsets = [(i, j, k) for i in axis_offsets(0) for j in axis_offsets(1)
               for k in axis_offsets(2)]

    def rebuild(pos, active):
        n = pos.shape[0]
        dev = pos.device
        i64 = dict(dtype=torch.int64, device=dev)
        lo_a = torch.tensor(lo, dtype=pos.dtype, device=dev)
        size = torch.tensor([(hi[0] - lo[0]) / nbx, (hi[1] - lo[1]) / nby,
                             (hi[2] - lo[2]) / nbz], dtype=pos.dtype,
                            device=dev)
        ijk = torch.floor((pos - lo_a) / size).to(torch.int64)
        ijk = torch.minimum(ijk.clamp(min=0),
                            torch.tensor([nbx - 1, nby - 1, nbz - 1], **i64))
        bin_id = (ijk[:, 0] * nby + ijk[:, 1]) * nbz + ijk[:, 2]
        bin_id = torch.where(active, bin_id,
                             torch.full_like(bin_id, n_bins))  # park inactive

        order = torch.argsort(bin_id, stable=True)    # (N,) particle ids
        sorted_bins = bin_id[order]

        # candidate SLOTS (positions in the sorted order): for each of 27
        # offsets, M entries from that bin; layout (27M, N) keeps N minor.
        # Bin extents come from searchsorted at the queried ids, never
        # from an O(n_bins) starts table (dilute boxes have huge bin grids)
        ok_list, nbid_list = [], []
        for (di, dj, dk) in offsets:
            nijk = ijk + torch.tensor([di, dj, dk], **i64)
            ok = torch.ones(n, dtype=torch.bool, device=dev)
            cols = []
            for a in range(3):
                col = nijk[:, a]
                if periodic[a]:
                    col = torch.remainder(col, nb[a])
                else:
                    ok &= (col >= 0) & (col < nb[a])
                cols.append(col)
            nb_id = (cols[0] * nby + cols[1]) * nbz + cols[2]
            ok_list.append(ok)
            nbid_list.append(nb_id.clamp(0, n_bins - 1))
        nb_ids = torch.stack(nbid_list)                 # (27, N)
        s27 = torch.searchsorted(sorted_bins, nb_ids)
        e27 = torch.searchsorted(sorted_bins, nb_ids + 1)
        arangeM = torch.arange(M, **i64)[None, :, None]  # (1, M, 1)
        slot = s27[:, None, :] + arangeM                # (27, M, N)
        valid = torch.stack(ok_list)[:, None, :] & (slot < e27[:, None, :])
        slots = slot.clamp(0, n - 1).reshape(-1, n)     # (27M, N)
        valid = valid.reshape(-1, n)

        # particle -> its position in the sorted order (inverse permutation)
        me_slot = torch.empty_like(order)
        me_slot[order] = torch.arange(n, **i64)
        valid &= slots != me_slot[None, :]
        valid &= active[None, :]
        # ONE packed (27M, N, 3) partner row gather
        pos_sorted = pos[order]                          # (N, 3)
        diff = pos[None, :, :] - pos_sorted[slots]       # (27M, N, 3)
        dcs = []
        for c in range(3):
            dc = diff[..., c]
            if plen[c] is not None:
                dc = dc - plen[c] * torch.round(dc / plen[c])
            dcs.append(dc)
        d2 = dcs[0] * dcs[0] + dcs[1] * dcs[1] + dcs[2] * dcs[2]
        d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))

        # K nearest: stable ascending argsort on the candidate axis, as
        # jnp.argsort is stable (ties keep the lower candidate slot)
        sel = torch.argsort(d2, dim=0, stable=True)[:K]      # (K, N)
        d2k = torch.gather(d2, 0, sel)
        slot_sel = torch.gather(slots, 0, sel)               # (K, N)
        keep = torch.isfinite(d2k)
        idx = order[slot_sel]                                # (K, N)
        if audit_ring > 0.0:
            inring = torch.sum(d2 < audit_ring * audit_ring, dim=0)  # (N,)
            dropped = torch.sum(torch.clamp(inring - K, min=0))
        else:
            dropped = torch.zeros((), **i64)
        return (torch.where(keep, idx, torch.full_like(idx, n)
                            ).to(torch.int32),
                dropped.to(torch.int32))

    return rebuild


def carry_over_shear(old_idx, new_idx, old_shear):
    """Transfer per-contact shear across a rebuild by partner matching.

    old_idx (Ko, N), new_idx (Kn, N), old_shear (3, Ko, N) -> (3, Kn, N).
    Needs full-precision matmuls on the card (TF32 off): TF32 would round
    the carried history to about three digits at every rebuild.
    """
    n = old_idx.shape[1]
    match = (new_idx[:, None, :] == old_idx[None, :, :]) & \
            (new_idx[:, None, :] < n)                 # (Kn, Ko, N)
    m = match.to(old_shear.dtype)
    return torch.einsum("kon,con->ckn", m, old_shear).contiguous()


def scrub_dead_partners(idx, active):
    """Rewrite table slots that point at deactivated particles to the
    empty sentinel (== n_capacity). Idempotent: a table whose partners
    are all active comes back unchanged."""
    n = active.shape[0]
    j = idx.clamp(0, n - 1).long()
    keep = active[j] | (idx >= n)          # sentinel stays sentinel
    return torch.where(keep, idx, torch.full_like(idx, n))


def gather_partners(state: ParticleState, idx, periodic_len=None):
    """Partner-field gather for the (K, N) neighbor table.

    Returns (has (K,N) bool, pg (K,N,11) packed partner fields, delta
    3-tuple of x_i - x_j with minimum image, rsq). Packed layout:
    [x,y,z, vx,vy,vz, wx,wy,wz, rad, m]. Partner activity is not
    gathered: delete events scrub the table (scrub_dead_partners).
    """
    n = state.n_capacity
    x, v, w = state.pos, state.vel, state.omega
    rad, m = state.radius, state.mass

    j = idx.clamp(0, n - 1).long()                # (K, N)
    packed = torch.cat([x, v, w, rad[:, None], m[:, None]], dim=1)  # (N, 11)
    pg = packed[j]                                # (K, N, 11)
    has = idx < n

    delta = min_image(tuple(x[:, c][None, :] - pg[..., c] for c in range(3)),
                      periodic_len)
    rsq = delta[0] ** 2 + delta[1] ** 2 + delta[2] ** 2
    return has, pg, delta, rsq


def pair_forces_binned(state: ParticleState, params: PairParams, dt: float,
                       idx, shearupdate: bool = True, periodic_len=None):
    """Contact forces via the (K, N) neighbor table.

    Returns (force (N,3), torque (N,3), new_shear (3, K, N)).
    """
    v, w = state.vel, state.omega
    rad, m = state.radius, state.mass

    has, pg, delta, rsq = gather_partners(state, idx, periodic_len)
    radj = pg[..., 9]
    radsum = rad[None, :] + radj
    touch = has & state.active[None, :] & (rsq < radsum * radsum)

    rsq_safe = torch.where(touch, rsq, torch.ones_like(rsq))
    r = torch.sqrt(rsq_safe)
    rinv = 1.0 / r
    rsqinv = 1.0 / rsq_safe

    vr = tuple(v[:, c][None, :] - pg[..., 3 + c] for c in range(3))
    vnnr = sum(vr[c] * delta[c] for c in range(3))
    vn = tuple(delta[c] * vnnr * rsqinv for c in range(3))
    vt = tuple(vr[c] - vn[c] for c in range(3))
    wr = tuple((rad[None, :] * w[:, c][None, :] + radj * pg[..., 6 + c])
               * rinv for c in range(3))
    vtr = (vt[0] - (delta[2] * wr[1] - delta[1] * wr[2]),
           vt[1] - (delta[0] * wr[2] - delta[2] * wr[0]),
           vt[2] - (delta[1] * wr[0] - delta[0] * wr[1]))

    mj = pg[..., 10]
    # 1e-300 rounds to 0 in f32, as in the reference
    meff = m[None, :] * mj / torch.clamp(m[None, :] + mj, min=1e-300)
    overlap = radsum - r
    poly_arg = overlap * rad[None, :] * radj / torch.clamp(radsum, min=1e-300)

    shear = (state.shear[0], state.shear[1], state.shear[2])
    force_pair, fs_vec, new_shear = contact_force(
        params, dt, touch, overlap, r, rinv, rsqinv, delta,
        vnnr, vtr, shear, meff, poly_arg, shearupdate)

    force = torch.stack([torch.sum(force_pair[c], dim=0) for c in range(3)],
                        dim=-1)
    tor = vcross(delta, fs_vec)
    torque = torch.stack(
        [-rad * torch.sum(tor[c] * rinv, dim=0) for c in range(3)], dim=-1)

    return force, torque, torch.stack(new_shear)
