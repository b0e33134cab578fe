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

from pbref import device_vector
from pbref.config import PairParams
from pbref.dem.forcelaws import contact_force, vcross
from pbref.dem.pair import min_image, own
from pbref.dem.state import ParticleState


def bin_counts(lo, hi, cutoff) -> Tuple[int, int, int]:
    """Bins per axis of a bin grid of pitch >= cutoff over the box."""
    return tuple(max(int((hi[a] - lo[a]) / cutoff), 1) for a in range(3))


def bin_ids(pos, active, lo, hi, nb):
    """(ijk (N, 3) int64, bin_id (N,) int64) of the particles on the
    nb = (nbx, nby, nbz) bin grid over the box, positions outside clamped
    into it; inactive rows get the id n_bins, so that a sort parks them
    last."""
    dev = pos.device
    nbx, nby, nbz = nb
    lo_a = device_vector(tuple(lo), pos.dtype, dev)
    size = device_vector(((hi[0] - lo[0]) / nbx, (hi[1] - lo[1]) / nby,
                          (hi[2] - lo[2]) / nbz), pos.dtype, dev)
    ijk = torch.floor((pos - lo_a) / size).to(torch.int64)
    ijk = torch.minimum(ijk.clamp(min=0), device_vector(
        (nbx - 1, nby - 1, nbz - 1), torch.int64, dev))
    bin_id = (ijk[:, 0] * nby + ijk[:, 1]) * nbz + ijk[:, 2]
    bin_id = torch.where(active, bin_id,
                         torch.full_like(bin_id, nbx * nby * nbz))
    return ijk, bin_id


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
    nb = nbx, nby, nbz = bin_counts(lo, hi, cutoff)
    n_bins = nbx * nby * nbz
    if n_bins + 1 >= 2 ** 31:
        raise ValueError(
            f"bin grid {nbx}x{nby}x{nbz} overflows int32 ids; "
            "increase the cutoff or shrink the domain")
    K = k_neighbors
    M = max_per_bin
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
        ijk, bin_id = bin_ids(pos, active, lo, hi, nb)

        order = torch.argsort(bin_id, stable=True)    # (N,) particle ids
        sorted_bins = bin_id[order]

        # candidate SLOTS (positions in the sorted order): for each of 27
        # offsets, M entries from that bin; layout (27M, N) keeps N minor.
        # Bin extents come from searchsorted at the queried ids, never
        # from an O(n_bins) starts table (dilute boxes have huge bin grids)
        ok_list, nbid_list = [], []
        for (di, dj, dk) in offsets:
            nijk = ijk + device_vector((di, dj, dk), torch.int64, dev)
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


def make_sort_order(lo, hi, cutoff, periodic=(False, False, False)):
    """Makes the bin-sort permutation: order (N,) with new_row -> particle.

    Sorting the SoA by bin at every rebuild makes partner indices in the
    (K, N) table point into a small local window, so the per-substep
    partner row gather lands near its predecessor in memory. Inactive
    particles park at the end (what the active window relies on). The
    sort is stable, as the reference's: particles of one bin keep their
    order.
    """
    nb = bin_counts(lo, hi, cutoff)

    def sort_order(pos, active):
        return torch.argsort(bin_ids(pos, active, lo, hi, nb)[1],
                             stable=True)

    return sort_order


def permute_particle_state(st: ParticleState, order) -> ParticleState:
    """Reorder the fixed-capacity SoA so row r holds particle order[r].

    (N, ...) fields take a row gather; the (3, K, N)/(3, W, N) history
    tensors and the (K, N) neighbor table permute their N axis (the
    results are contiguous, as the contact-chain kernel needs);
    neighbor-table VALUES are relabeled to the new rows (sentinel N maps
    to N). The dense backend's (3, N, N) history permutes both N axes.
    Rigid clumps: mol and displace move with their rows; the body SoA
    (st.rigid) is indexed by body id and stays put.
    """
    n = st.n_capacity
    order = order.long()
    rank = torch.empty_like(order)               # old row -> new row
    rank[order] = torch.arange(n, dtype=order.dtype, device=order.device)
    rank_ext = torch.cat([rank, rank.new_full((1,), n)]).to(torch.int32)

    def p_rows(x):                               # (N, ...) or (N,)
        return x[order]

    def p_minor(x):                              # (..., N) -> permute last
        return torch.index_select(x, -1, order)

    if st.nbr_idx.shape[0]:
        # binned (3, K, N): the K (slot) axis stays fixed; only N moves
        # (branch on the table, not on shapes: K may equal the capacity)
        nbr_idx = rank_ext[p_minor(st.nbr_idx).long()]
        shear = p_minor(st.shear)
    else:
        nbr_idx = st.nbr_idx
        shear = st.shear[:, order][:, :, order]  # dense (3, N, N)

    return st._replace(
        pos=p_rows(st.pos), vel=p_rows(st.vel), omega=p_rows(st.omega),
        radius=p_rows(st.radius), mass=p_rows(st.mass),
        density=p_rows(st.density), ptype=p_rows(st.ptype),
        tag=p_rows(st.tag), active=p_rows(st.active),
        force=p_rows(st.force), torque=p_rows(st.torque),
        shear=shear, wall_shear=p_minor(st.wall_shear),
        nbr_idx=nbr_idx, pos_at_build=p_rows(st.pos_at_build),
        fdrag=p_rows(st.fdrag), dudt=p_rows(st.dudt),
        v_old=p_rows(st.v_old), n0=p_rows(st.n0),
        sum_delta_fb=p_rows(st.sum_delta_fb),
        vel_fluid_old=p_rows(st.vel_fluid_old),
        mol=p_rows(st.mol), displace=p_rows(st.displace),
    )


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


def gather_partners(state: ParticleState, idx, periodic_len=None,
                    rows=None):
    """Partner-field gather for the (K, N) neighbor table.

    Returns (has (K,N) bool, pg (K,N,11) packed partner fields, delta
    3-tuple of x_i - x_j with minimum image, rsq). Packed layout:
    [x,y,z, vx,vy,vz, wx,wy,wz, rad, m]. Partner activity is not
    gathered: delete events scrub the table (scrub_dead_partners).
    rows=(row0, n_rows): the table's columns are those rows of the
    state's N (idx (K, n_rows), its values rows of all N).
    """
    n = state.n_capacity
    x, v, w = state.pos, state.vel, state.omega
    rad, m = state.radius, state.mass

    j = idx.clamp(0, n - 1).long()                # (K, N)
    packed = torch.cat([x, v, w, rad[:, None], m[:, None]], dim=1)  # (N, 11)
    pg = packed[j]                                # (K, N, 11)
    has = idx < n

    xi = own(x, rows)
    delta = min_image(tuple(xi[:, c][None, :] - pg[..., c] for c in range(3)),
                      periodic_len)
    rsq = delta[0] ** 2 + delta[1] ** 2 + delta[2] ** 2
    return has, pg, delta, rsq


def slot_kinematics(state: ParticleState, idx, periodic_len=None,
                    rows=None):
    """Contact geometry and relative surface motion of every slot of the
    (K, N) table: (has, touch, overlap, r, rinv, rsqinv, delta, vnnr,
    vtr, meff, poly_arg); from `touch` on, the arguments of
    forcelaws.contact_force. rows: as gather_partners."""
    v, w = own(state.vel, rows), own(state.omega, rows)
    rad, m = own(state.radius, rows), own(state.mass, rows)

    has, pg, delta, rsq = gather_partners(state, idx, periodic_len, rows)
    radj = pg[..., 9]
    radsum = rad[None, :] + radj
    touch = has & own(state.active, rows)[None, :] & (rsq < radsum * radsum)

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
    return (has, touch, overlap, r, rinv, rsqinv, delta, vnnr, vtr, meff,
            poly_arg)


def pair_forces_binned(state: ParticleState, params: PairParams, dt: float,
                       idx, shearupdate: bool = True, periodic_len=None,
                       rows=None):
    """Contact forces via the (K, N) neighbor table.

    Returns (force (N,3), torque (N,3), new_shear (3, K, N)); with
    rows=(row0, n_rows) those rows' alone, against partners in all N
    (idx and state.shear are the rows' own: (K, n_rows), (3, K, n_rows)).
    """
    rad = own(state.radius, rows)
    _, touch, overlap, r, rinv, rsqinv, delta, vnnr, vtr, meff, poly_arg = \
        slot_kinematics(state, idx, periodic_len, rows)

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
