"""Roll-based lattice contact backend: gather-free pair enumeration (port
of ``sedifoam_tpu/dem/lattice.py``).

Particles live on a ghost-padded bin lattice of fixed slots, and the
partner data of every pair comes from 13 static half-offset ROLLS of the
slot arrays (plus the in-bin pairs): no per-pair gather, only shifts.

Layout: every slot array is (M, S) with the flattened padded bin axis
minor. The bin grid is (nbx+2) x (nby+2) x (nbz+2) with one ghost layer:
periodic axes copy the opposite boundary layer into the ghosts (the
halo-exchange pattern), wall axes leave the ghosts empty, after which
all 26 neighbor offsets are plain flat shifts, valid for every real bin,
with no bounds masks.

Contact shear history is lattice-resident: (3, NOFF, M, M, S) keyed by
(half-offset o, slot mi, partner slot mj, bin), exact ordered-pair
semantics via Newton (the j side sees -shear). Between rebuilds the keys
are static, so history accumulates in place; on rebuild it is carried by
tag matching through a compact per-slot top-k table.

Pairs are enumerated once (half list): offset (0,0,0) takes mi < mj; the
13 lexicographically-positive offsets take full (M, M) blocks; the
reaction lands on the partner via a reverse roll.

Every function is plain PyTorch on tensors of fixed shape, with static
Python loops over the offsets, so that a captured step sees one shape at
every replay. The force law is forcelaws.contact_force, the one of the
dense and binned backends.

Reference hot loop: interfaceToLammps/pair_gran_hertzFix_history.cpp:
109-287.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch

from sedifoam_tpu_torch.config import DEMConfig
from sedifoam_tpu_torch.dem.forcelaws import contact_force
from sedifoam_tpu_torch.dem.state import ParticleState

# half neighborhood: (0,0,0) + the 13 offsets whose first nonzero is +
HALF_OFFSETS = [(0, 0, 0)] + [
    (dx, dy, dz)
    for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
    if (dx, dy, dz) > (0, 0, 0)
]
NOFF = len(HALF_OFFSETS)  # 14


def geom_offsets(geom: "LatticeGeom"):
    """Half offsets deduplicated for tiny periodic axes: with nb==2 the
    -1 and +1 images coincide (keep +1 and 0); with nb==1 only 0."""

    def ok(off):
        for a in range(3):
            if geom.periodic[a]:
                if geom.nb[a] == 1 and off[a] != 0:
                    return False
                if geom.nb[a] == 2 and off[a] == -1:
                    return False
        return True

    return [off for off in HALF_OFFSETS if ok(off)]


@dataclasses.dataclass(frozen=True)
class LatticeGeom:
    nb: Tuple[int, int, int]        # real bins per axis
    pitch: Tuple[float, float, float]
    lo: Tuple[float, float, float]
    periodic: Tuple[bool, bool, bool]
    M: int                          # slots per bin

    @property
    def padded(self):
        return tuple(n + 2 for n in self.nb)

    @property
    def S(self):
        p = self.padded
        return p[0] * p[1] * p[2]

    def flat_delta(self, off) -> int:
        p = self.padded
        return (off[0] * p[1] + off[1]) * p[2] + off[2]


def make_geom(cfg: DEMConfig) -> LatticeGeom:
    nb = tuple(max(int((cfg.domain_hi[a] - cfg.domain_lo[a]) / cfg.cutoff),
                   1) for a in range(3))
    pitch = tuple((cfg.domain_hi[a] - cfg.domain_lo[a]) / nb[a]
                  for a in range(3))
    return LatticeGeom(nb=nb, pitch=pitch, lo=tuple(cfg.domain_lo),
                       periodic=tuple(cfg.periodic), M=cfg.max_per_bin)


def bin_slots(geom: LatticeGeom, pos, active):
    """Assign particles to lattice slots.

    Returns (slot_particle (M, S) int32 with N = empty, overflow count).
    Ghost bins stay empty; they are filled by halo copies. The sort is
    stable (ties keep particle order), as the reference's argsort is: an
    unstable one would put particles in other slots.
    """
    n = pos.shape[0]
    dev = pos.device
    p = geom.padded
    S, M = geom.S, geom.M
    ijk_cols = []
    for a in range(3):
        c = torch.floor((pos[:, a] - geom.lo[a]) / geom.pitch[a]
                        ).to(torch.int64)
        ijk_cols.append(torch.clamp(c, 0, geom.nb[a] - 1) + 1)  # +1: ghosts
    bin_id = (ijk_cols[0] * p[1] + ijk_cols[1]) * p[2] + ijk_cols[2]
    bin_id = torch.where(active, bin_id, torch.full_like(bin_id, S))

    sorted_bins, order = torch.sort(bin_id, stable=True)
    starts = torch.searchsorted(
        sorted_bins, torch.arange(S + 1, dtype=torch.int64, device=dev))
    # rank within bin for each sorted position
    rank = torch.arange(n, dtype=torch.int64, device=dev) \
        - starts[torch.clamp(sorted_bins, 0, S)]
    real = sorted_bins < S
    overflow = torch.sum((rank >= M) & real).to(torch.int32)

    ok = (rank < M) & real
    # the reference's mode="drop" scatter: writes that fall out of the
    # table go to one extra slot, cut off after the scatter
    flat = torch.where(ok, rank * S + sorted_bins,
                       torch.full_like(rank, M * S))
    slot_particle = torch.full((M * S + 1,), n, dtype=torch.int32,
                               device=dev)
    slot_particle = slot_particle.scatter(0, flat, order.to(torch.int32))
    return slot_particle[:M * S].reshape(M, S), overflow


def _halo_exchange(arr, geom: LatticeGeom):
    """Fill ghost layers: periodic axes copy the opposite boundary slab,
    wall axes leave the zero/empty fill. arr: (..., S) -> (..., S)."""
    p = geom.padded
    a4 = arr.reshape(arr.shape[:-1] + p)
    for a, per in enumerate(geom.periodic):
        if not per:
            continue
        ax = arr.dim() - 1 + a  # axis index in the reshaped view
        lo_src = a4.narrow(ax, p[a] - 2, 1)
        hi_src = a4.narrow(ax, 1, 1)
        a4 = torch.cat([lo_src, a4.narrow(ax, 1, p[a] - 2), hi_src], dim=ax)
    return a4.reshape(arr.shape)


def _halo_fold(arr, geom: LatticeGeom):
    """Reverse of _halo_exchange for ACCUMULATED quantities: add what
    landed on periodic ghost layers back onto their source real layers
    (ghost 0 came from real p-2; ghost p-1 from real 1)."""
    p = geom.padded
    a4 = arr.reshape(arr.shape[:-1] + p)
    for a, per in enumerate(geom.periodic):
        if not per:
            continue
        ax = arr.dim() - 1 + a
        lo_g = a4.narrow(ax, 0, 1)
        hi_g = a4.narrow(ax, p[a] - 1, 1)
        mid = a4.narrow(ax, 1, p[a] - 2)
        zero_g = torch.zeros_like(lo_g)
        if p[a] == 3:  # single real layer: both ghosts fold onto it
            a4 = torch.cat([zero_g, mid + lo_g + hi_g, zero_g], dim=ax)
        else:
            first = mid.narrow(ax, 0, 1) + hi_g
            last = mid.narrow(ax, p[a] - 3, 1) + lo_g
            inner = mid.narrow(ax, 1, p[a] - 4)
            a4 = torch.cat([zero_g, first, inner, last, zero_g], dim=ax)
    return a4.reshape(arr.shape)


def real_bin_mask(geom: LatticeGeom) -> np.ndarray:
    """(S,) bool: True for real (non-ghost) bins."""
    p = geom.padded
    m = np.zeros(p, bool)
    m[1:-1, 1:-1, 1:-1] = True
    return m.reshape(-1)


@functools.lru_cache(maxsize=64)
def _real_mask(geom: LatticeGeom, device) -> torch.Tensor:
    """real_bin_mask on `device`, made there once (a captured step may
    not copy host data; its eager warm-up fills this cache)."""
    m = torch.zeros(geom.padded, dtype=torch.bool, device=device)
    m[1:-1, 1:-1, 1:-1] = True
    return m.reshape(-1)


@functools.lru_cache(maxsize=64)
def _upper(M: int, device) -> torch.Tensor:
    """(M, M, 1) bool: mi < mj, the in-bin half of the pairs."""
    return torch.triu(torch.ones((M, M), dtype=torch.bool, device=device),
                      diagonal=1)[:, :, None]


def _shift(arr, d: int):
    """Flat shift by d bins: out[..., s] = arr[..., s + d] (wrap reads hit
    ghost/far rows, harmless: the i side there is a ghost)."""
    return torch.roll(arr, -d, dims=-1)


_FIELDS = ("x", "y", "z", "vx", "vy", "vz", "wx", "wy", "wz", "rad", "m")


def pack_fields(state: ParticleState, slot_particle, geom: LatticeGeom):
    """Particle SoA -> lattice slot arrays via ONE padded row gather.

    Returns (fields dict of (M, S) tensors, has (M, S) bool).
    """
    n = state.n_capacity
    has = slot_particle < n
    j = torch.clamp(slot_particle, 0, n - 1).long()
    packed = torch.cat([state.pos, state.vel, state.omega,
                        state.radius[:, None], state.mass[:, None]],
                       dim=-1)                                # (N, 11)
    pg = packed[j]                                            # (M, S, 11)
    # deactivated particles are scrubbed out of the slot table at the
    # delete event (neighbor.scrub_dead_partners), not masked here
    zero = torch.zeros((), dtype=pg.dtype, device=pg.device)
    fields = {k: torch.where(has, pg[..., i], zero)
              for i, k in enumerate(_FIELDS)}
    return fields, has


def _halo_fields(fields, has, geom: LatticeGeom):
    """Halo-exchange every field; wrap coordinates by +-L on the copied
    ghost slabs so deltas are already minimum-image."""
    p = geom.padded
    out = {k: _halo_exchange(v, geom) for k, v in fields.items()}
    has = _halo_exchange(has, geom)
    for a, key in enumerate(("x", "y", "z")):
        if not geom.periodic[a]:
            continue
        L = geom.nb[a] * geom.pitch[a]
        c4 = out[key].reshape(out[key].shape[:-1] + p)
        idx = torch.arange(p[a], device=c4.device)
        shape = [1, 1, 1]
        shape[a] = p[a]
        lo_ghost = (idx == 0).reshape(shape).to(c4.dtype)
        hi_ghost = (idx == p[a] - 1).reshape(shape).to(c4.dtype)
        c4 = c4 - lo_ghost * L + hi_ghost * L
        out[key] = c4.reshape(out[key].shape)
    return out, has


def lattice_pair_forces(state: ParticleState, cfg: DEMConfig,
                        geom: LatticeGeom, slot_particle, shear_lat,
                        shearupdate: bool = True):
    """Pair forces/torques via half-offset rolls.

    shear_lat: (3, NOFF, M, M, S) with NOFF = len(geom_offsets(geom)).
    Returns (force (N,3), torque (N,3), new shear_lat).
    """
    params = cfg.pair
    dt = cfg.dt
    M, S = geom.M, geom.S
    n = state.n_capacity
    dtype, dev = state.pos.dtype, state.pos.device

    offs = geom_offsets(geom)
    fields, has0 = pack_fields(state, slot_particle, geom)
    fields, has = _halo_fields(fields, has0, geom)
    real = _real_mask(geom, dev)
    one = torch.ones((), dtype=dtype, device=dev)

    f_acc = {c: torch.zeros((M, S), dtype=dtype, device=dev) for c in "xyz"}
    t_acc = {c: torch.zeros((M, S), dtype=dtype, device=dev) for c in "xyz"}
    new_shear = []

    for o_i, off in enumerate(offs):
        d = geom.flat_delta(off)
        nbf = {k: _shift(v, d) for k, v in fields.items()} \
            if d != 0 else fields
        nb_has = _shift(has, d) if d != 0 else has

        # pair block (M_i, M_j, S)
        delta = tuple(fields[c][:, None, :] - nbf[c][None, :, :]
                      for c in "xyz")
        rsq = delta[0] ** 2 + delta[1] ** 2 + delta[2] ** 2
        radi = fields["rad"][:, None, :]
        radj = nbf["rad"][None, :, :]
        radsum = radi + radj
        # real[i-bin] kills the mirrored ghost-side enumeration of
        # cross-seam pairs (each physical pair is counted exactly once)
        touch = has[:, None, :] & nb_has[None, :, :] \
            & (rsq < radsum ** 2) & real[None, None, :]
        if off == (0, 0, 0):
            touch = touch & _upper(M, dev)   # in-bin: ordered half mi < mj

        rsq_safe = torch.where(touch, rsq, one)
        r = torch.sqrt(rsq_safe)
        rinv = 1.0 / r
        rsqinv = 1.0 / rsq_safe

        vr = tuple(fields["v" + c][:, None, :] - nbf["v" + c][None, :, :]
                   for c in "xyz")
        vnnr = vr[0] * delta[0] + vr[1] * delta[1] + vr[2] * delta[2]
        vn = tuple(delta[c] * vnnr * rsqinv for c in range(3))
        vt = tuple(vr[c] - vn[c] for c in range(3))
        wr = tuple((radi * fields["w" + c][:, None, :]
                    + radj * nbf["w" + c][None, :, :]) * rinv for c in "xyz")
        vtr = (vt[0] - (delta[2] * wr[1] - delta[1] * wr[2]),
               vt[1] - (delta[0] * wr[2] - delta[2] * wr[0]),
               vt[2] - (delta[1] * wr[0] - delta[0] * wr[1]))

        mi = fields["m"][:, None, :]
        mj = nbf["m"][None, :, :]
        meff = mi * mj / torch.clamp(mi + mj, min=1e-300)
        overlap = radsum - r
        poly_arg = overlap * radi * radj / torch.clamp(radsum, min=1e-300)

        sh = (shear_lat[0, o_i], shear_lat[1, o_i], shear_lat[2, o_i])
        fpair, fs_vec, sh_new = contact_force(
            params, dt, touch, overlap, r, rinv, rsqinv, delta,
            vnnr, vtr, sh, meff, poly_arg, shearupdate)
        new_shear.append(torch.stack(sh_new))

        # accumulate on i; Newton reaction on j via reverse shift (the
        # reverse shift can land on a ghost copy of j -> folded below)
        for c in range(3):
            key = "xyz"[c]
            f_acc[key] = f_acc[key] + torch.sum(fpair[c], dim=1)
            back = torch.sum(fpair[c], dim=0)         # (M_j, S)
            f_acc[key] = f_acc[key] - (_shift(back, -d) if d != 0 else back)
        # torque: -rad_i/r cross(delta, fs) on i; -rad_j/r same cross on j
        tor = (delta[1] * fs_vec[2] - delta[2] * fs_vec[1],
               delta[2] * fs_vec[0] - delta[0] * fs_vec[2],
               delta[0] * fs_vec[1] - delta[1] * fs_vec[0])
        for c in range(3):
            key = "xyz"[c]
            t_acc[key] = t_acc[key] - torch.sum(radi * tor[c] * rinv, dim=1)
            backt = torch.sum(radj * tor[c] * rinv, dim=0)
            t_acc[key] = t_acc[key] - (_shift(backt, -d) if d != 0
                                       else backt)

    # fold periodic-ghost accumulations back onto their real bins
    for c in "xyz":
        f_acc[c] = _halo_fold(f_acc[c], geom)
        t_acc[c] = _halo_fold(t_acc[c], geom)

    shear_out = torch.stack(new_shear, dim=1)         # (3, NOFF, M, M, S)

    # lattice -> particle: the reference's segment_sum by particle id.
    # Slots are unique per particle, so every real row receives exactly
    # one addend and the result does not depend on the order of the
    # atomics; the empty slots all land on row n, which is cut off.
    sp = slot_particle.reshape(-1).long()

    def to_particles(acc):
        vals = torch.stack([acc[c].reshape(-1) for c in "xyz"], dim=-1)
        out = torch.zeros((n + 1, 3), dtype=dtype, device=dev)
        return out.index_add_(0, sp, vals)[:n]

    return to_particles(f_acc), to_particles(t_acc), shear_out


# --------------------------------------------------------------------------
# rebuild: slot assignment + compact tag-matched shear carry
# --------------------------------------------------------------------------


def carry_shear_lattice(old_slot, new_slot, old_shear, geom: LatticeGeom,
                        n: int, k_compact: int = 16):
    """Carry per-pair shear across a rebuild.

    k_compact bounds the carried contacts per particle; callers pass the
    case's touch-ring K bound (DEMConfig.nbr_k, >= max coordination ~12
    plus headroom) so HCP-like packings don't silently drop history.

    1) compact the old lattice: per old slot (mi, bin), its pairs are the
       i-side rows (o, mj) plus the j-side rows (o, mi') shifted back:
       2*NOFF*M candidates; keep the k_compact largest |shear| with their
       partner ids (a running merge over the offsets, so the candidates
       are never all materialized at once);
    2) re-map compact rows from old slots to new slots by particle id
       (one row gather of M*S rows);
    3) re-inject: each new pair key matches its partner id against the
       particle's k_compact entries (elementwise) and sums the shear.

    The top-k is a stable descending sort cut at k_compact: equal
    magnitudes keep the lower index first, as lax.top_k orders them. The
    re-injection sum is an einsum of a 0/1 match mask; with TF32 on it
    would round the carried history (the package turns TF32 off,
    full_f32_precision).
    """
    M, S = geom.M, geom.S
    dev = old_slot.device
    dtype = old_shear.dtype
    halo_old = _halo_exchange(old_slot, geom)

    # --- 1) compact extraction in old-slot space ------------------------
    def _merge(best, block_ids, block_sh):
        # best: (ids (M,S,Kc), sh (3,M,S,Kc), mag (M,S,Kc));
        # block: ids (M_j, S) of the partners, sh (3, M, Mc, S)
        b_ids = block_ids.t()[None].expand(M, S, M)       # (M, S, Mc)
        b_sh = torch.movedim(block_sh, 2, -1)             # (3, M, S, Mc)
        b_mag = torch.sum(b_sh * b_sh, dim=0)             # (M, S, Mc)
        ids_c = torch.cat([best[0], b_ids], dim=-1)
        sh_c = torch.cat([best[1], b_sh], dim=-1)
        mag_c = torch.cat([best[2], b_mag], dim=-1)
        topmag, sel = torch.sort(mag_c, dim=-1, descending=True, stable=True)
        topmag, sel = topmag[..., :k_compact], sel[..., :k_compact]
        new_ids = torch.gather(ids_c, -1, sel)
        new_sh = torch.gather(sh_c, -1, sel[None].expand(3, -1, -1, -1))
        return (new_ids, new_sh, topmag)

    best = (torch.full((M, S, k_compact), n, dtype=torch.int32, device=dev),
            torch.zeros((3, M, S, k_compact), dtype=dtype, device=dev),
            torch.full((M, S, k_compact), -1.0, dtype=dtype, device=dev))
    for o_i, off in enumerate(geom_offsets(geom)):
        d = geom.flat_delta(off)
        # i-side: I am mi at bin; partner j = slot (mj, bin + d)
        pj = _shift(halo_old, d) if d != 0 else halo_old       # (M, S)
        best = _merge(best, pj, old_shear[:, o_i])
        # j-side: I am mj at bin; pair stored at bin-d as (mi', me):
        # shifted view puts it at my bin; swap (mi', me) so my slot leads
        pi = _shift(halo_old, -d) if d != 0 else halo_old
        sh_b = _shift(old_shear[:, o_i], -d) if d != 0 \
            else old_shear[:, o_i]                             # (3,Mi',Me,S)
        best = _merge(best, pi, -torch.transpose(sh_b, 1, 2))  # (3,Me,Mi',S)
    comp_ids, comp_sh, topmag = best
    live = topmag > 0.0
    comp_ids = torch.where(live, comp_ids, torch.full_like(comp_ids, n))
    comp_sh = torch.where(live[None], comp_sh, torch.zeros_like(comp_sh))

    # --- 2) old-slot-major -> new-slot-major (by particle id) ----------
    comp_ids = comp_ids.reshape(M * S, k_compact)
    comp_sh = comp_sh.reshape(3, M * S, k_compact)
    old_owner = old_slot.reshape(-1).long()           # (M*S,)
    # every empty old slot writes row n of the (n + 1) buffer; which of
    # those writes wins is harmless: row n is read only for empty new
    # slots, which src_ok masks
    slot_of_particle = torch.full((n + 1,), M * S, dtype=torch.int64,
                                  device=dev).scatter(
        0, old_owner, torch.arange(M * S, dtype=torch.int64, device=dev))
    new_owner = new_slot.reshape(-1).long()
    src = slot_of_particle[torch.clamp(new_owner, 0, n)]
    src_ok = (new_owner < n) & (src < M * S)
    src_c = torch.clamp(src, 0, M * S - 1)
    comp_ids_new = torch.where(src_ok[:, None], comp_ids[src_c],
                               torch.full_like(comp_ids, n)
                               ).reshape(M, S, k_compact)
    comp_sh_new = torch.where(src_ok[None, :, None], comp_sh[:, src_c],
                              torch.zeros_like(comp_sh)
                              ).reshape(3, M, S, k_compact)

    # --- 3) re-inject into new lattice keys -----------------------------
    halo_new = _halo_exchange(new_slot, geom)
    valid = comp_ids_new < n
    outs = []
    for off in geom_offsets(geom):
        d = geom.flat_delta(off)
        pj = _shift(halo_new, d) if d != 0 else halo_new  # (M_j, S)
        # match (Mi, Mj, S, Kc): my compact entry k names partner pj[mj]
        match = (comp_ids_new[:, None, :, :] == pj[None, :, :, None]) \
            & valid[:, None, :, :]
        outs.append(torch.einsum("ijsk,cisk->cijs", match.to(dtype),
                                 comp_sh_new))
    return torch.stack(outs, dim=1)                   # (3, NOFF, M, M, S)
