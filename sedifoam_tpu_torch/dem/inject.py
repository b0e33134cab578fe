"""Particle injection/deletion regions (port of
``sedifoam_tpu/dem/inject.py``): mask flips on the fixed-capacity SoA.

Reference: softParticleCloud::{addNewParticles, addAndDeleteParticle,
findAddParticleCells} (softParticleCloud.C:1099-1352) and the evolve hook
(enhancedCloud.C:697-711). Every addParticleTimeStep seconds, one particle
is seeded at each cell center inside addParticleBox (subsampled by
reduceNumberFactor, positions jittered by randomPerturb); deleteParticle
clears a box region; deleteBeforeAdd clears the seed region first.

The random draws are jax.random's threefry2x32 `split`, `uniform` and
`normal` (the partitionable variant, jax's default; `normal` feeds the
DNS forcing of fluid/bodyforce.py), written in plain torch on
int64 tensors that hold uint32 values. They are pure functions of the
state's `rng_key`, so a checkpoint captures the generator, and a JAX
checkpoint resumed here draws the same perturbations bit for bit.

`maybe_add_delete` decides whether an add fires with the reference's
lax.cond (graphs.cond: a conditional node inside a captured step) and
returns whether it fired and whether the delete box removed anyone as
device tensors, for the caller's conds. `SYNCS` counts the decisions
read on the host: those of eager calls.

In a step split over ranks (`shard`, parallel/mesh.Shard) the countdown
and the key are whole on every rank, so every rank takes the add branch
alike; the add runs on the gathered whole state on every rank (the slot
assignment and the tags read all rows) and each rank cuts its own block
out again. The delete box is per row; whether it removed anyone is the
largest over the ranks, so that every rank takes the caller's branch
alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sedifoam_tpu_torch import device_vector, graphs
from sedifoam_tpu_torch.config import CloudConfig
from sedifoam_tpu_torch.dem.state import ParticleState
from sedifoam_tpu_torch.grid import Grid

# injection decisions read on the host in this process (eager calls of
# maybe_add_delete and of coupling.cloud.evolve's add/delete branches)
SYNCS = 0

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds), as jax's threefry2x32_p.
    Arguments are int64 tensors holding uint32 values (broadcasting);
    returns the two output words the same way."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _counts(n, device):
    """jax's iota_2x32_shape over n elements: (hi, lo) 32-bit words of
    the row-major flat index."""
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return idx >> 32, idx & _M32


def split(key, num: int = 2):
    """jax.random.split(key, num) for a raw (2,) uint32 key held as
    int64: returns (num, 2)."""
    hi, lo = _counts(num, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    return torch.stack([b1, b2], dim=-1)


def uniform(key, shape, dtype=torch.float64):
    """jax.random.uniform(key, shape, dtype) in [0, 1): the mantissa bits
    of the threefry draw under an exponent of 1, minus 1."""
    n = math.prod(shape)
    hi, lo = _counts(n, key.device)
    b1, b2 = threefry2x32(key[0], key[1], hi, lo)
    if dtype == torch.float32:
        bits = ((b1 ^ b2) >> 9) | 0x3F800000
        f = bits.to(torch.int32).view(torch.float32)
    elif dtype == torch.float64:
        # ((b1 << 32) | b2) >> 12, without overflowing int64
        bits = (b1 << 20) | (b2 >> 12) | 0x3FF0000000000000
        f = bits.view(torch.float64)
    else:
        raise ValueError(f"uniform: no draw for dtype {dtype}")
    return torch.clamp((f - 1.0).reshape(shape), min=0.0)


def normal(key, shape, dtype=torch.float64):
    """jax.random.normal(key, shape, dtype): sqrt(2) * erfinv(u), u the
    uniform draw mapped onto [nextafter(-1, 0), 1) exactly as jax maps
    it, so u matches bit for bit. erfinv is another polynomial here than
    in XLA: the values agree to round-off, not to bits."""
    np_dtype = {torch.float32: np.float32, torch.float64: np.float64}[dtype]
    lo = np.nextafter(np_dtype(-1.0), np_dtype(0.0))
    span = np_dtype(1.0) - lo                       # rounded in dtype
    u = uniform(key, shape, dtype) * float(span) + float(lo)
    u = torch.clamp(u, min=float(lo))
    return math.sqrt(2.0) * torch.special.erfinv(u)


def seed_positions(grid: Grid, box, reduce_factor: int) -> np.ndarray:
    """Static injection sites: cell centers in the box, subsampled like
    findAddParticleCells (softParticleCloud.C:1271-1352)."""
    if len(box) != 6:
        return np.zeros((0, 3))
    xs, ys, zs = (grid.axis_centers(a) for a in range(3))
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    centers = np.stack([X, Y, Z]).reshape(3, -1).T
    inside = np.all((centers >= np.asarray(box[0::2]))
                    & (centers <= np.asarray(box[1::2])), axis=1)
    pts = centers[inside]
    n_cell = len(pts)
    if n_cell == 0 or reduce_factor <= 1:
        return pts
    n_line = int(np.sqrt(n_cell))
    i = np.arange(n_cell)
    keep = ((i % reduce_factor) % reduce_factor == 0) & \
           ((i // max(n_line, 1)) % reduce_factor == 0)
    return pts[keep]


def _in_box(pos, box):
    lo = device_vector(tuple(box[0::2]), pos.dtype, pos.device)
    hi = device_vector(tuple(box[1::2]), pos.dtype, pos.device)
    return torch.all((pos >= lo) & (pos <= hi), dim=-1)


def delete_in_box(state: ParticleState, box) -> ParticleState:
    if len(box) != 6:
        return state
    inside = _in_box(state.pos, box)
    return state._replace(active=state.active & ~inside)


def add_particles(state: ParticleState, sites, ccfg: CloudConfig,
                  rng_key) -> ParticleState:
    """Activate one inactive slot per seed site (capacity permitting).
    sites: (n_add, 3) tensor on the state's device."""
    n_add = sites.shape[0]
    if n_add == 0:
        return state
    cap = state.n_capacity
    dev, dtype = state.pos.device, state.pos.dtype
    d, rho, ptype = ccfg.add_info

    # slot assignment: the k-th seed takes the k-th inactive slot
    slot_of_rank = torch.argsort(state.active.to(torch.int32),
                                 stable=True)          # inactive slots first
    take = torch.arange(n_add, device=dev)
    slots = slot_of_rank[torch.clamp(take, 0, cap - 1)]
    ok = take < torch.sum(~state.active)               # capacity check
    # seeds beyond capacity write into a dump row past the end. (The
    # reference clamps them onto slot cap-1 and keeps its old row there,
    # which loses the add that legitimately took slot cap-1.)
    slots = torch.where(ok, slots, torch.full_like(slots, cap))

    perturb = ccfg.random_perturb * (0.5 - uniform(rng_key, (n_add, 3),
                                                   dtype))
    new_pos = sites.to(dtype) + perturb
    new_vel = device_vector(tuple(ccfg.add_velocity), state.vel.dtype,
                            dev).expand(n_add, 3)

    max_tag = torch.max(torch.where(state.active, state.tag,
                                    torch.zeros_like(state.tag)))
    new_tags = max_tag + 1 + torch.arange(n_add, dtype=torch.int32,
                                          device=dev)

    def scat(arr, vals):
        out = torch.cat([arr, arr[:1]])
        out[slots] = vals.to(arr.dtype)
        return out[:cap]

    def full(shape, v, like):
        return torch.full(shape, v, dtype=like.dtype, device=dev)

    mass = rho * (4.0 / 3.0) * math.pi * (d / 2.0) ** 3
    zeros3 = torch.zeros((n_add, 3), dtype=dtype, device=dev)
    return state._replace(
        pos=scat(state.pos, new_pos),
        vel=scat(state.vel, new_vel),
        v_old=scat(state.v_old, new_vel),
        vel_fluid_old=scat(state.vel_fluid_old, new_vel),
        pos_at_build=scat(state.pos_at_build, new_pos),
        omega=scat(state.omega, zeros3),
        radius=scat(state.radius, full((n_add,), d / 2.0, state.radius)),
        mass=scat(state.mass, full((n_add,), mass, state.mass)),
        density=scat(state.density, full((n_add,), rho, state.density)),
        ptype=scat(state.ptype, full((n_add,), ptype, state.ptype)),
        tag=scat(state.tag, new_tags),
        n0=scat(state.n0, full((n_add,), 0.0, state.n0)),
        sum_delta_fb=scat(state.sum_delta_fb, zeros3),
        fdrag=scat(state.fdrag, zeros3),
        mol=scat(state.mol, full((n_add,), 0, state.mol)),
        displace=scat(state.displace, zeros3),
        active=scat(state.active, torch.ones(n_add, dtype=torch.bool,
                                             device=dev)),
    )


def count_sync():
    """Count one injection decision read on the host (eager only)."""
    global SYNCS
    if not graphs.capturing():
        SYNCS += 1


def maybe_add_delete(state: ParticleState, time_to_add, rng_key, sites,
                     grid: Grid, ccfg: CloudConfig, dt_fluid: float,
                     shard=None):
    """The addAndDeleteParticle step (softParticleCloud.C:1206-1268).

    When the countdown expires, the seed region is (optionally) cleared
    and refilled and the countdown resets; otherwise it decrements by the
    fluid dt. Box deletion runs every call. The key splits on every call
    with an add region, fired or not, as in the reference. Returns
    (state, new_time_to_add, new_rng_key, added, deleted), `added` and
    `deleted` 0-d bool tensors on the device. After an add the caller
    rebuilds the neighbor table and recomputes forces; after a delete
    alone it scrubs dead partners from the table. `shard`: the module
    docstring.
    """
    dev = state.pos.device
    added = torch.zeros((), dtype=torch.bool, device=dev)
    deleted = torch.zeros((), dtype=torch.bool, device=dev)
    if ccfg.add_particle > 0 and sites.shape[0] > 0:
        keys = split(rng_key)
        key_add, key_next = keys[0], keys[1]

        def do_add(st):
            if ccfg.delete_before_add and len(ccfg.clear_box) == 6:
                st = delete_in_box(st, ccfg.clear_box)
            return add_particles(st, sites, ccfg, key_add)

        due = time_to_add <= 0.0
        count_sync()
        if shard is None:
            state = graphs.cond(due, do_add, state)
        else:
            state = shard.cond(due, lambda st, sh: sh.cut(do_add(
                sh.gather(st))), state)
        time_to_add = torch.where(due,
                                  torch.full_like(time_to_add,
                                                  ccfg.add_interval),
                                  time_to_add - dt_fluid)
        rng_key = key_next
        added = due

    if ccfg.delete_particle > 0 and len(ccfg.delete_box) == 6:
        was_active = state.active
        state = delete_in_box(state, ccfg.delete_box)
        deleted = torch.any(was_active != state.active)
        if shard is not None:
            deleted = shard.comm.all_reduce_max(deleted.to(torch.int32)) > 0
            shard.set_active(state.active)

    return state, time_to_add, rng_key, added, deleted
