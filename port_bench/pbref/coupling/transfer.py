"""Particle <-> grid transfer (port of ``sedifoam_tpu/coupling/transfer.py``).

Everything is a gather (grid -> particle) or a scatter-add (particle ->
grid) keyed by the particle's host-cell flat index. Inactive particles
scatter zero weight and gather from a clamped cell.

The scatter-add is `index_put_(accumulate=True)`, which sums duplicates
in a fixed order on CUDA (indices sorted first). `index_add_` sums with
float atomics in a varying order there: run-to-run round-off in alpha
and Asrc that a packed bed amplifies to 3e-4 of the contact forces'
scale within 6 coupled steps (H100), so two runs, or a run and its
resume from a checkpoint, would not repeat. With the sorted sum a run
repeats bit for bit on the card too (tests/test_torch_cuda.py).

In a step split over ranks (`shard`, parallel/mesh.Shard) with the
fluid whole on every rank, each rank scatters its own rows into a
partial grid, and the partials are summed over the ranks
(shard.comm.all_reduce_sum): the sum runs in another order than one
rank's sorted sum, so the fields agree with it to round-off. The
gathers need no exchange.

With the fluid split along grid-x (grid.SlabGrid) each row's values go
to the rank whose slab holds its cell, and each rank scatters the rows
of its slab's cells in the rows' global order: one process's sum, bit
for bit. The exchange is of a fixed size, so that a captured step can
hold it (`_to_slabs`: every rank sends every rank a block of all its
rows, those bound elsewhere aimed at a dump cell that the sum slices
off). The gathers read the fields of the whole domain, gathered from
the slabs (`join`).
"""

from __future__ import annotations

from typing import Tuple

import torch

from pbref.dem.state import ParticleState
from pbref.grid import Grid, SlabGrid

ROOTVSMALL = 1e-18


def particle_cells(state: ParticleState, grid: Grid):
    """Flat host-cell index per particle (clamped into the box), int64."""
    ijk = grid.locate(state.pos)
    return grid.flat_index(ijk).long()


def cell_volume_at(cells, grid: Grid, like):
    """Host-cell volume per particle: scalar on uniform grids, a gather on
    graded ones."""
    V = grid.domain.cell_volume_like(like)
    if grid.uniform:
        return V
    return V.reshape(-1)[cells]


def _segment_sum(w, cells, n_cells):
    out = torch.zeros((n_cells,) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    return out.index_put_((cells,), w, accumulate=True)


def _to_slabs(w, cells, grid: SlabGrid):
    """(w, cells) of the rows of all ranks, in their global order, each
    cell local to this rank's slab, the rows of other slabs' cells at a
    dump cell past its last (grid.n_cells). Each rank sends each rank a
    block of all its rows: their values, and their cells local to the
    receiver's slab (the slabs are alike in size) as int32. Two
    fixed-size all-to-alls."""
    comm, n = grid.comm, grid.n_cells
    ranks = torch.arange(comm.ranks, device=cells.device)[:, None]
    local = cells[None, :] - ranks * n                      # (R, rows)
    local = torch.where((local >= 0) & (local < n), local,
                        torch.full_like(local, n))
    got = comm.all_to_all_blocks(w.expand((comm.ranks,) + w.shape))
    return (got.reshape((-1,) + tuple(w.shape[1:])),
            comm.all_to_all_blocks(local.int()).reshape(-1).long())


def _scatter(w, cells, grid: Grid, shard):
    """(grid.n_cells, ...) sums of the rows w (N, ...) at their domain
    cells: over the ranks' rows too in a split step (the module
    docstring)."""
    if isinstance(grid, SlabGrid):
        if grid.comm.ranks == 1:
            return _segment_sum(w, cells, grid.n_cells)
        w, local = _to_slabs(w, cells, grid)
        return _segment_sum(w, local, grid.n_cells + 1)[:grid.n_cells]
    flat = _segment_sum(w, cells, grid.n_cells)
    return flat if shard is None else shard.comm.all_reduce_sum(flat)


def scatter_to_grid(values, cells, active, grid: Grid, shard=None):
    """sum_p values_p -> host cells. values: (N,) or (N,3); with a shard,
    summed over the ranks' rows too."""
    if values.ndim == 2:
        w = torch.where(active[:, None], values, torch.zeros_like(values))
        flat = _scatter(w, cells, grid, shard)
        return torch.movedim(flat, -1, 0).reshape((values.shape[1],)
                                                  + grid.shape)
    w = torch.where(active, values, torch.zeros_like(values))
    return _scatter(w, cells, grid, shard).reshape(grid.shape)


def scatter_fields(cells, active, grid: Grid, *values, shard=None):
    """ONE scatter for several per-particle fields at the same cells.

    values: each (N,) or (N,3); packed into one (N, C) scatter-add (with
    a shard, summed over the ranks' rows in one exchange).
    Returns one grid field per input ((nx,ny,nz) or (3,nx,ny,nz))."""
    cols, splits = [], []
    for v in values:
        if v.ndim == 2:
            cols.append(v)
            splits.append(v.shape[1])
        else:
            cols.append(v[:, None])
            splits.append(0)          # 0 marks "scalar"
    packed = torch.cat(cols, dim=1)
    w = torch.where(active[:, None], packed, torch.zeros_like(packed))
    flat = _scatter(w, cells, grid, shard)
    out, o = [], 0
    for s in splits:
        if s == 0:
            out.append(flat[:, o].reshape(grid.shape))
            o += 1
        else:
            out.append(torch.movedim(flat[:, o:o + s], -1, 0
                                     ).reshape((s,) + grid.shape))
            o += s
    return out


def gather_from_grid(field, cells, grid: Grid = None):
    """field value at each particle's host cell. field: (nx,ny,nz) or
    (3,...) of `grid` (a slab's: joined first)."""
    if grid is not None:
        field = grid.join(field)
    if field.ndim == 4:
        return field.reshape(field.shape[0], -1).T[cells]
    return field.reshape(-1)[cells]


def gather_fields(cells, *fields, grid: Grid = None):
    """ONE row gather for several grid fields at the same host cells.

    fields: each (nx,ny,nz) or (C,nx,ny,nz) of `grid`; all components
    concatenate into one (n_cells, C_total) table (a slab's: joined in
    one gather). Returns one tensor per input ((N,) or (N,C))."""
    cols, splits = [], []
    for f in fields:
        if f.ndim == 4:
            cols.append(f.reshape(f.shape[0], -1))
            splits.append(f.shape[0])
        else:
            cols.append(f.reshape(1, -1))
            splits.append(0)
    packed = torch.cat(cols, dim=0)
    if grid is not None:
        packed = grid.join(packed, axis=1)
    packed = packed.T                             # (n_cells, C_total)
    g = packed[cells]                             # one row gather
    out, o = [], 0
    for s in splits:
        if s == 0:
            out.append(g[:, o])
            o += 1
        else:
            out.append(g[:, o:o + s])
            o += s
    return out


def particle_to_eulerian(state: ParticleState, grid: Grid,
                         smooth_fn, alpha_smooth: bool, up_smooth: bool,
                         shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """particleToEulerianField (enhancedCloud.C:911-980).

    Returns (gamma, Ue): solid volume fraction and ensemble solid velocity.
    smooth_fn(field) applies the diffusion coarse-graining.
    """
    cells = particle_cells(state, grid)
    vol = state.volume
    V = grid.cell_volume_like(vol)

    gamma, Ue = scatter_fields(cells, state.active, grid,
                               vol, vol[:, None] * state.vel, shard=shard)
    gamma = gamma / V
    Ue = Ue / V

    if alpha_smooth and up_smooth:
        # one batched tensor-product solve for all 4 components
        packed = smooth_fn(torch.cat([gamma[None], Ue], dim=0))
        gamma, Ue = packed[0], packed[1:]
    elif alpha_smooth:
        gamma = smooth_fn(gamma)
    elif up_smooth:
        Ue = smooth_fn(Ue)

    # normalize by gamma where particles exist
    has = gamma > ROOTVSMALL
    denom = torch.where(has, gamma, torch.ones_like(gamma))
    Ue = torch.where(has[None], Ue / denom[None], Ue)
    return gamma, Ue


def calc_asrc(state: ParticleState, jd_vals, uf_smoothed, gamma, grid: Grid,
              smooth_fn, drag_smooth: bool, uf_at_p=None, shard=None):
    """calcTcFields (enhancedCloud.C:316-441): the explicit particle->fluid
    momentum source Asrc [kg m^-2 s^-2].

    Asrc_cell = sum_p omg_p*(U_p - UfSmoothed_cell), omg = Vol*Jd/Vcell,
    then (1-gamma)-weighted smoothing. uf_at_p, when the caller already
    gathered UfSmoothed at the particles, skips the second gather.
    """
    cells = particle_cells(state, grid)
    V = cell_volume_at(cells, grid, jd_vals)
    omg = state.volume * jd_vals / V
    if uf_at_p is None:
        uf_at_p = gather_from_grid(uf_smoothed, cells, grid)
    contrib = omg[:, None] * (state.vel - uf_at_p)
    asrc = scatter_to_grid(contrib, cells, state.active, grid, shard)

    one_minus = 1.0 - gamma
    asrc = asrc * one_minus[None]
    if drag_smooth:
        asrc = smooth_fn(asrc)
    denom = torch.where(torch.abs(one_minus) > ROOTVSMALL, one_minus,
                        torch.ones_like(one_minus))
    return asrc / denom[None]


def calc_omega_asrc_semi(state: ParticleState, jd_vals, grid: Grid,
                         shard=None):
    """Semi-implicit coupling fields (enhancedCloud.C:338-360):
    Omega = sum_p omg, Asrc = sum_p omg*U_p (no smoothing in the
    reference's branch)."""
    cells = particle_cells(state, grid)
    V = cell_volume_at(cells, grid, jd_vals)
    omg = state.volume * jd_vals / V
    omega, asrc = scatter_fields(cells, state.active, grid,
                                 omg, omg[:, None] * state.vel, shard=shard)
    return omega, asrc


def weighted_smooth_uf(Uf, gamma, smooth_fn):
    """UfSmoothed = smooth((1-gamma)*Uf)/(1-gamma) (enhancedCloud.C:675-690)."""
    one_minus = 1.0 - gamma
    out = smooth_fn(Uf * one_minus[None])
    denom = torch.where(torch.abs(one_minus) > ROOTVSMALL, one_minus,
                        torch.ones_like(one_minus))
    return out / denom[None]
