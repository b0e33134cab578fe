"""Particle <-> grid transfer (port of ``sedifoam_tpu/coupling/transfer.py``).

Everything is a gather (grid -> particle) or a scatter-add (particle ->
grid, `index_add_`) keyed by the particle's host-cell flat index.
Inactive particles scatter zero weight and gather from a clamped cell.
On CUDA `index_add_` sums with atomics in a varying order, so results
differ from run to run by round-off: compare by tolerance.
The semi-implicit drag fields (calc_omega_asrc_semi) are not ported.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sedifoam_tpu_torch.dem.state import ParticleState
from sedifoam_tpu_torch.grid import Grid

ROOTVSMALL = 1e-18


def particle_cells(state: ParticleState, grid: Grid):
    """Flat host-cell index per particle (clamped into the box), int64."""
    ijk = grid.locate(state.pos)
    return grid.flat_index(ijk).long()


def cell_volume_at(cells, grid: Grid, like):
    """Host-cell volume per particle: scalar on uniform grids, a gather on
    graded ones."""
    V = grid.cell_volume
    if grid.uniform:
        return V
    return torch.as_tensor(V, dtype=like.dtype,
                           device=like.device).reshape(-1)[cells]


def _segment_sum(w, cells, n_cells):
    out = torch.zeros((n_cells,) + tuple(w.shape[1:]), dtype=w.dtype,
                      device=w.device)
    return out.index_add_(0, cells, w)


def scatter_to_grid(values, cells, active, grid: Grid):
    """sum_p values_p -> host cells. values: (N,) or (N,3)."""
    if values.ndim == 2:
        w = torch.where(active[:, None], values, torch.zeros_like(values))
        flat = _segment_sum(w, cells, grid.n_cells)
        return torch.movedim(flat, -1, 0).reshape((values.shape[1],)
                                                  + grid.shape)
    w = torch.where(active, values, torch.zeros_like(values))
    return _segment_sum(w, cells, grid.n_cells).reshape(grid.shape)


def scatter_fields(cells, active, grid: Grid, *values):
    """ONE scatter for several per-particle fields at the same cells.

    values: each (N,) or (N,3); packed into one (N, C) scatter-add.
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
    flat = _segment_sum(w, cells, grid.n_cells)
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


def gather_from_grid(field, cells):
    """field value at each particle's host cell. field: (nx,ny,nz) or (3,...)."""
    if field.ndim == 4:
        return field.reshape(field.shape[0], -1).T[cells]
    return field.reshape(-1)[cells]


def gather_fields(cells, *fields):
    """ONE row gather for several grid fields at the same host cells.

    fields: each (nx,ny,nz) or (C,nx,ny,nz); all components concatenate
    into one (n_cells, C_total) table. Returns one tensor per input
    ((N,) or (N,C))."""
    cols, splits = [], []
    for f in fields:
        if f.ndim == 4:
            cols.append(f.reshape(f.shape[0], -1))
            splits.append(f.shape[0])
        else:
            cols.append(f.reshape(1, -1))
            splits.append(0)
    packed = torch.cat(cols, dim=0).T             # (n_cells, C_total)
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
                         smooth_fn, alpha_smooth: bool, up_smooth: bool
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """particleToEulerianField (enhancedCloud.C:911-980).

    Returns (gamma, Ue): solid volume fraction and ensemble solid velocity.
    smooth_fn(field) applies the diffusion coarse-graining.
    """
    cells = particle_cells(state, grid)
    vol = state.volume
    V = grid.cell_volume
    if not grid.uniform:
        V = torch.as_tensor(V, dtype=vol.dtype, device=vol.device)

    gamma, Ue = scatter_fields(cells, state.active, grid,
                               vol, vol[:, None] * state.vel)
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
              smooth_fn, drag_smooth: bool, uf_at_p=None):
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
        uf_at_p = gather_from_grid(uf_smoothed, cells)
    contrib = omg[:, None] * (state.vel - uf_at_p)
    asrc = scatter_to_grid(contrib, cells, state.active, grid)

    one_minus = 1.0 - gamma
    asrc = asrc * one_minus[None]
    if drag_smooth:
        asrc = smooth_fn(asrc)
    denom = torch.where(torch.abs(one_minus) > ROOTVSMALL, one_minus,
                        torch.ones_like(one_minus))
    return asrc / denom[None]


def weighted_smooth_uf(Uf, gamma, smooth_fn):
    """UfSmoothed = smooth((1-gamma)*Uf)/(1-gamma) (enhancedCloud.C:675-690)."""
    one_minus = 1.0 - gamma
    out = smooth_fn(Uf * one_minus[None])
    denom = torch.where(torch.abs(one_minus) > ROOTVSMALL, one_minus,
                        torch.ones_like(one_minus))
    return out / denom[None]
