"""Turbulence closure for the continuous phase (port of
``sedifoam_tpu/fluid/turbulence.py``, laminar only).

The momentum coupling is entirely through nuEff. The LES and RAS models
of the reference are not ported yet and raise.
"""

from __future__ import annotations

import torch

from sedifoam_tpu_torch import ops
from sedifoam_tpu_torch.config import FluidConfig
from sedifoam_tpu_torch.fluid.state import FluidBCs, FluidState
from sedifoam_tpu_torch.grid import Grid


def _require_laminar(cfg: FluidConfig):
    if cfg.turbulence.model != "laminar":
        raise NotImplementedError(
            f"TurbulenceConfig.model={cfg.turbulence.model!r}: only "
            "'laminar' is ported")


def reynolds_stress(fs: FluidState, grid: Grid, bcs: FluidBCs,
                    cfg: FluidConfig):
    """B = (2/3) k I - nuEff * twoSymm(grad(Ub)) — the Reynolds-stress
    export of the reference (pEqn.H:100); k and nut are zero when
    laminar.

    Returns (6, nx, ny, nz): xx, xy, xz, yy, yz, zz.
    """
    _require_laminar(cfg)
    g = ops.grad_vec(fs.Ub, grid, bcs.Ub)   # g[j, i] = dU_j/dx_i
    nueff = cfg.nub + fs.nut
    k = fs.k

    def comp(i, j):
        s = nueff * (g[i, j] + g[j, i])
        return ((2.0 / 3.0) * k - s) if i == j else -s

    return torch.stack([comp(0, 0), comp(0, 1), comp(0, 2),
                        comp(1, 1), comp(1, 2), comp(2, 2)])


def nu_eff(fs: FluidState, grid: Grid, cfg: FluidConfig):
    """Effective viscosity field for the momentum equation."""
    _require_laminar(cfg)
    return torch.full(grid.shape, cfg.nub, dtype=fs.p.dtype,
                      device=fs.p.device)


def correct(fs: FluidState, grid: Grid, bcs: FluidBCs, cfg: FluidConfig
            ) -> FluidState:
    """turbulence->correct(): nothing to update for a laminar flow."""
    _require_laminar(cfg)
    return fs
