"""Turbulence closure for the continuous phase (port of
``sedifoam_tpu/fluid/turbulence.py``, laminar only).

The momentum coupling is entirely through nuEff. The LES and RAS models
of the reference are not ported yet and raise.
"""

from __future__ import annotations

import torch

from sedifoam_tpu_torch.config import FluidConfig
from sedifoam_tpu_torch.fluid.state import FluidBCs, FluidState
from sedifoam_tpu_torch.grid import Grid


def _require_laminar(cfg: FluidConfig):
    if cfg.turbulence.model != "laminar":
        raise NotImplementedError(
            f"TurbulenceConfig.model={cfg.turbulence.model!r}: only "
            "'laminar' is ported")


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
