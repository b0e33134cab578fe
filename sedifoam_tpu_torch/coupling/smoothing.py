"""Diffusion-based coarse-graining smoothing (enhancedCloud::smoothField);
port of ``sedifoam_tpu/coupling/smoothing.py``, FastDiag branch.

The Sun & Xiao two-grid formulation: integrate pure diffusion
d f/dt = div(DT grad f) for a pseudo-time T = bandwidth^2/4 in `steps`
implicit Euler sub-steps, with zeroGradient BCs and an anisotropic DT
given by the cloudProperties `smoothDirection` tensor diagonal. All the
steps run as one exact tensor-product transform pair
(fastsolve.FastDiag.solve_pow).
"""

from __future__ import annotations

from typing import Tuple

from sedifoam_tpu_torch import fastsolve
from sedifoam_tpu_torch.grid import Grid


def smooth(field, grid: Grid, bandwidth: float, steps: int,
           direction: Tuple[float, float, float] = (1.0, 1.0, 1.0),
           solver: fastsolve.FastDiag = None):
    """Smooth a scalar (nx,ny,nz) or stacked-vector (C,nx,ny,nz) field.

    `solver` is the prebuilt fastsolve.smoothing_solver for this grid and
    direction (built here when None)."""
    if steps <= 0 or bandwidth <= 0.0:
        return field
    if solver is None:
        solver = fastsolve.smoothing_solver(
            grid, tuple(float(d) for d in direction), field.dtype,
            field.device)
    # volume-normalized implicit Euler: (1/dt I - V^-1 L) x = f/dt,
    # all `steps` applications collapsed into one transform pair
    dt_f = (bandwidth ** 2 / 4.0) / steps
    c0 = 1.0 / dt_f
    return solver.solve_pow(field, c0, int(steps))
