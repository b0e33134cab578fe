"""Diffusion-based coarse-graining smoothing (enhancedCloud::smoothField);
port of ``sedifoam_tpu/coupling/smoothing.py``.

The Sun & Xiao two-grid formulation: integrate pure diffusion
d f/dt = div(DT grad f) for a pseudo-time T = bandwidth^2/4 in `steps`
implicit Euler sub-steps, with zeroGradient BCs and an anisotropic DT
given by the cloudProperties `smoothDirection` tensor diagonal.

With USE_FASTDIAG (the default, as in the reference) all the steps run
as one exact tensor-product transform pair (fastsolve.FastDiag.
solve_pow). Without it each step is a Jacobi-PCG solve at tol 1e-10
(fvSolution tempDiffScalar/tempDiffVector): linsolve.pcg for a scalar
field, linsolve.pcg_multi for the three components of a vector field.
"""

from __future__ import annotations

from typing import Tuple

import torch

from pbref import bc as _bc
from pbref import fastsolve, linop, linsolve
from pbref.grid import FaceField, Grid

USE_FASTDIAG = True  # exact tensor-product smoother (CG fallback if False)


def smooth(field, grid: Grid, bandwidth: float, steps: int,
           direction: Tuple[float, float, float] = (1.0, 1.0, 1.0),
           tol: float = 1e-10, max_iter: int = 500,
           solver: fastsolve.FastDiag = None):
    """Smooth a scalar (nx,ny,nz) or stacked-vector (3,nx,ny,nz) field.

    `solver` is the prebuilt fastsolve.smoothing_solver for this grid and
    direction (built here when None); tol and max_iter are the PCG
    branch's."""
    if steps <= 0 or bandwidth <= 0.0:
        return field

    if USE_FASTDIAG:
        if solver is None:
            solver = fastsolve.smoothing_solver(
                grid, tuple(float(d) for d in direction), field.dtype,
                field.device)
        # volume-normalized implicit Euler: (1/dt I - V^-1 L) x = f/dt,
        # all `steps` applications collapsed into one transform pair
        dt_f = (bandwidth ** 2 / 4.0) / steps
        c0 = 1.0 / dt_f
        return solver.solve_pow(field, c0, int(steps))

    dt = (bandwidth ** 2 / 4.0) / steps
    dtype, device = field.dtype, field.device
    gamma_face = FaceField(*(
        torch.full(shape, float(direction[a]), dtype=dtype, device=device)
        for a, shape in enumerate(((grid.nx + 1, grid.ny, grid.nz),
                                   (grid.nx, grid.ny + 1, grid.nz),
                                   (grid.nx, grid.ny, grid.nz + 1)))))
    lap = linop.laplacian(gamma_face, grid, _bc.zero_gradient(), dtype=dtype)
    V_dt = grid.cell_volume_like(field) / dt

    def apply_fn(x):
        return V_dt * x - lap.apply(x)

    diag = V_dt + torch.zeros(grid.shape, dtype=dtype, device=device) \
        - lap.diag
    # one batched solve per diffusion step for a vector (3 RHS, one
    # operator)
    solve = linsolve.pcg_multi if field.dim() == 4 else linsolve.pcg
    for _ in range(steps):
        field = solve(apply_fn, V_dt * field, field, diag, tol=tol,
                      max_iter=max_iter, grid=grid).x
    return field
