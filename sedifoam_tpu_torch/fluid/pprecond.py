"""Pressure-Poisson preconditioner (port of
``sedifoam_tpu/fluid/pprecond.py``).

The exact inverse of the CONSTANT-coefficient Poisson operator (unit
diffusivity, same BCs), applied via tensor-product fast diagonalization
(fastsolve.py). The true operator's face coefficient Dp = betaf*rUbAf/rhob
varies mildly around its mean, so PCG converges in a handful of
iterations.
"""

from __future__ import annotations

import torch

from sedifoam_tpu_torch import bc as _bc
from sedifoam_tpu_torch import fastsolve
from sedifoam_tpu_torch.grid import Grid


def make_preconditioner(grid: Grid, pbc: _bc.FieldBC, needs_ref: bool,
                        ref_cell: int, dtype=torch.float64, device=None,
                        solver: fastsolve.FastDiag = None):
    """Returns precond(r, dp_scale) -> z. `solver`, when given, is the
    prebuilt fastsolve.pressure_preconditioner for these BCs."""
    if solver is None:
        solver = fastsolve.pressure_preconditioner(grid, pbc, dtype, device)
    inv_vol = 1.0 / grid.cell_volume  # scalar or (nx,ny,nz)
    if not grid.uniform:
        inv_vol = torch.as_tensor(inv_vol, dtype=dtype, device=device)

    def precond(r, dp_scale):
        # operator A = L * Dp (negative definite, volume-integrated);
        # the fastdiag inverts the volume-NORMALIZED (-V^-1 L):
        # L^-1 r = -solve(r/V, 0), so A^-1 r = -solve(r/V, 0)/Dp
        z = solver.solve(r * inv_vol, 0.0, project_null=True)
        return -z / dp_scale

    return precond
