"""Compensated global reductions (port of ``sedifoam_tpu/utils/accum.py``).

The reference accumulates its conservation audits in C++ doubles
(enhancedCloud.C:395-435 Ftotal/Utotal, chPressureGrad.C:242-257 the
beta*V-weighted Ubar mean). A plain f32 sum's rounding error grows with
the length and the magnitude spread of the data.

`stable_sum` reduces in two stages:

1. block partial sums (vectorized, error ~ eps * log2(block) within a
   narrow magnitude band), as the reference;
2. the ~n/block partials are summed in float64 and the total is rounded
   once to the input's dtype.

The reference combines its partials with a Neumaier two-sum scan
(`lax.scan`, compiled into one program) so that the sequential combine is
exact to one final rounding. Eager PyTorch would run that scan as a
Python loop of 0-d tensors: about ten launches a partial, 5,000 for the
546,000 cells of a channel mesh. A float64 sum of float32 partials gives
the same guarantee in two launches and no host sync: each partial is
exact in float64, and the sum of m of them carries at most m * 2^-53 of
their magnitudes, nine orders below float32's own rounding for any m a
grid gives. (An error-free pairwise tree in float32 would need log2(m)
levels of two-sums and a compensation array for the same result.) f64
inputs and inputs of at most one block take a plain sum.

Given the fluid's Grid (`grid=`), a grid field is summed by the grid
instead: each grid-x plane, then the planes in x order (grid.Grid.total),
the plane sums of an f32 field added in float64 and rounded once; on a
slab of a fluid split over ranks (grid.SlabGrid) the planes are
gathered from the ranks first, so every rank has the one-process sum
bit for bit.

The policy knob (`FluidConfig.dtype_policy` / the `policy=` argument):
  "compensated" (default)  — the scheme above on the native dtype
  "native"                 — plain torch.sum
"""

from __future__ import annotations

import numpy as np
import torch

_BLOCK = 1024


def _flat(x):
    """x as a flat tensor; Python and numpy scalars keep their precision
    (torch.as_tensor would make a Python float float32)."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    return x.reshape(-1)


def stable_sum(x, policy: str = "compensated", grid=None):
    """Scalar sum of all elements of `x` with compensated accumulation
    (of a grid field (nx, ny, nz) of `grid`: plane by plane)."""
    if grid is not None:
        return grid.total(x, compensated=policy != "native")
    x = _flat(x)
    if policy == "native" or x.dtype == torch.float64 or \
            x.numel() <= _BLOCK:
        return torch.sum(x)
    pad = (-x.numel()) % _BLOCK
    if pad:
        x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)])
    partials = torch.sum(x.reshape(-1, _BLOCK), dim=1)

    return torch.sum(partials, dtype=torch.float64).to(x.dtype)


def stable_dot(a, b, policy: str = "compensated", grid=None):
    """Compensated sum(a*b) — the weighted means of chPressureGrad and
    the V-weighted audit totals."""
    if grid is not None:
        return stable_sum(a * b, policy, grid)
    a = a.reshape(-1) if isinstance(a, torch.Tensor) else a
    b = b.reshape(-1) if isinstance(b, torch.Tensor) else b
    return stable_sum(a * b, policy)


def stable_mean(x, w, policy: str = "compensated"):
    """Compensated weighted mean sum(x*w)/sum(w)."""
    return stable_dot(x, w, policy) / stable_sum(w, policy)
