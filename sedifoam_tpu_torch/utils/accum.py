"""Compensated global reductions (port of ``sedifoam_tpu/utils/accum.py``).

The reference accumulates its conservation audits in C++ doubles
(enhancedCloud.C:395-435 Ftotal/Utotal, chPressureGrad.C:242-257 the
beta*V-weighted Ubar mean). A plain f32 sum's rounding error grows with
the length and the magnitude spread of the data.

`stable_sum` reduces in two stages:

1. block partial sums (vectorized, error ~ eps * log2(block) within a
   narrow magnitude band);
2. a Neumaier two-sum scan over the ~n/block partials carrying an
   explicit compensation term, so the sequential combine is exact to
   one final rounding.

The scan is a Python loop over 0-d tensors, as the reference's
`lax.scan` is sequential: about ten small kernels per partial, no host
sync. f64 inputs and inputs of at most one block take a plain sum.

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


def stable_sum(x, policy: str = "compensated"):
    """Scalar sum of all elements of `x` with compensated accumulation."""
    x = _flat(x)
    if policy == "native" or x.dtype == torch.float64 or \
            x.numel() <= _BLOCK:
        return torch.sum(x)
    pad = (-x.numel()) % _BLOCK
    if pad:
        x = torch.cat([x, torch.zeros(pad, dtype=x.dtype, device=x.device)])
    partials = torch.sum(x.reshape(-1, _BLOCK), dim=1)

    s = torch.zeros((), dtype=x.dtype, device=x.device)
    c = torch.zeros((), dtype=x.dtype, device=x.device)
    for v in partials.unbind():
        t = s + v
        # Neumaier: recover the rounding error of s+v exactly
        c = c + torch.where(torch.abs(s) >= torch.abs(v),
                            (s - t) + v, (v - t) + s)
        s = t
    return s + c


def stable_dot(a, b, policy: str = "compensated"):
    """Compensated sum(a*b) — the weighted means of chPressureGrad and
    the V-weighted audit totals."""
    a = a.reshape(-1) if isinstance(a, torch.Tensor) else a
    b = b.reshape(-1) if isinstance(b, torch.Tensor) else b
    return stable_sum(a * b, policy)


def stable_mean(x, w, policy: str = "compensated"):
    """Compensated weighted mean sum(x*w)/sum(w)."""
    return stable_dot(x, w, policy) / stable_sum(w, policy)
