"""Matrix-free preconditioned conjugate gradient (port of
``sedifoam_tpu/linsolve.py::pcg``).

Convergence uses OpenFOAM's residual normalisation, so tolerance-based
termination gives comparable answers:

    normFactor = sum(|A x - A xRef| + |b - A xRef|),  xRef = mean(x) * ones

The reference's lax.while_loop is a Python loop with the same stop rule
(tolerance floored at the dtype's round-off, relative tolerance, stall
counter, finite check); deciding to stop costs one host sync per
iteration.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

_SMALL = 1e-300  # solverPerformance::small_ analogue (f64)


class SolveResult(NamedTuple):
    x: torch.Tensor
    initial_residual: torch.Tensor
    final_residual: torch.Tensor
    n_iterations: torch.Tensor


def norm_factor(apply_fn: Callable, x, b):
    """OpenFOAM lduMatrix::normFactor."""
    xref = torch.mean(x)
    Aref = apply_fn(torch.zeros_like(x) + xref)
    Ax = apply_fn(x)
    return torch.sum(torch.abs(Ax - Aref) + torch.abs(b - Aref)) + _SMALL


def _dtype_tol_floor(dtype) -> float:
    """Smallest meaningful normalized residual for a dtype (~50 eps)."""
    return float(50 * torch.finfo(dtype).eps)


def _safe_ratio(num, den):
    """num/den with a hard guard, scaled to the dtype, against
    denominators that would overflow or NaN the ratio at round-off
    stagnation."""
    fi = torch.finfo(den.dtype)
    bad = torch.abs(den) < torch.abs(num) * (4.0 / fi.max) + fi.tiny
    return torch.where(bad, torch.zeros_like(num),
                       num / torch.where(bad, torch.ones_like(den), den))


def pcg(apply_fn: Callable, b, x0, diag, tol: float = 1e-10,
        rel_tol: float = 0.0, max_iter: int = 1000,
        precond: Callable = None) -> SolveResult:
    """Preconditioned conjugate gradient (Jacobi unless `precond` given).

    apply_fn must be LINEAR and symmetric (positive or negative) definite
    in the flattened cell space. Stops on the normalized tolerance, the
    relative tolerance, max_iter, 8 iterations without a 0.1% improvement
    (round-off stagnation), or a non-finite residual.
    """
    tol = max(tol, _dtype_tol_floor(x0.dtype))
    if precond is None:
        inv_diag = 1.0 / torch.where(diag == 0.0, torch.ones_like(diag),
                                     diag)
        precond = lambda r: inv_diag * r  # noqa: E731 (Jacobi default)

    nf = norm_factor(apply_fn, x0, b)
    r = b - apply_fn(x0)
    res0 = torch.sum(torch.abs(r)) / nf
    x, p = x0, torch.zeros_like(x0)
    rz_old = torch.ones((), dtype=x0.dtype, device=x0.device)
    res, best = res0, res0
    stall = torch.zeros((), dtype=torch.int32, device=x0.device)
    it = 0
    while it < max_iter:
        go = (res > tol) & (res > rel_tol * res0) & (stall < 8) \
            & torch.isfinite(res)
        if not bool(go):                                # host sync
            break
        z = precond(r)
        rz = torch.sum(r * z)
        beta = torch.zeros_like(rz) if it == 0 else _safe_ratio(rz, rz_old)
        p = z + beta * p
        Ap = apply_fn(p)
        pAp = torch.sum(p * Ap)
        alpha = _safe_ratio(rz, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        res = torch.sum(torch.abs(r)) / nf
        improved = res < 0.999 * best
        stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
        best = torch.minimum(best, res)
        rz_old = rz
        it += 1
    return SolveResult(x, res0, res,
                       torch.tensor(it, dtype=torch.int32, device=x0.device))
