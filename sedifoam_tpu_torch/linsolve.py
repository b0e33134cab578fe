"""Matrix-free preconditioned linear solvers (port of
``sedifoam_tpu/linsolve.py``: ``pcg`` for the pressure Poisson,
``bicgstab`` for the nonsymmetric k/epsilon transport equations).

Convergence uses OpenFOAM's residual normalisation, so tolerance-based
termination gives comparable answers:

    normFactor = sum(|A x - A xRef| + |b - A xRef|),  xRef = mean(x) * ones

The reference's lax.while_loop is graphs.while_loop with the same
carry, body and stop rule (tolerance floored at the dtype's round-off,
relative tolerance, stall counter, finite check, max_iter): inside a
captured step it is a WHILE node that tests the stop rule on the device;
run eagerly it reads the rule on the host once per iteration. `STATS`
counts solves and iterations per solver on the device (a captured solve
counts at every replay) and turns them into numbers when read.

``pcg_multi`` drives a batch of systems that share one operator (the
smoothing's PCG branch, coupling/smoothing.py with USE_FASTDIAG off).

`grid`: the fluid's Grid, whose `total` and `mean` reduce a field plane
by plane along grid-x and, on a slab of a fluid split over ranks
(grid.SlabGrid), over the ranks: the dots, norms and the stop rule are
then the same on every rank, and equal to one process's bit for bit.
Without one the reductions are plain torch.sum and torch.mean.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Callable, NamedTuple

import torch

from sedifoam_tpu_torch import graphs, telemetry

_SMALL = 1e-300  # solverPerformance::small_ analogue (f64)

class _Stats(Mapping):
    """[solves, iterations] per solver since the last reset_stats(),
    kept in the telemetry registry as one int64 pair per solver and
    device on the device (``linsolve.<solver>``: written in place, so a
    captured step adds to the same pair at every replay) and summed on
    the host only when read."""

    NAMES = ("pcg", "pcg_multi", "bicgstab")
    PREFIX = "linsolve."
    FIELDS = ("solves", "iterations")

    def add(self, name, it):
        c = telemetry.counter(self.PREFIX + name, it.device, self.FIELDS)
        c[0].add_(1)
        c[1].add_(it)

    def __getitem__(self, name):
        if name not in self.NAMES:
            raise KeyError(name)
        return telemetry.REGISTRY.value(self.PREFIX + name) or [0, 0]

    def __iter__(self):
        return iter(self.NAMES)

    def __len__(self):
        return len(self.NAMES)

    def reset(self):
        telemetry.REGISTRY.reset(self.PREFIX)

    def snapshot(self):
        return telemetry.snapshot(self.PREFIX)

    def restore(self, saved):
        """Put the counts of snapshot() back, in place (the device
        counters a captured step adds to stay the same tensors)."""
        telemetry.restore(saved, self.PREFIX)


STATS = _Stats()


def reset_stats():
    STATS.reset()


class SolveResult(NamedTuple):
    x: torch.Tensor
    initial_residual: torch.Tensor
    final_residual: torch.Tensor
    n_iterations: torch.Tensor


def _reductions(grid):
    """(total, mean) over a field's cells: the grid's, or torch's."""
    if grid is None:
        return torch.sum, torch.mean
    return grid.total, grid.mean


def norm_factor(apply_fn: Callable, x, b, grid=None):
    """OpenFOAM lduMatrix::normFactor."""
    total, mean = _reductions(grid)
    xref = mean(x)
    Aref = apply_fn(torch.zeros_like(x) + xref)
    Ax = apply_fn(x)
    return total(torch.abs(Ax - Aref) + torch.abs(b - Aref)) + _SMALL


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
        precond: Callable = None, grid=None) -> SolveResult:
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

    total, _ = _reductions(grid)
    nf = norm_factor(apply_fn, x0, b, grid)
    r0 = b - apply_fn(x0)
    res0 = total(torch.abs(r0)) / nf

    def cond(state):
        x, r, p, rz, it, res, best, stall = state
        not_conv = (res > tol) & (res > rel_tol * res0)
        return not_conv & (it < max_iter) & (stall < 8) & torch.isfinite(res)

    def body(state):
        x, r, p, rz_old, it, _, best, stall = state
        z = precond(r)
        rz = total(r * z)
        beta = torch.where(it == 0, torch.zeros_like(rz),
                           _safe_ratio(rz, rz_old))
        p = z + beta * p
        Ap = apply_fn(p)
        pAp = total(p * Ap)
        alpha = _safe_ratio(rz, pAp)
        x = x + alpha * p
        r = r - alpha * Ap
        res = total(torch.abs(r)) / nf
        improved = res < 0.999 * best
        stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
        best = torch.minimum(best, res)
        return (x, r, p, rz, it + 1, res, best, stall)

    zero = torch.zeros((), dtype=torch.int32, device=x0.device)
    init = (x0, r0, torch.zeros_like(x0),
            torch.ones((), dtype=x0.dtype, device=x0.device), zero,
            res0, res0, zero)
    x, r, p, rz, it, res, best, stall = graphs.while_loop(cond, body, init)
    STATS.add("pcg", it)
    return SolveResult(x, res0, res, it)


def pcg_multi(apply_fn: Callable, b, x0, diag, tol: float = 1e-10,
              rel_tol: float = 0.0, max_iter: int = 1000,
              grid=None) -> SolveResult:
    """PCG for a batch of systems sharing one SPD operator.

    b, x0: (B, ...) with the batch axis leading; apply_fn acts on a
    single (...)-shaped field (the reference vmaps it; here it runs once
    per system). One while_loop drives all B systems with per-system
    step sizes; it stops when every system has converged, at max_iter,
    after 10 iterations without a 0.1% improvement of the worst residual,
    or on a non-finite residual.
    """
    tol = max(tol, _dtype_tol_floor(x0.dtype))
    inv_diag = 1.0 / torch.where(diag == 0.0, torch.ones_like(diag), diag)
    axes = tuple(range(1, x0.dim()))
    bshape = (-1,) + (1,) * (x0.dim() - 1)

    def vapply(x):
        return torch.stack([apply_fn(x[i]) for i in range(x.shape[0])])

    def total(a):
        """Per system: the sum over its cells."""
        return torch.sum(a, dim=axes) if grid is None else grid.total(a)

    def dot(a, c):
        return total(a * c)

    nf = torch.stack([norm_factor(apply_fn, x0[i], b[i], grid)
                      for i in range(x0.shape[0])])
    r0 = b - vapply(x0)
    res0 = total(torch.abs(r0)) / nf

    def cond(state):
        x, r, p, rz, it, res, best, stall = state
        not_conv = torch.any((res > tol) & (res > rel_tol * res0))
        return not_conv & (it < max_iter) & (stall < 10) & \
            torch.all(torch.isfinite(res))

    def body(state):
        x, r, p, rz_old, it, _, best, stall = state
        z = inv_diag[None] * r
        rz = dot(r, z)
        beta = torch.where(it == 0, torch.zeros_like(rz),
                           _safe_ratio(rz, rz_old))
        p = z + beta.reshape(bshape) * p
        Ap = vapply(p)
        alpha = _safe_ratio(rz, dot(p, Ap))
        al = alpha.reshape(bshape)
        x = x + al * p
        r = r - al * Ap
        res = total(torch.abs(r)) / nf
        worst = torch.max(res)
        improved = worst < 0.999 * best
        stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
        best = torch.minimum(best, worst)
        return (x, r, p, rz, it + 1, res, best, stall)

    zero = torch.zeros((), dtype=torch.int32, device=x0.device)
    init = (x0, r0, torch.zeros_like(x0), torch.ones_like(res0), zero,
            res0, torch.max(res0), zero)
    x, r, p, rz, it, res, best, stall = graphs.while_loop(cond, body, init)
    STATS.add("pcg_multi", it)
    return SolveResult(x, res0, res, it)


def bicgstab(apply_fn: Callable, b, x0, diag, tol: float = 1e-10,
             rel_tol: float = 0.0, max_iter: int = 1000,
             grid=None) -> SolveResult:
    """Jacobi-preconditioned BiCGStab for nonsymmetric operators
    (convection-diffusion: the k/epsilon transport equations). Right
    preconditioning: solve A M^-1 y = b, x = M^-1 y. Stops as pcg does,
    with 10 stalled iterations."""
    tol = max(tol, _dtype_tol_floor(x0.dtype))
    inv_diag = 1.0 / torch.where(diag == 0.0, torch.ones_like(diag), diag)

    def prec_apply(v):
        return apply_fn(inv_diag * v)

    total, _ = _reductions(grid)
    nf = norm_factor(apply_fn, x0, b, grid)
    y0 = diag * x0
    r0 = b - prec_apply(y0)
    rhat = r0
    res0 = total(torch.abs(r0)) / nf

    def cond(state):
        y, r, p, v, rho, alpha, omega, it, res, best, stall = state
        not_conv = (res > tol) & (res > rel_tol * res0)
        return not_conv & (it < max_iter) & (stall < 10) & \
            torch.isfinite(res)

    def body(state):
        y, r, p, v, rho_old, alpha, omega, it, _, best, stall = state
        rho = total(rhat * r)
        beta = _safe_ratio(rho, rho_old) * _safe_ratio(alpha, omega)
        beta = torch.where(it == 0, torch.zeros_like(beta), beta)
        p = r + beta * (p - omega * v)
        v = prec_apply(p)
        alpha = _safe_ratio(rho, total(rhat * v))
        s = r - alpha * v
        t = prec_apply(s)
        omega = _safe_ratio(total(t * s), total(t * t))
        y = y + alpha * p + omega * s
        r = s - omega * t
        res = total(torch.abs(r)) / nf
        improved = res < 0.999 * best
        stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
        best = torch.minimum(best, res)
        return (y, r, p, v, rho, alpha, omega, it + 1, res, best, stall)

    one = torch.ones((), dtype=x0.dtype, device=x0.device)
    zero = torch.zeros((), dtype=torch.int32, device=x0.device)
    init = (y0, r0, torch.zeros_like(x0), torch.zeros_like(x0),
            one, one, one, zero, res0, res0, zero)
    y, r, p, v, rho, alpha, omega, it, res, best, stall = graphs.while_loop(
        cond, body, init)
    STATS.add("bicgstab", it)
    return SolveResult(inv_diag * y, res0, res, it)
