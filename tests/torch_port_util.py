"""Shared helpers for the tests of sedifoam_tpu_torch
(tests/test_torch_*.py): those that hold it against sedifoam_tpu, and
those that run the port alone, on the CPU and on the card (`devices`,
`by_tag`, `chain_kernel_ran`, `Stepper`; tests/test_torch_physics_*.py).
Imports nothing of JAX."""

import contextlib

import numpy as np
import pytest
import torch

from sedifoam_tpu_torch import bridge


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two PyTorch threads while a module's tests run. The test files run
    in several worker processes at once, and PyTorch's default of a
    thread per core in each of them oversubscribes the machine: the
    barriers of its many small parallel regions then wait for
    descheduled threads, and a step of seconds takes minutes. Import
    this into a test module to use it."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def rel_err(ref, got):
    """max |ref - got| / max |ref|: the error relative to the field's
    scale (elementwise relative error is meaningless at exact zeros)."""
    ref = _np(ref).astype(np.float64)
    got = _np(got).astype(np.float64)
    assert ref.shape == got.shape, (ref.shape, got.shape)
    if ref.size == 0:
        return 0.0
    return float(np.max(np.abs(ref - got)) / (np.max(np.abs(ref)) + 1e-300))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def particles_to_torch(jax_particles, dtype=None):
    """A sedifoam_tpu ParticleState -> the port's, field by field."""
    return bridge.particle_state_from_numpy(
        bridge.tree_to_numpy(jax_particles), dtype=dtype)


def fluid_to_torch(jax_fluid, dtype=None):
    return bridge.fluid_state_from_numpy(bridge.tree_to_numpy(jax_fluid),
                                         dtype=dtype)


def assert_tree_close(ref, got, tol, skip=(), path=""):
    """Compare two nested numpy dicts (bridge.tree_to_numpy) leaf by
    leaf; floats by rel_err <= tol, everything else exactly. Returns the
    worst float deviation seen."""
    worst = 0.0
    assert set(ref) == set(got), (path, set(ref) ^ set(got))
    for k in ref:
        if k in skip:
            continue
        a, b = ref[k], got[k]
        where = f"{path}.{k}"
        if isinstance(a, dict):
            worst = max(worst, assert_tree_close(a, b, tol, skip, where))
        elif a is None:
            assert b is None, where
        elif np.issubdtype(np.asarray(a).dtype, np.floating):
            e = rel_err(a, b)
            assert e <= tol, f"{where}: rel err {e:.3e} > {tol:.1e}"
            worst = max(worst, e)
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                          err_msg=where)
    return worst


def devices(slow=False):
    """The `device` parameters of a test of the port alone: "cpu", which
    always runs, and "cuda", marked `cuda` and skipped where no card is
    present; with `slow`, both marked `slow` as well."""
    extra = [pytest.mark.slow] if slow else []
    cuda = [pytest.mark.cuda,
            pytest.mark.skipif(not torch.cuda.is_available(),
                               reason="needs a CUDA card")]
    return [pytest.param("cpu", id="cpu", marks=extra),
            pytest.param("cuda", id="cuda", marks=cuda + extra)]


DEVICES = devices()


def by_tag(state, *fields):
    """The given (N, ...) fields of a port ParticleState on any device,
    as host numpy arrays of its ACTIVE rows sorted by tag (the binned
    backend may re-sort rows at a rebuild: identity is the tag, not the
    row), so states of different capacity compare directly. One field
    gives one array, several a list."""
    tag = _np(state.tag)
    rows = np.where(_np(state.active))[0]
    order = rows[np.argsort(tag[rows], kind="stable")]
    out = [_np(getattr(state, f))[order] for f in fields]
    return out if len(out) > 1 else out[0]


@contextlib.contextmanager
def chain_kernel_ran(device, binned=True):
    """Around a case that steps the binned contact chain (`binned`): on
    a CUDA device, asserts that the kernel's launch count
    (dem.fused.launches(), eager and inside replayed graphs) grew across
    the case, so the kernel ran and no plain version stood in for it.
    Nothing is checked on the CPU, where the plain version is the
    chain."""
    if not binned or torch.device(device).type != "cuda":
        yield
        return
    from sedifoam_tpu_torch.dem import fused
    before = fused.launches()
    yield
    assert fused.launches() > before, \
        "the contact-chain kernel was never launched"


class Stepper:
    """state = fn(state), n times, for the long runs of a test. On the
    CPU, and for fewer than `block` steps, an eager loop. On a CUDA
    device whole blocks of `block` steps replay one captured graph of
    them (graphs.StepGraph, captured at the first block: an eager
    warm-up with every branch run, then the capture), and the remainder
    runs eagerly: the steps are the same, one graph launch a block in
    place of a Python loop of kernels. run returns a copy that outlives
    the next replay."""

    def __init__(self, fn, block):
        self.fn, self.block, self.graph = fn, block, None

    def _loop(self, state, n):
        for _ in range(n):
            state = self.fn(state)
        return state

    def run(self, state, n):
        from sedifoam_tpu_torch import graphs
        if graphs.flatten(state)[0].device.type != "cuda" or n < self.block:
            return self._loop(state, n)
        if self.graph is None:
            self.graph = graphs.StepGraph(
                lambda st: self._loop(st, self.block)).capture(state)
        for _ in range(n // self.block):
            state = self.graph.replay(state)
        state = graphs.tree_map(torch.clone, state)
        return self._loop(state, n % self.block)


def dem_stepper(cfg, block=100):
    """A Stepper of DEM substeps (dem.integrate.run_dem one substep at a
    time). Each substep takes its step time as 0, which only a wiggled
    wall reads: those are refused."""
    from sedifoam_tpu_torch.dem.integrate import run_dem
    if any(w.wiggle for w in cfg.walls):
        raise ValueError("dem_stepper: a wiggled wall reads the step time")
    return Stepper(lambda st: run_dem(st, cfg, 1), block)


def fluid_stepper(grid, bcs, cfg, device, block=10):
    """A Stepper of fluid_step(fs, grid, bcs, cfg), `block` steps a
    captured graph on the card, with the pressure preconditioner built
    once (the operator fluid_step builds itself when given none) as the
    port's coupled step builds it."""
    from sedifoam_tpu_torch import fastsolve
    from sedifoam_tpu_torch.fluid.step import fluid_step
    pp = fastsolve.pressure_preconditioner(grid, bcs.p, torch.float64, device)
    return Stepper(lambda s: fluid_step(s, grid, bcs, cfg, pprecond=pp),
                   block)
