"""Shared helpers for the tests that hold sedifoam_tpu_torch against
sedifoam_tpu (tests/test_torch_*.py)."""

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
