"""Shared pieces of the tests that hold the split step on each
configuration (tests/test_torch_parallel_dem.py,
tests/test_torch_parallel_cases.py): the JAX package's tiny cases set up
by the port and carried back, the port's one-process run under one
thread (as each rank runs), the JAX package's jitted step, and the
comparisons of two states."""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sedifoam_tpu import solver as jsolver
from sedifoam_tpu.parallel.mesh import make_mesh as jmake_mesh
from sedifoam_tpu.parallel.mesh import shard_state as jshard
from sedifoam_tpu.solver import coupled_step as jcoupled
from sedifoam_tpu_torch import bridge
from sedifoam_tpu_torch import solver as tsolver
from sedifoam_tpu_torch.dem import lubrication as tlub
from torch_port_cases import port_config

ge = importlib.import_module("__graft_entry__")

RANKS = [2, 4]
STEPS = 2
TIMEOUT = 300.0            # seconds a spawn of ranks may take
# the tolerance of the port's one-process step against the JAX package's
# jitted one (tests/test_torch_parallel.py's): p and vel
RTOL, ATOL = 1e-10, 1e-12


def to_port(cfg_j):
    """A JAX SimConfig as the port's (port_config, and the lubrication
    parameters, which live in dem/lubrication.py in both packages)."""
    lub = cfg_j.dem.lubrication
    cfg = port_config(dataclasses.replace(cfg_j, dem=dataclasses.replace(
        cfg_j.dem, lubrication=None)))
    if lub is not None:
        cfg = dataclasses.replace(cfg, dem=dataclasses.replace(
            cfg.dem, lubrication=tlub.LubricationParams(
                **dataclasses.asdict(lub))))
    return cfg


def tiny(**kw):
    """__graft_entry__._tiny_case's (cfg, fluid, particles) before its
    set-up (the JAX package's jitted initialize is left out: the port
    sets the case up, `setup`)."""
    init = jsolver.initialize
    jsolver.initialize = lambda fluid, particles, cfg: (fluid, particles)
    try:
        cfg, (fluid, particles) = ge._tiny_case(dtype=jnp.float64, **kw)
    finally:
        jsolver.initialize = init
    return cfg, fluid, particles


def _like(template, d):
    """The numpy tree d as a tree of the JAX package's NamedTuples,
    shaped and typed as `template`."""
    if template is None or d is None:
        return None
    if hasattr(template, "_fields"):
        return type(template)(**{k: _like(getattr(template, k), d[k])
                                 for k in template._fields})
    return jnp.asarray(np.asarray(d), dtype=template.dtype)


def setup(cfg_j, fluid_j, particles_j):
    """(port cfg, the state the port's initialize sets up, as numpy, and
    as the JAX package's SimState)."""
    cfg = to_port(cfg_j)
    fluid = bridge.fluid_state_from_numpy(bridge.tree_to_numpy(fluid_j),
                                          device="cpu")
    parts = bridge.particle_state_from_numpy(
        bridge.tree_to_numpy(particles_j), device="cpu")
    snp = bridge.sim_state_to_numpy(
        tsolver.CoupledStep(cfg, device="cpu").initialize(fluid, parts))
    template = jsolver.SimState(fluid_j, particles_j, fluid_j.Ub, fluid_j.Ub)
    return cfg, snp, _like(template, snp)


def one_process(cfg, snp, n_steps=STEPS):
    """The port's CoupledStep from the numpy state snp, n_steps steps on
    the CPU under one PyTorch thread (as a rank runs): the numpy states
    after each."""
    st = bridge.sim_state_from_numpy(snp, device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        step = tsolver.CoupledStep(cfg, device="cpu")
        out = []
        for _ in range(n_steps):
            st = step(st)
            out.append(bridge.sim_state_to_numpy(st))
    finally:
        torch.set_num_threads(n)
    return out


def jax_step(cfg_j, st_j, sharded=False):
    """The JAX package's jitted coupled_step from st_j (placed by its
    shard_state on 8 devices when `sharded`), as numpy."""
    if sharded:
        st_j = jshard(st_j, jmake_mesh(8))
    out = jax.jit(lambda s: jcoupled(s, cfg_j))(st_j)
    if sharded:
        assert len(out.fluid.p.sharding.device_set) == 8
    return bridge.sim_state_to_numpy(out)


def differ(ref, got, path=""):
    """The paths of the leaves of two nested numpy dicts that are not
    equal bit for bit."""
    assert set(ref) == set(got), (path, set(ref) ^ set(got))
    out = []
    for k, a in ref.items():
        where = f"{path}.{k}" if path else k
        if isinstance(a, dict):
            out += differ(a, got[k], where)
        elif a is None:
            if got[k] is not None:
                out.append(where)
        else:
            a, b = np.asarray(a), np.asarray(got[k])
            if a.shape != b.shape or a.tobytes() != b.tobytes():
                out.append(where)
    return out


def close_to_jax(ref_j, got):
    """The port's state after a step against the JAX package's: p and
    vel within RTOL/ATOL, pos within 1e-12/1e-14, every integer field
    (tags, the table, active) exactly."""
    np.testing.assert_allclose(got["fluid"]["p"], ref_j["fluid"]["p"],
                               rtol=RTOL, atol=ATOL, err_msg="p")
    for k, rtol, atol in (("vel", RTOL, ATOL), ("pos", 1e-12, 1e-14)):
        np.testing.assert_allclose(got["particles"][k],
                                   ref_j["particles"][k], rtol=rtol,
                                   atol=atol, err_msg=k)
    for k in ("tag", "active", "nbr_idx", "ptype"):
        np.testing.assert_array_equal(got["particles"][k],
                                      ref_j["particles"][k], err_msg=k)
