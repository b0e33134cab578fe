"""The fluid split along grid-x over ranks (sedifoam_tpu_torch/grid.py's
SlabGrid, parallel/step.ShardedStep), in f64 on the CPU with gloo ranks
spawned from the test (parallel/launch.run_ranks), against the port's
one-process step and against sedifoam_tpu.

- Every stencil operator of ops.py, linop.py (diag, rhs and apply of
  div and laplacian, A and H of a relaxed sum of terms) and fluid/piso.py
  (div_tensor, reconstruct) on the slabs of 2 and 4 ranks, joined,
  equals the whole grid's call bit for bit: on a uniform grid with
  cyclic x and z, and on a grid graded along all three axes with
  fixedValue, inletOutlet and zeroGradient x ends (tests/
  torch_port_slabs.py, the rank job).
- The FastDiag solve on the slabs (each rank gathers the right-hand
  side and solves on the whole grid), solve with the null mode
  projected and solve_pow, PCG (preconditioned by the FastDiag),
  pcg_multi and BiCGStab, and the grid's plane-ordered total and means,
  equal the one-process calls bit for bit, the solvers in as many
  iterations.
- The coarse transport-bedload channel (16 x 13 x 6 cells: cyclic x and
  z, graded y, kEqn LES, Ubar forcing, the semi-implicit drag; the set-up
  of tests/test_torch_channel.py with nx = 16, so that 2 and 4 ranks
  split it), 3 steps split over 2 and 4 ranks: every field equals the
  port's one-process run bit for bit; within test_torch_channel.py's
  1e-9 of each field's scale of the JAX package's one-device step and
  of its shard_state(..., make_mesh(8)) step (Ua and what is built from
  it compared as there).
- Each rank holds 1/R of the bytes of p, Ub and alpha, and the step
  reports the "slab" layout and the collectives of the split fluid.
- The channel at nx = 15 on 2 ranks (15 does not divide by 2) steps
  with the fluid whole on every rank and says so.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu.io.case import load_case as jload  # noqa: E402
from sedifoam_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from sedifoam_tpu.parallel.mesh import shard_state as jshard  # noqa: E402
from sedifoam_tpu.solver import coupled_step as jcoupled  # noqa: E402
from sedifoam_tpu.solver import initialize as jinit  # noqa: E402
from sedifoam_tpu_torch import bridge, cases  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.io.case import load_case as tload  # noqa: E402
from sedifoam_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from sedifoam_tpu_torch.parallel.step import FIELDS, run_steps  # noqa: E402
from torch_port_slabs import slab_ops_job  # noqa: E402
from torch_port_util import assert_tree_close, few_threads  # noqa: E402,F401
from torch_port_util import rel_err  # noqa: E402

RANKS = [2, 4]
TIMEOUT = 240.0            # seconds a spawn of ranks may take
STEPS = 3
ILL_CONDITIONED = ("Ua", "Ua_old", "phia", "phia_old", "DDtUa")
SOLVES = ("FastDiag.solve", "FastDiag.solve project_null",
          "FastDiag.solve_pow", "pcg", "pcg_multi", "bicgstab",
          "grid.total", "grid.mean x faces")


def _bitwise(ref, got, path=""):
    """Every leaf of two nested numpy dicts equal bit for bit."""
    assert set(ref) == set(got), path
    for k, a in ref.items():
        if isinstance(a, dict):
            _bitwise(a, got[k], f"{path}.{k}")
        elif a is not None:
            a, b = np.asarray(a), np.asarray(got[k])
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), \
                f"{path}.{k}"


@pytest.fixture(scope="module")
def slab_ops():
    """ranks -> rank 0's result of the rank job, spawned once each."""
    done = {}

    def run(ranks):
        if ranks not in done:
            done[ranks] = run_ranks(slab_ops_job, ranks, args=(5,),
                                    device="cpu", timeout=TIMEOUT)[0]
        return done[ranks]
    return run


@pytest.mark.parametrize("kind", ["uniform-cyclic", "graded"])
@pytest.mark.parametrize("ranks", RANKS)
def test_stencils_on_slabs_equal_the_whole_grid(slab_ops, ranks, kind):
    res = slab_ops(ranks)[kind]
    ops_ok = {k: v for k, v in res.items()
              if k not in SOLVES and k != "iterations"}
    assert len(ops_ok) == 24
    assert [k for k, v in ops_ok.items() if not v] == []
    assert slab_ops(ranks)["bytes"]["collective-permute"] > 0


@pytest.mark.parametrize("kind", ["uniform-cyclic", "graded"])
@pytest.mark.parametrize("ranks", RANKS)
def test_solvers_on_slabs_equal_one_process(slab_ops, ranks, kind):
    res = slab_ops(ranks)[kind]
    assert [k for k in SOLVES if not res[k]] == []
    whole, split = res["iterations"]
    assert whole == split and min(whole.values()) > 1
    # every FastDiag solve gathers its right-hand side and solves whole
    # (fastsolve.py): no transposes
    kinds = slab_ops(ranks)["bytes"]
    assert "all-to-all" not in kinds and kinds["all-gather"] > 0


def _semi(cfg):
    return dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=True))


def _channel(tmp, counts):
    case = cases.write_channel_case(str(tmp / f"channel{counts[0]}"),
                                    counts=counts, layers=2, overlap=2e-6)
    ct, ft, pt, _ = tload(case, backend="binned", device="cpu")
    ct = _semi(ct)
    state = tsolver.CoupledStep(ct, device="cpu").initialize(ft, pt)
    return case, ct, state


@pytest.fixture(scope="module")
def channel(tmp_path_factory):
    """The 16 x 13 x 6 channel: (port cfg, initial state as numpy, the
    port's one-process states after each step, the JAX package's
    one-device and sharded states after the last)."""
    case, ct, st = _channel(tmp_path_factory.mktemp("slab"), (16, 13, 6))
    snp = bridge.sim_state_to_numpy(st)
    n = torch.get_num_threads()
    torch.set_num_threads(1)            # as in the ranks
    try:
        step = tsolver.CoupledStep(ct, device="cpu")
        refs = []
        for _ in range(STEPS):
            st = step(st)
            refs.append(bridge.sim_state_to_numpy(st))
    finally:
        torch.set_num_threads(n)
    cj, fj, pj, _ = jload(case, backend="binned", dtype=jnp.float64)
    cj = _semi(cj)
    sj = jinit(fj, pj, cj)
    step_j = jax.jit(lambda s: jcoupled(s, cj))
    one, sharded = sj, jshard(sj, jmake_mesh(8))
    for _ in range(STEPS):
        one, sharded = step_j(one), step_j(sharded)
    assert len(sharded.fluid.p.sharding.device_set) == 8
    return (ct, snp, refs, bridge.sim_state_to_numpy(one),
            bridge.sim_state_to_numpy(sharded))


@pytest.fixture(scope="module")
def channel_runs(channel):
    done = {}

    def run(ranks):
        if ranks not in done:
            ct, snp = channel[:2]
            done[ranks] = run_ranks(run_steps, ranks,
                                    args=(ct, snp, STEPS), device="cpu",
                                    timeout=TIMEOUT)
        return done[ranks]
    return run


@pytest.mark.parametrize("ranks", RANKS)
def test_split_channel_equals_one_process_bitwise(channel, channel_runs,
                                                  ranks):
    res = channel_runs(ranks)
    for i, ref in enumerate(channel[2], 1):
        _bitwise(ref, res[0]["states"][i])
    assert all(r["fluid"] == "slab" for r in res)


@pytest.mark.parametrize("which", ["one device", "shard_state on 8"])
@pytest.mark.parametrize("ranks", RANKS)
def test_split_channel_matches_the_jax_package(channel, channel_runs,
                                               ranks, which):
    ref = channel[3] if which == "one device" else channel[4]
    got = channel_runs(ranks)[0]["states"][STEPS]
    assert_tree_close(ref, got, 1e-9, skip=ILL_CONDITIONED)
    assert rel_err(ref["fluid"]["alpha"][None] * ref["fluid"]["Ua"],
                   got["fluid"]["alpha"][None] * got["fluid"]["Ua"]) <= 1e-9
    assert got["fluid"]["grad_p_value"] > 0.0


@pytest.mark.parametrize("ranks", RANKS)
def test_grid_fields_split_per_rank_memory(channel, channel_runs, ranks):
    whole = channel[1]["fluid"]
    res = channel_runs(ranks)
    for r in res:
        for name in FIELDS:
            assert r["fields"][name] * ranks == whole[name].nbytes, name
        for kinds in r["comm"]:
            assert {"collective-permute", "all-to-all", "all-gather",
                    "collective-broadcast"} <= set(kinds)


def test_undivided_grid_steps_whole(tmp_path):
    """nx = 15 on 2 ranks: the fluid stays whole on every rank (its P2G
    sums partial grids over the ranks, in another order than one
    process: within 1e-9 of each field's scale after a step)."""
    _, ct, st = _channel(tmp_path, (15, 13, 6))
    snp = bridge.sim_state_to_numpy(st)
    res = run_ranks(run_steps, 2, args=(ct, snp, 1), device="cpu",
                    timeout=TIMEOUT)
    ref = bridge.sim_state_to_numpy(tsolver.CoupledStep(ct, device="cpu")(st))
    for r in res:
        assert r["fluid"] == "whole"
        for name in FIELDS:
            assert r["fields"][name] == snp["fluid"][name].nbytes
        assert "collective-permute" not in r["comm"][0]
    assert_tree_close(ref, res[0]["states"][1], 1e-9, skip=ILL_CONDITIONED)
