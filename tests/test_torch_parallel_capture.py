"""The split step as a capture sees it (parallel/step.ShardedStep and
GraphedShardedStep), in f64 on the CPU with gloo ranks spawned from the
test (parallel/launch.run_ranks; one spawn per rank count runs every
case, tests/torch_port_capture.rehearse_jobs).

A CUDA graph holds no host read and no shape that depends on the data.
On the CPU graphs.host_reads_forbidden() stands in for the capture: it
raises HostRead on any host read but the decisions of graphs.cond and
graphs.while_loop. The cases:

- sorted: __graft_entry__._tiny_case's binned bed (256 particles, 16 x
  8 x 8) with sort_on_rebuild and skin 0 (a rebuild at every substep),
  its rows in a seeded random order: the sorted rebuilds move rows
  between the ranks;
- channel: the coarse transport-bedload channel (16 x 13 x 6, the
  semi-implicit drag) of tests/test_torch_parallel_fluid.py, its fluid
  on slabs: the particle-to-grid sums go through the fixed-size
  exchange (coupling/transfer._to_slabs);
- jetflow: the written jetFlow case shrunk as tests/test_torch_jetflow.py
  shrinks it (cases.write_jetflow_case, 12 x 120 x 12 counts, a column
  of 4 cells, 20 substeps), 256 rows, with sort_on_rebuild, two set-up
  edits as chip_smoke.py's split_jetflow makes them: the add due in
  step 1, and 4 rows made active in the delete box;
- clumps: tests/test_torch_parallel_dem.py's 128 rigid dimers on the
  binned table.

For each, at 2 and 4 ranks: a step under host_reads_forbidden() equals
the port's one-process CoupledStep (one thread) bit for bit in every
field, check_replicas holding after it; a warm-up step under
graphs.warming() equals a plain eager step bit for bit, and so do the
Shard's gathered radius, mass, active (and mol) at its end (a rebuild
branch not taken, run on a copy in the warm-up, once rebound them). The
sorted case after one step is held against the JAX package's jitted
coupled_step on its shard_state(..., make_mesh(8)) placement (p and vel
within rtol 1e-10 / atol 1e-12, pos 1e-12 / 1e-14, integer fields
exactly). The fixed-size exchange hands each slab the rows of its cells
in their global order, as the data-sized exchange it replaces did, on a
shuffled bed; and GraphedShardedStep refuses gloo, naming it.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from sedifoam_tpu import solver as jsolver  # noqa: E402
from sedifoam_tpu_torch import bridge, cases  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.dem.neighbor import permute_particle_state  # noqa: E402
from sedifoam_tpu_torch.io.case import load_case as tload  # noqa: E402
from sedifoam_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from sedifoam_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from sedifoam_tpu_torch.parallel.step import GraphedShardedStep  # noqa: E402
from sedifoam_tpu_torch.parallel.step import ShardedStep  # noqa: E402
from torch_port_capture import exchange_job, rehearse_jobs  # noqa: E402
from torch_port_split import RANKS, TIMEOUT, _like  # noqa: E402
from torch_port_split import close_to_jax, differ, jax_step  # noqa: E402
from torch_port_split import one_process, setup, tiny  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from test_torch_parallel_dem import build as dem_build  # noqa: E402

CASES = ["sorted", "channel", "jetflow", "clumps"]
STEPS = 1
JET = dict(counts=(12, 120, 12), column_cells=4, add_interval=1.2e-3,
           dem_dt=1e-5)
JET_ROWS = 256
DELETE_ROWS = 4


def _shuffled(snp, seed):
    """The state snp with its rows in a seeded random order."""
    st = bridge.sim_state_from_numpy(snp, device="cpu")
    order = torch.as_tensor(np.random.RandomState(seed).permutation(
        st.particles.n_capacity))
    return bridge.sim_state_to_numpy(st._replace(
        particles=permute_particle_state(st.particles, order)))


def _sorted():
    """(JAX cfg, port cfg, the state as numpy, as the JAX package's)."""
    cfg_j, fluid_j, parts_j = tiny(nx=16, ny=8, nz=8, n_particles=256,
                                   sub_steps=2, backend="binned")
    cfg_j = dataclasses.replace(cfg_j, dem=dataclasses.replace(
        cfg_j.dem, sort_on_rebuild=True, skin=0.0))
    cfg, snp, _ = setup(cfg_j, fluid_j, parts_j)
    snp = _shuffled(snp, 11)
    template = jsolver.SimState(fluid_j, parts_j, fluid_j.Ub, fluid_j.Ub)
    return cfg_j, cfg, snp, _like(template, snp)


def _channel(tmp):
    case = cases.write_channel_case(str(tmp / "channel"), counts=(16, 13, 6),
                                    layers=2, overlap=2e-6)
    cfg, fluid, parts, _ = tload(case, backend="binned", device="cpu")
    cfg = dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=True))
    state = tsolver.CoupledStep(cfg, device="cpu").initialize(fluid, parts)
    return cfg, bridge.sim_state_to_numpy(state)


def _jetflow(tmp):
    """The shrunken jetFlow with the add due and DELETE_ROWS rows in the
    delete box (copies of an active row with fresh tags, at rest)."""
    case = cases.write_jetflow_case(str(tmp / "jetFlow"), **JET)
    cfg, fluid, parts, _ = tload(case, backend="binned", embed_ogrid=True,
                                 capacity=JET_ROWS, device="cpu")
    cfg = dataclasses.replace(cfg, dem=dataclasses.replace(
        cfg.dem, sort_on_rebuild=True))
    state = tsolver.CoupledStep(cfg, device="cpu").initialize(fluid, parts)
    snp = bridge.sim_state_to_numpy(state)
    p = snp["particles"]
    src = int(np.argmax(p["active"]))
    rows = np.arange(JET_ROWS - DELETE_ROWS, JET_ROWS)
    assert p["active"][src] and not p["active"][rows].any()
    for k, v in p.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and \
                v.shape[0] == JET_ROWS:
            v[rows] = v[src]
    box = cfg.cloud.delete_box
    for a in range(3):
        lo, hi = box[2 * a], box[2 * a + 1]
        p["pos"][rows, a] = lo + (hi - lo) * (
            np.linspace(0.2, 0.8, DELETE_ROWS) if a == 0 else 0.5)
    p["pos_at_build"][rows] = p["pos"][rows]
    p["vel"][rows] = 0.0
    p["tag"][rows] = p["tag"].max() + 1 + np.arange(DELETE_ROWS)
    p["time_to_add"] = np.zeros_like(p["time_to_add"])
    return cfg, snp


@pytest.fixture(scope="module")
def cases_(tmp_path_factory):
    """{name: (port cfg, the state as numpy, the port's one-process
    states after each of STEPS steps)}, and the JAX package's jitted
    step of the sorted case on its shard_state placement, as numpy."""
    tmp = tmp_path_factory.mktemp("capture")
    cfg_j, cfg, snp, st_j = _sorted()
    built = {"sorted": (cfg, snp), "channel": _channel(tmp),
             "jetflow": _jetflow(tmp)}
    cfg_c, snp_c, _ = setup(*dem_build("clumps"))
    built["clumps"] = (cfg_c, snp_c)
    out = {n: (c, s, one_process(c, s, STEPS))
           for n, (c, s) in built.items()}
    return out, jax_step(cfg_j, st_j, sharded=True)


@pytest.fixture(scope="module")
def runs(cases_):
    """ranks -> {name: the ranks' results of rehearse_job on the case},
    spawned once per rank count."""
    done = {}

    def run(ranks):
        if ranks not in done:
            jobs = [(cases_[0][n][0], cases_[0][n][1], STEPS)
                    for n in CASES]
            res = run_ranks(rehearse_jobs, ranks, args=(jobs,),
                            device="cpu", timeout=TIMEOUT)
            done[ranks] = {n: [r[i] for r in res]
                           for i, n in enumerate(CASES)}
        return done[ranks]
    return run


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("name", CASES)
def test_split_step_without_host_reads_equals_one_process(cases_, runs,
                                                          name, ranks):
    res = runs(ranks)[name]
    refs = cases_[0][name][2]
    for i, ref in enumerate(refs, 1):
        assert differ(ref, res[0]["states"][i]) == [], (name, i)
    if name == "channel":
        # the particle-to-grid sums crossed the slabs' seams
        assert all(c["all-to-all"] > 0 for r in res for c in r["comm"])
    if name == "sorted":
        before = cases_[0][name][1]["particles"]["tag"]
        after = refs[-1]["particles"]["tag"]
        n = len(before) // ranks
        assert any(set(before[r * n:(r + 1) * n])
                   != set(after[r * n:(r + 1) * n]) for r in range(ranks))
    if name == "jetflow":
        p0, p1 = cases_[0][name][1]["particles"], refs[0]["particles"]
        live = set(p1["tag"][p1["active"]])
        assert any(t > p0["tag"].max() for t in live)           # the add
        gone = p0["tag"][JET_ROWS - DELETE_ROWS:]
        assert not live & set(gone)                              # deleted


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("name", CASES)
def test_warm_up_leaves_the_shard_as_a_plain_step(runs, name, ranks):
    for r in runs(ranks)[name]:
        assert r["warm_parted"] == [], (name, r["warm_parted"])
        assert all(r["full_equal"].values()), (name, r["full_equal"])


@pytest.mark.parametrize("ranks", RANKS)
def test_sorted_split_step_matches_the_jax_shard_state_step(cases_, runs,
                                                            ranks):
    close_to_jax(cases_[1], runs(ranks)["sorted"][0]["states"][1])


@pytest.mark.parametrize("ranks", RANKS)
def test_fixed_size_exchange_keeps_the_global_row_order(ranks):
    res = run_ranks(exchange_job, ranks, args=(64, 12, 5), device="cpu",
                    timeout=TIMEOUT)
    for r in res:
        np.testing.assert_array_equal(r["cells"], r["ref_cells"])
        np.testing.assert_array_equal(r["w"], r["ref_w"])
        # every rank's block of all its rows to every other rank: 3
        # values of 8 bytes and a cell of 4
        assert r["bytes"] == {"all-to-all": (ranks - 1) * 64 * (3 * 8 + 4)}


def test_graphed_split_step_refuses_gloo(tmp_path):
    cfg, snp = _channel(tmp_path)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        step = ShardedStep(cfg, tmesh.make_mesh(1, device="cpu"))
        with pytest.raises(RuntimeError, match="backend is gloo"):
            GraphedShardedStep(step)
    finally:
        dist.destroy_process_group()
