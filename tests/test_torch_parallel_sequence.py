"""Every rank of the split step (parallel/step.ShardedStep) issues the same
collectives in the same order, on the CPU over gloo ranks spawned from
the test (parallel/launch.run_ranks; one spawn per rank count runs every
case, tests/torch_port_sequence.sequence_job).

Under NCCL a collective that one rank issues and another does not, or
issues with another shape, dtype or split, waits without a word; so the
ranks' sequences are recorded here, where gloo runs them on the CPU:
per rank and in order, each call to torch.distributed's collectives
with its kind (an all_reduce's op), dtype, shapes, split sizes (as the
rank sees its peers: the k-th after it) and a broadcast's src. One step
of each case eagerly and one under graphs.warming() (every branch run,
as a capture's warm-up runs it), at 2 and 4 ranks:

- bench: the bench bed shrunk (bench_case.build_config: 256 particles,
  8 x 8 x 8, K = 8) with sort_on_rebuild, its fluid on slabs;
- channel: the coarse transport-bedload channel (16 x 13 x 6, the
  semi-implicit drag) of tests/test_torch_parallel_capture.py, on slabs;
- jetflow: that file's shrunken jetFlow (256 rows) with the add due in
  the step and 4 rows in the delete box;
- dimers: tests/test_torch_parallel_dem.py's 128 rigid dimers on the
  binned table.

Each rank's record must equal rank 0's, and what each rank sends a peer
in an all_to_all_single must be what the peer expects from it.
"""

import pytest

torch = pytest.importorskip("torch")

from sedifoam_tpu_torch import bench_case, bridge  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from torch_port_sequence import sequence_job  # noqa: E402
from torch_port_split import RANKS, TIMEOUT, setup  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from test_torch_parallel_capture import _channel, _jetflow  # noqa: E402
from test_torch_parallel_dem import build as dem_build  # noqa: E402

CASES = ["bench", "channel", "jetflow", "dimers"]
MODES = ["eager", "warming"]
BENCH = dict(n_particles=256, nx=8, ny=8, nz=8)


def _bench():
    cfg = bench_case.build_config(**BENCH, sort_on_rebuild=True)
    fluid, parts = bench_case.build_state(cfg, BENCH["n_particles"],
                                          torch.float64, "cpu")
    state = tsolver.CoupledStep(cfg, torch.float64, "cpu").initialize(
        fluid, parts)
    return cfg, bridge.sim_state_to_numpy(state)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """ranks -> {case: [each rank's {mode: record}]}, one spawn per rank
    count."""
    tmp = tmp_path_factory.mktemp("sequence")
    built = {"bench": _bench(), "channel": _channel(tmp),
             "jetflow": _jetflow(tmp)}
    cfg_d, snp_d, _ = setup(*dem_build("clumps"))
    built["dimers"] = (cfg_d, snp_d)
    done = {}

    def run(ranks):
        if ranks not in done:
            res = run_ranks(sequence_job, ranks,
                            args=([built[n] for n in CASES],), device="cpu",
                            timeout=TIMEOUT)
            done[ranks] = {n: [r[i] for r in res]
                           for i, n in enumerate(CASES)}
        return done[ranks]
    return run


def _same(a):
    return [{k: v for k, v in e.items() if k != "absolute"} for e in a]


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", CASES)
def test_every_rank_issues_the_same_collectives(records, name, mode, ranks):
    per = [r[mode] for r in records(ranks)[name]]
    assert per[0], (name, mode)
    kinds = {e["kind"] for e in per[0]}
    assert {"all_gather_into_tensor", "all_reduce"} <= kinds
    for r, rec in enumerate(per[1:], 1):
        assert len(rec) == len(per[0]), (name, mode, r, len(rec),
                                          len(per[0]))
        for i, (a, b) in enumerate(zip(_same(per[0]), _same(rec))):
            assert a == b, (name, mode, r, i, a, b)
    # the fluid on slabs: halos and the particle-to-grid exchange ran
    assert "all_to_all_single" in kinds
    # what rank a sends rank b is what b expects from a, call by call
    for i, e in enumerate(per[0]):
        if e["kind"] != "all_to_all_single" or e["absolute"][1] is None:
            continue
        for a in range(ranks):
            for b in range(ranks):
                sent = per[a][i]["absolute"][1][b]
                expected = per[b][i]["absolute"][0][a]
                assert sent == expected, (name, mode, i, a, b)


def _within(short, long):
    """Whether `short` is a subsequence of `long`."""
    it = iter(long)
    return all(any(a == b for b in it) for a in short)


@pytest.mark.parametrize("ranks", RANKS)
def test_the_warm_up_calls_every_collective_of_the_step(records, ranks):
    # a capture's warm-up step (every branch run) calls each collective
    # the plain step calls, in its order: the graph then holds no
    # collective's first call
    for name in CASES:
        for r in records(ranks)[name]:
            assert len(r["warming"]) > len(r["eager"]) or name == "bench", \
                name
            assert _within(_same(r["eager"]), _same(r["warming"])), name
