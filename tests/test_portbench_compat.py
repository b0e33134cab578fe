"""The accepted benchmark harness (port_bench/) against the program as it
stands, on the CPU at tiny sizes: the harness reads the program's
counters through the telemetry registry as before, and a cell runs
correct with the program's telemetry off and on, its checks the same to
the last bit (the marks and spans touch no state), with the harness's
hook inside the runner's run.on_sample span. The harness's own tests
are port_bench/test_portbench_harness.py (python -m pytest port_bench).
"""

import importlib.util
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from sedifoam_tpu_torch import linsolve, telemetry  # noqa: E402
from sedifoam_tpu_torch.dem import fused  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401

BENCH = Path(__file__).resolve().parent.parent / "port_bench"
CELL = "tiny_bed-visit2"
SEED = 2 ** 31 + 11


def _bench_conftest():
    """port_bench/conftest.py (its tiny cells), loaded under a name of
    its own beside this directory's conftest."""
    spec = importlib.util.spec_from_file_location("port_bench_conftest",
                                                  BENCH / "conftest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def tiny_bench(tmp_path):
    telemetry.enable(False)
    yield tmp_path, _bench_conftest().make_bench(tmp_path)
    telemetry.enable(False)
    telemetry._SPANS.clear()


def _run(root, pb):
    from pbench import harness
    return harness.run(CELL, SEED, 0.5, False, "cpu", root,
                       time.perf_counter(), bench_dir=pb, log=lambda m: None)


def test_harness_counters_read_the_registry(tiny_bench):
    root, pb = tiny_bench
    res = _run(root, pb)
    assert res["correct"], res["checks"]
    from pbench import harness
    got = harness._counters()
    assert got == {"pcg_iters": linsolve.STATS["pcg"][1],
                   "chain": fused.launches()}
    assert got["pcg_iters"] == telemetry.read()[
        "linsolve.pcg.iterations"] > 0
    assert "pbench" in sys.modules


def test_cell_same_with_telemetry_on(tiny_bench):
    root, pb = tiny_bench
    off = _run(root, pb)
    telemetry.enable(True)
    on = _run(root, pb)
    for res in (off, on):
        assert res["correct"], res["checks"]
        assert set(res["metrics"]) == {"setup_s", "step_ms", "peak_mem_gib"}
    assert on["checks"] == off["checks"]
    recs = telemetry.spans()
    hooks = [s for s in recs if s.name == "run.on_sample"]
    assert hooks and all(s.parent == "run.visit" for s in hooks)
    # the window's visits and the set-up's, each a run.visit
    assert sum(s.name == "run.visit" for s in recs) >= on["attempted"] // 2
