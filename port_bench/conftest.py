"""Tests of the benchmark harness (run: python -m pytest port_bench).

They run on the CPU at tiny sizes through the harness's own code, in a
copy of the benchmark that adds tiny cells as files alone; tests marked
`cuda` need the card and skip here.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# tiny cells: configurations that copy a case module at small sizes, each
# with a traffic file and a limits file copied from a full cell's
TINY = {
    "tiny_bed-visit2": ("tiny_bed", "bench_bed", "bench_bed-visit20",
                        dict(n_particles=256, nx=8, ny=16, nz=8)),
    "tiny_channel-visit2": ("tiny_channel", "bedload_channel",
                            "bedload-visit20",
                            dict(counts=[14, 13, 6], layers=2,
                                 n_particles=2024, capacity=4096)),
}


def make_bench(root: Path) -> Path:
    """A copy of the benchmark under root/port_bench, with BENCHMARK.json
    and the tiny cells added as files and entries; returns the copy."""
    pb = root / "port_bench"
    shutil.copytree(BENCH, pb, ignore=shutil.ignore_patterns(
        "__pycache__", "test_*.py", "conftest.py"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for cell, (cfg, base_cfg, base_cell, sizes) in TINY.items():
        spec = json.loads((pb / "configs" / f"{base_cfg}.json").read_text())
        spec.update(sizes, name=cfg)
        (pb / "configs" / f"{cfg}.json").write_text(json.dumps(spec))
        shutil.copy(pb / "configs" / f"{base_cfg}.py",
                    pb / "configs" / f"{cfg}.py")
        wl = json.loads((pb / "workloads" / f"{base_cell}.json").read_text())
        wl.update(config=cfg, steps_per_host_visit=2, log_every=2,
                  warmup_visits=2, check_visit=2)
        (pb / "workloads" / f"{cell}.json").write_text(json.dumps(wl))
        shutil.copy(pb / "limits" / f"{base_cell}.json",
                    pb / "limits" / f"{cell}.json")
        bench["configs"].append({"name": cfg, "source": "tiny",
                                 "file": f"port_bench/configs/{cfg}.json",
                                 "reduced": list(sizes), "why": "tests"})
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": "visit2", "chips": 1,
                                   "why": "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return pb


@pytest.fixture
def tiny_bench(tmp_path):
    return tmp_path, make_bench(tmp_path)


@pytest.fixture
def card():
    """The CUDA card; skips without one."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
