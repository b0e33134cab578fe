"""The port's bench entry point (sedifoam_tpu_torch/bench.py) on the CPU.

- `python -m sedifoam_tpu_torch.bench --small --device cpu` as a
  subprocess: the last line is one JSON object with bench.py's four keys,
  with --repeats each repeat's rate stands on an earlier line and the
  value is their median;
- a table forced too small (the case built with K = 2 on the binned
  backend) exits nonzero with the audit's message and prints no result;
- without a card and without --device cpu the module raises;
- the module imports nothing of JAX;
- the state after the warm-up and the 3 timed steps of `--small` against
  the repository's bench.py (build_case + make_step_fn, dense, f32) after
  the same 4 steps: 1e-4 of each field's scale (f32 round-off through 40
  substeps; measured: 7.0e-6 at worst), and likewise on the binned
  backend with bin-sorted rebuilds, rows matched by tag;
- bench_case.build_config takes sort_on_rebuild as bench.build_case does.
"""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import bench as jbench  # noqa: E402
from sedifoam_tpu.solver import make_step_fn as jstep_fn  # noqa: E402
from sedifoam_tpu_torch import bench as tbench  # noqa: E402
from sedifoam_tpu_torch import bench_case  # noqa: E402
from tagsort import by_tag  # noqa: E402
from torch_port_util import few_threads, rel_err  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"metric", "value", "unit", "vs_baseline"}


def _python(*args):
    # two threads: see torch_port_util.few_threads
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="2")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, env=env, cwd=REPO, timeout=300)


def _bench(*args):
    return _python("-m", "sedifoam_tpu_torch.bench", *args)


# the bench's main() on a case whose table holds 2 partners a particle
TABLE_TOO_SMALL = """
import dataclasses, sys
from sedifoam_tpu_torch import bench, bench_case
build = bench_case.build_config
def build_config(**kw):
    cfg = build(**kw)
    return dataclasses.replace(cfg, dem=dataclasses.replace(cfg.dem, nbr_k=2))
bench_case.build_config = build_config
bench.main(sys.argv[1:])
"""


def test_bench_small_prints_the_json_line():
    res = _bench("--small", "--device", "cpu", "--repeats", "3")
    assert res.returncode == 0, res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    out = json.loads(lines[-1])
    assert set(out) == KEYS
    assert out["metric"] == "particle_dem_substeps_per_sec_coupled"
    assert out["unit"] == "particle-substeps/s"
    assert out["value"] > 0 and np.isfinite(out["value"])
    assert out["vs_baseline"] == round(
        out["value"] / tbench.REFERENCE_MEASURED_PSTEPS_PER_CORE, 4)
    rates = [float(ln.split(",")[1].split()[0]) for ln in lines[:-1]
             if ln.startswith("repeat ")]
    assert len(rates) == 3
    assert out["value"] == round(float(np.median(rates)), 1)


def test_bench_fails_hard_when_a_partner_was_dropped():
    res = _python("-c", TABLE_TOO_SMALL, "--small", "--device", "cpu",
                  "--backend=binned")
    assert res.returncode != 0
    assert "NEIGHBOR AUDIT FAILED" in res.stderr
    assert "K=2 table" in res.stderr
    assert "particle_dem_substeps_per_sec_coupled" not in res.stdout


def test_bench_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tbench.run(small=True)


def test_bench_imports_no_jax():
    code = ("import sys, sedifoam_tpu_torch.bench, "
            "sedifoam_tpu_torch.validate.battery; "
            "assert 'jax' not in sys.modules and not any("
            "m == 'sedifoam_tpu' or m.startswith('sedifoam_tpu.') "
            "for m in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr[-2000:]


def test_build_config_takes_sort_on_rebuild():
    assert bench_case.build_config(**tbench.SMALL).dem.sort_on_rebuild \
        is False
    assert bench_case.build_config(
        **tbench.SMALL, sort_on_rebuild=True).dem.sort_on_rebuild is True


@pytest.mark.parametrize("backend,sort", [("dense", False),
                                          ("binned", True)])
def test_bench_small_state_matches_reference(backend, sort):
    """1 warm-up + 3 timed steps in both packages, f32."""
    cfg_j, st = jbench.build_case(backend=backend, sort_on_rebuild=sort,
                                  **tbench.SMALL)
    step = jstep_fn(cfg_j)
    for _ in range(4):
        st = step(st)
    run = tbench.run(small=True, backend=backend, device="cpu",
                     sort_on_rebuild=sort)
    assert run.n_timed == 3 and len(run.rates) == 1
    got = run.state
    assert int(got.fluid.step) == int(st.fluid.step) == 4
    assert int(got.particles.nbr_dropped) == 0
    worst = 0.0
    for name in ("pos", "vel", "omega", "force"):
        e = rel_err(by_tag(st.particles, name),
                    by_tag(got.particles, name))
        assert e <= 1e-4, (name, e)
        worst = max(worst, e)
    for name in ("alpha", "p", "Ub", "Asrc"):
        e = rel_err(getattr(st.fluid, name), getattr(got.fluid, name))
        assert e <= 1e-4, (name, e)
        worst = max(worst, e)
    if sort:
        np.testing.assert_array_equal(np.asarray(st.particles.tag),
                                      got.particles.tag.numpy())
    print(f"bench --small [{backend}, sort {sort}]: worst {worst:.3e}")
