"""The harness end to end on the CPU at tiny sizes: a sound run is
correct, a broken step is not, nothing loads JAX or the JAX package,
the reference loads nothing of the program, and cells, configurations
and metrics are found by name from files alone."""

import json
import subprocess
import sys
import time

import pytest
import torch

from conftest import BENCH, ROOT

CELLS = ("tiny_bed-visit2", "tiny_channel-visit2")
SEED = 2 ** 31 + 7


def _run(root, pb, cell, seconds=1.0):
    from pbench import harness
    return harness.run(cell, SEED, seconds, False, "cpu", root,
                       time.perf_counter(), bench_dir=pb, log=lambda m: None)


@pytest.mark.parametrize("cell", CELLS)
def test_tiny_cell_cpu(tiny_bench, cell):
    root, pb = tiny_bench
    res = _run(root, pb, cell)
    assert list(res)[-1] == "checks"
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    assert res["device"]["memory_peak_bytes"] is None
    assert res["device"]["count"] == 0
    # every metric of the host clock or the device is not measured here
    assert set(res["metrics"]) == {"setup_s", "step_ms", "peak_mem_gib"}
    for m in res["metrics"].values():
        assert m["value"] is None and m["note"] == "not measured"


def _freeze(state):
    return state


def _half(step_forward):
    """A step that advances the first half of the particle rows and
    leaves the rest as they were."""
    def forward(self, state):
        new = step_forward(self, state)
        n = state.particles.pos.shape[0] // 2
        ps = new.particles._replace(**{
            k: torch.cat([getattr(new.particles, k)[:n],
                          getattr(state.particles, k)[n:]])
            for k in ("pos", "vel", "omega", "force")})
        return new._replace(particles=ps)
    return forward


def _altered(step_forward):
    """A step whose answer is altered where it is made: one particle's
    velocity nudged."""
    def forward(self, state):
        new = step_forward(self, state)
        vel = new.particles.vel.clone()
        vel[0, 1] += 1e-3
        return new._replace(particles=new.particles._replace(vel=vel))
    return forward


@pytest.mark.parametrize("fault", ("unchanged", "half_rows", "altered"))
def test_broken_step_is_not_correct(tiny_bench, monkeypatch, fault):
    """The run's timed step broken underneath the harness: correct comes
    out false."""
    from sedifoam_tpu_torch import solver
    fwd = solver.CoupledStep.forward
    broken = {"unchanged": lambda self, s: _freeze(s),
              "half_rows": _half(fwd), "altered": _altered(fwd)}[fault]
    monkeypatch.setattr(solver.CoupledStep, "forward", broken)
    root, pb = tiny_bench
    res = _run(root, pb, "tiny_bed-visit2")
    assert not res["correct"], res["checks"]


def _modules_after(code, tmp):
    """Top-level module names loaded by `code` in a fresh interpreter."""
    prog = (f"import sys; sys.path[:0] = [{str(BENCH)!r}, {str(ROOT)!r}]\n"
            + code +
            "\nimport json; print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], cwd=tmp,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_run_loads_no_jax(tiny_bench):
    """A whole run through the harness, metrics and configurations loads
    no module whose top-level name is jax, jaxlib, flax or sedifoam_tpu
    (compared whole: sedifoam_tpu_torch begins with sedifoam_tpu)."""
    root, pb = tiny_bench
    code = (f"import time\nfrom pbench import harness\n"
            f"harness.run('tiny_bed-visit2', 3, 0.5, False, 'cpu', "
            f"__import__('pathlib').Path({str(root)!r}), time.perf_counter(),"
            f" bench_dir=__import__('pathlib').Path({str(pb)!r}))\n"
            "import importlib.util, glob\n"
            f"for f in glob.glob({str(pb)!r} + '/metrics/*.py'):\n"
            "    s = importlib.util.spec_from_file_location('m', f)\n"
            "    s.loader.exec_module(importlib.util.module_from_spec(s))\n"
            "import run, calibrate")
    names = _modules_after(code, root)
    assert "sedifoam_tpu_torch" in names and "pbref" in names
    assert not names & {"jax", "jaxlib", "flax", "sedifoam_tpu"}


def test_reference_loads_nothing_of_the_program(tiny_bench):
    """The reference (pbref) and the comparison build the case from the
    configurations' inputs and step it without the program."""
    root, pb = tiny_bench
    code = (
        "import torch\nfrom pbench import check, spec\n"
        "import pathlib\n"
        f"for cell in {list(CELLS)!r}:\n"
        f"    c = spec.find_cell(cell, pathlib.Path({str(root)!r}), "
        f"pathlib.Path({str(pb)!r}))\n"
        f"    inp = c.case.inputs(c.config, 5, {str(root)!r})\n"
        "    ref = check.Reference(c.case, c.config, inp, 'cpu')\n"
        "    s = ref.advance(ref.start, 2)\n"
        "    assert bool(torch.isfinite(s.particles.vel).all())\n"
        "import pkgutil, importlib, pbref\n"
        "for m in pkgutil.walk_packages(pbref.__path__, 'pbref.'):\n"
        "    importlib.import_module(m.name)")
    names = _modules_after(code, root)
    assert "pbref" in names
    assert not names & {"sedifoam_tpu_torch", "jax", "jaxlib", "flax",
                        "sedifoam_tpu"}


def test_added_as_files_alone(tiny_bench):
    """A configuration with a case module of its own, a cell and a metric
    added as new files and entries are found by name."""
    from pbench import spec
    root, pb = tiny_bench
    (pb / "configs" / "other_bed.py").write_text(
        (pb / "configs" / "bench_bed.py").read_text())
    cfg = json.loads((pb / "configs" / "tiny_bed.json").read_text())
    cfg.update(name="other_bed", nbr_k=10)
    (pb / "configs" / "other_bed.json").write_text(json.dumps(cfg))
    wl = json.loads((pb / "workloads" / "tiny_bed-visit2.json").read_text())
    wl.update(config="other_bed", probe_every=2)
    (pb / "workloads" / "other_bed-visit2.json").write_text(json.dumps(wl))
    (pb / "limits" / "other_bed-visit2.json").write_text(
        (pb / "limits" / "tiny_bed-visit2.json").read_text())
    (pb / "metrics" / "steps_seen.py").write_text(
        "def read(rec):\n    return float(rec['steps'])\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "other_bed"})
    bench["workloads"].append({"name": "other_bed-visit2",
                               "config": "other_bed", "traffic": "visit2",
                               "chips": 1, "why": "tests"})
    bench["end_to_end"].append({"name": "steps_seen", "unit": "steps",
                                "better": "higher", "bound": 0.01,
                                "source": "program_counter"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("other_bed-visit2", root, pb)
    assert cell.case.__name__.endswith("other_bed")
    assert cell.config["nbr_k"] == 10
    assert cell.workload["probe_every"] == 2
    assert [m["name"] for m in cell.end_to_end][-1] == "steps_seen"
    res = _run(root, pb, "other_bed-visit2")
    assert res["correct"], res["checks"]
    assert res["metrics"]["steps_seen"]["value"] == res["attempted"]


@pytest.mark.cuda
def test_control_fails_on_the_card(card, tiny_bench):
    """The control (the reference in TF32) in the program's place fails
    at least one number of the bench bed's limits, at a small size."""
    from pbench import check, spec
    root, pb = tiny_bench
    cfg = json.loads((pb / "configs" / "tiny_bed.json").read_text())
    cfg.update(n_particles=8192, nx=16, ny=32, nz=16)
    (pb / "configs" / "tiny_bed.json").write_text(json.dumps(cfg))
    cell = spec.find_cell("tiny_bed-visit2", root, pb)
    spv = cell.workload["steps_per_host_visit"]
    for seed in (1, 2, 3):
        inp = cell.case.inputs(cell.config, seed, str(root))
        ref = check.Reference(cell.case, cell.config, inp, card)
        ctl = check.Reference(cell.case, cell.config, inp, card,
                              tf32=True)
        mid = check.to_host(ref.advance(ref.start, 3 * spv))
        got = check.reference_states(ctl, spv, mid)
        want = check.reference_states(ref, spv, mid)
        nums = check.numbers(check.run_checks(got, want, mid))
        assert any(nums[k] > cell.limits[k]["limit"] for k in nums), nums
