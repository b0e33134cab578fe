"""The port's xiaocase1 and expWachem_PCM validators
(sedifoam_tpu_torch/validate/xiaocase1.py, wachem.py) against the
reference scripts, on stand-in case directories
(tests/torch_port_refcases.py) on the CPU.

Both scripts take --case, so each runs as a subprocess (JAX_PLATFORMS=cpu)
on the same written directory as the port's validator:

- xiaocase1: 100 spheres resting on the floor, two layers of the
  lattice 0.05 d apart (the bed lands on the floor and the layers
  collide within the window), in a (6, 16, 2) air column with the inlet
  ramp table, f64, 200 steps (10 host visits, a probe sample every 5):
  the result has exactly the script's keys, n_samples and the sample
  times equal, the dp series within 1e-9 of its scale of
  `validate_xiaocase1.py --f64`'s (measured 2.2e-10: round-off grown
  by the collisions; tests/torch_port_measure_parting.py measures one
  layer, floor contacts only, at 8.0e-14 and a third layer at 7.4e-4,
  and the port against itself with the heights nudged by one ulp
  parting as fast), ramp_max_rel_err within 1e-9 of it; the port's
  run with the checkpoint split after 5 visits equals its straight run
  bit for bit (dp series, n_samples, the end-state audits) and says
  where it resumed;
- expWachem_PCM: 60 spheres 6 mm above the floor (free of contacts in
  the window: f32 round-off grown through collisions as above would
  pass the f32 tolerance) in a (6, 20, 2) gas column, 100 steps in f32:
  the script run first with a temporary baseline path creates that
  baseline (status "baseline"); the port against it gives the script's
  keys with the regression pair in place of the created-baseline pair,
  dp_mean and dp_bed_weight within 1e-4 of scale (f32 through 400
  substeps; measured 3.8e-6), dp_vs_baseline_rel_err within 1e-4, the
  probe series within 1e-4 of scale (measured 6.1e-5); the port with no
  baseline creates its own under a torch_-prefixed name with status
  "baseline"; with the
  committed results/expWachem_PCM_baseline.npz (a pressure from the
  reference package's run) it reads that file and leaves it as it was.
"""

import hashlib
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

import torch_port_refcases as rc  # noqa: E402
from sedifoam_tpu_torch.validate import wachem, xiaocase1  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
XC1_T = 0.0195          # 10 visits of 20 steps: probe samples at 5 and 10
XC1_SPLIT = 0.0095      # after 5 visits, a probe visit
WA_T = 0.0095           # 4 visits of 25 steps


def script(name, *args):
    """The reference script's JSON line, run on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", name),
                          *args], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _rel(ref, got):
    ref, got = np.asarray(ref, float), np.asarray(got, float)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-300))


# -- xiaocase1 ----------------------------------------------------------------

@pytest.fixture(scope="module")
def xc1(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("xc1")
    case = rc.write_xiaocase1(str(tmp / "xiaocase1"), n=100)
    ref = script("validate_xiaocase1.py", "--f64", "--case", case,
                 "--t-end", str(XC1_T), "--out", str(tmp / "ref.npz"))
    got = xiaocase1.run(case, XC1_T, torch.float64, out=str(tmp / "dp.npz"),
                        device="cpu", timing_reps=1)
    return tmp, case, ref, got


def test_xiaocase1_matches_the_script(xc1):
    tmp, _, ref, got = xc1
    assert set(got) == set(ref)
    assert got["n_samples"] == ref["n_samples"] == 2
    assert got["t_end"] == ref["t_end"]
    a, b = np.load(tmp / "ref.npz"), np.load(tmp / "torch_dp.npz")
    assert not os.path.exists(tmp / "dp.npz")
    np.testing.assert_array_equal(a["times"], b["times"])
    err = _rel(a["dp"], b["dp"])
    assert err <= 1e-9, err
    assert abs(got["ramp_max_rel_err"] - ref["ramp_max_rel_err"]) \
        <= 1e-9 * abs(ref["ramp_max_rel_err"])
    assert abs(got["alpha_min"] - ref["alpha_min"]) <= 1e-12
    assert set(got["timing_split_ms"]) == set(ref["timing_split_ms"])
    print(f"xiaocase1 vs the script: dp {err:.2e} of scale")


def test_xiaocase1_checkpoint_split_is_the_straight_run(xc1):
    tmp, case, _, straight = xc1
    split = xiaocase1.run(case, XC1_T, torch.float64, ckpt_split=XC1_SPLIT,
                          out=str(tmp / "split.npz"), device="cpu",
                          timing_reps=1)
    assert split["resumed_at"] == pytest.approx(0.01, abs=1e-9)
    assert set(split) == set(straight) | {"resumed_at"}
    a, b = np.load(tmp / "torch_dp.npz"), np.load(tmp / "torch_split.npz")
    np.testing.assert_array_equal(a["times"], b["times"])
    np.testing.assert_array_equal(a["dp"], b["dp"])
    for key in ("n_samples", "ramp_max_rel_err", "continuity_err",
                "audit_drift_asrc_y", "alpha_min"):
        assert split[key] == straight[key], key


def test_xiaocase1_main_parses_the_scripts_flags(monkeypatch, capsys):
    seen = {}

    def fake_run(*a):
        seen["args"] = a
        return {"n_samples": 0}

    monkeypatch.setattr(xiaocase1, "run", fake_run)
    res = xiaocase1.main(["--t-end", "4", "--f64", "--case", "/x",
                          "--out", "o.npz", "--ckpt-split", "15",
                          "--device", "cpu"])
    assert seen["args"] == ("/x", 4.0, torch.float64, 15.0, "o.npz", "cpu")
    assert json.loads(capsys.readouterr().out.strip()) == res


# -- expWachem_PCM ------------------------------------------------------------

@pytest.fixture(scope="module")
def wachem_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("wachem")
    case = rc.write_wachem(str(tmp / "expWachem_PCM"), y0=0.006)
    base = str(tmp / "jax_baseline.npz")
    ref = script("validate_wachem.py", "--case", case, "--t-end", str(WA_T),
                 "--out", str(tmp / "ref"), "--baseline", base)
    got = wachem.run(case, WA_T, out=str(tmp / "wa"), baseline=base,
                     device="cpu", timing_reps=1)
    return tmp, case, ref, got


def test_wachem_matches_the_script(wachem_runs):
    tmp, _, ref, got = wachem_runs
    assert ref["status"] == "baseline" and ref["baseline_created"] is True
    assert set(got) == (set(ref) - {"status", "baseline_created"}) \
        | {"baseline_dp_mean", "dp_vs_baseline_rel_err"}
    assert got["n_particles"] == ref["n_particles"] == 60
    worst = 0.0
    for key in ("dp_mean", "dp_bed_weight"):
        err = abs(got[key] - ref[key]) / abs(ref[key])
        assert err <= 1e-4, (key, ref[key], got[key])
        worst = max(worst, err)
    assert got["baseline_dp_mean"] == pytest.approx(ref["dp_mean"],
                                                    rel=1e-12)
    assert got["dp_vs_baseline_rel_err"] <= 1e-4
    assert abs(got["dp_vs_bed_weight_rel_err"]
               - ref["dp_vs_bed_weight_rel_err"]) <= 1e-4
    a, b = np.load(tmp / "ref_probes.npz"), np.load(tmp / "torch_wa_probes.npz")
    np.testing.assert_array_equal(a["times"], b["times"])
    probes = _rel(a["p"], b["p"])
    assert probes <= 1e-4, probes
    with open(tmp / "torch_wa_summary.json") as f:
        assert json.load(f) == got
    print(f"expWachem_PCM vs the script: dp {worst:.2e}, probes "
          f"{probes:.2e} of scale")


def test_wachem_creates_its_own_baseline_under_torch_name(wachem_runs):
    tmp, case, ref, _ = wachem_runs
    base = tmp / "new" / "baseline.npz"
    os.makedirs(base.parent)
    got = wachem.run(case, WA_T, out=str(tmp / "wa2"), baseline=str(base),
                     device="cpu", timing_reps=1)
    assert set(got) == set(ref)
    assert got["status"] == "baseline" and got["baseline_created"] is True
    assert not base.exists()
    made = np.load(base.parent / "torch_baseline.npz")
    assert float(made["dp_mean"]) == got["dp_mean"]


def test_wachem_reads_the_committed_baseline(wachem_runs):
    tmp, case, _, _ = wachem_runs
    with open(wachem.BASELINE, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    got = wachem.run(case, WA_T, out=str(tmp / "wa3"), device="cpu",
                     timing_reps=1)
    with open(wachem.BASELINE, "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == digest
    assert got["baseline_dp_mean"] == float(
        np.load(wachem.BASELINE)["dp_mean"])
    assert "status" not in got
    assert not os.path.exists(os.path.join(os.path.dirname(wachem.BASELINE),
                                           "torch_expWachem_PCM_baseline.npz"))
