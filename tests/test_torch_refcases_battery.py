"""The port's battery on the reference's own cases and its report
(sedifoam_tpu_torch/validate/battery.py, report.py), on stand-in case
directories (tests/torch_port_refcases.py) laid out as the reference's
case tree, on the CPU. Imports nothing of JAX.

- `python -m sedifoam_tpu_torch.validate.battery --device cpu --quick
  --cases-dir <stand-ins> --only <the six>` with the quick lengths cut
  (xiaocase1 200 steps, the Mueller cases 100 with the average from 0,
  expWachem_PCM 100, BL24-TH1 25 in a table of 512, the collisions 20):
  each case runs, its result is stored as run_all_cases.py stores it
  (`passed`, `wall_s`, the validator's keys; the Mueller cases in the
  multi-seed layout with seeds [0]) and judged by run_all_cases.py's
  gates (the stand-ins are not the physics: the verdict is recomputed
  here from the stored numbers, not expected to pass); the validators'
  --out files land beside the report under torch_ names;
- without the case tree each of the six is `not_run`, naming the
  missing directory (with no tree given, the directories it needs); a tree that lacks data/p_bench.dat or BL24's
  In_initial.in names exactly those files, and the battery has no runner
  for those cases;
- judge on hand-made result dicts for each gate of the six cases;
- report.py on the battery's report: one table row per case with its
  verdict, the not_run rows, a plot for each case whose --out file is
  there (matplotlib is here), a table and a note without matplotlib,
  and refusal of the reference's results/report.md and results/plots/;
- each of the five new validators, given no device, raises where no
  CUDA card is present.
"""

import json
import os
import shutil
import sys

import pytest

torch = pytest.importorskip("torch")

import torch_port_refcases as rc  # noqa: E402
from sedifoam_tpu_torch.validate import (battery, bl24, report,  # noqa: E402
                                         RESULTS)
from torch_port_util import few_threads  # noqa: E402,F401

REF_NAMES = ("multiParticlesCollide", "xiaocase1", "expMueller06",
             "expMueller09", "expWachem_PCM", "BL24-TH1")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("cases")
    rc.write_tree(str(root), sizes={
        "xiaocase1": dict(y0=0.004), "expMueller06": dict(y0=0.004),
        "expMueller09": dict(y0=0.004), "expWachem_PCM": dict(y0=0.006)},
        collide_end=0.02)
    return str(root)


@pytest.fixture(scope="module")
def battery_run(tree, tmp_path_factory):
    out = tmp_path_factory.mktemp("battery")
    path = str(out / "torch_report.json")
    mp = pytest.MonkeyPatch()
    mp.setattr(battery, "QUICK_T", {"xiaocase1": 0.0195, "mueller": 0.0095,
                                    "mueller_avg": 0.0, "wachem": 0.0095,
                                    "bl24": 0.0024})
    mp.setattr(bl24, "CAPACITY", 512)
    try:
        with pytest.raises(SystemExit) as done:
            battery.main(["--device", "cpu", "--quick", "--cases-dir", tree,
                          "--report", path, "--only", ",".join(REF_NAMES)])
    finally:
        mp.undo()
    with open(path) as f:
        return out, path, json.load(f), done.value.code


def test_battery_runs_and_judges_the_reference_cases(battery_run):
    out, _, rep, code = battery_run
    assert rep["quick"] is True
    assert set(rep["cases"]) == set(REF_NAMES)
    for name in REF_NAMES:
        entry = rep["cases"][name]
        assert "not_run" not in entry and "error" not in entry, entry
        assert entry["passed"] is battery.judge(name, entry, True)
        assert entry["wall_s"] >= 0.0
    n_pass = sum(c["passed"] for c in rep["cases"].values())
    assert code == (0 if n_pass == len(REF_NAMES) else 1)
    x1 = rep["cases"]["xiaocase1"]
    assert x1["n_samples"] == 2 and "resumed_at" not in x1
    for name in ("expMueller06", "expMueller09"):
        m = rep["cases"][name]
        assert m["seeds"] == [0] and "seedmean_lineY3_uy_rms_err" in m
        assert len(m["per_seed_lineY3_uy_rms_err"]) == 1
    assert "seedmean_lineY5_uy_corr" in rep["cases"]["expMueller09"]
    wa = rep["cases"]["expWachem_PCM"]
    assert wa["n_particles"] == 60 and "dp_vs_baseline_rel_err" in wa
    bl = rep["cases"]["BL24-TH1"]
    assert bl["quick"] is True and "ubar_locked" not in bl["gates"]
    col = rep["cases"]["multiParticlesCollide"]
    assert set(col["cases"]) == {"multiParticlesCollideDia",
                                 "multiParticlesCollideRho"}
    assert col["cases"]["multiParticlesCollideDia"]["frames"] == 3
    for f in ("torch_xiaocase1_dp_curve.npz",
              "torch_expMueller06_profiles_seed0.npz",
              "torch_expMueller09_profiles_seed0.npz",
              "torch_expWachem_PCM_probes.npz",
              "torch_expWachem_PCM_summary.json",
              "torch_collide_traces.npz"):
        assert (out / f).exists(), f
    assert not (out / "torch_bl24_bedprofile.npz").exists()   # quick


def test_battery_without_the_case_tree(tmp_path):
    gone = str(tmp_path / "nowhere")
    not_run = battery.not_run(gone)
    assert set(not_run) == set(REF_NAMES)
    assert not_run["xiaocase1"] == (f"missing under {gone}: auto-testing/"
                                    "test-cases/xiaocase1/")
    assert not_run["multiParticlesCollide"].endswith(
        "multiParticlesCollideDia/, auto-testing/test-cases/"
        "multiParticlesCollideRho/")
    assert not set(REF_NAMES) & set(battery.case_runners("cpu", True, gone))
    rep = battery.run_battery({}, str(tmp_path / "torch_report.json"),
                              say=lambda m: None, not_run=not_run)
    for name in REF_NAMES:
        assert rep["cases"][name] == {"passed": False,
                                      "not_run": not_run[name]}
    assert battery.summary(rep) == (0, 0, len(REF_NAMES))
    # no tree given: every reference case, naming the directories it needs
    assert battery.NOT_RUN == battery.not_run(None)
    assert set(battery.NOT_RUN) == set(REF_NAMES)
    assert battery.NOT_RUN["BL24-TH1"] == (
        "no case tree given (--cases-dir, $SEDIFOAM_CASES_DIR): needs "
        "example-cases/BL24-TH1/")
    assert not set(REF_NAMES) & set(battery.case_runners("cpu", True, None))


def test_battery_names_each_missing_file(tree, tmp_path):
    part = str(tmp_path / "cases")
    shutil.copytree(tree, part)
    x1 = os.path.join(part, rc.TEST_CASES, "xiaocase1")
    os.remove(os.path.join(x1, "data", "p_bench.dat"))
    os.remove(os.path.join(part, rc.EXAMPLE_CASES, "BL24-TH1",
                           "In_initial.in"))
    os.remove(os.path.join(part, rc.TEST_CASES, "expMueller09", "data",
                           "sets_bench", "lineY4_UaMean.xy"))
    not_run = battery.not_run(part)
    assert not_run == {
        "xiaocase1": f"missing under {part}: auto-testing/test-cases/"
                     "xiaocase1/data/p_bench.dat",
        "BL24-TH1": f"missing under {part}: example-cases/BL24-TH1/"
                    "In_initial.in",
        "expMueller09": f"missing under {part}: auto-testing/test-cases/"
                        "expMueller09/data/sets_bench/lineY4_UaMean.xy"}
    runners = battery.case_runners("cpu", True, part)
    assert {"multiParticlesCollide", "expMueller06",
            "expWachem_PCM"} <= set(runners)
    assert not set(not_run) & set(runners)


@pytest.mark.parametrize("name,data,quick,expect", [
    ("xiaocase1", {"ramp_max_rel_err": 0.07}, True, True),
    ("xiaocase1", {"ramp_max_rel_err": 0.09}, True, False),
    ("xiaocase1", {}, True, False),
    ("xiaocase1", {"ramp_max_rel_err": 0.02, "plateau_rel_err": 0.04},
     False, True),
    ("xiaocase1", {"ramp_max_rel_err": 0.02, "plateau_rel_err": 0.06},
     False, False),
    ("expMueller06", {"seedmean_lineY3_uy_rms_err": 0.2,
                      "seedmean_lineY3_uy_corr": 0.95,
                      "lineY1_alpha_rms_err": 0.1}, False, True),
    ("expMueller06", {"seedmean_lineY3_uy_rms_err": 0.3,
                      "seedmean_lineY3_uy_corr": 0.95}, False, False),
    ("expMueller06", {"seedmean_lineY3_uy_rms_err": 0.2,
                      "seedmean_lineY3_uy_corr": 0.85}, False, False),
    ("expMueller06", {"seedmean_lineY3_uy_rms_err": 0.2,
                      "seedmean_lineY3_uy_corr": 0.95,
                      "seed1_lineY2_alpha_rms_err": 0.3}, False, False),
    ("expMueller06", {"seedmean_lineY3_uy_rms_err": 0.2,
                      "seedmean_lineY3_uy_corr": 0.95,
                      "error": "seed 1 crashed"}, False, False),
    ("expMueller09", {"seedmean_lineY3_uy_rms_err": 0.2,
                      "seedmean_lineY3_uy_corr": 0.95,
                      "seedmean_lineY4_uy_rms_err": 0.2,
                      "seedmean_lineY4_uy_corr": 0.95}, False, False),
    ("expMueller09", {"lineY3_uy_rms_err": 0.4, "lineY4_uy_rms_err": 0.45,
                      "lineY5_uy_rms_err": 0.3, "lineY5_uy_corr": 0.95,
                      "lineY1_uy_rms_err": 0.9}, True, True),
    ("expMueller09", {"lineY3_uy_rms_err": 0.4, "lineY5_uy_corr": 0.8},
     True, False),
    ("expMueller06", {"lineY1_uy_rms_err": 0.1}, True, False),
    ("expWachem_PCM", {"dp_vs_bed_weight_rel_err": 0.09,
                       "continuity_err": 1e-3, "alpha_min": 0.0,
                       "dp_vs_baseline_rel_err": 0.01}, False, True),
    ("expWachem_PCM", {"dp_vs_bed_weight_rel_err": 0.09,
                       "continuity_err": 1e-3, "alpha_min": 0.0}, False,
     False),
    ("expWachem_PCM", {"dp_vs_bed_weight_rel_err": 0.09,
                       "continuity_err": 1e-3, "alpha_min": 0.0}, True,
     True),
    ("expWachem_PCM", {"dp_vs_bed_weight_rel_err": 0.09,
                       "continuity_err": 1e-3, "alpha_min": 0.0,
                       "status": "baseline", "baseline_created": True},
     True, False),
    ("expWachem_PCM", {"dp_vs_bed_weight_rel_err": 0.11,
                       "continuity_err": 1e-3, "alpha_min": 0.0,
                       "dp_vs_baseline_rel_err": 0.01}, False, False),
    ("expWachem_PCM", {"dp_vs_bed_weight_rel_err": 0.09,
                       "continuity_err": 1e-3, "alpha_min": -1e-3,
                       "dp_vs_baseline_rel_err": 0.01}, False, False),
    ("expWachem_PCM", {"dp_vs_bed_weight_rel_err": 0.09,
                       "continuity_err": 1e-3, "alpha_min": 0.0,
                       "dp_vs_baseline_rel_err": 0.2}, True, False),
    ("BL24-TH1", {"passed": True}, False, True),
    ("BL24-TH1", {"passed": False}, True, False),
    ("multiParticlesCollide", {"cases": {"a": {}, "b": {}},
                               "y_max_dev": 3.9e-3, "vy_max_dev": 0.029},
     False, True),
    ("multiParticlesCollide", {"cases": {"a": {}, "b": {}},
                               "y_max_dev": 4.1e-3, "vy_max_dev": 0.01},
     False, False),
    ("multiParticlesCollide", {"cases": {"a": {}, "b": {}},
                               "y_max_dev": 1e-3, "vy_max_dev": 0.031},
     False, False),
    ("multiParticlesCollide", {"cases": {"a": {}}, "y_max_dev": 1e-3,
                               "vy_max_dev": 0.01}, False, False),
    ("multiParticlesCollide", {"not_run": "missing"}, False, False),
])
def test_judge_reference_cases(name, data, quick, expect):
    assert battery.judge(name, data, quick) is expect


def test_report_from_the_battery(battery_run, tmp_path):
    out, path, rep, _ = battery_run
    with open(path) as f:
        doc = json.load(f)
    doc["cases"]["transport-vortex-dune"] = {"passed": False,
                                             "not_run": "no files"}
    with_not_run = str(out / "torch_report_notrun.json")
    with open(with_not_run, "w") as f:
        json.dump(doc, f)
    md, plots = str(tmp_path / "torch_report.md"), str(tmp_path
                                                       / "torch_plots")
    res = report.write_report(with_not_run, md, plots)
    assert res["plots_drawn"] is True and res["cases"] == 7
    with open(md) as f:
        text = f.read()
    rows = [ln for ln in text.splitlines() if ln.startswith("| ")
            and not ln.startswith("| case")]
    assert [r.split(" | ")[0][2:] for r in rows] == list(doc["cases"])
    for name, entry in rep["cases"].items():
        verdict = "PASS" if entry["passed"] else "FAIL"
        assert f"| {name} | {verdict} |" in text
    assert "| transport-vortex-dune | NOT RUN | no files |" in text
    assert sorted(res["plots"]) == sorted([
        "xiaocase1_dp.png", "expMueller06_profiles.png",
        "expMueller09_profiles.png", "expWachem_pressure.png"])
    for name in res["plots"]:
        assert os.path.getsize(os.path.join(plots, name)) > 0
        assert f"(torch_plots/{name})" in text


def test_report_without_matplotlib(battery_run, tmp_path, monkeypatch):
    _, path, rep, _ = battery_run
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    md = str(tmp_path / "torch_report.md")
    res = report.write_report(path, md, str(tmp_path / "torch_plots"))
    assert res["plots_drawn"] is False and res["plots"] == []
    with open(md) as f:
        text = f.read()
    assert "No plots were drawn: matplotlib is not installed." in text
    assert text.count("\n| ") == len(rep["cases"]) + 1
    assert not (tmp_path / "torch_plots").exists()


def test_report_refuses_the_references_files(battery_run, capsys):
    _, path, _, _ = battery_run
    for args in (["--out", os.path.join(RESULTS, "report.md")],
                 ["--plots", os.path.join(RESULTS, "plots")],
                 ["--out", os.path.join(RESULTS, "xiaocase1_comparison.txt")]):
        with pytest.raises(SystemExit):
            report.main(["--report", path, *args])
        assert "refusing to write" in capsys.readouterr().err
    with pytest.raises(ValueError, match="reference"):
        report.write_report(path, os.path.join(RESULTS, "report.md"))


@pytest.mark.parametrize("module", ["xiaocase1", "mueller", "wachem",
                                    "bl24", "collide"])
def test_validators_run_on_the_card_unless_asked(module, tmp_path):
    """With no --device each validator takes the CUDA card, and raises
    where there is none (here) rather than carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import importlib
    mod = importlib.import_module(f"sedifoam_tpu_torch.validate.{module}")
    flag = "--cases" if module == "collide" else "--case"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([flag, str(tmp_path), "--out", str(tmp_path / "out")])
