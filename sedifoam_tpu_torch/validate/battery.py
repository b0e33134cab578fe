"""The case battery on the port (the counterpart of
``scripts/run_all_cases.py``): every case of the reference battery, end
to end, each judged by its own gates, into results/torch_report.json.

  python -m sedifoam_tpu_torch.validate.battery [--only case1,case2]
        [--quick] [--cases-dir DIR] [--report FILE] [--device cpu]

Cases: xiaocase3 (the one-particle settling curve against
tests/golden_data/xiaoCase3.dat, dense DEM, f64), irregular,
transport-bedload, transport-suspended, transport-vortex-dune and jetFlow
(their validators' `passed`; the port writes their case directories),
and the reference's own auto-testing and example cases, read from
--cases-dir (the reference's case tree: auto-testing/test-cases/<case>,
example-cases/<case>; default $SEDIFOAM_CASES_DIR, else none):
xiaocase1 (ramp and plateau of the probe dp),
expMueller06 and expMueller09 (seed-mean UaMean profiles), expWachem_PCM
(dp against the bed weight and the baseline), BL24-TH1 (its validator's
`passed`) and multiParticlesCollide (the traces of
tests/golden_data). Each of these runs where its files are found under
--cases-dir; otherwise the report lists it as
`"not_run": "missing under DIR: <files>"` (with no tree given: `"no case
tree given ...: needs <directories>"`): not passed, not left out.
--quick shortens the runs (smoke mode; the report is marked quick); the
runs' lengths are run_all_cases.py's (QUICK_T, FULL_T).

A full run streams into <report>.partial and replaces the report only
when every selected case has run: an interrupted battery never leaves a
stub in place of the last complete report. --only merges into the
existing report, case by case. The validators' --out files go beside the
report under torch_-prefixed names. The reference's own report
(results/report.json) is never written.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from sedifoam_tpu_torch.validate import (CASES_DIR, EXAMPLE_CASES, REPO,
                                         RESULTS, TEST_CASES, missing_files)

GOLDEN = os.path.join(REPO, "tests", "golden_data")

# the reference's cases read from the case tree: {name: (their
# directories under it, the files each needs beyond the loader's)}
REF_CASES = {
    "multiParticlesCollide": (
        (os.path.join(TEST_CASES, "multiParticlesCollideDia"),
         os.path.join(TEST_CASES, "multiParticlesCollideRho")), ()),
    "xiaocase1": ((os.path.join(TEST_CASES, "xiaocase1"),),
                  ("data/p_bench.dat",)),
    "expMueller06": ((os.path.join(TEST_CASES, "expMueller06"),),
                     ("system/sampleDict",
                      "data/sets_bench/lineY3_UaMean.xy")),
    "expMueller09": ((os.path.join(TEST_CASES, "expMueller09"),),
                     ("system/sampleDict",) + tuple(
                         f"data/sets_bench/lineY{i}_UaMean.xy"
                         for i in (3, 4, 5))),
    "expWachem_PCM": ((os.path.join(TEST_CASES, "expWachem_PCM"),), ()),
    "BL24-TH1": ((os.path.join(EXAMPLE_CASES, "BL24-TH1"),), ()),
}
# the runs' lengths in simulated seconds (run_all_cases.py:91-95)
# and of scripts/validate_bl24.py (--quick: 0.05 s; its default 2 s)
QUICK_T = {"xiaocase1": 4.0, "mueller": 1.0, "mueller_avg": 0.5,
           "wachem": 0.5, "bl24": 0.05}
FULL_T = {"xiaocase1": 30.0, "mueller": 10.0, "mueller_avg": 2.0,
          "wachem": 3.0, "bl24": 2.0}
MUELLER_SEEDS = {True: (0,), False: (0, 1, 2)}
# a full xiaocase1 run checkpoints at 15 s and resumes into a fresh
# Simulation (the end-to-end `startFrom latestTime` path)
XIAOCASE1_SPLIT = 15.0
# the cases judged by their validator's `passed`
VALIDATED = ("irregular", "transport-bedload", "transport-suspended",
             "transport-vortex-dune", "jetFlow", "BL24-TH1")


def missing(name, cases_dir) -> str:
    """Why the reference case `name` cannot run from `cases_dir` (the
    files absent, or the directories it needs where no tree is given), or
    "" when it can."""
    dirs, extra = REF_CASES[name]
    if not cases_dir:
        return ("no case tree given (--cases-dir, $SEDIFOAM_CASES_DIR): "
                "needs " + ", ".join(rel + "/" for rel in dirs))
    gaps = []
    for rel in dirs:
        case = os.path.join(cases_dir, rel)
        if not os.path.isdir(case):
            gaps.append(rel + "/")
            continue
        gaps += [os.path.join(rel, f) for f in missing_files(case, extra)]
    return f"missing under {cases_dir}: " + ", ".join(gaps) if gaps else ""


def not_run(cases_dir) -> dict:
    """{case: why} of the reference cases whose files are absent from
    `cases_dir` (all of them where it is None)."""
    return {n: why for n in REF_CASES if (why := missing(n, cases_dir))}


# with no case tree given: every reference case
NOT_RUN = not_run(None)


def run_xiaocase3(device=None, quick=False) -> dict:
    """The port's xiaocase3 through Simulation (250 steps; 50 with quick)
    against the golden settling curve."""
    import numpy as np
    import torch

    from sedifoam_tpu_torch import cases, default_device
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import CoupledStep
    device = default_device(device)
    cfg, fluid, particles = cases.xiaocase3(torch.float64, device)
    state = CoupledStep(cfg, torch.float64, device).initialize(fluid,
                                                               particles)
    sim = Simulation(cfg, state, device=device)
    times, vels = [], []

    def record(s):
        t, v = torch.stack([s.state.fluid.time,
                            s.state.particles.vel[0, 1]]).tolist()
        times.append(t)
        vels.append(v)

    n_steps = 50 if quick else 250
    sim.run((n_steps - 0.5) * cfg.fluid.dt, on_sample=record)
    times, vels = np.asarray(times), np.asarray(vels)
    bench = np.loadtxt(os.path.join(GOLDEN, "xiaoCase3.dat"))
    vb = np.interp(times, bench[:, 0], bench[:, 1])
    mask = times > 2e-4
    return {
        "quick": bool(quick),
        "steps": int(len(times)),
        "wall_time_s": round(sim.wall_time, 2),
        "v_end": float(vels[-1]),
        "v_end_benchmark": float(vb[-1]),
        "curve_max_dev": float(np.max(np.abs(vels[mask] - vb[mask]))),
        "finite": bool(np.isfinite(vels).all()),
    }


def judge(name, data, quick=False) -> bool:
    """Tolerance gates per case (a missing metric fails): those of
    tests/test_golden_xiaocase3.py and run_all_cases.py's judge."""
    try:
        if "not_run" in data:
            return False
        if name == "xiaocase3":
            # tests/test_golden_xiaocase3.py's bounds: the curve within
            # 0.004 m/s after the first 2e-4 s, the terminal velocity
            # within 5% of the 0.05 m/s inflow (full runs reach it)
            ok = bool(data["finite"]) and data["curve_max_dev"] < 0.004
            if not quick:
                ok &= abs(data["v_end"] - data["v_end_benchmark"]) \
                    < 0.05 * 0.05
            return bool(ok)
        if name in VALIDATED:
            return bool(data.get("passed"))
        if name == "xiaocase1":
            # the deterministic fixed-bed ramp pointwise; the chaotic
            # plateau by its mean where the run reached it
            ok = data.get("ramp_max_rel_err", 1.0) < 0.08
            if "plateau_rel_err" in data:
                ok &= data["plateau_rel_err"] < 0.05
            return bool(ok)
        if name.startswith("expMueller"):
            return _judge_mueller(name, data)
        if name == "expWachem_PCM":
            ok = data.get("dp_vs_bed_weight_rel_err", 1.0) < 0.10
            ok &= data.get("continuity_err", 1e9) < 0.1
            ok &= data.get("alpha_min", -1.0) > -1e-4
            # a run that created its own baseline has nothing to regress
            # against: never a pass; full runs need the comparison
            ok &= data.get("status") != "baseline"
            if not quick:
                ok &= data.get("dp_vs_baseline_rel_err", 1e9) < 0.10
            elif "dp_vs_baseline_rel_err" in data:
                ok &= data["dp_vs_baseline_rel_err"] < 0.10
            return bool(ok)
        if name == "multiParticlesCollide":
            # tests/test_golden_collide.py:62-66: y within 4 mm, vy within
            # 0.03 m/s of the traces, every particle of both cases
            return bool(len(data["cases"]) == 2
                        and data["y_max_dev"] < 4e-3
                        and data["vy_max_dev"] < 0.03)
    except (TypeError, KeyError):
        return False
    return False  # an unknown case is never passed


def _judge_mueller(name, data) -> bool:
    """The lines the reference's report compares (UaMean on lineY3 for
    06, lineY3-5 for 09): a multi-seed run's seed mean within RMS 0.25 and
    correlation 0.90; a single-seed run within the sanity bound RMS 0.50
    (a bubbling bed's amplitude swings ~2x between realizations); alphaMean
    on lineY1/Y2 within 0.20 where benchmarked. A seed that failed fails
    the case."""
    if "error" in data:                       # a seed did not run
        return False
    lines = (("lineY3",) if name.endswith("06")
             else ("lineY3", "lineY4", "lineY5"))
    if "seedmean_lineY3_uy_rms_err" in data:
        ok = True
        for line in lines:
            ok &= data.get(f"seedmean_{line}_uy_rms_err", 1.0) < 0.25
            ok &= data.get(f"seedmean_{line}_uy_corr", 0.0) > 0.90
        aerrs = [v for k, v in data.items()
                 if k.endswith("_alpha_rms_err")
                 and ("lineY1" in k or "lineY2" in k)]
        if aerrs:
            ok &= max(aerrs) < 0.20
        return bool(ok)
    errs = [v for k, v in data.items() if k.endswith("_uy_rms_err")
            and k.split("_uy")[0] in lines]
    corrs = [v for k, v in data.items() if k.endswith("_uy_corr")
             and k.split("_uy")[0] in lines]
    aerrs = [v for k, v in data.items() if k.endswith("_alpha_rms_err")
             and k.split("_alpha")[0] in ("lineY1", "lineY2")]
    ok = bool(errs) and max(errs) < 0.50
    if corrs:
        ok &= min(corrs) > 0.90
    if aerrs:
        ok &= max(aerrs) < 0.20
    return bool(ok)


def case_runners(device, quick, cases_dir=CASES_DIR, out_dir=RESULTS):
    """{name: function returning the case's result dict}: the port's own
    cases, and each reference case whose files are under `cases_dir`.
    A run's --out files go to `out_dir` under torch_-prefixed names (full
    runs only for the validators whose scripts take --out only then)."""
    from sedifoam_tpu_torch.validate import (bedload, bl24, collide, dune,
                                             irregular, jetflow, mueller,
                                             suspended, torch_out, wachem,
                                             xiaocase1)

    def out(name):
        return torch_out(os.path.join(out_dir, name))

    def validator(module, out_name):
        kw = dict(module.QUICK, quick=True) if quick else \
            {"out": out(out_name)}
        return lambda: module.run(device=device, **kw)

    runners = {
        "xiaocase3": lambda: run_xiaocase3(device, quick),
        "irregular": validator(irregular, "irregular_rigidity.npz"),
        "transport-bedload": validator(bedload, "bedload_transport.npz"),
        "transport-suspended": validator(suspended,
                                         "suspended_transport.npz"),
        "transport-vortex-dune": validator(dune, "dune_migration.npz"),
        "jetFlow": validator(jetflow, "jetflow_centerline.npz"),
    }
    times = QUICK_T if quick else FULL_T

    def case(name):
        return os.path.join(cases_dir, REF_CASES[name][0][0])

    def run_mueller(name):
        # a seed that failed leaves its traceback under "error"
        return lambda: mueller.run_seeds(
            case(name), MUELLER_SEEDS[bool(quick)], times["mueller"],
            times["mueller_avg"], out_dir=out_dir, device=device,
            say=lambda m: print(m, flush=True))[1]

    ref = {
        "multiParticlesCollide": lambda: collide.run(
            os.path.join(cases_dir, TEST_CASES),
            out=out("collide_traces.npz"), device=device),
        "xiaocase1": lambda: xiaocase1.run(
            case("xiaocase1"), times["xiaocase1"],
            ckpt_split=0.0 if quick else XIAOCASE1_SPLIT,
            out=out("xiaocase1_dp_curve.npz"), device=device),
        "expMueller06": run_mueller("expMueller06"),
        "expMueller09": run_mueller("expMueller09"),
        "expWachem_PCM": lambda: wachem.run(
            case("expWachem_PCM"), times["wachem"],
            out=out("expWachem_PCM"), device=device),
        "BL24-TH1": lambda: bl24.run(
            case("BL24-TH1"), times["bl24"], quick=quick,
            out="" if quick else out("bl24_bedprofile.npz"),
            device=device),
    }
    runners.update({n: fn for n, fn in ref.items()
                    if not missing(n, cases_dir)})
    return runners


def run_battery(runners, report_path, only=(), quick=False,
                say=print, not_run=NOT_RUN) -> dict:
    """Run `runners` (all, or those named in `only`) and write the report,
    the cases of `not_run` listed as not run. Returns the report."""
    os.makedirs(os.path.dirname(os.path.abspath(report_path)), exist_ok=True)
    report = {"quick": bool(quick), "cases": {}}
    if only and os.path.exists(report_path):
        with open(report_path) as f:
            prev = json.load(f)
        if bool(prev.get("quick")) == bool(quick):
            report["cases"].update(prev.get("cases", {}))
    live_path = report_path if only else report_path + ".partial"
    selected = [n for n in only if n in runners] if only else list(runners)

    def flush():
        with open(live_path, "w") as f:
            json.dump(report, f, indent=1)

    for name, why in not_run.items():
        report["cases"][name] = {"passed": False, "not_run": why}
    for name in selected:
        say(f"=== {name} ...")
        t0 = time.time()
        try:
            data, ok = runners[name](), True
        except Exception:                     # recorded as a failed case
            data, ok = {"error": traceback.format_exc()[-2000:]}, False
        secs = time.time() - t0
        passed = ok and judge(name, data, quick)
        report["cases"][name] = {"passed": bool(passed),
                                 "wall_s": round(secs, 1), **data}
        say(f"=== {name}: {'PASS' if passed else 'FAIL'} ({secs:.0f}s) "
            f"{json.dumps(data)[:300]}")
        flush()
    flush()
    if live_path != report_path:
        os.replace(live_path, report_path)
    return report


def summary(report):
    """(passed, run, not run) counts of a report."""
    ran = [c for c in report["cases"].values() if "not_run" not in c]
    return (sum(1 for c in ran if c["passed"]), len(ran),
            len(report["cases"]) - len(ran))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cases-dir", default=CASES_DIR,
                    help="the reference's case tree (auto-testing/"
                         "test-cases/<case>, example-cases/<case>)")
    ap.add_argument("--report",
                    default=os.path.join(RESULTS, "torch_report.json"))
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if os.path.abspath(args.report) == os.path.join(RESULTS, "report.json"):
        ap.error("results/report.json is the reference battery's report")
    from sedifoam_tpu_torch import default_device
    device = default_device(args.device)
    only = [c.strip() for c in args.only.split(",") if c.strip()]
    runners = case_runners(device, args.quick, args.cases_dir,
                           os.path.dirname(os.path.abspath(args.report)))
    unknown = [c for c in only if c not in runners]
    if unknown:
        ap.error(f"unknown or not runnable: {unknown}; runnable: "
                 f"{sorted(runners)}")
    report = run_battery(runners, args.report, only, args.quick,
                         say=lambda m: print(m, flush=True),
                         not_run=not_run(args.cases_dir))
    n_pass, n_run, n_not = summary(report)
    print(f"=== {n_pass}/{n_run} cases passed, {n_not} not run -> "
          f"{args.report}", flush=True)
    if n_pass != n_run:
        sys.exit(1)
    return report


if __name__ == "__main__":
    main()
