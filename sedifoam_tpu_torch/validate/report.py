"""The port's validation report (the counterpart of
``scripts/generate_report.py``): a markdown table of the battery's
verdicts and a plot of each case against its benchmark data.

Reads results/torch_report.json (validate.battery) and the port's
torch_-prefixed --out files beside it; the benchmark curves come from
--cases-dir where present. Writes results/torch_report.md and
results/torch_plots/*.png. The reference's report (results/report.md,
results/plots/) and every other file of results/ are never written: the
markdown file and the plot directory must carry the torch_ prefix.

matplotlib is imported only to draw the plots. Where it is absent, the
report holds its table and says that no plots were drawn.

  python -m sedifoam_tpu_torch.validate.report [--report FILE]
        [--out FILE.md] [--plots DIR] [--cases-dir DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

from sedifoam_tpu_torch.validate import CASES_DIR, RESULTS, TEST_CASES

REPORT = os.path.join(RESULTS, "torch_report.json")
OUT = os.path.join(RESULTS, "torch_report.md")
PLOTS = os.path.join(RESULTS, "torch_plots")


def _load(results, name):
    import numpy as np
    f = os.path.join(results, "torch_" + name)
    return np.load(f) if os.path.exists(f) else None


def _bench(cases_dir, case, *rel):
    """The benchmark file `rel` of `case` in the case tree, or None where
    no tree is given or the file is absent."""
    if not cases_dir:
        return None
    f = os.path.join(cases_dir, TEST_CASES, case, "data", *rel)
    return f if os.path.exists(f) else None


def _save(plt, plots, name, lines, title):
    plt.savefig(os.path.join(plots, name), dpi=110, bbox_inches="tight")
    plt.close()
    lines.append(f"![{title}]({os.path.basename(plots)}/{name})\n")
    return name


def plot_xiaocase1(plt, results, plots, cases_dir, lines):
    import numpy as np
    d = _load(results, "xiaocase1_dp_curve.npz")
    if d is None:
        return None
    plt.figure(figsize=(7, 4))
    plt.plot(d["times"], d["dp"], "r-", lw=1.5, label="sedifoam_tpu_torch")
    bench_f = _bench(cases_dir, "xiaocase1", "p_bench.dat")
    if bench_f:
        bench = np.loadtxt(bench_f)
        plt.plot(bench[:, 0], bench[:, 1], "k--", lw=1.5, label="benchmark")
    plt.xlabel("t [s]")
    plt.ylabel("probe pressure drop [Pa]")
    plt.title("xiaocase1: fluidized-pipe pressure drop (Xiao & Sun 2011)")
    plt.legend()
    return _save(plt, plots, "xiaocase1_dp.png", lines, "xiaocase1")


def plot_mueller(case, plt, results, plots, cases_dir, lines):
    """The seed mean of the case's torch_<case>_profiles_seed<s>.npz."""
    import numpy as np
    files = sorted(glob.glob(os.path.join(
        results, f"torch_{case}_profiles_seed*.npz")))
    if not files:
        return None
    seeds = [np.load(f) for f in files]
    plt.figure(figsize=(7, 4))
    colors = ["r", "b", "g", "m"]
    for i, name in enumerate(sorted(seeds[0].files)):
        prof = np.mean([s[name] for s in seeds], axis=0)  # x, ux, uy, uz
        plt.plot(prof[:, 0] * 1e3, prof[:, 2], colors[i % 4] + "-",
                 lw=1.5, label=f"{name} (ours, {len(seeds)} seeds)")
        bench_f = _bench(cases_dir, case, "sets_bench", f"{name}_UaMean.xy")
        if bench_f:
            b = np.loadtxt(bench_f)
            plt.plot(b[:, 0] * 1e3, b[:, 2], colors[i % 4] + "--", lw=1.0,
                     label=f"{name} (bench)")
    exp_f = _bench(cases_dir, case, "experimentData")
    if exp_f:
        try:
            e = np.loadtxt(exp_f)
            plt.plot(e[:, 0] * 1e3, e[:, 1], "ko", ms=4, label="experiment")
        except ValueError:
            pass
    plt.xlabel("x [mm]")
    plt.ylabel("UaMean_y [m/s]")
    plt.title(f"{case}: time-averaged solid velocity profiles "
              "(Mueller et al. bubbling bed)")
    plt.legend(fontsize=7)
    return _save(plt, plots, f"{case}_profiles.png", lines, case)


def plot_wachem(plt, results, plots, cases_dir, lines):
    d = _load(results, "expWachem_PCM_probes.npz")
    if d is None:
        return None
    p = d["p"]
    plt.figure(figsize=(7, 4))
    plt.plot(d["times"], p[:, 0], "r-", lw=1, label="local pressure")
    plt.plot(d["times"], d["dp"], "k.", ms=2, label="relative pressure")
    plt.xlabel("t [s]")
    plt.ylabel("p [Pa]")
    plt.title("expWachem_PCM: bed pressure signal (van Wachem)")
    plt.legend()
    return _save(plt, plots, "expWachem_pressure.png", lines, "expWachem")


def plot_jetflow(plt, results, plots, cases_dir, lines):
    import numpy as np
    d = _load(results, "jetflow_centerline.npz")
    if d is None:
        return None
    times, uc = d["times"], d["uc"]
    stations = [int(s) for s in d["stations"]]
    U0 = float(d["U0"])
    _, (a1, a2) = plt.subplots(1, 2, figsize=(11, 4))
    for i, s in enumerate(stations):
        a1.plot(times, uc[:, i] / U0, lw=1, label=f"y/D={s}")
    a1.set_xlabel("t [s]")
    a1.set_ylabel("Uc / U0")
    a1.set_title("jetFlow: centerline velocity (kEqn LES)")
    a1.legend(fontsize=8)
    late = times > 0.6 * times[-1]
    inv = np.asarray(stations, float)
    a2.plot(inv, U0 / np.maximum(uc[late].mean(axis=0), 1e-9), "ro-",
            label="sedifoam_tpu_torch (late-time mean)")
    a2.plot(inv, inv / 5.8, "k--", label="U0/Uc = (y/D)/B, B=5.8 (exp.)")
    a2.set_xlabel("y/D")
    a2.set_ylabel("U0 / Uc")
    a2.set_title("round-jet decay")
    a2.legend(fontsize=8)
    return _save(plt, plots, "jetflow_decay.png", lines, "jetFlow")


def plot_bl24(plt, results, plots, cases_dir, lines):
    d = _load(results, "bl24_bedprofile.npz")
    if d is None:
        return None
    _, (a1, a2) = plt.subplots(1, 2, figsize=(11, 4))
    a1.plot(d["t"], d["ub"], "b-", lw=1, label="bulk Ub_x")
    a1.axhline(0.167, color="k", ls="--", lw=1,
               label="Ubar target 0.167 m/s")
    a1.set_xlabel("t [s]")
    a1.set_ylabel("beta-weighted bulk Ub_x [m/s]")
    a1.set_title("BL24-TH1: Ubar channel-forcing lock")
    a1.legend(fontsize=8)
    a2.plot(d["x_bins"] * 1e3, d["bed_h"] * 1e3, "ro-")
    a2.set_xlabel("x [mm]")
    a2.set_ylabel("bed height (95th pct) [mm]")
    a2.set_title("x-resolved bed profile (dune precursor)")
    return _save(plt, plots, "bl24_bed.png", lines, "BL24-TH1")


def plot_bedload(plt, results, plots, cases_dir, lines):
    d = _load(results, "bedload_transport.npz")
    if d is None:
        return None
    plt.figure(figsize=(7, 4))
    plt.plot(d["t"], d["q_star"], "b-", lw=0.8, alpha=0.6,
             label="instantaneous q*")
    plt.axhline(float(d["q_star_mean"]), color="r", lw=1.5,
                label=f"mean q* = {float(d['q_star_mean']):.2f}")
    plt.axhline(float(d["q_star_mpm"]), color="k", ls="--", lw=1.5,
                label=f"MPM 8(theta-theta_c)^1.5 = "
                      f"{float(d['q_star_mpm']):.2f} "
                      f"(theta = {float(d['theta']):.3f})")
    plt.xlabel("t [s]")
    plt.ylabel("q* = q / sqrt((s-1) g d^3)")
    plt.title("transport-bedload: bed-load rate vs Meyer-Peter & Mueller")
    plt.legend(fontsize=8)
    return _save(plt, plots, "bedload_qstar.png", lines, "bedload")


def plot_suspended(plt, results, plots, cases_dir, lines):
    import numpy as np
    d = _load(results, "suspended_transport.npz")
    if d is None:
        return None
    _, (a1, a2) = plt.subplots(1, 2, figsize=(11, 4))
    a1.plot(d["t"], d["ycom"] * 1e3, "b-", lw=1)
    a1.set_xlabel("t [s]")
    a1.set_ylabel("mobile-particle CoM height [mm]")
    a1.set_title(f"transport-suspended: suspension rise "
                 f"(Rouse P = {float(d['rouse']):.2f})")
    a2.plot(d["t"], d["frac_hi"], "r-", lw=1,
            label="mass fraction above 25% depth")
    a2.plot(d["t"], d["q"] / max(float(np.abs(d["q"]).max()), 1e-12),
            "g-", lw=0.8, alpha=0.6, label="q (normalized)")
    a2.set_xlabel("t [s]")
    a2.legend(fontsize=8)
    a2.set_title("suspension regime indicators")
    return _save(plt, plots, "suspended_transport.png", lines, "suspended")


def plot_dune(plt, results, plots, cases_dir, lines):
    d = _load(results, "dune_migration.npz")
    if d is None:
        return None
    _, (a1, a2) = plt.subplots(1, 2, figsize=(11, 4))
    a1.plot(d["t"], d["xcom"] * 1e3, "b-", lw=1)
    a1.set_xlabel("t [s]")
    a1.set_ylabel("crest-layer CoM x [mm]")
    a1.set_title(f"transport-vortex-dune: crest migration "
                 f"({float(d['migration']) * 1e3:.2f} mm)")
    a2.plot(d["t"], d["q"], "g-", lw=0.8)
    a2.set_xlabel("t [s]")
    a2.set_ylabel("streamwise transport q")
    a2.set_title(f"bed-load rate (q* = {float(d['q_star']):.3f})")
    return _save(plt, plots, "dune_migration.png", lines, "dune")


def plot_irregular(plt, results, plots, cases_dir, lines):
    import numpy as np
    d = _load(results, "irregular_rigidity.npz")
    if d is None:
        return None
    _, (a1, a2) = plt.subplots(1, 2, figsize=(11, 4))
    a1.hist(np.abs(d["gaps1"] - d["gaps0"]).ravel() * 1e9, bins=30,
            color="steelblue")
    a1.set_xlabel("member-gap drift over the run [nm]")
    a1.set_ylabel("count")
    a1.set_title("irregular: rigid-clump member-distance preservation")
    a2.plot(d["vx"], "b-", lw=1, label="clump vx")
    a2.plot(d["vy"], "r-", lw=1, label="clump vy")
    a2.set_xlabel("member")
    a2.set_ylabel("mobile-clump member velocity [m/s]")
    a2.set_title("clump transport under the current")
    a2.legend(fontsize=8)
    return _save(plt, plots, "irregular_rigidity.png", lines, "irregular")


PLOTTERS = (
    plot_xiaocase1,
    lambda *a: plot_mueller("expMueller06", *a),
    lambda *a: plot_mueller("expMueller09", *a),
    plot_wachem, plot_jetflow, plot_bl24, plot_bedload, plot_suspended,
    plot_dune, plot_irregular)


def table(report) -> list:
    """The markdown table: one row per case, its verdict (PASS, FAIL or
    NOT RUN with what is missing) and its numbers."""
    lines = ["| case | verdict | key metrics |", "|---|---|---|"]
    for name, entry in report.get("cases", {}).items():
        if "not_run" in entry:
            lines.append(f"| {name} | NOT RUN | {entry['not_run']} |")
            continue
        metrics = {k: round(v, 4) for k, v in entry.items()
                   if isinstance(v, float) and k != "wall_s"}
        verdict = "PASS" if entry.get("passed") else "FAIL"
        lines.append(f"| {name} | {verdict} | `{metrics}` |")
    return lines + [""]


def check_target(path, what):
    """Raise unless `path`'s name carries the torch_ prefix: the
    reference's report.md and plots/, and every file results/ holds, are
    someone else's."""
    if not os.path.basename(os.path.normpath(path)).startswith("torch_"):
        raise ValueError(f"refusing to write {what} {path}: the port's "
                         "report files are torch_-prefixed (results/"
                         "report.md and results/plots/ are the reference's)")


def write_report(report_path=REPORT, out=OUT, plots=PLOTS,
                 cases_dir=CASES_DIR) -> dict:
    """Write the markdown report (and the plots, where matplotlib is
    present); returns {"out", "plots": [file names], "plots_drawn",
    "cases"}."""
    check_target(out, "the report")
    check_target(plots, "the plots into")
    with open(report_path) as f:
        report = json.load(f)
    results = os.path.dirname(os.path.abspath(report_path))
    lines = ["# sedifoam_tpu_torch validation report\n",
             "The case battery on the port (sedifoam_tpu_torch.validate."
             "battery; the reference's `cases/auto-testing` suite and its "
             f"example cases): see `{os.path.basename(report_path)}` for "
             "the raw metrics." + (" Quick run (smoke mode)." if
                                   report.get("quick") else "") + "\n"]
    lines += table(report)
    drawn = []
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        plt = None
    if plt is None:
        lines.append("No plots were drawn: matplotlib is not installed.\n")
    else:
        os.makedirs(plots, exist_ok=True)
        for plot in PLOTTERS:
            name = plot(plt, results, plots, cases_dir, lines)
            if name:
                drawn.append(name)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        f.write("\n".join(lines))
    return {"out": out, "plots": drawn, "plots_drawn": plt is not None,
            "cases": len(report.get("cases", {}))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--report", default=REPORT)
    ap.add_argument("--out", default=OUT)
    ap.add_argument("--plots", default=PLOTS)
    ap.add_argument("--cases-dir", default=CASES_DIR)
    args = ap.parse_args(argv)
    try:
        res = write_report(args.report, args.out, args.plots,
                           args.cases_dir)
    except ValueError as e:
        ap.error(str(e))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
