"""expWachem_PCM validation on the port: fluidized-bed pressure signal
(the counterpart of ``scripts/validate_wachem.py``).

Reference: cases/auto-testing/test-cases/expWachem_PCM — the van Wachem
bubbling bed. The reference ships no benchmark curve, so the gates are
physical invariants and a regression against a recorded baseline:

1. the time-mean probe pressure drop over the fluidized phase supports
   the buoyant weight of the suspension between the probe heights,
   taken from the time-averaged alpha field over the same window;
2. the continuity residual stays small;
3. alpha stays in [0, maxPossibleAlpha];
4. dp mean against the baseline's (results/expWachem_PCM_baseline.npz:
   dp_mean there is a pressure in Pa from the reference package's run)
   when that file exists.

The baseline is only read. Where it is absent and --out is given, the
run records its own dp under a torch_-prefixed name beside it and
reports `status: "baseline"`: a run that created its baseline has
nothing to regress against, and the battery never counts it a pass.

The gas-solid density ratio puts the explicit drag reaction's coupling
gain above 1: the run uses the semi-implicit fluid-side drag.

Run: python -m sedifoam_tpu_torch.validate.wachem [--t-end 3.0]
     [--case DIR] [--out PREFIX] [--baseline FILE.npz] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os

from sedifoam_tpu_torch.validate import (RESULTS, TEST_CASES, ref_case,
                                         torch_out)

CASE = ref_case(TEST_CASES, "expWachem_PCM")
BASELINE = os.path.join(RESULTS, "expWachem_PCM_baseline.npz")
DEFAULT_PROBES = [(0.045, 0.005, 0.004), (0.045, 0.4, 0.004)]
STEPS_PER_VISIT = 25


def run(case, t_end=3.0, out="", baseline=BASELINE, device=None,
        steps_per_host_visit=STEPS_PER_VISIT, timing_reps=5) -> dict:
    """Load the case (binned, f32, semi-implicit drag), sample the
    controlDict's probes every visit, average alpha over the fluidized
    window, and compare dp with the bed weight and the baseline. Returns
    the script's result dict."""
    import numpy as np
    import torch

    from sedifoam_tpu_torch import default_device
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.run_case import probe_locations_from_controldict
    from sedifoam_tpu_torch.runtime import diagnostics as _diag
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import initialize
    from sedifoam_tpu_torch.utils.postprocess import TimeAverager
    from sedifoam_tpu_torch.validate import semi_implicit

    device = default_device(device)
    cfg, fluid, particles, _ = load_case(case, backend="binned",
                                         dtype=torch.float32, device=device)
    cfg = semi_implicit(cfg)
    state = initialize(fluid, particles, cfg)

    probes = probe_locations_from_controldict(case) or DEFAULT_PROBES
    sim = Simulation(cfg, state, probe_locations=probes,
                     steps_per_host_visit=steps_per_host_visit,
                     device=device)
    avg = TimeAverager()
    t_fluid = min(1.0, 0.5 * t_end)

    def on_sample(s):
        if s.t > t_fluid:
            avg.add(alpha=s.state.fluid.alpha)

    sim.run(t_end, probe_every=1, log_every=40, on_sample=on_sample)

    times, p = sim.probes.series("p")
    # the probe pair bracketing the largest height span (the controlDict
    # probes sit inside the bed: the balance is against the bed mass
    # between those heights)
    ys = [loc[1] for loc in probes]
    i_lo, i_hi = int(np.argmin(ys)), int(np.argmax(ys))
    y_lo, y_hi = ys[i_lo], ys[i_hi]
    dp = p[:, i_lo] - p[:, i_hi]
    fluidized = times > t_fluid
    dp_mean = float(dp[fluidized].mean())

    ps = sim.state.particles
    act = ps.active.cpu().numpy()
    rho_p = float(ps.density.cpu().numpy()[act].mean())
    g = abs(cfg.fluid.gravity[1])
    alpha_mean = avg.mean("alpha")
    yc = np.asarray(cfg.grid.axis_centers(1))
    wy = np.asarray(cfg.grid.axis_widths(1))
    in_span = (yc >= y_lo) & (yc <= y_hi)
    alpha_y = alpha_mean.mean(axis=(0, 2))      # column-averaged profile
    dp_bed = float((rho_p - cfg.fluid.rhob) * g
                   * np.sum(alpha_y[in_span] * wy[in_span]))

    diag = _diag.to_host(sim.diag_fn(sim.state))
    result = {
        "case": "expWachem_PCM", "t_end": t_end,
        "n_particles": int(act.sum()),
        "wall_time_s": round(sim.wall_time, 2),
        "dp_mean": dp_mean, "dp_bed_weight": dp_bed,
        "dp_vs_bed_weight_rel_err": abs(dp_mean / dp_bed - 1.0),
        "continuity_err": diag["continuity_err"],
        "alpha_min": diag["alpha_min"], "alpha_max": diag["alpha_max"],
        "audit_drift_asrc_y": diag["audit_drift_asrc_y"],
    }
    if baseline and os.path.exists(baseline):
        base = np.load(baseline)
        result["baseline_dp_mean"] = float(base["dp_mean"])
        result["dp_vs_baseline_rel_err"] = abs(
            dp_mean / float(base["dp_mean"]) - 1.0)
    elif baseline and out:
        np.savez(torch_out(baseline), times=times, dp=dp, dp_mean=dp_mean)
        result["baseline_created"] = True
        result["status"] = "baseline"
    result["timing_split_ms"] = {
        k: round(v * 1e3, 2)
        for k, v in sim.timing_split(n=timing_reps).items()}
    if out:
        prefix = torch_out(out)
        np.savez(prefix + "_probes.npz", times=times, p=p, dp=dp)
        with open(prefix + "_summary.json", "w") as f:
            json.dump(result, f, indent=1)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t-end", type=float, default=3.0)
    ap.add_argument("--case", default=CASE, required=CASE is None)
    ap.add_argument("--out", default="")
    ap.add_argument("--baseline", default=BASELINE)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    result = run(args.case, args.t_end, args.out, args.baseline,
                 args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
