"""xiaocase1 golden validation on the port: fluidized-pipe probe pressure
drop (the counterpart of ``scripts/validate_xiaocase1.py``).

Reference: cases/auto-testing/test-cases/xiaocase1 — 2,160 1.5 mm glass
particles in a 4 x 20 cm air column; the inlet ramps 0 -> 1.5 m/s over
15 s and back. The validation metric is the pressure drop between probes
at y=0.002 and y=0.16 (postprocessing.py:12-20) against data/p_bench.dat:
pointwise on the deterministic fixed-bed ramp (t < 8 s), by its mean on
the chaotic bubbling plateau (9-23 s).

--ckpt-split T checkpoints at t = T, drops the Simulation, and resumes from
the checkpoint into a fresh Simulation (re-loaded, re-initialized: the
`startFrom latestTime` path) before running on to t_end; every gate must
pass as in a straight run.

Run: python -m sedifoam_tpu_torch.validate.xiaocase1 [--t-end 2.0] [--f64]
     [--case DIR] [--out FILE.npz] [--ckpt-split T] [--device cpu]
Prints one JSON line with the script's keys; --out is written under a
torch_-prefixed name.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

from sedifoam_tpu_torch.validate import TEST_CASES, ref_case, torch_out

CASE = ref_case(TEST_CASES, "xiaocase1")
# probe locations of xiaocase1/system/controlDict's functions block
PROBES = [(0.02, 0.002, 0.003), (0.02, 0.16, 0.003)]
STEPS_PER_VISIT = 20
PROBE_EVERY = 5


def _load(case, dtype, device):
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.solver import initialize
    cfg, fluid, particles, _ = load_case(case, backend="binned",
                                         dtype=dtype, device=device)
    return cfg, initialize(fluid, particles, cfg)


def run(case, t_end=2.0, dtype=None, ckpt_split=0.0, out="",
        device=None, steps_per_host_visit=STEPS_PER_VISIT,
        timing_reps=5) -> dict:
    """Load the case (binned, `dtype`: f32 unless given), run it to t_end
    with the two probes sampled every PROBE_EVERY host visits, and
    compare dp with data/p_bench.dat. Returns the script's result
    dict."""
    import numpy as np
    import torch

    from sedifoam_tpu_torch import default_device
    from sedifoam_tpu_torch.runtime import diagnostics as _diag
    from sedifoam_tpu_torch.runtime.runner import Simulation

    device = default_device(device)
    dtype = dtype or torch.float32
    cfg, state = _load(case, dtype, device)
    sim = Simulation(cfg, state, probe_locations=PROBES,
                     steps_per_host_visit=steps_per_host_visit,
                     device=device)
    resumed_at = None
    if 0.0 < ckpt_split < t_end:
        sim.run(ckpt_split, probe_every=PROBE_EVERY)
        with tempfile.TemporaryDirectory(prefix="xc1_ckpt_") as tmp:
            ckpt = sim.save_checkpoint(os.path.join(tmp, "checkpoint.npz"))
            resumed_at = sim.t
            wall_before = sim.wall_time
            del sim, state
            # a fresh Simulation, as a restarted process: re-load, re-init,
            # restore everything (the contact history, the probe series)
            cfg, state = _load(case, dtype, device)
            sim = Simulation(cfg, state, probe_locations=PROBES,
                             steps_per_host_visit=steps_per_host_visit,
                             device=device)
            sim.resume(ckpt)
        sim.wall_time = wall_before
        assert abs(sim.t - resumed_at) < 1e-9
    sim.run(t_end, probe_every=PROBE_EVERY)

    times, p = sim.probes.series("p")
    dp = p[:, 0] - p[:, 1]
    bench = np.loadtxt(os.path.join(case, "data", "p_bench.dat"))

    result = {"t_end": t_end, "n_samples": int(len(times)),
              "wall_time_s": round(sim.wall_time, 2)}
    if resumed_at is not None:
        result["resumed_at"] = round(resumed_at, 6)
    ramp = (times >= bench[0, 0]) & (times < min(8.0, t_end))
    if ramp.any():
        b = np.interp(times[ramp], bench[:, 0], bench[:, 1])
        result["ramp_max_rel_err"] = float(
            np.abs(dp[ramp] - b).max() / np.abs(b).max())
    plateau = (times > 9.0) & (times < 23.0)
    if plateau.any():
        bm = (bench[:, 0] > 9.0) & (bench[:, 0] < 23.0)
        result["plateau_mean"] = float(dp[plateau].mean())
        result["plateau_mean_bench"] = float(bench[bm, 1].mean())
        result["plateau_rel_err"] = abs(
            result["plateau_mean"] / result["plateau_mean_bench"] - 1.0)
    diag = _diag.to_host(sim.diag_fn(sim.state))
    for k in ("continuity_err", "audit_drift_asrc_y", "alpha_min"):
        result[k] = diag[k]
    result["timing_split_ms"] = {
        k: round(v * 1e3, 2)
        for k, v in sim.timing_split(n=timing_reps).items()}
    if out:
        np.savez(torch_out(out), times=times, dp=dp)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t-end", type=float, default=2.0)
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--case", default=CASE, required=CASE is None)
    ap.add_argument("--out", default="")
    ap.add_argument("--ckpt-split", type=float, default=0.0, metavar="T",
                    help="checkpoint at t=T and resume into a fresh "
                         "Simulation before running on to t_end")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    import torch
    result = run(args.case, args.t_end,
                 torch.float64 if args.f64 else torch.float32,
                 args.ckpt_split, args.out, args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
