"""expMueller06/09 golden validation on the port: fluidized-bed mean
velocity profiles (the counterpart of ``scripts/validate_expMueller.py``
and of the multi-seed loop of ``scripts/run_all_cases.py``).

Reference: cases/auto-testing/test-cases/expMueller06 (and 09) — the
Mueller et al. bubbling-bed experiment: 9,240 1.2 mm particles in a
44 mm column. The metric is the time-averaged solid velocity (UaMean)
along the sampleDict's lineY* lines against data/sets_bench/*_UaMean.xy,
and alphaMean where the case ships *_alphaMean.xy.

A seed s > 0 is an independent realization: the initial positions are
jittered by +-2% r, drawn with np.random.RandomState(s) as the script
draws them, so seed s starts from the script's exact positions. The
battery gates the seed-mean profile of the lines the reference's report
compares (lineY3 for 06, lineY3-5 for 09): a bubbling bed is chaotic and
one realization's amplitude swings ~2x.

Run: python -m sedifoam_tpu_torch.validate.mueller [--case DIR]
     [--t-end 10] [--t-avg-start 2] [--seed 0] [--out FILE.npz]
     [--device cpu]
Prints one JSON line with the script's keys; --out is written under a
torch_-prefixed name.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

from sedifoam_tpu_torch.validate import TEST_CASES, ref_case, torch_out

CASE = ref_case(TEST_CASES, "expMueller06")
# samples for the running average every 50 steps (the reference's
# fieldAverage accumulates every step; over thousands of samples the
# means agree)
STEPS_PER_VISIT = 50


def case_name(case) -> str:
    return os.path.basename(os.path.normpath(case))


def gate_lines(case) -> tuple:
    """The lines the reference's own report compares UaMean on."""
    return ("lineY3",) if case_name(case).endswith("06") else \
        ("lineY3", "lineY4", "lineY5")


def jittered(particles, seed):
    """The particles with their positions jittered by +-2% r, drawn as
    scripts/validate_expMueller.py draws them (seed 0: unchanged)."""
    import numpy as np
    import torch
    if not seed:
        return particles
    rng = np.random.RandomState(seed)
    rad = particles.radius.cpu().numpy()
    jit = rng.uniform(-0.02, 0.02, (rad.shape[0], 3)) * rad[:, None]
    return particles._replace(pos=particles.pos + torch.as_tensor(
        jit, dtype=particles.pos.dtype, device=particles.pos.device))


def sample_lines(case) -> dict:
    """{name: (start, end, nPoints)} of system/sampleDict's sets."""
    from sedifoam_tpu_torch.io import foamdict
    sample_d = foamdict.parse_file(os.path.join(case, "system",
                                                "sampleDict"))
    lines = {}
    sets = sample_d.get("sets", [])
    i = 0
    while i < len(sets) - 1:
        name, spec = sets[i], sets[i + 1]
        if isinstance(spec, dict) and "start" in spec:
            lines[name] = (spec["start"], spec["end"],
                           int(spec.get("nPoints", 100)))
            i += 2
        else:
            i += 1
    return lines


def profiles_run(case, t_end=10.0, t_avg_start=2.0, seed=0,
                 device=None, steps_per_host_visit=STEPS_PER_VISIT,
                 timing_reps=5):
    """One realization: (the script's result dict, {line: (n, 4) array
    of x, UaMean}) ."""
    import numpy as np
    import torch

    from sedifoam_tpu_torch import default_device
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.runtime import diagnostics as _diag
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import initialize
    from sedifoam_tpu_torch.utils.postprocess import TimeAverager, line_sample

    device = default_device(device)
    cfg, fluid, particles, _ = load_case(case, backend="binned",
                                         dtype=torch.float32, device=device)
    particles = jittered(particles, seed)
    state = initialize(fluid, particles, cfg)
    sim = Simulation(cfg, state, steps_per_host_visit=steps_per_host_visit,
                     device=device)
    avg = TimeAverager()

    def on_sample(s):
        if s.t >= t_avg_start:
            avg.add(Ua=s.state.fluid.Ua, alpha=s.state.fluid.alpha)

    sim.run(t_end, on_sample=on_sample)
    ua_mean = avg.mean("Ua")

    result = {"case": case_name(case), "t_end": t_end,
              "wall_time_s": round(sim.wall_time, 2)}
    profiles = {}
    bench_dir = os.path.join(case, "data", "sets_bench")
    for name, (start, end, npts) in sample_lines(case).items():
        pts, vals = line_sample(ua_mean, cfg.grid, start, end, npts)
        profiles[name] = np.column_stack([pts[:, 0], vals])
        bench_f = os.path.join(bench_dir, f"{name}_UaMean.xy")
        if os.path.exists(bench_f):
            bench = np.loadtxt(bench_f)
            vy = np.interp(bench[:, 0], pts[:, 0], vals[:, 1])
            denom = max(np.abs(bench[:, 2]).max(), 1e-9)
            result[f"{name}_uy_rms_err"] = float(
                np.sqrt(np.mean((vy - bench[:, 2]) ** 2)) / denom)
            result[f"{name}_uy_corr"] = float(
                np.corrcoef(vy, bench[:, 2])[0, 1])
        bench_a = os.path.join(bench_dir, f"{name}_alphaMean.xy")
        if os.path.exists(bench_a):
            _, avals = line_sample(avg.mean("alpha"), cfg.grid, start, end,
                                   npts)
            ba = np.loadtxt(bench_a)
            av = np.interp(ba[:, 0], pts[:, 0], avals)
            denom = max(np.abs(ba[:, 1]).max(), 1e-9)
            result[f"{name}_alpha_rms_err"] = float(
                np.sqrt(np.mean((av - ba[:, 1]) ** 2)) / denom)
    diag = _diag.to_host(sim.diag_fn(sim.state))
    for k in ("continuity_err", "audit_drift_asrc_y", "alpha_min"):
        result[k] = diag[k]
    result["timing_split_ms"] = {
        k: round(v * 1e3, 2)
        for k, v in sim.timing_split(n=timing_reps).items()}
    return result, profiles


def run(case, t_end=10.0, t_avg_start=2.0, seed=0, out="",
        device=None, **kw) -> dict:
    """One realization; returns the script's result dict and writes the
    line profiles to torch_-prefixed `out`."""
    import numpy as np
    result, profiles = profiles_run(case, t_end, t_avg_start, seed, device,
                                    **kw)
    if out:
        np.savez(torch_out(out), **profiles)
    return result


def run_seeds(case, seeds=(0, 1, 2), t_end=10.0, t_avg_start=2.0,
              out_dir="", device=None, say=print, **kw):
    """The seeds one after another, as run_all_cases.py's multi-seed
    loop: (all ran, its data dict). Seed 0's keys stand bare, seed s's
    with the prefix `seed{s}_`; then the seed-mean UaMean's RMS error and
    correlation against the benchmark on each gate line, and each seed's
    RMS error. With `out_dir`, seed s's profiles go to
    torch_<case>_profiles_seed<s>.npz there."""
    import numpy as np
    name = case_name(case)
    data = {"seeds": list(seeds)}
    oks, profs = [], []
    for s in seeds:
        t0 = time.time()
        try:
            d, prof = profiles_run(case, t_end, t_avg_start, s, device, **kw)
            ok = True
        except Exception:                     # recorded as a failed seed
            d, prof, ok = {}, None, False
            data.setdefault("error", traceback.format_exc()[-2000:])
        oks.append(ok)
        prefix = f"seed{s}_" if s else ""
        for k, v in d.items():
            if k not in ("case", "t_end", "seeds"):
                data[prefix + k] = v
        say(f"  - seed {s}: {'ok' if ok else 'FAIL'} "
            f"({time.time() - t0:.0f}s)")
        if ok:
            profs.append(prof)
            if out_dir:
                np.savez(os.path.join(out_dir, torch_out(
                    f"{name}_profiles_seed{s}.npz")), **prof)
    for line in gate_lines(case):
        if not profs:
            break
        bench = np.loadtxt(os.path.join(case, "data", "sets_bench",
                                        f"{line}_UaMean.xy"))
        x = profs[0][line][:, 0]
        denom = max(np.abs(bench[:, 2]).max(), 1e-9)
        per_seed = [np.interp(bench[:, 0], x, p[line][:, 2]) for p in profs]
        vy = np.mean(per_seed, axis=0)
        data[f"seedmean_{line}_uy_rms_err"] = float(
            np.sqrt(np.mean((vy - bench[:, 2]) ** 2)) / denom)
        data[f"seedmean_{line}_uy_corr"] = float(
            np.corrcoef(vy, bench[:, 2])[0, 1])
        data[f"per_seed_{line}_uy_rms_err"] = [
            float(np.sqrt(np.mean((v - bench[:, 2]) ** 2)) / denom)
            for v in per_seed]
    return all(oks), data


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default=CASE, required=CASE is None,
                    help="the case directory")
    ap.add_argument("--t-end", type=float, default=10.0)
    ap.add_argument("--t-avg-start", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="realization seed: jitters the initial positions "
                         "by +-2%% r (seed 0: the case file verbatim)")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    result = run(args.case, args.t_end, args.t_avg_start, args.seed,
                 args.out, args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
