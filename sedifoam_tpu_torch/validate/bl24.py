"""BL24-TH1 example-case validation on the port: the current-induced
dune-formation pipe (Case 1a of arXiv:1510.07201) run end to end from
its own files (the counterpart of ``scripts/validate_bl24.py``).

The case ships its particle IC (In_initial.in: 9,341 spheres, d = 0.5
mm, a frozen type-2 bottom layer), a 3-block y-graded 16x100x4 channel,
kEqn LES and Ubar-feedback forcing at 0.167 m/s. Nothing is synthesized:
mesh, BCs, LES model, DEM pair law and the IC come from the case
directory. It loads binned, f32, in a table of 16,384 rows, with the
semi-implicit fluid-side drag (water and a dense sand bed put the
explicit drag's coupling gain far above 2).

Gates (the reference ships no golden curve):
- finite: p and the particle velocities;
- frozen_immobile: the type-2 rows exactly still;
- no_escapes: every particle still active;
- alpha_bounds: alpha_min > -1e-4 and alpha_max < 0.74 (the HCP bound);
- ubar_locked (full runs): the late beta-weighted bulk Ub_x within 5%
  of Ubar.
The bed load q* and the x-resolved bed height (the 95th percentile of
the particles' heights in 16 x-bins, in --out) are recorded.

Run: python -m sedifoam_tpu_torch.validate.bl24 [--case DIR]
     [--t-end 2.0] [--t-avg-start 1.0] [--quick] [--out FILE.npz]
     [--device cpu]
Prints one JSON line with the script's keys; --out is written under a
torch_-prefixed name.
"""

from __future__ import annotations

import argparse
import json
import math
import os

from sedifoam_tpu_torch.validate import (EXAMPLE_CASES, ref_case,
                                         torch_out)

CASE = ref_case(EXAMPLE_CASES, "BL24-TH1")
CAPACITY = 16384
RHOA = 2500.0
GRAV = 9.8
N_BINS = 16
STEPS_PER_VISIT = 25


def sampler(cfg, samples):
    """on_sample callback appending (t, q, ub, gp): the mobile grains'
    x volume flux per bed area, the beta-weighted bulk Ub_x, the forcing;
    one device-to-host fetch a sample."""
    import torch

    xf, zf = cfg.grid.axis_faces(0), cfg.grid.axis_faces(2)
    area = float(xf[-1] - xf[0]) * float(zf[-1] - zf[0])

    def on_sample(sim):
        ps, fs = sim.state.particles, sim.state.fluid
        mob = ps.active & (ps.ptype == 1)
        vp = (4.0 / 3.0) * math.pi * ps.radius ** 3
        qx = torch.sum(torch.where(mob, ps.vel[:, 0],
                                   torch.zeros_like(vp)) * vp)
        cell_v = cfg.grid.cell_volume_like(fs.alpha)
        beta = 1.0 - fs.alpha
        ub = torch.sum(fs.Ub[0] * beta * cell_v) / torch.sum(beta * cell_v)
        t, qx, ub, gp = torch.stack([
            fs.time.double(), qx.double(), ub.double(),
            fs.grad_p_value.double()]).tolist()
        samples["t"].append(t)
        samples["q"].append(qx / area)
        samples["ub"].append(ub)
        samples["gp"].append(gp)

    return on_sample


def bed_heights(pos, x0, lx, n_bins=N_BINS):
    """The 95th percentile of the particles' heights in each of n_bins
    x-bins (NaN in an empty bin)."""
    import numpy as np
    xb = np.clip(((pos[:, 0] - x0) / lx * n_bins).astype(int), 0,
                 n_bins - 1)
    return np.array([np.percentile(pos[xb == i, 1], 95) if (xb == i).any()
                     else np.nan for i in range(n_bins)])


def run(case, t_end=2.0, t_avg_start=1.0, quick=False, out="",
        device=None, capacity=None, steps_per_host_visit=STEPS_PER_VISIT,
        timing_reps=5) -> dict:
    """Load and run the case to t_end; returns the script's result dict
    with its `gates` and `passed` (quick: the smoke gates, averaged over
    the whole run)."""
    import numpy as np
    import torch

    from sedifoam_tpu_torch import default_device
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import initialize
    from sedifoam_tpu_torch.validate import finite, semi_implicit

    device = default_device(device)
    cfg, fluid, particles, _ = load_case(
        case, backend="binned", dtype=torch.float32,
        capacity=capacity or CAPACITY, device=device)
    cfg = semi_implicit(cfg)
    state = initialize(fluid, particles, cfg)

    ps0 = state.particles
    frozen_mask = ps0.ptype == 2
    n_part = int(ps0.active.sum())
    frozen0 = ps0.pos[frozen_mask].clone()
    d = 2.0 * float(ps0.radius[ps0.active].max())
    xf = cfg.grid.axis_faces(0)
    lx = float(xf[-1] - xf[0])
    rhob = cfg.fluid.rhob
    ubar = cfg.fluid.forcing.mag_ubar

    samples = {"t": [], "q": [], "ub": [], "gp": []}
    sim = Simulation(cfg, state, steps_per_host_visit=steps_per_host_visit,
                     device=device)
    sim.run(t_end, on_sample=sampler(cfg, samples))

    t = np.asarray(samples["t"])
    q = np.asarray(samples["q"])
    ub = np.asarray(samples["ub"])
    gp = np.asarray(samples["gp"])
    late = t >= (t_avg_start if not quick else 0.0)
    s = RHOA / rhob
    q_star = float(q[late].mean()) / np.sqrt((s - 1.0) * GRAV * d ** 3)
    ub_late = float(ub[late].mean())

    ps, fs = sim.state.particles, sim.state.fluid
    act = ps.active.cpu().numpy()
    pos = ps.pos.cpu().numpy()[act]
    bed_h = bed_heights(pos, float(xf[0]), lx)
    result = {
        "quick": bool(quick),
        "case": "BL24-TH1",
        "grid": list(cfg.grid.shape),
        "n_particles": n_part,
        "t_end": t_end,
        "wall_time_s": round(sim.wall_time, 2),
        "ub_bulk_late": round(ub_late, 5),
        "ubar_target": ubar,
        "ubar_rel_err": round(abs(ub_late - ubar) / ubar, 5),
        "gradP_late_mean": float(gp[late].mean()),
        "q_star": round(q_star, 5),
        "frozen_max_disp": float((ps.pos[frozen_mask] - frozen0).abs()
                                 .max()),
        "alpha_min": float(fs.alpha.min()),
        "alpha_max": float(fs.alpha.max()),
        "finite": finite(sim.state),
        "n_active": int(act.sum()),
        "timing_split_ms": {k: round(v * 1e3, 2) for k, v in
                            sim.timing_split(n=timing_reps).items()},
    }
    gates = {
        "finite": result["finite"],
        "frozen_immobile": result["frozen_max_disp"] == 0.0,
        "no_escapes": result["n_active"] == n_part,
        # the case's own settled bed packs to 0.715 smoothed onto 1 mm
        # cells; nothing physical exceeds the HCP bound
        "alpha_bounds": (result["alpha_min"] > -1e-4
                         and result["alpha_max"] < 0.74),
    }
    if not quick:
        gates["ubar_locked"] = result["ubar_rel_err"] < 0.05
    result["gates"] = gates
    result["passed"] = all(gates.values())
    if out:
        np.savez(torch_out(out), t=t, q=q, ub=ub, gp=gp, bed_h=bed_h,
                 x_bins=(np.arange(N_BINS) + 0.5) * lx / N_BINS
                 + float(xf[0]))
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--case", default=CASE, required=CASE is None)
    ap.add_argument("--t-end", type=float, default=2.0)
    ap.add_argument("--t-avg-start", type=float, default=1.0)
    ap.add_argument("--quick", action="store_true",
                    help="0.05 s, smoke gates only")
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.quick:
        from sedifoam_tpu_torch.validate.battery import QUICK_T
        args.t_end = QUICK_T["bl24"]
    result = run(args.case, args.t_end, args.t_avg_start, args.quick,
                 args.out, args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
