"""transport-bedload example-case validation on the port: sheet-flow
bed-load rate against the Meyer-Peter & Mueller (1948) law (the
counterpart of ``scripts/validate_bedload.py``).

The case directory comes from ``cases.write_channel_case``: the sediment
transport case the SediFoam paper (Sun & Xiao 2016, arXiv:1601.03801)
headlines, d = 2.5 mm sand (rhoa 2650) in a 0.121 x 0.04 x 0.06 m
channel, x/z cyclic, top slip, kEqn LES, Ubar feedback forcing at 0.8
m/s, hooke/history DEM over a frozen bottom layer (type 2), the bed a
jittered simple-cubic lattice. It is loaded as the reference validator
loads its own (binned, f32, capacity 8,192, semi-implicit drag) and its
mesh coarsened by --coarsen.

The loose bed first settles in quiescent water with the forcing off
(--t-settle; the Ubar controller applies its whole velocity correction
in one step, and a suspended bed under that kick diverges), then the
clock is set back to 0 and the forced run starts.

Physics gates (the reference ships no golden curve for this case):
- Shields number from the measured equilibrium forcing:
  tau_b = rhob * <gradP> * V_fluid / A_bed (the top is slip: all driving
  momentum lands on the bed), theta = tau_b / ((rhoa - rhob) g d);
- q* = sum(vel_x * V_p) / (Lx Lz) / sqrt((s - 1) g d^3), averaged over
  the developed window (t >= --t-avg-start);
- full runs only (not --quick, t_end beyond --t-avg-start): theta >
  0.047 and q* > 0.1 (`transporting`), and q* within a factor 3 of
  q*_mpm = 8 (theta - 0.047)^1.5 (`mpm_band`);
- frozen bed immobile, everything finite, no particle escapes.

Each sample (q, grad_p_value, the fluid volume, the time) is one
device-to-host fetch.

Run: python -m sedifoam_tpu_torch.validate.bedload [--t-end 3.0]
     [--t-avg-start 1.5] [--t-settle 0.3] [--coarsen 2] [--layers 6]
     [--quick] [--out FILE.npz] [--device cpu]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

D = 2.5e-3
RHOA = 2650.0
THETA_C = 0.047
# --quick: 4x-coarsened mesh, smoke gates only
QUICK = dict(t_end=0.05, coarsen=4, t_settle=0.1)


def bed_area() -> float:
    """The channel's x-z extent, on which the driving momentum lands."""
    from sedifoam_tpu_torch import cases
    box = cases.CHANNEL_BOX
    return (box[1] - box[0]) * (box[5] - box[4])


def sampler(cfg, samples):
    """on_sample callback appending (t, q, gp, Vb) to `samples`: the
    mobile grains' volume flux per bed area, the forcing, the fluid
    volume."""
    import torch

    area = bed_area()

    def on_sample(sim):
        ps, fs = sim.state.particles, sim.state.fluid
        mob = ps.active & (ps.ptype == 1)
        vp = (4.0 / 3.0) * math.pi * ps.radius ** 3
        q = torch.sum(torch.where(mob, ps.vel[:, 0], torch.zeros_like(vp))
                      * vp)
        vb = torch.sum((1.0 - fs.alpha) * cfg.grid.cell_volume_like(fs.alpha))
        t, q, gp, vb = torch.stack([
            fs.time.double(), q.double(), fs.grad_p_value.double(),
            vb.double()]).tolist()                    # the one fetch
        samples["t"].append(t)
        samples["q"].append(q / area)
        samples["gp"].append(gp)
        samples["Vb"].append(vb)

    return on_sample


def run(t_end=3.0, t_avg_start=1.5, t_settle=0.3, coarsen=2, layers=6,
        quick=False, out="", device=None, counts=None, case_dir=None,
        steps_per_host_visit=25, timing_reps=5, max_wall=None,
        capacity=8192) -> dict:
    """Write, load, settle and run the case; returns the result dict with
    its `gates` and `passed`. `counts` and `capacity` shrink the written
    mesh and the particle table (tests);
    `case_dir` keeps the written directory there. The gates of a full
    run are taken by a run that is not quick and reaches a t_end beyond
    t_avg_start; where they are left out they are listed under
    `not_evaluated`, never counted as passed. `max_wall` seconds stop the
    forced run early
    (validate.run_until); a run so stopped reports `t_reached` and takes
    no full-run gate."""
    import numpy as np
    import torch

    from sedifoam_tpu_torch import cases, default_device
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.validate import finite, load, run_until, settle

    device = default_device(device)
    counts = tuple(counts or cases.CHANNEL_FULL["counts"])
    with tempfile.TemporaryDirectory(prefix="bedload_") as tmp:
        case = cases.write_channel_case(
            case_dir or os.path.join(tmp, "bedload"), counts=counts,
            layers=layers, d=D)
        cfg, state = load(case, coarsen, device, capacity)
    n_part = len(cases.channel_bed(D, layers))
    frozen_mask = state.particles.ptype == 2

    state = settle(cfg, state, t_settle, device, steps_per_host_visit)
    frozen0 = state.particles.pos[frozen_mask].clone()

    rhob, g = cfg.fluid.rhob, 9.81
    s = RHOA / rhob

    samples = {"t": [], "q": [], "gp": [], "Vb": []}
    sim = Simulation(cfg, state, steps_per_host_visit=steps_per_host_visit,
                     device=device)
    reached = run_until(sim, t_end, max_wall,
                        on_sample=sampler(cfg, samples))
    full_gates = not quick and reached and t_end > t_avg_start

    t = np.asarray(samples["t"])
    q = np.asarray(samples["q"])
    gp = np.asarray(samples["gp"])
    Vb = np.asarray(samples["Vb"])
    # a run too short for the full gates averages over all of itself
    late = t >= (t_avg_start if full_gates else 0.0)

    q_mean = float(q[late].mean())
    gp_mean = float(gp[late].mean())
    tau_b = rhob * gp_mean * float(Vb[late].mean()) / bed_area()
    theta = tau_b / ((RHOA - rhob) * g * D)
    q_star = q_mean / np.sqrt((s - 1.0) * g * D ** 3)
    q_mpm = 8.0 * max(theta - THETA_C, 0.0) ** 1.5

    ps, fs = sim.state.particles, sim.state.fluid
    frozen1 = ps.pos[frozen_mask]
    result = {
        "quick": bool(quick),
        "grid": list(cfg.grid.shape),
        "n_particles": int(n_part),
        "t_end": t_end,
        "t_reached": sim.t,
        "steps": int(fs.step),
        "wall_time_s": round(sim.wall_time, 2),
        "Ub_bulk": float(fs.Ub[0].mean()),
        "gradP_mean": gp_mean,
        "tau_b": round(float(tau_b), 4),
        "shields_theta": round(float(theta), 4),
        "q_star": round(float(q_star), 4),
        "q_star_mpm": round(float(q_mpm), 4),
        "q_ratio_vs_mpm": round(float(q_star / q_mpm), 3)
        if q_mpm > 0 else None,
        "frozen_max_disp": float((frozen1 - frozen0).abs().max()),
        "finite": finite(sim.state),
        "n_active": int(ps.active.sum()),
        "nbr_dropped": int(ps.nbr_dropped),
        "timing_split_ms": {k: round(v * 1e3, 2) for k, v in
                            sim.timing_split(n=timing_reps).items()},
    }
    gates = {
        "finite": result["finite"],
        "frozen_immobile": result["frozen_max_disp"] == 0.0,
        "no_escapes": result["n_active"] == n_part,
    }
    if full_gates:
        gates["transporting"] = bool(theta > THETA_C and q_star > 0.1)
        gates["mpm_band"] = bool(q_mpm > 0
                                 and q_mpm / 3.0 < q_star < q_mpm * 3.0)
    result["gates"] = gates
    result["not_evaluated"] = [] if full_gates else ["transporting",
                                                     "mpm_band"]
    result["passed"] = all(gates.values())
    if out:
        np.savez(out, t=t, q_star=q / np.sqrt((s - 1) * g * D ** 3), gp=gp,
                 theta=float(theta), q_star_mean=float(q_star),
                 q_star_mpm=float(q_mpm))
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t-end", type=float, default=3.0)
    ap.add_argument("--t-avg-start", type=float, default=1.5)
    ap.add_argument("--t-settle", type=float, default=0.3,
                    help="DEM settling phase with the channel forcing off")
    ap.add_argument("--coarsen", type=int, default=2)
    ap.add_argument("--layers", type=int, default=6)
    ap.add_argument("--quick", action="store_true",
                    help="4x-coarsened mesh, 0.05 s, smoke gates only")
    ap.add_argument("--out", default="")
    ap.add_argument("--max-wall", type=float, default=None,
                    help="stop the forced run after about this many seconds "
                         "and report how far it came (no full-run gate "
                         "then)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.quick:
        vars(args).update(QUICK)
    result = run(args.t_end, args.t_avg_start, args.t_settle, args.coarsen,
                 args.layers, args.quick, args.out, args.device,
                 max_wall=args.max_wall)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
