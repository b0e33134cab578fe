"""transport-suspended example-case validation on the port: the
suspension regime (the counterpart of ``scripts/validate_suspended.py``).

The case directory comes from ``cases.write_suspended_case``: the
suspended sediment-transport case of the SediFoam paper (Sun & Xiao 2016,
arXiv:1601.03801), d = 0.5 mm sand (rhoa 2650) in a 0.12125 x 0.04 x
0.06 m channel, x/z cyclic, walls at both y faces, Ubar feedback forcing
at 0.8 m/s, SyamlalOBrien drag, hooke/history DEM over one dense frozen
layer (type 2) with sparse mobile layers above. It is loaded as the
reference validator loads its own (binned, f32, K = 8 asked of the
loader, capacity 65,536, semi-implicit drag) and its mesh coarsened by
--coarsen.

The loose bed first settles in quiescent water with the forcing off
(--t-settle), then the clock is set back to 0 and the forced run starts.

Physics gates (the reference ships no golden curve for this case):
- the SUSPENSION regime: Rouse number P = w_s / (kappa u*) < 2.5, with
  u* from the equilibrium forcing, tau_b = rhob <gradP> V_fluid / A_bed
  (the top is a wall here too, so the bed takes about half; the script
  keeps the full-bed convention of the bedload validator, and so does
  this one), and w_s from Ferguson & Church (2004) for natural sand;
- measured suspension: the mobile grains' centre of mass rises above
  twice its initial height, and more than 10% of them travel above a
  quarter of the depth (`suspended_mass`);
- q* > 0.1 (`transporting`), q* = sum(vel_x V_p) / (Lx Lz) / sqrt((s -
  1) g d^3), averaged over t >= --t-avg-start;
- frozen bed immobile (displacement exactly 0), everything finite, no
  particle escapes, no in-ring partner dropped by the K-nearest table
  (`k_audit`).
The last four hold for every run; the first three only for a full run
(not --quick, reaching a t_end beyond --t-avg-start): elsewhere they are
listed under `not_evaluated`, never counted as passed.

Each sample (the time, q, gradP, the fluid volume, the mobile centre
of mass height, the share above a quarter of the depth) is one
device-to-host fetch.

Run: python -m sedifoam_tpu_torch.validate.suspended [--t-end 1.5]
     [--t-avg-start 0.75] [--t-settle 0.2] [--coarsen 2] [--layers 2]
     [--quick] [--out FILE.npz] [--max-wall S] [--device cpu]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

RHOA = 2650.0
KAPPA = 0.41
NEIGHBOR_K = 8
CAPACITY = 65536
# --quick: 4x-coarsened mesh, 0.02 s, smoke gates only
QUICK = dict(t_end=0.02, coarsen=4, t_settle=0.02)
FULL_GATES = ("suspension_regime", "suspended_mass", "transporting")


def settling_velocity_fc(d, s=2.65, g=9.81, nu=1e-6):
    """Ferguson & Church (2004) natural-sand settling velocity."""
    C1, C2 = 18.0, 1.0
    return ((s - 1.0) * g * d ** 2
            / (C1 * nu + math.sqrt(0.75 * C2 * (s - 1.0) * g * d ** 3)))


def sampler(cfg, samples, box):
    """on_sample callback appending (t, q, gp, Vb, ycom, frac_hi) to
    `samples`: the mobile grains' volume flux per bed area, the forcing,
    the fluid volume, the mobile grains' mean height and their share
    above a quarter of the depth."""
    import torch

    area = (box[1] - box[0]) * (box[5] - box[4])
    y_hi = 0.25 * (box[3] - box[2])

    def on_sample(sim):
        ps, fs = sim.state.particles, sim.state.fluid
        mob = ps.active & (ps.ptype == 1)
        zero = torch.zeros_like(ps.radius)
        vp = (4.0 / 3.0) * math.pi * ps.radius ** 3
        q = torch.sum(torch.where(mob, ps.vel[:, 0], zero) * vp)
        vb = torch.sum((1.0 - fs.alpha) * cfg.grid.cell_volume_like(fs.alpha))
        y = ps.pos[:, 1].double()
        n_mob = mob.sum().double()
        ycom = torch.where(mob, y, 0.0).sum() / n_mob
        hi = (mob & (ps.pos[:, 1] > y_hi)).sum().double() / n_mob
        t, q, gp, vb, ycom, hi = torch.stack([
            fs.time.double(), q.double(), fs.grad_p_value.double(),
            vb.double(), ycom, hi]).tolist()            # the one fetch
        samples["t"].append(t)
        samples["q"].append(q / area)
        samples["gp"].append(gp)
        samples["Vb"].append(vb)
        samples["ycom"].append(ycom)
        samples["frac_hi"].append(hi)

    return on_sample


def run(t_end=1.5, t_avg_start=0.75, t_settle=0.2, coarsen=2, layers=2,
        quick=False, out="", device=None, counts=None, box=None,
        case_dir=None, steps_per_host_visit=25, timing_reps=5,
        max_wall=None, capacity=CAPACITY) -> dict:
    """Write, load, settle and run the case; returns the result dict with
    its `gates` and `passed`. `counts`, `box` and `capacity` shrink the
    written mesh, the channel and the particle table (tests); every gate
    reads the same box. `case_dir` keeps the written directory there.
    `max_wall` seconds stop the forced run early (validate.run_until); a
    run so stopped reports `t_reached` and takes no full-run gate."""
    import numpy as np
    import torch

    from sedifoam_tpu_torch import cases, default_device
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.validate import finite, load, run_until, settle

    device = default_device(device)
    counts = tuple(counts or cases.SUSPENDED_FULL["counts"])
    box = tuple(box or cases.SUSPENDED_BOX)
    d = cases.SAND_D
    with tempfile.TemporaryDirectory(prefix="suspended_") as tmp:
        case = cases.write_suspended_case(
            case_dir or os.path.join(tmp, "suspended"), counts=counts,
            layers=layers, box=box, d=d)
        cfg, state = load(case, coarsen, device, capacity, NEIGHBOR_K)
    n_part = len(cases.suspended_bed(d, layers, box=box))
    frozen_mask = state.particles.ptype == 2
    mobile_mask = state.particles.active & (state.particles.ptype == 1)

    state = settle(cfg, state, t_settle, device, steps_per_host_visit)
    frozen0 = state.particles.pos[frozen_mask].clone()
    y_com0 = float(state.particles.pos[mobile_mask, 1].double().mean())

    rhob, g = cfg.fluid.rhob, 9.81
    s = RHOA / rhob
    Lx, Lz = box[1] - box[0], box[5] - box[4]

    samples = {"t": [], "q": [], "gp": [], "Vb": [], "ycom": [],
               "frac_hi": []}
    sim = Simulation(cfg, state, steps_per_host_visit=steps_per_host_visit,
                     device=device)
    reached = run_until(sim, t_end, max_wall,
                        on_sample=sampler(cfg, samples, box))
    full_gates = not quick and reached and t_end > t_avg_start

    t = np.asarray(samples["t"])
    gp = np.asarray(samples["gp"])
    Vb = np.asarray(samples["Vb"])
    # a run too short for the full gates averages over all of itself
    late = t >= (t_avg_start if full_gates else 0.0)

    gp_mean = float(gp[late].mean())
    tau_b = rhob * gp_mean * float(Vb[late].mean()) / (Lx * Lz)
    u_star = math.sqrt(max(tau_b, 0.0) / rhob)
    w_s = settling_velocity_fc(d, s=s, g=g, nu=cfg.fluid.nub)
    rouse = w_s / (KAPPA * u_star) if u_star > 0 else float("inf")
    q_mean = float(np.asarray(samples["q"])[late].mean())
    q_star = q_mean / math.sqrt((s - 1.0) * g * d ** 3)
    ycom_late = float(np.asarray(samples["ycom"])[late].mean())
    frac_hi = float(np.asarray(samples["frac_hi"])[late].mean())

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
        "u_star": round(u_star, 4),
        "w_s_ferguson_church": round(w_s, 4),
        "rouse_number": round(rouse, 3),
        "q_star": round(q_star, 4),
        "y_com_initial": round(y_com0, 5),
        "y_com_late": round(ycom_late, 5),
        "frac_above_quarter_depth": round(frac_hi, 3),
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
        "k_audit": result["nbr_dropped"] == 0,
    }
    if full_gates:
        gates["suspension_regime"] = rouse < 2.5
        gates["suspended_mass"] = ycom_late > 2.0 * y_com0 and frac_hi > 0.10
        gates["transporting"] = q_star > 0.1
    result["gates"] = gates
    result["not_evaluated"] = [] if full_gates else list(FULL_GATES)
    result["passed"] = all(gates.values())
    if out:
        np.savez(out, t=t, q=np.asarray(samples["q"]), gp=gp, Vb=Vb,
                 ycom=np.asarray(samples["ycom"]),
                 frac_hi=np.asarray(samples["frac_hi"]), rouse=rouse,
                 u_star=u_star, w_s=w_s)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t-end", type=float, default=1.5)
    ap.add_argument("--t-avg-start", type=float, default=0.75)
    ap.add_argument("--t-settle", type=float, default=0.2,
                    help="DEM settling phase with the channel forcing off")
    ap.add_argument("--coarsen", type=int, default=2)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--quick", action="store_true",
                    help="4x-coarsened mesh, 0.02 s, smoke gates only")
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
