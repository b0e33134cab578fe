"""irregular example-case validation on the port: rigid-clump
(bonded-sphere) grain transport, the setup of arXiv:1608.01049 (the
counterpart of ``scripts/validate_irregular.py``).

The case directory comes from ``cases.write_irregular_case``: trimer
grains of 0.35 mm spheres integrated as rigid bodies (`fix rigid/small
molecule`), a water channel with Ubar feedback forcing at 0.5 m/s,
hooke/history DEM, a frozen type-2 floor and jittered trimer clumps
above it, lowered `press` into the floor so that contacts exist from the
first substep. It is loaded as the reference validator loads its own
(binned, f32, capacity 8,192, semi-implicit drag), its mesh coarsened by
--coarsen, and run through Simulation with 25 steps per host visit.

Gates (no golden curve; dune-scale morphology needs minutes of sim):
- clumps stay rigid: member-member distances constant to 1e-7 m
  (positions are rebuilt from the body's degrees of freedom each
  substep; f32 world coordinates at the 0.07 m box scale carry ~8e-9 of
  round-off, free spheres drift micrometres in one contact);
- frozen floor immobile (type-2 displacement exactly 0);
- everything finite, no escapes, alpha above -1e-4 (alpha_max sits at the
  case's own maxPossibleAlpha cap by design and is not gated);
- on a full run only (not --quick, t_end of 0.6 s or more): the clump
  ensemble drifts with the current (mean vx > 0.01 m/s).

Run: python -m sedifoam_tpu_torch.validate.irregular [--t-end 0.6]
     [--clumps 600] [--coarsen 4] [--quick] [--out FILE.npz]
     [--device cpu]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

PRESS = 1e-5           # trimers lowered into the floor: contacts at once
T_FULL = 0.6           # the full run's t_end: the ensemble drifts by then
QUICK = dict(t_end=0.05, clumps=150)       # --quick: smoke gates only


def same_body_slots(p) -> int:
    """Table slots of p that hold a partner of the particle's own body."""
    n = p.n_capacity
    j = p.nbr_idx.clamp(0, n - 1).long()
    return int(((p.mol[j] == p.mol[None, :]) & (p.mol[None, :] > 0)
                & (p.nbr_idx < n)).sum())


def member_gaps(p):
    """Distances between consecutive members of each clump, (n_clumps,
    members - 1), the clumps in body order and the members in tag order
    wherever their rows are."""
    import torch
    member = (p.mol > 0) & p.active
    # one stable sort by (mol, tag): tags are below 2^31
    key = p.mol[member].long() * (2 ** 31) + p.tag[member].long()
    pos = p.pos[member][torch.argsort(key, stable=True)]
    n_bodies = int(p.mol.max())
    members = pos.reshape(n_bodies, -1, 3)
    return torch.linalg.norm(members[:, 1:] - members[:, :-1], dim=-1)


def run(t_end=T_FULL, clumps=600, coarsen=4, quick=False, out="", device=None,
        counts=None, floor_d=None, case_dir=None, steps_per_host_visit=25,
        timing_reps=5, max_wall=None, capacity=8192) -> dict:
    """Write, load and run the case; returns the result dict with its
    `gates` and `passed`. `counts`/`floor_d`/`capacity` shrink the written
    mesh, the floor and the particle table (tests); `case_dir` keeps the
    written directory there. The gate of a full run is taken by a run
    that is not quick and reaches a t_end of at least T_FULL; where it is
    left out it is listed under `not_evaluated`, never counted as passed.
    `max_wall` seconds stop the run early (validate.run_until); a run so
    stopped reports `t_reached` and takes no full-run gate."""
    import numpy as np
    import torch

    from sedifoam_tpu_torch import cases, default_device
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.validate import finite, load, run_until

    device = default_device(device)
    full = cases.IRREGULAR_FULL
    counts = tuple(counts or full["counts"])
    floor_d = floor_d or full["floor_d"]
    with tempfile.TemporaryDirectory(prefix="irregular_") as tmp:
        case = cases.write_irregular_case(
            case_dir or os.path.join(tmp, "irregular"), n_clumps=clumps,
            counts=counts, floor_d=floor_d, press=PRESS)
        cfg, state = load(case, coarsen, device, capacity)
    n_part = len(cases.trimer_bed(clumps, floor_d, PRESS)[0])

    ps0 = state.particles
    frozen_mask = (ps0.ptype == 2) & ps0.active
    member_mask = (ps0.mol > 0) & ps0.active
    frozen0 = ps0.pos[frozen_mask].clone()
    gaps0 = member_gaps(ps0)

    sim = Simulation(cfg, state, steps_per_host_visit=steps_per_host_visit,
                     device=device)
    reached = run_until(sim, t_end, max_wall)

    ps, fs = sim.state.particles, sim.state.fluid
    gaps1 = member_gaps(ps)
    frozen1 = ps.pos[frozen_mask]
    mvel = ps.vel[member_mask]
    moved = (frozen1 - frozen0).abs().max() if frozen0.numel() else \
        torch.zeros(())
    result = {
        "quick": bool(quick),
        "case": "irregular",
        "grid": list(cfg.grid.shape),
        "n_particles": int(n_part),
        "n_clumps": int(clumps),
        "t_end": t_end,
        "t_reached": sim.t,
        "steps": int(fs.step),
        "wall_time_s": round(sim.wall_time, 2),
        "member_gap_max_dev": float((gaps1 - gaps0).abs().max()),
        "frozen_max_disp": float(moved),
        "clump_mean_vx": float(mvel[:, 0].mean()),
        "clump_mean_vy": float(mvel[:, 1].mean()),
        "alpha_min": float(fs.alpha.min()),
        "alpha_max": float(fs.alpha.max()),
        "finite": finite(sim.state),
        "n_active": int(ps.active.sum()),
        "nbr_dropped": int(ps.nbr_dropped),
        "timing_split_ms": {k: round(v * 1e3, 2) for k, v in
                            sim.timing_split(n=timing_reps).items()},
    }
    gates = {
        "finite": result["finite"],
        "rigid_members": result["member_gap_max_dev"] < 1e-7,
        "frozen_immobile": result["frozen_max_disp"] == 0.0,
        "no_escapes": result["n_active"] == n_part,
        "alpha_bounds": result["alpha_min"] > -1e-4,
    }
    full_gates = not quick and reached and t_end >= T_FULL
    if full_gates:
        gates["transporting"] = result["clump_mean_vx"] > 0.01
    result["gates"] = gates
    result["not_evaluated"] = [] if full_gates else ["transporting"]
    result["passed"] = all(gates.values())
    if out:
        np.savez(out, gaps0=gaps0.cpu().numpy(), gaps1=gaps1.cpu().numpy(),
                 vx=mvel[:, 0].cpu().numpy(), vy=mvel[:, 1].cpu().numpy())
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t-end", type=float, default=T_FULL)
    ap.add_argument("--clumps", type=int, default=600)
    ap.add_argument("--coarsen", type=int, default=4)
    ap.add_argument("--quick", action="store_true",
                    help="0.05 s, 150 clumps, smoke gates only")
    ap.add_argument("--out", default="")
    ap.add_argument("--max-wall", type=float, default=None,
                    help="stop the run after about this many seconds and "
                         "report how far it came (no full-run gate then)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if args.quick:
        vars(args).update(QUICK)
    result = run(args.t_end, args.clumps, args.coarsen, args.quick,
                 args.out, args.device, max_wall=args.max_wall)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
