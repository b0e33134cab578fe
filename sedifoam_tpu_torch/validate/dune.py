"""transport-vortex-dune example-case validation on the port: the
dune-migration smoke (the counterpart of ``scripts/validate_dune.py``).

The case directory comes from ``cases.write_dune_case``: the
current-induced dune case of Sun & Xiao (arXiv:1510.07201), a shallow
periodic channel 0.155885 x 0.0167 x 0.04 m on two y-stacked mesh blocks
(x/z cyclic), Ubar feedback forcing at 0.34 m/s, SyamlalOBrien drag,
`subCycles 5`, hooke/history DEM (kn 200, xmu 0.4) over a frozen type-2
base layer, and a mobile Gaussian hump of 0.5 mm sand centred at 0.4 Lx.
It is loaded as the reference validator loads its own (binned, f32, K =
8 asked of the loader, capacity 65,536, semi-implicit drag) and its mesh
coarsened by --coarsen. The bed settles with the forcing off
(--t-settle), the clock is set back to 0, and the forced run starts.

Physics gates (the reference's controlDict runs 50 s of morphology, far
beyond a validation run; this is the migration smoke):
- the hump migrates DOWNSTREAM: the mobile grains' streamwise centre
  (by minimum image about the initial crest, so a hump crossing the x
  boundary does not wrap the mean) moves in +x over the run
  (`migrates_downstream`);
- q* > 0.01 (`transporting`), q* averaged over the second half of the
  run;
- the frozen base immobile (displacement exactly 0), everything finite,
  no particle escapes, no in-ring partner dropped (`k_audit`).
The last four hold for every run; the first two only for a full run
(not --quick, not stopped by --max-wall): elsewhere they are listed
under `not_evaluated`, never counted as passed.

Each sample (the time, q and the mobile grains' x positions) is one
device-to-host fetch; the hump's centre is taken from the positions in
float64 on the host.

Run: python -m sedifoam_tpu_torch.validate.dune [--t-end 1.5]
     [--t-settle 0.2] [--coarsen 2] [--crest-layers 6] [--quick]
     [--out FILE.npz] [--max-wall S] [--device cpu]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile

RHOA = 2650.0
NEIGHBOR_K = 8
CAPACITY = 65536
# --quick: 4x-coarsened mesh, 0.02 s, smoke gates only
QUICK = dict(t_end=0.02, coarsen=4, t_settle=0.02)
FULL_GATES = ("transporting", "migrates_downstream")


def hump_center(x, x_crest0, Lx):
    """The streamwise centre of the mobile grains at x (float64), taken
    relative to the initial crest by the periodic minimum image."""
    import numpy as np
    dx = np.asarray(x, dtype=np.float64) - x_crest0
    dx -= Lx * np.round(dx / Lx)
    return x_crest0 + float(dx.mean())


def sampler(samples, box, x_crest0):
    """on_sample callback appending (t, q, xcom) to `samples`: the mobile
    grains' volume flux per bed area and the hump's centre."""
    import numpy as np
    import torch

    Lx = box[1] - box[0]
    area = Lx * (box[5] - box[4])

    def on_sample(sim):
        ps, fs = sim.state.particles, sim.state.fluid
        mob = ps.active & (ps.ptype == 1)
        zero = torch.zeros_like(ps.radius)
        vp = (4.0 / 3.0) * math.pi * ps.radius ** 3
        q = torch.sum(torch.where(mob, ps.vel[:, 0], zero) * vp)
        x = torch.where(mob, ps.pos[:, 0], float("nan"))
        row = torch.cat([torch.stack([fs.time.double(), q.double()]),
                         x.double()]).cpu().numpy()     # the one fetch
        x = row[2:]
        samples["t"].append(float(row[0]))
        samples["q"].append(float(row[1]) / area)
        samples["xcom"].append(hump_center(x[~np.isnan(x)], x_crest0, Lx))

    return on_sample


def run(t_end=1.5, t_settle=0.2, coarsen=2, crest_layers=6, quick=False,
        out="", device=None, counts=None, bed_cells=None, box=None,
        case_dir=None, steps_per_host_visit=25, timing_reps=5,
        max_wall=None, capacity=CAPACITY) -> dict:
    """Write, load, settle and run the case; returns the result dict with
    its `gates` and `passed`. `counts`, `bed_cells`, `box` and `capacity`
    shrink the written mesh, the channel and the particle table (tests);
    every gate reads the same box. `case_dir` keeps the written directory
    there. `max_wall` seconds stop the forced run early
    (validate.run_until); a run so stopped reports `t_reached` and takes
    no full-run gate."""
    import numpy as np

    from sedifoam_tpu_torch import cases, default_device
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.validate import finite, load, run_until, settle

    device = default_device(device)
    full = cases.DUNE_FULL
    counts = tuple(counts or full["counts"])
    bed_cells = bed_cells or full["bed_cells"]
    box = tuple(box or cases.DUNE_BOX)
    d = cases.SAND_D
    with tempfile.TemporaryDirectory(prefix="dune_") as tmp:
        case = cases.write_dune_case(
            case_dir or os.path.join(tmp, "dune"), counts=counts,
            bed_cells=bed_cells, crest_layers=crest_layers, box=box, d=d)
        cfg, state = load(case, coarsen, device, capacity, NEIGHBOR_K)
    rows, x_crest0 = cases.dune_bed(d, crest_layers, box=box)
    n_part = len(rows)
    frozen_mask = state.particles.ptype == 2

    state = settle(cfg, state, t_settle, device, steps_per_host_visit)
    frozen0 = state.particles.pos[frozen_mask].clone()
    ps = state.particles
    x_com0 = hump_center(ps.pos[ps.active & (ps.ptype == 1), 0].cpu(),
                         x_crest0, box[1] - box[0])

    rhob, g = cfg.fluid.rhob, 9.81
    s = RHOA / rhob

    samples = {"t": [], "q": [], "xcom": []}
    sim = Simulation(cfg, state, steps_per_host_visit=steps_per_host_visit,
                     device=device)
    reached = run_until(sim, t_end, max_wall,
                        on_sample=sampler(samples, box, x_crest0))
    full_gates = not quick and reached
    t_run = t_end if reached else sim.t

    t = np.asarray(samples["t"])
    q = np.asarray(samples["q"])
    xcom = np.asarray(samples["xcom"])
    late = t >= 0.5 * t_run

    q_mean = float(q[late].mean())
    q_star = q_mean / math.sqrt((s - 1.0) * g * d ** 3)
    migration = float(xcom[-1] - x_com0)

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
        "q_star": round(q_star, 4),
        "x_crest_initial": round(x_com0, 5),
        "dune_migration_m": round(migration, 6),
        "migration_celerity_mm_s": round(1e3 * migration / t_run, 4),
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
        gates["transporting"] = q_star > 0.01
        gates["migrates_downstream"] = migration > 0.0
    result["gates"] = gates
    result["not_evaluated"] = [] if full_gates else list(FULL_GATES)
    result["passed"] = all(gates.values())
    if out:
        np.savez(out, t=t, q=q, xcom=xcom, migration=migration,
                 q_star=q_star)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t-end", type=float, default=1.5)
    ap.add_argument("--t-settle", type=float, default=0.2,
                    help="DEM settling phase with the channel forcing off")
    ap.add_argument("--coarsen", type=int, default=2)
    ap.add_argument("--crest-layers", type=int, default=6)
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
    result = run(args.t_end, args.t_settle, args.coarsen, args.crest_layers,
                 args.quick, args.out, args.device, max_wall=args.max_wall)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
