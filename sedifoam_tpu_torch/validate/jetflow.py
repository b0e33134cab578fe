"""jetFlow example-case validation on the port: the particle-laden round
jet, kEqn LES (the counterpart of ``scripts/validate_jetflow.py``).

The case directory comes from ``cases.write_jetflow_case`` unless
--case names one: a D = 5 mm jet at 1.72 m/s along +y into a 0.1 x 0.3 x
0.1 m tank of water, 0.5 mm particles added over the inlet every 2.5 ms
and deleted near the outlet. Its O-grid mesh runs through the Cartesian
embedding (io.case.read_block_mesh_embedded) with the inlet disc as a
region BC. It is loaded as the reference validator loads its own:
binned DEM at the loader's K, f32, embed_ogrid, capacity 65,536 (--quick:
8,192, the mesh coarsened 2x and t_end 0.05 s), the explicit drag (the
script sets no semi-implicit one). The runner steps 25 coupled steps a
host visit and samples the five axis probes at y/D 10, 20, 30, 40 and 50
every second visit; the active window follows the population, and on
the card each window size captures the step once.

Gates (the script's, unchanged):
- `finite`: Ub, p and the particle velocities finite;
- `inlet_flux`: the volume flux through the floor equals 1.72 m/s times
  the disc's coverage-weighted area to 1e-6 (the face fluxes summed in
  float64: a float32 sum of the floor's 3,136 faces would carry its own
  rounding into a 1e-6 gate);
- `disc_area`: that area equals pi r^2 to 2e-2;
and in a full run (not --quick, not stopped by --max-wall):
- `uc_monotone`: the centreline velocity, averaged over the last 40% of
  the run, falls from y/D 20 to 30 to 40;
- `decay_band`: the decay constant B = (Uc/U0)(y/D) lies in (3, 12) at
  y/D 20, 30 and 40 (experiments: B ~ 5.8);
- `particles_flowing`: 100 < active particles < capacity at the end.
Elsewhere the last three are listed under `not_evaluated`, never counted
as passed.

Every 20 host visits a `[progress]` line prints the simulated time, the
pace in ms per step, the population and the window (the script's
heartbeat); the result keeps them under `progress`.

Run: python -m sedifoam_tpu_torch.validate.jetflow [--t-end 1.5]
     [--quick] [--f64] [--case DIR] [--out FILE.npz] [--max-wall S]
     [--device cpu]
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time

CAPACITY = 65536
STATIONS = (10, 20, 30, 40, 50)          # y/D of the axis probes
STEPS_PER_VISIT = 25
PROBE_EVERY = 2
HEARTBEAT_VISITS = 20
# --quick: the mesh coarsened 2x, capacity 8,192, 0.05 s, smoke gates only
QUICK = dict(t_end=0.05, coarsen=2, capacity=8192)
FULL_GATES = ("uc_monotone", "decay_band", "particles_flowing")


def load(case_dir, coarsen, device, capacity, dtype):
    """(cfg, initialized state) of the case directory, loaded as the
    script loads it (binned, embed_ogrid, the loader's K), the mesh
    coarsened `coarsen` times (the fluid then starts anew on it)."""
    from sedifoam_tpu_torch.fluid.state import init_fluid
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.solver import initialize
    from sedifoam_tpu_torch.validate import coarsened
    cfg, fluid, particles, _ = load_case(
        case_dir, backend="binned", dtype=dtype, embed_ogrid=True,
        capacity=capacity, device=device)
    if coarsen > 1:
        cfg = coarsened(cfg, coarsen)
        fluid = init_fluid(cfg.grid, dtype=dtype, device=device)
    return cfg, initialize(fluid, particles, cfg)


def inlet_fluxes(cfg, fluid, U0):
    """(q_in, q_disc, q_exact): the volume flux through the floor (its
    face fluxes summed in float64), U0 times the disc's coverage-weighted
    area, and U0 pi r^2."""
    import numpy as np
    disc = cfg.bcs.Ub.ym.region
    m = np.asarray(disc.mask(cfg.grid))[0]
    xf = np.asarray(cfg.grid.axis_faces(0))
    zf = np.asarray(cfg.grid.axis_faces(2))
    areas = np.diff(xf)[:, None] * np.diff(zf)[None, :]
    q_in = float(fluid.phib.y[:, 0].double().sum())
    return q_in, float(U0 * (m * areas).sum()), U0 * math.pi * disc.radius ** 2


class CaptureLog:
    """The runner's graphed step (solver.GraphedStep) with a record of
    its captures: a call at a capacity it holds no graph for frees the
    old graph and the allocator's cache first, then `log` gets the
    capacity, the capture's seconds, its conditional nodes and the
    device memory that the capture and its first replay left reserved."""

    def __init__(self, graphed):
        self.graphed, self.log = graphed, []

    def __call__(self, state):
        import torch
        g, cap = self.graphed, state.particles.n_capacity
        if g.graph is not None and g.graph.capacity == cap:
            return g(state)
        g.graph = None
        dev = state.particles.pos.device
        torch.cuda.empty_cache()
        reserved, seconds = torch.cuda.memory_reserved(dev), g.capture_seconds
        out = g(state)
        self.log.append({
            "capacity": cap, "seconds": round(g.capture_seconds - seconds, 3),
            "nodes": dict(g.graph.nodes), "reserved_mb": round(
                (torch.cuda.memory_reserved(dev) - reserved) / 2**20, 1)})
        return out


def heartbeat(t_end, progress, windows, steps_per_visit=STEPS_PER_VISIT):
    """on_sample callback: records each window size the run reaches in
    `windows`, and every HEARTBEAT_VISITS visits appends (and prints) the
    time, visit, wall seconds, ms per step since the last line, the active
    population (one host read) and the window to `progress`."""
    every = HEARTBEAT_VISITS
    clock = {"v": 0, "t0": time.perf_counter(), "tl": time.perf_counter()}

    def on_sample(sim):
        ps = sim.state.particles
        if not windows or windows[-1] != ps.n_capacity:
            windows.append(ps.n_capacity)
        clock["v"] += 1
        if clock["v"] % every:
            return
        now = time.perf_counter()
        rec = {"t": sim.t, "visit": clock["v"],
               "wall_s": round(now - clock["t0"], 1),
               "ms_per_step": round((now - clock["tl"]) / every
                                    / steps_per_visit * 1e3, 2),
               "active": int(ps.active.sum()), "window": ps.n_capacity}
        clock["tl"] = now
        progress.append(rec)
        print(f"[progress] t={rec['t']:.4f}/{t_end} visit={rec['visit']} "
              f"({steps_per_visit * rec['visit']} steps) "
              f"wall={rec['wall_s']:.0f}s ({rec['ms_per_step']:.0f} "
              f"ms/step) active={rec['active']} window={rec['window']}",
              flush=True)

    return on_sample


def run(t_end=1.5, quick=False, out="", device=None, capacity=CAPACITY,
        coarsen=1, f64=False, case=None,
        steps_per_host_visit=STEPS_PER_VISIT, timing_reps=5,
        max_wall=None) -> dict:
    """Load and run the case directory `case` (by default one that
    write_jetflow_case writes into a temporary directory); returns the
    result dict with its `gates` and `passed`. `max_wall` seconds stop
    the run early (validate.run_until); a run so stopped reports
    `t_reached` and takes no full-run gate."""
    import numpy as np
    import torch

    from sedifoam_tpu_torch import cases, default_device
    from sedifoam_tpu_torch.dem import fused
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.validate import run_until

    device = default_device(device)
    dtype = torch.float64 if f64 else torch.float32
    D, U0 = cases.JET_D, cases.JET_U
    with tempfile.TemporaryDirectory(prefix="jetflow_") as tmp:
        if case is None:
            case = cases.write_jetflow_case(os.path.join(tmp, "jetFlow"))
        cfg, state = load(case, coarsen, device, capacity, dtype)

    probes = [(0.0, s * D, 0.0) for s in STATIONS]
    sim = Simulation(cfg, state, probe_locations=probes,
                     steps_per_host_visit=steps_per_host_visit,
                     device=device)
    graphed = sim.advance is not sim.step_fn
    if graphed:
        sim.advance = CaptureLog(sim.advance)
    progress, windows = [], []
    launched = fused.launch_sizes()
    on_sample = heartbeat(t_end, progress, windows, steps_per_host_visit)
    reached = run_until(sim, t_end, max_wall, probe_every=PROBE_EVERY,
                        on_sample=on_sample)
    full_gates = not quick and reached
    launched = fused.launch_sizes() - launched

    times, Ub = sim.probes.series("Ub")        # (n_t, 3, n_probe)
    uc = Ub[:, 1, :]                           # the axial component
    fs, ps = sim.state.fluid, sim.state.particles
    q_in, q_disc, q_exact = inlet_fluxes(cfg, fs, U0)
    n_active = int(ps.active.sum())
    result = {
        "t_end": t_end, "quick": bool(quick),
        "grid": list(cfg.grid.shape),
        "t_reached": sim.t,
        "steps": int(fs.step),
        "wall_time_s": round(sim.wall_time, 2),
        "inlet_flux_rel_err": abs(q_in / q_disc - 1.0),
        "disc_area_rel_err": abs(q_disc / q_exact - 1.0),
        "n_particles_active": n_active,
        "finite": bool(torch.isfinite(fs.Ub).all()
                       and torch.isfinite(fs.p).all()
                       and torch.isfinite(ps.vel).all()),
        "nbr_k": cfg.dem.nbr_k,
        "nbr_dropped": int(ps.nbr_dropped),
        "sub_steps": cfg.cloud.sub_steps,
        "windows": windows,
        "captures": sim.advance.graphed.captures if graphed else 0,
        "capture_s": round(sim.advance.graphed.capture_seconds, 3)
        if graphed else 0.0,
        "capture_log": sim.advance.log if graphed else [],
        # the contact-chain kernel's launches in the run, by window size
        "chain_launches": {str(n): c for n, c in sorted(launched.items())},
        "progress": progress,
        "timing_split_ms": {k: round(v * 1e3, 2) for k, v in
                            sim.timing_split(n=timing_reps).items()},
    }
    result["continuity_err"] = float(sim.diag_fn(sim.state)["continuity_err"])

    gates = {
        "finite": result["finite"],
        "inlet_flux": result["inlet_flux_rel_err"] < 1e-6,
        "disc_area": result["disc_area_rel_err"] < 2e-2,
    }
    if full_gates:
        # the developed jet: the centreline over the last 40% of the run
        late = times > 0.6 * t_end
        uc_mean = uc[late].mean(axis=0)
        result["uc_mean_by_station"] = {f"y/D={s}": round(float(u), 4)
                                        for s, u in zip(STATIONS, uc_mean)}
        B = [float(uc_mean[i] * s / U0) for i, s in enumerate(STATIONS)]
        result["decay_B_by_station"] = {f"y/D={s}": round(b, 2)
                                        for s, b in zip(STATIONS, B)}
        gates["uc_monotone"] = bool(uc_mean[1] > uc_mean[2] > uc_mean[3])
        gates["decay_band"] = all(3.0 < b < 12.0 for b in B[1:4])
        gates["particles_flowing"] = 100 < n_active < capacity
    result["gates"] = gates
    result["not_evaluated"] = [] if full_gates else list(FULL_GATES)
    result["passed"] = all(gates.values())
    if out:
        np.savez(out, times=times, uc=uc,
                 stations=np.asarray(STATIONS, float), D=D, U0=U0)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t-end", type=float, default=1.5)
    ap.add_argument("--quick", action="store_true",
                    help="2x-coarsened mesh, capacity 8192, 0.05 s, smoke "
                         "gates only")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--case", default=None,
                    help="a case directory (default: one written by "
                         "cases.write_jetflow_case)")
    ap.add_argument("--capacity", type=int, default=CAPACITY)
    ap.add_argument("--out", default="",
                    help="the centreline samples (.npz)")
    ap.add_argument("--max-wall", type=float, default=None,
                    help="stop the run after about this many seconds and "
                         "report how far it came (no full-run gate then)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    coarsen = 1
    if args.quick:
        # the script's quick mode shortens only a default t_end
        t_end = QUICK["t_end"] if args.t_end == 1.5 else args.t_end
        vars(args).update(t_end=t_end, capacity=QUICK["capacity"])
        coarsen = QUICK["coarsen"]
    result = run(args.t_end, args.quick, args.out, args.device,
                 args.capacity, coarsen, args.f64, case=args.case,
                 max_wall=args.max_wall)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
