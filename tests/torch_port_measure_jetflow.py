"""jetFlow's centreline on the port and on the JAX package, on the CPU,
side by side: does the port follow the reference while the jet's front
passes the stations that `decay_band` reads (y/D 20, 30, 40)?

    JAX_PLATFORMS=cpu python3 tests/torch_port_measure_jetflow.py \
        [--t-end 0.2] [--coarsen 2] [--f32] [--threads 4]

One directory is written by cases.write_jetflow_case at its full mesh
(56x120x56); each package loads it as the validator loads it (binned,
embed_ogrid, K from the loader, the explicit drag, capacity 8,192, the
mesh coarsened --coarsen times, the fluid anew at rest on it), in
float64 unless --f32, and runs to --t-end with the validator's probes
(the axis at y/D 10, 20, 30, 40, 50) sampled at every host visit of 25
steps, the active window following the population. The two packages
run at once, each in a process of its own (--threads PyTorch threads
for the port).

Prints one JSON line per sample: the time, the axial velocity Uc / U0
at each station in both packages, the largest difference between them
relative to U0, and both populations; then a last JSON line: the time
at which Uc first passed U0 / 2 at each station (the front's arrival)
in each package, B = (Uc / U0)(y/D) at each station at the end in each,
the worst probe difference, the particle rows at the end (active rows
equal; the largest position difference in m and velocity difference
relative to the reference's largest speed), the windows, and the wall
times. A one-off measurement; not collected by pytest (the file name
has no test_ prefix).
"""

import argparse
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

CAPACITY = 8192
VISIT = 25


def _population(pop, windows, label):
    """on_sample callback recording the active count at each visit and
    each window size reached; every fourth visit prints a line."""
    import numpy as np

    def on_sample(sim):
        ps = sim.state.particles
        pop.append(int(np.asarray(ps.active).sum()))
        if not windows or windows[-1] != ps.n_capacity:
            windows.append(int(ps.n_capacity))
        if len(pop) % 4 == 0:
            print(f"[{label}] t={float(sim.t):.4f} active={pop[-1]}",
                  flush=True)
    return on_sample


def run_port(case, coarsen, t_end, f64, threads):
    import numpy as np
    import torch
    torch.set_num_threads(threads)

    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.validate import jetflow
    dtype = torch.float64 if f64 else torch.float32
    cfg, state = jetflow.load(case, coarsen, "cpu", CAPACITY, dtype)
    probes = [(0.0, s * cases.JET_D, 0.0) for s in jetflow.STATIONS]
    sim = Simulation(cfg, state, probe_locations=probes,
                     steps_per_host_visit=VISIT, device="cpu")
    pop, windows = [], []
    sim.run(t_end - 0.5 * cfg.fluid.dt, probe_every=1,
            on_sample=_population(pop, windows, "port"))
    times, Ub = sim.probes.series("Ub")
    ps = sim.state.particles
    rows = {k: np.asarray(getattr(ps, k).double() if k != "active"
                          else ps.active) for k in ("pos", "vel", "active")}
    return np.asarray(times, float), np.asarray(Ub[:, 1, :], float), pop, \
        windows, rows


def run_jax(case, coarsen, t_end, f64, threads):
    del threads                      # XLA sizes its own thread pool
    import jax
    jax.config.update("jax_enable_x64", bool(f64))
    import dataclasses

    import jax.numpy as jnp
    import numpy as np

    from sedifoam_tpu.fluid.state import init_fluid
    from sedifoam_tpu.grid import Grid
    from sedifoam_tpu.io.case import load_case
    from sedifoam_tpu.runtime.runner import Simulation
    from sedifoam_tpu.solver import initialize
    from sedifoam_tpu.utils.postprocess import coarsen_faces
    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.validate import jetflow
    dtype = jnp.float64 if f64 else jnp.float32
    cfg, fluid, particles, _ = load_case(case, backend="binned", dtype=dtype,
                                         embed_ogrid=True, capacity=CAPACITY)
    if coarsen > 1:
        grid = Grid.from_faces(*(coarsen_faces(
            np.asarray(cfg.grid.axis_faces(a)), coarsen) for a in range(3)))
        cfg = dataclasses.replace(cfg, grid=grid)
        fluid = init_fluid(grid, dtype=dtype)
    state = initialize(fluid, particles, cfg)
    probes = [(0.0, s * cases.JET_D, 0.0) for s in jetflow.STATIONS]
    sim = Simulation(cfg, state, probe_locations=probes,
                     steps_per_host_visit=VISIT)
    pop, windows = [], []
    sim.run(t_end - 0.5 * cfg.fluid.dt, probe_every=1,
            on_sample=_population(pop, windows, "jax"))
    times, Ub = sim.probes.series("Ub")
    ps = sim.state.particles
    rows = {k: np.asarray(getattr(ps, k), float if k != "active" else bool)
            for k in ("pos", "vel", "active")}
    return np.asarray(times, float), np.asarray(Ub[:, 1, :], float), pop, \
        windows, rows


def _timed(fn, *args):
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


def arrivals(times, uc, u0):
    """The first sample time at which Uc passed U0 / 2 at each station
    (None where it never did)."""
    out = []
    for i in range(uc.shape[1]):
        over = (uc[:, i] > 0.5 * u0).nonzero()[0]
        out.append(float(times[over[0]]) if over.size else None)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t-end", type=float, default=0.2)
    ap.add_argument("--coarsen", type=int, default=2)
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    import multiprocessing

    import numpy as np

    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.validate import jetflow
    run_args = (args.coarsen, args.t_end, not args.f32, args.threads)
    with tempfile.TemporaryDirectory(prefix="jetflow_") as tmp:
        case = cases.write_jetflow_case(os.path.join(tmp, "jetFlow"))
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(2) as pool:
            port_job = pool.apply_async(_timed, (run_port, case) + run_args)
            jax_job = pool.apply_async(_timed, (run_jax, case) + run_args)
            (t_p, uc_p, pop_p, win_p, rows_p), wall_p = port_job.get()
            (t_j, uc_j, pop_j, win_j, rows_j), wall_j = jax_job.get()
    u0 = cases.JET_U
    st = jetflow.STATIONS
    assert np.allclose(t_p, t_j, rtol=1e-6), (t_p, t_j)
    dev = np.abs(uc_p - uc_j).max(axis=1) / u0
    for k in range(len(t_p)):
        print(json.dumps({
            "t": round(float(t_j[k]), 6),
            "uc_over_u0_port": [round(float(u) / u0, 5) for u in uc_p[k]],
            "uc_over_u0_jax": [round(float(u) / u0, 5) for u in uc_j[k]],
            "worst_dev_of_u0": float(dev[k]),
            "active_port": pop_p[k], "active_jax": pop_j[k]}), flush=True)
    same_rows = bool(np.array_equal(rows_p["active"], rows_j["active"]))
    act = rows_j["active"]
    rows = {"active_equal": same_rows}
    if same_rows:
        rows["pos_dev_m"] = float(np.abs(rows_p["pos"][act]
                                         - rows_j["pos"][act]).max())
        rows["vel_dev"] = float(
            np.abs(rows_p["vel"][act] - rows_j["vel"][act]).max()
            / max(np.abs(rows_j["vel"][act]).max(), 1e-300))
    print(json.dumps({
        "t_end": args.t_end, "coarsen": args.coarsen,
        "dtype": "float32" if args.f32 else "float64",
        "front_arrival_s_port": arrivals(t_p, uc_p, u0),
        "front_arrival_s_jax": arrivals(t_j, uc_j, u0),
        "B_at_end_port": [round(float(uc_p[-1, i]) / u0 * s, 3)
                          for i, s in enumerate(st)],
        "B_at_end_jax": [round(float(uc_j[-1, i]) / u0 * s, 3)
                         for i, s in enumerate(st)],
        "worst_dev_of_u0": float(dev.max()),
        "first_t_dev_over_1e-3": next(
            (float(t_j[k]) for k in range(len(dev)) if dev[k] > 1e-3), None),
        "particle_rows_at_end": rows,
        "active_at_end": [pop_p[-1], pop_j[-1]],
        "windows": [win_p, win_j],
        "wall_s_port": round(wall_p, 1), "wall_s_jax": round(wall_j, 1)}),
        flush=True)


if __name__ == "__main__":
    main()
