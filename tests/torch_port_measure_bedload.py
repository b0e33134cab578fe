"""The bedload validator's sequence on the port and on the JAX package, in
float64 on the CPU, side by side: does the port follow the reference
over a window long enough to matter for `mpm_band`?

    JAX_PLATFORMS=cpu python3 tests/torch_port_measure_bedload.py \
        [--t-settle 0.3] [--steps 400] [--coarsen 4] [--window 50] \
        [--every 250] [--threads 4]

One directory is written by cases.write_channel_case at its full mesh
(140x65x60) with the full bed (6 layers, 6,072 grains of 2.5 mm in a
table of 8,192); each package loads it as the validator does (binned,
K from the loader, the semi-implicit drag, the mesh coarsened
--coarsen times, the fluid anew at rest on it) but in float64, lets the
bed settle for --t-settle seconds with the forcing off, sets the clock
back to 0 and runs --steps Ubar steps, sampling every step: q (the
mobile grains' volume flux per bed area), gradP and the Shields number
theta = rhob gradP V_fluid / A_bed / ((rhoa - rhob) g d), by the
validator's formulas. The two packages run at once, each in a process
of its own (--threads PyTorch threads for the port).

Prints one JSON line every --every steps of either phase: the largest
distance between a grain's positions in the two packages (m) and the
largest velocity difference relative to the reference's largest speed;
one JSON line per --window forced steps: the worst deviation of each
quantity over the window, relative to the reference's largest magnitude
in it; then a last JSON line with the settled states' worst field
deviation, the first forced step at which a deviation passed 1e-6 (null
if none did), and the run's wall times. A one-off measurement; not
collected by pytest (the file name has no test_ prefix).
"""

import argparse
import dataclasses
import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

D, RHOA, G = 2.5e-3, 2650.0, 9.81
DT = 1e-4


def area():
    from sedifoam_tpu_torch import cases
    box = cases.CHANNEL_BOX
    return (box[1] - box[0]) * (box[5] - box[4])


def _snapshots(every, snaps, phase):
    """on_sample callback appending (phase, step, pos, vel) to `snaps`
    every `every` steps (the step as the state counts it)."""
    import numpy as np

    def snap(sim):
        ps = sim.state.particles
        k = int(sim.state.fluid.step)
        if k % every == 0:
            snaps.append((phase, k, np.array(ps.pos), np.array(ps.vel)))
    return snap


def run_port(case, coarsen, t_settle, steps, every, threads):
    import torch
    torch.set_num_threads(threads)

    from sedifoam_tpu_torch import validate
    from sedifoam_tpu_torch.config import ChannelForcing
    from sedifoam_tpu_torch.fluid.state import init_fluid
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import initialize
    cfg, fluid, particles, _ = load_case(case, backend="binned",
                                         dtype=torch.float64, capacity=8192,
                                         device="cpu")
    cfg = validate.coarsened(validate.semi_implicit(cfg), coarsen)
    fluid = init_fluid(cfg.grid, dtype=torch.float64, device="cpu")
    state = initialize(fluid, particles, cfg)
    snaps = []
    # validate.settle's sequence, with snapshots
    cfg_settle = dataclasses.replace(cfg, fluid=dataclasses.replace(
        cfg.fluid, forcing=ChannelForcing(mode="none")))
    sim0 = Simulation(cfg_settle, state, steps_per_host_visit=1,
                      device="cpu")
    sim0.run(t_settle, on_sample=_snapshots(every, snaps, "settle"))
    state = sim0.state._replace(fluid=sim0.state.fluid._replace(
        time=torch.zeros_like(sim0.state.fluid.time)))
    settled = state
    out = {"q": [], "gp": [], "Vb": [], "snaps": snaps}
    cellV = cfg.grid.cell_volume_like(fluid.alpha)
    snap = _snapshots(every, snaps, "forced")

    def on_sample(sim):
        snap(sim)
        ps, fs = sim.state.particles, sim.state.fluid
        mob = ps.active & (ps.ptype == 1)
        vp = (4.0 / 3.0) * torch.pi * ps.radius ** 3
        out["q"].append(float(torch.sum(torch.where(
            mob, ps.vel[:, 0], torch.zeros_like(vp)) * vp)) / area())
        out["gp"].append(float(fs.grad_p_value))
        out["Vb"].append(float(torch.sum((1.0 - fs.alpha) * cellV)))

    sim = Simulation(cfg, state, steps_per_host_visit=1, device="cpu")
    sim.run((steps - 0.5) * DT, on_sample=on_sample)
    return _fields(settled), out, cfg.fluid.rhob


def run_jax(case, coarsen, t_settle, steps, every, threads):
    del threads                      # XLA sizes its own thread pool
    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np

    from sedifoam_tpu.config import ChannelForcing
    from sedifoam_tpu.fluid.state import init_fluid
    from sedifoam_tpu.grid import Grid
    from sedifoam_tpu.io.case import load_case
    from sedifoam_tpu.runtime.runner import Simulation
    from sedifoam_tpu.solver import initialize
    from sedifoam_tpu.utils.postprocess import coarsen_faces
    cfg, fluid, particles, _ = load_case(case, backend="binned",
                                         dtype=jnp.float64, capacity=8192)
    cfg = dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=True))
    if coarsen > 1:
        grid = Grid.from_faces(*(coarsen_faces(
            np.asarray(cfg.grid.axis_faces(a)), coarsen) for a in range(3)))
        cfg = dataclasses.replace(cfg, grid=grid)
        fluid = init_fluid(grid, dtype=jnp.float64)
    state = initialize(fluid, particles, cfg)
    snaps = []
    cfg_settle = dataclasses.replace(cfg, fluid=dataclasses.replace(
        cfg.fluid, forcing=ChannelForcing(mode="none")))
    sim0 = Simulation(cfg_settle, state, steps_per_host_visit=1)
    sim0.run(t_settle, on_sample=_snapshots(every, snaps, "settle"))
    state = sim0.state._replace(fluid=sim0.state.fluid._replace(
        time=jnp.zeros_like(sim0.state.fluid.time)))
    settled = state
    out = {"q": [], "gp": [], "Vb": [], "snaps": snaps}
    cellV = np.asarray(cfg.grid.cell_volume)
    snap = _snapshots(every, snaps, "forced")

    def on_sample(sim):
        snap(sim)
        ps, fs = sim.state.particles, sim.state.fluid
        mob = np.asarray(ps.active) & (np.asarray(ps.ptype) == 1)
        vp = (4.0 / 3.0) * np.pi * np.asarray(ps.radius) ** 3
        out["q"].append(float((np.asarray(ps.vel)[mob, 0] * vp[mob]).sum())
                        / area())
        out["gp"].append(float(fs.grad_p_value))
        out["Vb"].append(float(jnp.sum((1.0 - fs.alpha) * cellV)))

    sim = Simulation(cfg, state, steps_per_host_visit=1)
    sim.run((steps - 0.5) * DT, on_sample=on_sample)
    return _fields(settled), out


def _fields(state):
    """The settled state's compared fields as numpy arrays, and its
    step count."""
    import numpy as np
    return {"pos": np.asarray(state.particles.pos),
            "vel": np.asarray(state.particles.vel),
            "alpha": np.asarray(state.fluid.alpha),
            "p": np.asarray(state.fluid.p), "Ub": np.asarray(state.fluid.Ub),
            "step": int(state.fluid.step)}


def settled_deviation(port, ref):
    """(worst deviation of scale, field) over the particle positions and
    velocities and the fluid's alpha, p and Ub of the settled states."""
    import numpy as np
    worst, where = 0.0, ""
    for name in ("pos", "vel", "alpha", "p", "Ub"):
        a, b = port[name], ref[name]
        e = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        if e > worst:
            worst, where = e, name
    return worst, where


def _timed(fn, *args):
    t0 = time.perf_counter()
    return fn(*args), time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--t-settle", type=float, default=0.3)
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--coarsen", type=int, default=4)
    ap.add_argument("--window", type=int, default=50)
    ap.add_argument("--every", type=int, default=250)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    import multiprocessing

    import numpy as np

    from sedifoam_tpu_torch import cases
    run_args = (args.coarsen, args.t_settle, args.steps, args.every,
                args.threads)
    with tempfile.TemporaryDirectory(prefix="bedload_") as tmp:
        case = cases.write_channel_case(os.path.join(tmp, "bedload"),
                                        **cases.CHANNEL_FULL)
        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(2) as pool:
            port_job = pool.apply_async(_timed, (run_port, case) + run_args)
            jax_job = pool.apply_async(_timed, (run_jax, case) + run_args)
            (p_settled, port, rhob), t_port = port_job.get()
            (j_settled, ref), t_jax = jax_job.get()
    for (phase, k, pos, vel), snap_ref in zip(port["snaps"], ref["snaps"]):
        assert (phase, k) == snap_ref[:2], ((phase, k), snap_ref[:2])
        pos_ref, vel_ref = snap_ref[2:]
        print(json.dumps({
            "phase": phase, "step": k,
            "pos_dev_m": float(np.abs(pos - pos_ref).max()),
            "vel_dev": float(np.abs(vel - vel_ref).max()
                             / max(np.abs(vel_ref).max(), 1e-300))}),
            flush=True)
    for out in (port, ref):
        out["theta"] = [rhob * gp * vb / area() / ((RHOA - rhob) * G * D)
                        for gp, vb in zip(out["gp"], out["Vb"])]
    first = None
    for w0 in range(0, args.steps, args.window):
        sl = slice(w0, w0 + args.window)
        line = {"steps": [w0 + 1, min(w0 + args.window, args.steps)]}
        for k in ("q", "gp", "theta"):
            a, b = np.asarray(port[k][sl]), np.asarray(ref[k][sl])
            dev = np.abs(a - b) / max(np.abs(b).max(), 1e-300)
            line[k] = float(dev.max())
            line[k + "_ref_mean"] = float(b.mean())
            over = np.nonzero(dev > 1e-6)[0]
            if over.size and (first is None or w0 + over[0] + 1 < first):
                first = int(w0 + over[0] + 1)
        print(json.dumps(line), flush=True)
    worst, where = settled_deviation(p_settled, j_settled)
    print(json.dumps({"settle_steps": p_settled["step"],
                      "settled_worst": worst, "settled_field": where,
                      "first_step_over_1e-6": first,
                      "forced_steps": args.steps, "coarsen": args.coarsen,
                      "wall_s_port": round(t_port, 1),
                      "wall_s_jax": round(t_jax, 1)}), flush=True)


if __name__ == "__main__":
    main()
