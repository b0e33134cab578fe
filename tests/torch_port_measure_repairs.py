"""Before-and-after measurement of two host-side repairs of the port, on
one CUDA card in one call: the graded grid's constants kept on the
device (Grid.const) and the one-pass compensated sum (utils/accum).

    git archive <parent> sedifoam_tpu_torch | tar -x -C build/parent
    python3 tests/torch_port_measure_repairs.py build/parent . . build/parent

Each argument is a directory holding a `sedifoam_tpu_torch` package; each
is measured in a process of its own, in the order given (parent, change,
change, parent, so that a drift of the host shows), and prints one JSON
line:

- channel (cases.write_channel_case at its full 140x65x60 mesh, 6 layers
  pressed 2 um together, binned f32, semi-implicit drag; 3 settling
  steps, then Ubar steps): host syncs of one coupled step (torch's sync
  debug mode), ms per Ubar step (host clock, 10 steps), ms of one Ubar
  adjust (CUDA events, mean of 3);
- clumps (cases.write_irregular_case at 72x50x36, 600 clumps pressed 10
  um): host syncs of a step, ms per step (5 steps after a warm-up);
- bench case (131,072 particles): host syncs of a step, ms of one
  diagnostics log (compute + one copy to the host, mean of 3), ms per
  step (10 steps).

Imports nothing of JAX. The card's name and power limit are printed
first.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import warnings

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def count_syncs(fn):
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in seen)


def cuda_ms(fn, reps):
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def clone_tree(obj):
    import torch
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if hasattr(obj, "_fields"):
        return type(obj)(*(clone_tree(v) for v in obj))
    return obj


def timed_steps(sim, first, n):
    """ms per step of steps first+1 .. first+n (host clock, synced)."""
    import torch
    dt = sim.cfg.fluid.dt
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.run((first + n - 0.5) * dt)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3


def measure(root, device="cuda:0"):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import sedifoam_tpu_torch
    from sedifoam_tpu_torch import bench_case, cases
    from sedifoam_tpu_torch.config import ChannelForcing
    from sedifoam_tpu_torch.fluid import piso
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.runtime import diagnostics
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import CoupledStep
    assert os.path.abspath(sedifoam_tpu_torch.__file__).startswith(
        os.path.abspath(root)), sedifoam_tpu_torch.__file__
    dev = torch.device(device)
    out = {"root": root}

    def semi(cfg):
        return dataclasses.replace(cfg, cloud=dataclasses.replace(
            cfg.cloud, semi_implicit_drag=True))

    # channel
    with tempfile.TemporaryDirectory() as tmp:
        case = cases.write_channel_case(os.path.join(tmp, "channel"),
                                        **cases.CHANNEL_FULL, overlap=2e-6)
        cfg, fluid, particles, _ = load_case(
            case, backend="binned", dtype=torch.float32, capacity=8192,
            device=dev)
    cfg = semi(cfg)
    settle_cfg = dataclasses.replace(cfg, fluid=dataclasses.replace(
        cfg.fluid, forcing=ChannelForcing(mode="none")))
    state = CoupledStep(settle_cfg, torch.float32, dev).initialize(
        fluid, particles)
    settle = Simulation(settle_cfg, state, device=dev)
    settle.run(2.5 * cfg.fluid.dt)
    sim = Simulation(cfg, settle.state, device=dev)
    sim.run(3.5 * cfg.fluid.dt)                         # warm-up
    out["channel_ms_per_step"] = timed_steps(sim, 4, 10)
    s = sim.state
    out["channel_syncs_per_step"] = count_syncs(
        lambda: sim.step_fn(clone_tree(s)))
    rua = torch.full_like(s.fluid.alpha, 1e-3)
    out["ubar_adjust_ms"] = cuda_ms(lambda: piso.adjust_channel_forcing(
        s.fluid, rua, cfg.grid, cfg.fluid), 3)
    t0 = time.perf_counter()
    for _ in range(3):
        diagnostics.to_host(sim.diag_fn(s))
    out["channel_diagnostics_log_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    del sim, settle, s, state

    # clumps
    full = cases.IRREGULAR_FULL
    with tempfile.TemporaryDirectory() as tmp, warnings.catch_warnings():
        warnings.simplefilter("ignore")
        case = cases.write_irregular_case(
            os.path.join(tmp, "irregular"), n_clumps=full["n_clumps"],
            counts=full["counts"], floor_d=full["floor_d"], press=1e-5)
        cfg, fluid, particles, _ = load_case(
            case, backend="binned", dtype=torch.float32, capacity=8192,
            device=dev)
    cfg = semi(cfg)
    state = CoupledStep(cfg, torch.float32, dev).initialize(fluid, particles)
    sim = Simulation(cfg, state, device=dev)
    sim.run(0.5 * cfg.fluid.dt)                         # warm-up
    out["clumps_ms_per_step"] = timed_steps(sim, 1, 5)
    s = sim.state
    out["clumps_syncs_per_step"] = count_syncs(
        lambda: sim.step_fn(clone_tree(s)))
    del sim, s, state

    # bench case
    cfg = bench_case.build_config(**bench_case.FULL)
    fluid, particles = bench_case.build_state(
        cfg, bench_case.FULL["n_particles"], torch.float32, dev)
    state = CoupledStep(cfg, torch.float32, dev).initialize(fluid, particles)
    sim = Simulation(cfg, state, device=dev)
    sim.run(0.5 * cfg.fluid.dt)
    out["bench_ms_per_step"] = timed_steps(sim, 1, 10)
    s = sim.state
    out["bench_syncs_per_step"] = count_syncs(
        lambda: sim.step_fn(clone_tree(s)))
    diagnostics.to_host(sim.diag_fn(s))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        diagnostics.to_host(sim.diag_fn(s))
    out["bench_diagnostics_log_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    print(json.dumps(out), flush=True)


def main(argv):
    if len(argv) == 2 and argv[0] == "--measure":
        return measure(argv[1])
    if not argv:
        sys.exit(__doc__)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    for root in argv:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--measure", root], cwd=REPO)
        if res.returncode != 0:
            sys.exit(f"measuring {root} failed")


if __name__ == "__main__":
    main(sys.argv[1:])
