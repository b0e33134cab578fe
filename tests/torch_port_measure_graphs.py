"""Before-and-after measurement of the captured step on one CUDA card in
one call: a parent tree's eager step against this tree's graphed step.

    git archive <parent> sedifoam_tpu_torch | tar -x -C build/parent
    python3 tests/torch_port_measure_graphs.py build/parent . . build/parent

Each argument is a directory holding a `sedifoam_tpu_torch` package; each
is measured in a process of its own, in the order given (parent, change,
change, parent, so that a drift of the host shows), and prints one JSON
line. Every step goes through runtime.runner.Simulation, as the
validators run it: eagerly in a tree without graphs, replayed in one
with them.

- bench case (131,072 particles, 32x64x32, K = 8, f32): ms per step
  (host clock, 10 steps after a warm-up step), host syncs of one step as
  the Simulation takes it (torch's sync debug mode), the device's busy
  share (torch.profiler: kernel time over the span of 5 steps), the
  median rate of 5 timed blocks of sedifoam_tpu_torch.bench.run;
- channel (cases.write_channel_case at 140x65x60, 6 layers pressed 2 um,
  binned f32, semi-implicit drag, Ubar): ms per step, syncs, busy share;
- clumps (cases.write_irregular_case at 72x50x36, 600 clumps pressed 10
  um): ms per step (5 steps), syncs, busy share;
- the two validators at their full meshes, cut in depth:
  validate.irregular 150 steps, validate.bedload 50 settling + 150
  forced steps: ms per step of the forced run (its wall time over its
  steps).

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
DT = 1e-4                   # both validators' fluid step
# the text of torch's sync debug mode warning (its first use also warns
# that the mode is a prototype: that notice is no sync)
SYNC_WARNING = "called a synchronizing CUDA operation"


def count_syncs(fn):
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(SYNC_WARNING in str(w.message) for w in seen)


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


def busy_share(sim, first, n):
    """Kernel time over the span from the first kernel to the last one,
    over steps first+1 .. first+n (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        sim.run((first + n - 0.5) * sim.cfg.fluid.dt)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        return None
    return sum(b - a for a, b in spans) / (max(b for _, b in spans)
                                           - min(a for a, _ in spans))


def step_syncs(sim):
    """Host syncs of one coupled step as the Simulation takes it."""
    advance = getattr(sim, "advance", sim.step_fn)
    return count_syncs(lambda: advance(clone_tree(sim.state)))


def measure_sim(out, key, sim, warm, n):
    sim.run((warm - 0.5) * sim.cfg.fluid.dt)            # warm-up
    out[f"{key}_ms_per_step"] = timed_steps(sim, warm, n)
    out[f"{key}_syncs_per_step"] = step_syncs(sim)
    out[f"{key}_busy_share"] = busy_share(sim, warm + n, 3)


def measure(root, device="cuda:0"):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import sedifoam_tpu_torch
    from sedifoam_tpu_torch import bench, bench_case, cases
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import initialize
    from sedifoam_tpu_torch.validate import bedload, irregular
    assert os.path.abspath(sedifoam_tpu_torch.__file__).startswith(
        os.path.abspath(root)), sedifoam_tpu_torch.__file__
    dev = torch.device(device)
    out = {"root": root}

    def semi(cfg):
        return dataclasses.replace(cfg, cloud=dataclasses.replace(
            cfg.cloud, semi_implicit_drag=True))

    # bench case
    cfg = bench_case.build_config(**bench_case.FULL)
    fluid, particles = bench_case.build_state(
        cfg, bench_case.FULL["n_particles"], torch.float32, dev)
    sim = Simulation(cfg, initialize(fluid, particles, cfg), device=dev)
    measure_sim(out, "bench", sim, 1, 10)
    del sim
    run = bench.run(device=dev, repeats=5)
    out["bench_rate_median"] = run.value
    out["bench_rates"] = run.rates
    del run

    # channel
    with tempfile.TemporaryDirectory() as tmp:
        case = cases.write_channel_case(os.path.join(tmp, "channel"),
                                        **cases.CHANNEL_FULL, overlap=2e-6)
        cfg, fluid, particles, _ = load_case(
            case, backend="binned", dtype=torch.float32, capacity=8192,
            device=dev)
    cfg = semi(cfg)
    sim = Simulation(cfg, initialize(fluid, particles, cfg), device=dev)
    measure_sim(out, "channel", sim, 1, 10)
    del sim

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
    sim = Simulation(cfg, initialize(fluid, particles, cfg), device=dev)
    measure_sim(out, "clumps", sim, 1, 5)
    del sim

    # the validators, cut in depth
    res = irregular.run(t_end=150 * DT - 0.5 * DT, device=dev, timing_reps=1)
    out["irregular_ms_per_step"] = res["wall_time_s"] / res["steps"] * 1e3
    res = bedload.run(t_end=150 * DT - 0.5 * DT, t_settle=50 * DT - 0.5 * DT,
                      device=dev, timing_reps=1)
    out["bedload_ms_per_step"] = res["wall_time_s"] / 150 * 1e3
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
