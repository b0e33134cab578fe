"""The port's telemetry read at speed on one CUDA card: the phase clock,
the rebuild counter and the runner's spans over the benchmark's cells,
with the clock on and off, each run a process of its own.

    python3 tests/torch_port_measure_telemetry.py \\
        --cells bench_bed-visit20,bedload-visit20 --modes off,on,on,off \\
        --seeds 4100000001,4100000002 --seconds 40 \\
        --out telemetry.jsonl

For each cell, seed and mode (in that order) one process builds the cell
as port_bench/ builds it (pbench.harness.setup: inputs from the seed,
load, initialize, the Simulation, its capture, the warm-up visits), with
telemetry.enable(True) before the capture in mode "on". It then runs a
window of `--seconds` through Simulation.run as the harness's window
does (steps per visit, probe and log cadence of the cell's traffic) and
prints one JSON line:

- step_ms: the window's host ms per step (ending in a synchronize), and
  its first and last thirds;
- stretch: telemetry.delta from the window's first visit to the first
  visit past 40% of it, each read after the visit's own time read (a
  read at the window's open would add to `gap` the time the device
  idled before it): device ms per step of each clock slot, their sum,
  the host clock's ms per step over the same visits, rebuilds per step,
  and the runner's host ms per step (self time of run.visit,
  run.window, run.probes, run.diagnostics and run.write over the same
  visits, per step);
- chunks: the same split for every CHUNK visits of the window (a read
  after the visit's own time read, which has synchronized), to see
  which phase a slow stretch of the window is slow in;
- state_sha256 at the cell's check visit (the whole state's bytes): the
  same seed gives the same digest with the clock on and off;
- with --profile, torch.profiler over PROFILE_VISITS visits after the
  window: device kernels per step (no copies, fills or annotation
  echoes), and the names of the runner's spans on the profiler's
  timeline, host side and as device-side echoes;
- in mode "on", the device timer's resolution (telemetry.clock_ticks).

Imports nothing of JAX. `--root` and `--bench-dir` point at another
BENCHMARK.json and port_bench/ (the CPU rehearsal's tiny cells, with
`--device cpu`: no clock there, the same lines otherwise).
"""

import argparse
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
CHUNK = 10
START = 0.4
PROFILE_VISITS = 2
HOST_SPANS = ("run.visit", "run.window", "run.probes", "run.diagnostics",
              "run.write")


def _per_step(d, steps):
    from sedifoam_tpu_torch import telemetry
    out = {f"{s}_ms": d.get(f"clock.{s}_ns", 0) / 1e6 / steps
           for s in telemetry.SLOTS}
    out["sum_ms"] = sum(out.values())
    out["clock_steps"] = d.get("clock.steps", 0)
    out["rebuilds"] = d.get("rebuilds", 0) / steps
    out["runner_host_ms"] = sum(d.get(f"span.{n}.self_ns", 0)
                                for n in HOST_SPANS) / 1e6 / steps
    return out


def _digest(state):
    import torch
    from sedifoam_tpu_torch.graphs import flatten
    h = hashlib.sha256()
    for t in flatten(state):
        h.update(t.detach().reshape(-1).contiguous().view(torch.uint8)
                 .cpu().numpy())
    return h.hexdigest()


def _profile(sim, visits):
    """Kernels per step and the runner's span names on the timeline over
    `visits` visits."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    spv = sim.steps_per_visit
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        sim.run(sim.t + (visits * spv - 0.5) * sim.cfg.fluid.dt)
        torch.cuda.synchronize()
    kernels, host, echo = 0, set(), set()
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_card = e.device_type() == torch.autograd.DeviceType.CUDA
        if name.startswith("run."):
            (echo if on_card else host).add(name)
        elif on_card and not name.startswith(("Memcpy", "Memset", "pb.")):
            kernels += 1
    return {"kernels_per_step": kernels / (visits * spv),
            "host_spans": sorted(host), "device_echoes": sorted(echo)}


def one(args):
    t_start = time.perf_counter()
    sys.path[:0] = [args.bench_dir, REPO]
    import torch
    torch.set_num_threads(4)
    from pbench import harness, spec
    from sedifoam_tpu_torch import telemetry
    device = torch.device(args.device)
    on_card = device.type == "cuda"
    if args.mode == "on":
        telemetry.enable(True)
    cell = spec.find_cell(args.cell, Path(args.root), Path(args.bench_dir))
    wl = cell.workload
    spv = wl["steps_per_host_visit"]
    workdir = tempfile.mkdtemp(prefix="telemetry_")
    sim, rec = harness.setup(cell, args.seed, device, workdir, False,
                             t_start)
    setup_s = time.perf_counter() - t_start
    reads, stamps, digest, passed = [], [], [], []

    def hook(s):
        stamps.append(time.perf_counter())
        v = len(stamps)
        if v == wl["check_visit"]:
            digest.append(_digest(s.state))
        due = not passed and stamps[-1] >= t_open + START * args.seconds
        if due:
            passed.append(v)
        if v == 1 or v % CHUNK == 0 or due:
            reads.append((v, stamps[-1], telemetry.read()))
        if stamps[-1] >= t_open + args.seconds and v >= wl["check_visit"]:
            raise StopIteration

    reads.append((0, None, telemetry.read()))
    t_open = time.perf_counter()
    try:
        sim.run(math.inf, probe_every=wl["probe_every"],
                log_every=wl["log_every"], on_sample=hook)
    except StopIteration:
        pass
    if on_card:
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t_open
    n = len(stamps)
    st = [t_open] + stamps
    k = max(n // 3, 1)
    out = {"cell": args.cell, "seed": args.seed, "mode": args.mode,
           "device": (torch.cuda.get_device_name(device) if on_card
                      else "cpu"),
           "setup_s": setup_s, "visits": n, "steps": n * spv,
           "step_ms": wall * 1e3 / (n * spv),
           "thirds_ms": [(st[k] - st[0]) * 1e3 / (k * spv),
                         (st[n] - st[n - k]) * 1e3 / (k * spv)],
           "capture_s": rec["capture_s"],
           "state_sha256": digest[0] if digest else None}
    shutil.rmtree(workdir, ignore_errors=True)
    # from the first visit to the first past 40% of the window
    v0, t0, r0 = next(r for r in reads if r[0] == 1)
    v1, t1, r1 = next(r for r in reads if r[0] == passed[0])
    if v1 > v0:
        stretch = _per_step(telemetry.delta(r0, r1), (v1 - v0) * spv)
        stretch["host_ms"] = (t1 - t0) * 1e3 / ((v1 - v0) * spv)
        stretch["visits"] = [v0, v1]
        out["stretch"] = stretch
    chunks = []
    marks = [r for r in reads if r[0] % CHUNK == 0]
    for (va, ta, ra), (vb, tb, rb) in zip(marks, marks[1:]):
        c = _per_step(telemetry.delta(ra, rb), (vb - va) * spv)
        c["host_ms"] = ((tb - (ta or t_open)) * 1e3 / ((vb - va) * spv))
        c["visits"] = [va, vb]
        chunks.append(c)
    out["chunks"] = chunks
    if on_card and args.mode == "on":
        out["clock_ticks"] = telemetry.clock_ticks(device)
    if args.profile and on_card:
        out["profile"] = _profile(sim, PROFILE_VISITS)
    print(json.dumps(out), flush=True)
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default="bench_bed-visit20,bedload-visit20")
    ap.add_argument("--modes", default="off,on,on,off")
    ap.add_argument("--seeds", default="4100000001")
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--bench-dir", default=os.path.join(REPO, "port_bench"))
    ap.add_argument("--out", default=None)
    ap.add_argument("--one", nargs=3, metavar=("CELL", "SEED", "MODE"))
    args = ap.parse_args(argv)
    if args.one:
        args.cell, args.seed, args.mode = args.one
        args.seed = int(args.seed)
        return one(args)
    rc = 0
    for cell in args.cells.split(","):
        for seed in args.seeds.split(","):
            for mode in args.modes.split(","):
                cmd = [sys.executable, os.path.abspath(__file__),
                       "--one", cell, seed, mode,
                       "--seconds", str(args.seconds),
                       "--device", args.device, "--root", args.root,
                       "--bench-dir", args.bench_dir]
                if args.profile:
                    cmd.append("--profile")
                proc = subprocess.run(cmd, capture_output=True, text=True)
                line = proc.stdout.strip().splitlines()[-1:] or [""]
                if proc.returncode != 0 or not line[0].startswith("{"):
                    rc = 1
                    print(f"{cell} {seed} {mode}: exit {proc.returncode}\n"
                          f"{proc.stderr[-3000:]}", flush=True)
                    continue
                print(line[0], flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line[0] + "\n")
    return rc


if __name__ == "__main__":
    sys.exit(main())
