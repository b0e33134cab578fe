"""The split step captured as one CUDA graph per rank
(parallel/step.GraphedShardedStep) under NCCL, one rank a card, against
one process on the same cards.

    python3 tests/torch_port_measure_split_graph.py [--ranks 1,4] [--steps 3]

needs as many cards as the largest rank count. On the bench bed at full
width with sorted rebuilds (131,072 particles, 32x64x32, K = 8, f32) and
the transport-bedload channel at its full 140x65x60 (8,192 rows, K =
16, the semi-implicit drag):

- one process on card 0: CoupledStep eagerly, the oracle (ms per step),
  and solver.GraphedStep (capture seconds, ms per replayed step, the
  device's busy share over BUSY_REPS replays);
- for each rank count R above 1, first two spawns that place a stall:
  one all_reduce over the R NCCL ranks (`nccl_job`), then one eager
  ShardedStep step of each configuration (`eager_job`), each with its
  own time limit and its wall seconds printed, or where it ran past;
- for each rank count R, in one spawn of R NCCL ranks
  (parallel/launch.run_ranks): parallel/step.run_steps(graphed=True),
  so per rank the capture's seconds and conditional nodes, ms per
  replayed step beside the eager ShardedStep's, host syncs a replay,
  the collective bytes a replay by kind (counted on the device) and the
  fields that part from the eager ShardedStep; rank 0's gathered state
  after the last step against the one process's (the fields that are
  not bit for bit); then each rank's busy share over BUSY_REPS replays.

Busy share: the kernels' summed time over the span from the first
kernel's start to the last one's end (torch.profiler). Prints the card's
name and power limit first, then one JSON line per configuration and
rank count. Imports nothing of JAX.
"""

import argparse
import dataclasses
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sedifoam_tpu_torch import bench_case, bridge, cases, graphs  # noqa: E402
from sedifoam_tpu_torch.io.case import load_case  # noqa: E402
from sedifoam_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from sedifoam_tpu_torch.parallel.mesh import shard_state  # noqa: E402
from sedifoam_tpu_torch.parallel.step import GraphedShardedStep, \
    ShardedStep, run_steps  # noqa: E402
from sedifoam_tpu_torch.solver import CoupledStep, GraphedStep  # noqa: E402

BUSY_REPS = 5
TIMEOUT = 300.0            # seconds a spawn of ranks may take
STAGE_TIMEOUTS = {"nccl": 90.0, "eager": 200.0}   # the placing spawns'


def busy_share(advance, state, reps=BUSY_REPS):
    """The device's busy share over `reps` calls of advance(state) after
    one uncounted call (None where the profile saw no kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    state = advance(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            state = advance(state)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    if not spans:
        return None
    return sum(b - a for a, b in spans) / (max(b for _, b in spans)
                                           - min(a for a, _ in spans))


def nccl_job(mesh):
    """One all_reduce of the rank over the NCCL ranks: their sum."""
    import torch.distributed as dist
    x = torch.full((1,), float(mesh.rank), device=mesh.device)
    dist.all_reduce(x)
    return float(x.item())


def eager_job(mesh, jobs):
    """One eager ShardedStep step of each job's configuration: its
    milliseconds and bytes by kind."""
    out = []
    for _, cfg, snp, _ in jobs:
        res = run_steps(mesh, cfg, snp, 1, keep=set())
        out.append({"ms": res["ms"], "comm": res["comm"]})
    return out


def rank_job(mesh, jobs):
    """For each (label, cfg, state_np, n_steps): run_steps(graphed=True)
    keeping the last state, then the busy share of replays of a fresh
    capture."""
    out = []
    for label, cfg, snp, n_steps in jobs:
        res = run_steps(mesh, cfg, snp, n_steps, keep={n_steps},
                        graphed=True)
        local = shard_state(bridge.sim_state_from_numpy(
            snp, device=mesh.device), mesh)
        graphed = GraphedShardedStep(ShardedStep(cfg, mesh,
                                                 local.particles.pos.dtype))
        res["busy"] = busy_share(graphed, local)
        res["label"] = label
        out.append(res)
        del graphed, local
        gc.collect()
        torch.cuda.empty_cache()
    return out


def parted(ref, got, path=""):
    """The leaves of two nested numpy dicts that are not bit for bit."""
    out = []
    for k, a in ref.items():
        where = f"{path}.{k}" if path else k
        if isinstance(a, dict):
            out += parted(a, got[k], where)
        elif a is not None:
            a, b = np.asarray(a), np.asarray(got[k])
            if a.shape != b.shape or a.tobytes() != b.tobytes():
                out.append(where)
    return out


def configs(dev):
    """[(label, cfg, initialized state)]: the sorted bench bed, the
    channel."""
    cfg = bench_case.build_config(**bench_case.FULL, sort_on_rebuild=True)
    fluid, parts = bench_case.build_state(cfg, bench_case.FULL["n_particles"],
                                          torch.float32, dev)
    bench = CoupledStep(cfg, torch.float32, dev).initialize(fluid, parts)
    with tempfile.TemporaryDirectory() as tmp:
        case = cases.write_channel_case(os.path.join(tmp, "channel"),
                                        **cases.CHANNEL_FULL, overlap=2e-6)
        ccfg, cfluid, cparts, _ = load_case(case, backend="binned",
                                            dtype=torch.float32,
                                            capacity=8192, device=dev)
    ccfg = dataclasses.replace(ccfg, cloud=dataclasses.replace(
        ccfg.cloud, semi_implicit_drag=True))
    channel = CoupledStep(ccfg, torch.float32, dev).initialize(cfluid,
                                                                cparts)
    return [("bench bed", cfg, bench), ("channel", ccfg, channel)]


def one_process(cfg, state, n_steps):
    """CoupledStep eagerly (ms, the states as numpy) and GraphedStep
    (capture s, ms, busy share) from `state`."""
    def timed(advance, st, each=None):
        ms = []
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = advance(st)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if each is not None:
                each.append(bridge.sim_state_to_numpy(st))
        return ms, st
    refs = []
    eager_ms, _ = timed(CoupledStep(cfg, state.particles.pos.dtype,
                                    state.particles.pos.device),
                        graphs.tree_map(torch.clone, state), refs)
    graphed = GraphedStep(CoupledStep(cfg, state.particles.pos.dtype,
                                      state.particles.pos.device))
    st = graphed(graphs.tree_map(torch.clone, state))
    graph_ms, st = timed(graphed, st)
    return {"eager_ms": eager_ms, "graph_ms": graph_ms,
            "capture_s": graphed.capture_seconds,
            "busy": busy_share(graphed, st)}, refs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", default="1,4")
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    ranks = [int(r) for r in args.ranks.split(",")]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < max(ranks):
        sys.exit(f"needs {max(ranks)} CUDA cards")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    jobs, refs, one = [], {}, {}
    for label, cfg, state in configs(dev):
        one[label], refs[label] = one_process(cfg, state, args.steps)
        jobs.append((label, cfg, bridge.sim_state_to_numpy(state),
                     args.steps))
        print(json.dumps({"config": label, "ranks": 0, "one_process":
                          one[label]}), flush=True)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    for n in ranks:
        if n > 1:
            for stage, job, job_args in (("nccl", nccl_job, ()),
                                         ("eager", eager_job, (jobs,))):
                t0 = time.perf_counter()
                try:
                    got = run_ranks(job, n, args=job_args, backend="nccl",
                                    timeout=STAGE_TIMEOUTS[stage])
                except TimeoutError as e:
                    print(json.dumps({"ranks": n, "stage": stage,
                                      "stalled": str(e)}), flush=True)
                    sys.exit(1)
                print(json.dumps({"ranks": n, "stage": stage, "wall_s":
                                  time.perf_counter() - t0,
                                  "result": got}), flush=True)
        t0 = time.perf_counter()
        res = run_ranks(rank_job, n, args=(jobs,), backend="nccl",
                        timeout=TIMEOUT)
        wall = time.perf_counter() - t0
        for i, (label, *_rest) in enumerate(jobs):
            per = [r[i] for r in res]
            print(json.dumps({
                "config": label, "ranks": n, "wall_s": wall,
                "fluid": per[0]["fluid"],
                "parted_from_one_process": parted(
                    refs[label][-1], per[0]["states"][args.steps]),
                "one_process_graph_ms": one[label]["graph_ms"],
                "one_process_busy": one[label]["busy"],
                "per_rank": [{k: r[k] for k in (
                    "rank", "device", "capture_s", "nodes", "ms",
                    "eager_ms", "syncs", "parted", "comm", "capture_bytes",
                    "launches", "busy")} for r in per]}), flush=True)


if __name__ == "__main__":
    main()
