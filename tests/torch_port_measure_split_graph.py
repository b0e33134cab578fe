"""The split step (parallel/step.ShardedStep) and its capture as one CUDA
graph per rank (GraphedShardedStep) on R NCCL ranks, one card each,
against one process on card 0, stage by stage.

    python3 tests/torch_port_measure_split_graph.py [--ranks 2,4]
        [--steps 3] [--stages nccl,probe,eager,capture,replays]
        [--configs-at 2] [--debug DIR] [--out FILE]

needs as many cards as the largest rank count. The beds: the bench bed
at full width with sorted rebuilds (131,072 particles, 32x64x32, K = 8,
f32, 10 substeps) and the transport-bedload channel at its full
140x65x60 (8,192 rows, K = 16, the semi-implicit drag), the fluid on
x-slabs at every R that divides nx; with --configs-at R, at those rank
counts also every configuration of chip_smoke.py's SPLIT_CONFIGS
(jetFlow with an add and a deletion, the irregular clumps, the extras
bed, the wiggled wall, the DNS box, the cut lattice bed).

For each rank count R, these stages in order, each its own spawn of R
NCCL ranks (parallel/launch.run_ranks) with its own time limit
(`STAGE_TIMEOUTS`; the group's collective timeout half of it, so a hung
eager collective raises inside its rank with NCCL's own message): the
first stage that fails or stalls is named and ends the run (exit 1).

- ``nccl``: one all_reduce over the ranks (`nccl_job`);
- ``probe``: parallel/probe.probe_ranks: each collective of the split
  step with its own split pattern eagerly, in a plain capture and in IF
  and WHILE bodies, each case with its own limit; the cases that fail
  are tried again under each NCCL setting of DIAG_ENVS (a diagnostic
  sweep), and the first setting under which all pass stays set for the
  stages that follow; then the halo as the uneven all_to_all_single
  it was (probe.OTHERS) in the bodies, reported;
- ``eager``: one eager ShardedStep step of each bed, rank 0's gathered
  state against one process's step (the fields that are not bit for
  bit);
- ``capture``: GraphedShardedStep's capture of each bed (seconds,
  conditional nodes, the bytes the graph holds by kind);
- ``replays``: parallel/step.run_steps(graphed=True): per rank the
  capture's seconds and nodes, ms per replayed step beside the eager
  ShardedStep's, host syncs a replay, the collective bytes a replay by
  kind (counted on the device), the kernel's launches inside the
  replays against one process's, the fields that part from the eager
  ShardedStep stepped beside them, and rank 0's gathered state after
  each step against one process's; then each rank's busy share over
  BUSY_REPS replays of a fresh capture.

One process on card 0 (built before the first stage that needs it):
CoupledStep eagerly, the oracle (ms per step, the state after each
step), and solver.GraphedStep (capture seconds, ms per replayed step,
busy share). Busy share: the kernels' summed time over the span from the
first kernel's start to the last one's end (torch.profiler).

--debug DIR (diagnostic runs only) sets, for the ranks: NCCL_DEBUG=INFO
for the set-up, transports and collectives (NCCL_DEBUG_SUBSYS), written
to DIR/nccl.<host>.<pid>.log, and PyTorch's flight recorder
(TORCH_NCCL_TRACE_BUFFER_SIZE, TORCH_NCCL_DUMP_ON_TIMEOUT=1, dumps as
DIR/nccl_trace_rank_<r>), which names the last collective each rank
entered when the group's timeout fires.

Prints the card's name and power limit first, then one JSON line per
stage and rank count (also appended to --out). Imports nothing of JAX.
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from sedifoam_tpu_torch import bench_case, bridge, cases, graphs  # noqa: E402
from sedifoam_tpu_torch.dem import fused  # noqa: E402
from sedifoam_tpu_torch.io.case import load_case  # noqa: E402
from sedifoam_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from sedifoam_tpu_torch.parallel.mesh import shard_state  # noqa: E402
from sedifoam_tpu_torch.parallel.probe import probe_ranks  # noqa: E402
from sedifoam_tpu_torch.parallel.step import GraphedShardedStep, \
    ShardedStep, run_steps  # noqa: E402
from sedifoam_tpu_torch.solver import CoupledStep, GraphedStep  # noqa: E402

BUSY_REPS = 5
STAGES = ("nccl", "probe", "eager", "capture", "replays")
# seconds each stage's spawn may take: the bench bed and the channel
# (the eager and capture stages also build each rank's operators); the
# configurations of --configs-at, a spawn of their own after the beds',
# EXTRA_PER_CONFIG each
STAGE_TIMEOUTS = {"nccl": 90.0, "eager": 150.0, "capture": 150.0,
                  "replays": 240.0}
EXTRA_PER_CONFIG = {"eager": 60.0, "capture": 60.0, "replays": 120.0}
MAX_STALLS = 3            # probe spawns ended before the rest is skipped
# NCCL settings under which the probe's failed cases are tried again, in
# order (the graph-mixing events, NVLink SHARP, graph buffer
# registration, shared memory, cuMem buffers; then all of them)
DIAG_ENVS = ({"NCCL_GRAPH_MIXING_SUPPORT": "0"}, {"NCCL_NVLS_ENABLE": "0"},
             {"NCCL_GRAPH_REGISTER": "0"}, {"NCCL_SHM_DISABLE": "1"},
             {"NCCL_CUMEM_ENABLE": "0"},
             {"NCCL_GRAPH_MIXING_SUPPORT": "0", "NCCL_NVLS_ENABLE": "0",
              "NCCL_GRAPH_REGISTER": "0", "NCCL_CUMEM_ENABLE": "0"})


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
    milliseconds, bytes by kind, the fluid's layout, and (rank 0) the
    gathered state after it."""
    out = []
    for _, cfg, snp, _, _ in jobs:
        res = run_steps(mesh, cfg, snp, 1, keep={1})
        out.append({k: res[k] for k in ("ms", "comm", "fluid", "states",
                                        "launches")})
        torch.cuda.empty_cache()
    return out


def capture_job(mesh, jobs):
    """GraphedShardedStep's capture of each job's configuration: its
    seconds, conditional nodes and the bytes by kind the graph holds."""
    out = []
    for _, cfg, snp, _, _ in jobs:
        local = shard_state(bridge.sim_state_from_numpy(
            snp, device=mesh.device), mesh)
        graphed = GraphedShardedStep(ShardedStep(
            cfg, mesh, local.particles.pos.dtype))
        graphed.capture(local)
        out.append({"capture_s": graphed.capture_seconds,
                    "nodes": graphed.nodes,
                    "capture_bytes": graphed.capture_bytes})
        del graphed, local
        gc.collect()
        torch.cuda.empty_cache()
    return out


def rank_job(mesh, jobs):
    """For each (label, cfg, state_np, n_steps, _): run_steps(graphed=True)
    keeping every state, then the busy share of replays of a fresh
    capture."""
    out = []
    for label, cfg, snp, n_steps, _ in jobs:
        res = run_steps(mesh, cfg, snp, n_steps, graphed=True)
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


def beds(dev):
    """(label, cfg, initialized state) of the sorted bench bed, then of
    the channel."""
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
    yield "bench bed", cfg, bench
    del bench
    channel = CoupledStep(ccfg, torch.float32, dev).initialize(cfluid,
                                                                cparts)
    yield "channel", ccfg, channel


def split_configs(dev):
    """(label, cfg, initialized state) of each of chip_smoke.py's
    SPLIT_CONFIGS at full width, in turn."""
    import chip_smoke
    for label, build in chip_smoke.SPLIT_CONFIGS:
        yield (label,) + tuple(build(dev))


def one_process(cfg, state, n_steps):
    """CoupledStep eagerly (ms, the states as numpy, the kernel's
    launches) and GraphedStep (capture s, ms, busy share) from `state`."""
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
    launches0 = fused.launches()
    eager_ms, _ = timed(CoupledStep(cfg, state.particles.pos.dtype,
                                    state.particles.pos.device),
                        graphs.tree_map(torch.clone, state), refs)
    launches = fused.launches() - launches0
    graphed = GraphedStep(CoupledStep(cfg, state.particles.pos.dtype,
                                      state.particles.pos.device))
    st = graphed(graphs.tree_map(torch.clone, state))
    graph_ms, st = timed(graphed, st)
    return {"eager_ms": eager_ms, "graph_ms": graph_ms,
            "capture_s": graphed.capture_seconds, "launches": launches,
            "busy": busy_share(graphed, st)}, refs


def debug_env(out_dir):
    """The diagnostic environment of --debug, for the ranks to inherit."""
    os.makedirs(out_dir, exist_ok=True)
    os.environ.update(
        NCCL_DEBUG="INFO", NCCL_DEBUG_SUBSYS="INIT,ENV,P2P,SHM,NVLS,COLL",
        NCCL_DEBUG_FILE=os.path.join(out_dir, "nccl.%h.%p.log"),
        TORCH_NCCL_TRACE_BUFFER_SIZE="20000", TORCH_NCCL_DUMP_ON_TIMEOUT="1",
        TORCH_NCCL_DEBUG_INFO_TEMP_FILE=os.path.join(out_dir,
                                                     "nccl_trace_rank_"))


class References:
    """One process's runs of every configuration on card 0, made once."""

    def __init__(self, dev, n_steps, emit):
        self.dev, self.n_steps, self.emit = dev, n_steps, emit
        self.jobs, self.refs, self.one = {}, {}, {}
        self.built = set()

    def get(self, build):
        """The runs of every configuration build(dev) yields, once."""
        if build in self.built:
            return
        self.built.add(build)
        for label, cfg, state in build(self.dev):
            self.one[label], self.refs[label] = one_process(
                cfg, state, self.n_steps)
            self.jobs[label] = (label, cfg, bridge.sim_state_to_numpy(state),
                                self.n_steps, self.one[label]["launches"])
            self.emit({"config": label, "ranks": 1, "one_process":
                       self.one[label]})
            del state
            gc.collect()
            torch.cuda.empty_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", default="2,4")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--stages", default=",".join(STAGES))
    ap.add_argument("--configs-at", default="",
                    help="rank counts at which SPLIT_CONFIGS run too")
    ap.add_argument("--debug", default=None, metavar="DIR")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    ranks = [int(r) for r in args.ranks.split(",")]
    stages = args.stages.split(",")
    configs_at = {int(r) for r in args.configs_at.split(",") if r}
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < max(ranks):
        sys.exit(f"needs {max(ranks)} CUDA cards")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    if args.debug:
        debug_env(os.path.abspath(args.debug))

    def emit(line):
        text = json.dumps({**line, "card": smi.splitlines()[0]},
                          default=str)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the kernels built once here, not by every rank at once
    from sedifoam_tpu_torch import _build
    for name in ("contact_chain", "graph_cond"):
        _build.load(name)
    refs = References(dev, args.steps, emit)
    failed = []

    def place(n):
        # the stages that place a stall: the bare group, the probe
        for stage in [s for s in ("nccl", "probe") if s in stages]:
            t0 = time.perf_counter()
            if stage == "probe":
                res = probe_ranks(n, backend="nccl", max_stalls=MAX_STALLS,
                                  log=lambda m: print(m, flush=True))
                bad = {f"{c} in {p}": r for c, d in res["results"].items()
                       for p, r in d.items() if r != "ok"}
                emit({"ranks": n, "stage": stage, "wall_s":
                      time.perf_counter() - t0, "result": res,
                      "refused": bad})
                if bad:
                    failed.append((n, stage))
                    sweep(n, [tuple(k.split(" in ")) for k in bad])
                # the halo as the uneven all_to_all_single it was, in the
                # bodies: what it would meet (not a failure of the step)
                t0 = time.perf_counter()
                res = probe_ranks(n, backend="nccl", max_stalls=1,
                                  only=[("halo_all_to_all", p)
                                        for p in ("if_body", "while_body")])
                emit({"ranks": n, "stage": "probe old halo", "wall_s":
                      time.perf_counter() - t0, "result": res})
                continue
            try:
                got = run_ranks(nccl_job, n, backend="nccl",
                                timeout=STAGE_TIMEOUTS[stage])
            except Exception as e:      # noqa: BLE001 - the stage's result
                emit({"ranks": n, "stage": stage, "wall_s":
                      time.perf_counter() - t0, "failed":
                      f"{type(e).__name__}: {e}"[:2000]})
                failed.append((n, stage))
                return False
            emit({"ranks": n, "stage": stage, "wall_s":
                  time.perf_counter() - t0, "result": got})
        return True

    def sweep(n, cases):
        """The probe's failed cases under each of DIAG_ENVS, its first
        case alone first: the first setting under which all pass is
        kept in os.environ for the stages that follow (the ranks inherit
        it)."""
        for env in DIAG_ENVS:
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            t0 = time.perf_counter()
            res = probe_ranks(n, backend="nccl", only=cases[:1],
                              max_stalls=1)
            ok = all(r == "ok" for d in res["results"].values()
                     for r in d.values())
            if ok and len(cases) > 1:
                res = probe_ranks(n, backend="nccl", only=cases,
                                  max_stalls=MAX_STALLS)
                ok = all(r == "ok" for d in res["results"].values()
                         for r in d.values())
            emit({"ranks": n, "stage": "probe sweep", "env": env,
                  "wall_s": time.perf_counter() - t0, "all_ok": ok,
                  "result": res["results"]})
            if ok:
                return env
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        return None

    def step_stage(n, stage, labels, build):
        """One spawn of the stage on `labels`; whether all held."""
        refs.get(build)
        jobs = [refs.jobs[label] for label in labels]
        job = {"eager": eager_job, "capture": capture_job,
               "replays": rank_job}[stage]
        limit = STAGE_TIMEOUTS[stage] if build is beds else \
            len(labels) * EXTRA_PER_CONFIG[stage]
        t0 = time.perf_counter()
        try:
            got = run_ranks(job, n, args=(jobs,), backend="nccl",
                            timeout=limit)
        except Exception as e:      # noqa: BLE001 - the stage's result
            emit({"ranks": n, "stage": stage, "configs": labels,
                  "wall_s": time.perf_counter() - t0, "limit_s": limit,
                  "failed": f"{type(e).__name__}: {e}"[:2000]})
            failed.append((n, stage, labels))
            return False
        wall = time.perf_counter() - t0
        ok = True
        for i, label in enumerate(labels):
            per = [r[i] for r in got]
            line = {"config": label, "ranks": n, "stage": stage,
                    "wall_s": wall}
            if stage == "eager":
                line.update(
                    fluid=per[0]["fluid"],
                    parted_from_one_process=parted(
                        refs.refs[label][0], per[0]["states"][1]),
                    per_rank=[{k: r[k] for k in ("ms", "comm", "launches")}
                              for r in per])
                bad = line["parted_from_one_process"]
            elif stage == "capture":
                line["per_rank"] = per
                bad = []
            else:
                expected = refs.jobs[label][4]
                line.update(
                    fluid=per[0]["fluid"],
                    parted_from_one_process={
                        s: parted(refs.refs[label][s - 1],
                                  per[0]["states"][s])
                        for s in sorted(per[0]["states"])},
                    one_process=refs.one[label],
                    launches_expected=expected,
                    per_rank=[{k: r[k] for k in (
                        "rank", "device", "capture_s", "nodes", "ms",
                        "eager_ms", "syncs", "parted", "comm",
                        "capture_bytes", "capture_launches", "launches",
                        "busy")} for r in per])
                bad = [s for s, f in line["parted_from_one_process"].items()
                       if f] + [r["rank"] for r in per
                                if any(r["syncs"]) or any(r["parted"])
                                or r["launches"] != expected]
            line["ok"] = not bad
            if bad:
                failed.append((n, stage, label))
                ok = False
            emit(line)
        del got
        gc.collect()
        return ok

    # first what places a stall at every rank count, then the beds at
    # every rank count, then the configurations of --configs-at
    placed = {n: place(n) for n in ranks}
    import chip_smoke
    labels = [label for label, _ in chip_smoke.SPLIT_CONFIGS]
    runs = [(n, ["bench bed", "channel"], beds) for n in ranks] + [
        (n, labels, split_configs) for n in ranks if n in configs_at]
    for n, group, build in runs:
        if not placed[n]:
            continue
        for stage in [s for s in ("eager", "capture", "replays")
                      if s in stages]:
            if not step_stage(n, stage, group, build):
                break
    emit({"summary": True, "failed": failed})
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
