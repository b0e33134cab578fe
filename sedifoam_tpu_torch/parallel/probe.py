"""Which collectives of the split step a CUDA graph takes, and where, at
any number of ranks (a rank's job for parallel/launch.run_ranks, one
NCCL rank a card; `probe_ranks` spawns it and watches it).

    probe_ranks(2, backend="nccl")

calls each collective the split step uses (`COLLECTIVES`), with the
step's own split patterns, straight through torch.distributed (not
through parallel/comm.Comm, whose one-rank short cuts would skip NCCL):

- ``halo``: Comm.halo's all_gather_into_tensor of every rank's two end
  planes (comm.halo_exchange), x-planes of PLANE cells;
- ``all_to_all_values`` / ``all_to_all_cells``: the equal-block
  all_to_all_single of the particle-to-grid exchange
  (coupling/transfer.py), f32 values and int32 cells;
- ``all_gather_into_tensor``, ``all_reduce_sum``, ``all_reduce_max``;
- ``broadcast``: one value from the last rank (Comm.broadcast_cell's
  owner of the pressure reference cell need not be rank 0);

in each place (`PLACES`):

- ``eager``: called once, held against the value it must have, computed
  on the host from every rank's inputs;
- ``graph``: a plain ``torch.cuda.graph`` capture, global error mode
  (the mode graphs.StepGraph captures in);
- ``graph_thread_local``: the same, thread-local error mode;
- ``if_body``: once in a graphs.StepGraph's own graph and once more in
  the body of a graphs.cond IF node after it;
- ``while_body``: once in the graph and WHILE_ITERATIONS times in the
  body of a graphs.while_loop WHILE node after it.

Each capture is replayed and held against the same function run
eagerly, bit for bit. A case that raises on any rank ends the spawn (a
failed capture can leave the CUDA context unusable, and the other ranks
waiting in a collective); one that runs past its own limit is ended
from outside. Either way `probe_ranks` names the case and starts the
ranks anew on the cases after it. The result: {collective: {place:
"ok", "differs", the error, or "stalled past N s"}}, per rank where the
ranks disagree.

`OTHERS` holds collectives the step does not call, probed only when
named in `only=`: the list-form all_gather; batch_isend_irecv (each rank
to its right-hand neighbour) and ``halo_all_to_all``, the halo as an
all_to_all_single of uneven splits, empty to the ranks that are not
neighbours. NCCL carries both as point-to-point sends and receives,
which a conditional node's body refused even at one rank under NCCL's
default settings: so Comm.halo is an all-gather. At two ranks and more
those settings refuse every collective in a body; the ranks of
parallel/launch run with NCCL_ENV, under which all are taken.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from sedifoam_tpu_torch import graphs
from sedifoam_tpu_torch.parallel.comm import halo_exchange
from sedifoam_tpu_torch.parallel.launch import run_ranks

N = 4096                  # elements a rank sends each rank in a probe
PLANE = 3900              # cells of an x-plane of the 140x65x60 channel
WHILE_ITERATIONS = 3
CASE_LIMIT = 30.0         # seconds one case may take on any rank
START_LIMIT = 120.0       # seconds a spawn may take to reach its 1st case

PLACES = ("eager", "graph", "graph_thread_local", "if_body", "while_body")


def _inputs(rank, n_ranks):
    """This rank's inputs (numpy), by kind: exact in f32, so that a sum
    over the ranks has one value in any order."""
    base = np.arange(N, dtype=np.float32) * (1 + rank) - 7.5
    return {
        "values": base,
        "planes": (np.arange(2 * PLANE, dtype=np.float32).reshape(2, PLANE)
                   + 10000.0 * rank),
        "blocks": (np.arange(n_ranks * N, dtype=np.float32)
                   .reshape(n_ranks, N) + 0.5 * rank),
        "cells": (np.arange(n_ranks * N, dtype=np.int32).reshape(n_ranks, N)
                  * (rank + 1) - 3),
        "one": np.array([2.5 + rank], dtype=np.float32),
    }


def _halo(x):
    lo, hi = halo_exchange(x[0], x[1], dist.get_rank(),
                           dist.get_world_size())
    return torch.stack([lo, hi])


def _halo_all_to_all(x):
    """The halo as Comm.halo first exchanged it: one all_to_all_single
    of uneven splits, each rank's first plane to rank - 1 and its last to
    rank + 1, empty splits to the other ranks."""
    me, n = dist.get_rank(), dist.get_world_size()
    down, up = (me - 1) % n, (me + 1) % n
    plane = x.shape[1]
    ends = {"first": x[0], "last": x[1]}
    sends = [(["first"] if r == down else []) + (["last"] if r == up
                                                 else [])
             for r in range(n)]
    recvs = [plane * ((r == up) + (r == down)) for r in range(n)]
    src = torch.cat([ends[e] for to in sends for e in to])
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, recvs, [plane * len(to)
                                             for to in sends])
    got = torch.split(out, recvs)
    return torch.stack([got[down][-plane:], got[up][:plane]])


def _halo_expected(ins, r, n):
    return np.stack([ins[(r - 1) % n]["planes"][1],
                     ins[(r + 1) % n]["planes"][0]])


def _all_to_all(x):
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)
    return y


def _all_gather_into_tensor(x):
    out = torch.empty((dist.get_world_size() * x.shape[0],)
                      + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x)
    return out


def _all_reduce(op):
    def run(x):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return y
    return run


def _broadcast(x):
    y = x.clone()
    dist.broadcast(y, src=dist.get_world_size() - 1)
    return y


def _all_gather(x):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


def _send_recv_right(x):
    me, n = dist.get_rank(), dist.get_world_size()
    y = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, (me + 1) % n),
           dist.P2POp(dist.irecv, y, (me - 1) % n)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return y


# name: (call, input kind, expected(inputs of every rank, rank, ranks))
COLLECTIVES = {
    "halo": (_halo, "planes", _halo_expected),
    "all_to_all_values": (_all_to_all, "blocks", lambda ins, r, n: np.stack(
        [ins[s]["blocks"][r] for s in range(n)])),
    "all_to_all_cells": (_all_to_all, "cells", lambda ins, r, n: np.stack(
        [ins[s]["cells"][r] for s in range(n)])),
    "all_gather_into_tensor": (_all_gather_into_tensor, "values",
                               lambda ins, r, n: np.concatenate(
                                   [ins[s]["values"] for s in range(n)])),
    "all_reduce_sum": (_all_reduce(dist.ReduceOp.SUM), "values",
                       lambda ins, r, n: sum(ins[s]["values"]
                                             for s in range(n))),
    "all_reduce_max": (_all_reduce(dist.ReduceOp.MAX), "values",
                       lambda ins, r, n: np.max(
                           [ins[s]["values"] for s in range(n)], axis=0)),
    "broadcast": (_broadcast, "one", lambda ins, r, n: ins[n - 1]["one"]),
}
OTHERS = {
    "halo_all_to_all": (_halo_all_to_all, "planes", _halo_expected),
    "all_gather": (_all_gather, "values", lambda ins, r, n: np.concatenate(
        [ins[s]["values"] for s in range(n)])),
    "batch_isend_irecv": (_send_recv_right, "values",
                          lambda ins, r, n: ins[(r - 1) % n]["values"]),
}


def _plain(coll, x, mode):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        coll(x)                                  # warm-up
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode=mode):
        out = coll(x)
    g.replay()
    # no eager collective while a replay runs (parallel/launch.NCCL_ENV)
    torch.cuda.synchronize()
    return out


def _in_if(coll):
    def fn(c):
        flag, y, _ = c
        return graphs.cond(flag, lambda d: (d[0], d[1] + 1, coll(d[1] + 1)),
                           (flag, y, coll(y)))
    return fn


def _in_while(coll):
    def fn(c):
        i, y, _ = c
        return graphs.while_loop(
            lambda d: d[0] < WHILE_ITERATIONS,
            lambda d: (d[0] + 1, d[1] + 1, coll(d[1] + 1)), (i, y, coll(y)))
    return fn


def _one(coll, place, x):
    """(captured and replayed, eager) results of coll at `place`."""
    if place == "graph":
        return _plain(coll, x, "global"), coll(x)
    if place == "graph_thread_local":
        return _plain(coll, x, "thread_local"), coll(x)
    make = _in_if if place == "if_body" else _in_while
    first = torch.ones((), dtype=torch.bool, device=x.device) \
        if place == "if_body" else torch.zeros((), dtype=torch.int64,
                                               device=x.device)
    fn = make(coll)
    state = (first, x, coll(x))
    g = graphs.StepGraph(fn).capture(state)
    got = g.replay(state)[2].clone()
    torch.cuda.synchronize()
    return got, fn(state)[2]


def _todo(only, places):
    return [tuple(c) for c in only] if only else \
        [(c, p) for p in places for c in COLLECTIVES]


def _wait_for_all(path, i, n_ranks):
    """Each rank's result of case i (files under path), once every rank
    has written it: a barrier on the file system, which a broken CUDA
    context or a hung collective on another rank cannot hold up for
    longer than the watch of probe_ranks allows."""
    names = [os.path.join(path, f"case{i}.rank{r}.json")
             for r in range(n_ranks)]
    while not all(os.path.exists(f) for f in names):
        time.sleep(0.05)
    out = []
    for f in names:
        with open(f) as fh:
            out.append(json.load(fh)["result"])
    return out


def probe_capture(mesh, todo, path, first: int = 0) -> dict:
    """The rank's job: the cases todo[first:] (collective, place) in
    order, each result written to path as it comes; returns at the first
    case that is not "ok" on some rank. Writes path/rank<r>.at (the
    index of the case underway) before each case."""
    ins = [_inputs(r, mesh.ranks) for r in range(mesh.ranks)]
    mine = {k: torch.as_tensor(v, device=mesh.device)
            for k, v in ins[mesh.rank].items()}
    table = {**COLLECTIVES, **OTHERS}
    for i in range(first, len(todo)):
        name, place = todo[i]
        with open(os.path.join(path, f"rank{mesh.rank}.at"), "w") as f:
            f.write(str(i))
        coll, kind, expected = table[name]
        try:
            if place == "eager":
                got = coll(mine[kind]).cpu().numpy()
                want = expected(ins, mesh.rank, mesh.ranks)
                res = "ok" if got.shape == want.shape and \
                    got.tobytes() == want.tobytes() else "differs"
            else:
                got, ref = _one(coll, place, mine[kind])
                torch.cuda.synchronize()
                res = "ok" if torch.equal(got, ref) else "differs"
        except Exception as e:      # noqa: BLE001 - the error is the result
            res = f"{type(e).__name__}: {e}".strip()[:400]
            try:
                torch.cuda.synchronize()
            except Exception as e2:  # noqa: BLE001
                res += f" | then: {type(e2).__name__}: {e2}"[:200]
        with open(os.path.join(path, f"case{i}.rank{mesh.rank}.json.tmp"),
                  "w") as f:
            json.dump({"result": res}, f)
        os.replace(os.path.join(path, f"case{i}.rank{mesh.rank}.json.tmp"),
                   os.path.join(path, f"case{i}.rank{mesh.rank}.json"))
        if any(r != "ok" for r in _wait_for_all(path, i, mesh.ranks)):
            break
    return {"nccl": str(torch.cuda.nccl.version())
            if mesh.device.type == "cuda" else None,
            "backend": dist.get_backend()}


def _merged(results):
    """One result for the ranks' results of a case: theirs if they agree,
    else each rank's."""
    if len(set(results)) == 1:
        return results[0]
    return "; ".join(f"rank {r}: {v}" for r, v in enumerate(results))


def probe_ranks(n_ranks: int, backend: str = "nccl", device=None,
                only=None, places=PLACES, max_stalls=None,
                log=None) -> dict:
    """The module docstring's table at n_ranks ranks: `only`, a list of
    (collective, place) to probe, else those of COLLECTIVES at `places`.
    Each case may take CASE_LIMIT seconds on any rank, a spawn
    START_LIMIT to reach its first case; a case that fails or stalls
    is named and the ranks start anew after it (`restarts`); after
    `max_stalls` spawns ended so the cases left are reported "not run".
    log(msg),
    if given, hears of each spawn's end."""
    todo = _todo(only, places)
    results, restarts, seconds, info = {}, 0, [], {}
    first = stalls = 0
    with tempfile.TemporaryDirectory() as path:
        while first < len(todo):
            if max_stalls is not None and stalls >= max_stalls:
                for name, place in todo[first:]:
                    results.setdefault(name, {})[place] = \
                        f"not run ({stalls} stalls before it)"
                break
            t0 = time.monotonic()
            at = {}

            def watch():
                # the case each rank is in, and since when
                now = time.time()
                for r in range(n_ranks):
                    f = os.path.join(path, f"rank{r}.at")
                    if os.path.exists(f):
                        with open(f) as fh:
                            text = fh.read()
                        if text:
                            at[r] = (int(text), os.path.getmtime(f))
                if not at:
                    if time.monotonic() - t0 > START_LIMIT:
                        return f"no rank reached a case in {START_LIMIT} s"
                    return None
                for r, (i, since) in at.items():
                    if now - since > CASE_LIMIT:
                        return f"rank {r} stalled in case {i}"
                return None
            failure = None
            try:
                got = run_ranks(probe_capture, n_ranks,
                                args=(todo, path, first), backend=backend,
                                device=device,
                                timeout=START_LIMIT + CASE_LIMIT * (
                                    len(todo) - first),
                                collective_timeout=0.75 * CASE_LIMIT,
                                watch=watch)
                info = got[0]
            except Exception as e:     # noqa: BLE001 - reported, then on
                failure = f"{type(e).__name__}: {e}".strip()[:400]
                if not at:
                    raise RuntimeError(f"probe at {n_ranks} ranks: the "
                                       f"ranks reached no case: {failure}")
            seconds.append(time.monotonic() - t0)
            # the cases every rank finished
            i = first
            while i < len(todo) and all(os.path.exists(os.path.join(
                    path, f"case{i}.rank{r}.json"))
                    for r in range(n_ranks)):
                res = []
                for r in range(n_ranks):
                    with open(os.path.join(path,
                                           f"case{i}.rank{r}.json")) as fh:
                        res.append(json.load(fh)["result"])
                name, place = todo[i]
                results.setdefault(name, {})[place] = _merged(res)
                i += 1
            if failure is not None and i < len(todo):
                # the case underway when the spawn ended
                per = []
                for r in range(n_ranks):
                    f = os.path.join(path, f"case{i}.rank{r}.json")
                    if os.path.exists(f):
                        with open(f) as fh:
                            per.append(json.load(fh)["result"])
                    else:
                        per.append(failure if "stalled" not in failure
                                   else f"stalled past {CASE_LIMIT:.0f} s")
                name, place = todo[i]
                results.setdefault(name, {})[place] = _merged(per)
                stalls += 1
                i += 1
            if log is not None:
                log(f"probe at {n_ranks} ranks: cases {first}-{i - 1} of "
                    f"{len(todo)} in {seconds[-1]:.1f} s"
                    + (f" ({failure})" if failure else ""))
            if i < len(todo):
                restarts += 1
                for r in range(n_ranks):
                    f = os.path.join(path, f"rank{r}.at")
                    if os.path.exists(f):
                        os.remove(f)
            first = i
    return {"ranks": n_ranks, "backend": backend, "nccl": info.get("nccl"),
            "results": results, "restarts": restarts, "seconds": seconds}
