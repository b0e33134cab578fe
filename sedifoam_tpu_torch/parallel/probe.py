"""Which collectives of the split step a CUDA graph takes, and where
(a rank's job for parallel/launch.run_ranks, one NCCL rank a card).

    run_ranks(probe_capture, 1, backend="nccl", device="cuda:0")

calls every collective the split step uses (`COLLECTIVES`) straight
through torch.distributed (not through parallel/comm.Comm, whose
one-rank short cuts would skip NCCL) in each place the captured split
step puts one:

- ``graph``: a plain ``torch.cuda.graph`` capture, global error mode
  (the mode graphs.StepGraph captures in);
- ``graph_thread_local``: the same, thread-local error mode;
- ``if_body``: once in a graphs.StepGraph's own graph and once more in
  the body of a graphs.cond IF node after it;
- ``while_body``: once in the graph and twice in the body of a
  graphs.while_loop WHILE node after it.

Each capture is replayed and held against the same function run
eagerly, bit for bit. Returns {collective: {place: "ok", "differs" or
the error the capture raised}} and the NCCL version. A failed capture
can leave the process's CUDA context unusable for what follows, so a
caller re-runs a failure alone (`only=`) before it believes it.

`OTHERS` holds collectives the step does not call, probed only when
named in `only=`: the list-form all_gather, and batch_isend_irecv, whose
refusal in conditional bodies made parallel/comm's halo an all-to-all.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from sedifoam_tpu_torch import graphs

N = 4096                  # f32 elements per rank in each probe

PLACES = ("graph", "graph_thread_local", "if_body", "while_body")


def _all_gather_into_tensor(x):
    n = x.shape[0]
    out = torch.empty((dist.get_world_size() * n,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x)
    return out[dist.get_rank() * n:(dist.get_rank() + 1) * n]


def _all_gather(x):
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return parts[dist.get_rank()]


def _all_reduce(op):
    def run(x):
        y = x.clone()
        dist.all_reduce(y, op=op)
        return y
    return run


def _all_to_all_single(x):
    y = torch.empty_like(x)
    dist.all_to_all_single(y, x)
    return y


def _broadcast(x):
    y = x.clone()
    dist.broadcast(y, src=0)
    return y


def _send_recv_self(x):
    me = dist.get_rank()
    y = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, me), dist.P2POp(dist.irecv, y, me)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return y


COLLECTIVES = {
    "all_gather_into_tensor": _all_gather_into_tensor,
    "all_reduce_sum": _all_reduce(dist.ReduceOp.SUM),
    "all_reduce_max": _all_reduce(dist.ReduceOp.MAX),
    "all_to_all_single": _all_to_all_single,
    "broadcast": _broadcast,
}
OTHERS = {"all_gather": _all_gather, "batch_isend_irecv": _send_recv_self}


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
    return out


def _in_if(coll):
    def fn(c):
        pred, y = c
        return graphs.cond(pred, lambda d: (d[0], coll(d[1]) + 1.0),
                           (pred, coll(y)))
    return fn


def _in_while(coll):
    def fn(c):
        i, y = c
        return graphs.while_loop(lambda d: d[0] < 2,
                                 lambda d: (d[0] + 1, coll(d[1]) + 1.0),
                                 (i, coll(y)))
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
    state = (first, x)
    g = graphs.StepGraph(fn).capture(state)
    got = g.replay(state)[1].clone()
    return got, fn(state)[1]


def probe_capture(mesh, only=None) -> dict:
    """The module docstring's table on this rank; `only`: a list of
    (collective, place) to probe, those of COLLECTIVES everywhere by
    default."""
    x = torch.arange(N, dtype=torch.float32, device=mesh.device) \
        * (1.0 + mesh.rank) - 7.5
    todo = only or [(c, p) for p in PLACES for c in COLLECTIVES]
    out = {"nccl": str(torch.cuda.nccl.version())
           if mesh.device.type == "cuda" else None,
           "backend": dist.get_backend(), "ranks": mesh.ranks,
           "results": {}}
    for name, place in todo:
        try:
            got, ref = _one({**COLLECTIVES, **OTHERS}[name], place, x)
            torch.cuda.synchronize()
            res = "ok" if torch.equal(got, ref) else "differs"
        except Exception as e:      # noqa: BLE001 - the error is the result
            res = f"{type(e).__name__}: {e}".strip()[:400]
            try:
                torch.cuda.synchronize()
            except Exception as e2:  # noqa: BLE001
                res += f" | then: {type(e2).__name__}: {e2}"[:200]
        out["results"].setdefault(name, {})[place] = res
    return out
