"""The rank job of tests/test_torch_parallel_sequence.py (JAX-free: a
spawned rank imports the module of the function it runs).

`sequence_job` records, in order, every call the split step makes to
torch.distributed's collectives (`CALLS`), wrapping them in the rank's
own process: the kind (an all_reduce with its op), the dtype, the
shapes, the split sizes of an all_to_all_single and the `src` of a
broadcast. Split sizes are kept as this rank sees its peers: index k is
the rank k places after it (cyclically), so that the halo's
neighbour-to-neighbour pattern reads alike on every rank; the absolute
sizes are kept beside them for a check that what each rank sends a peer
is what that peer expects from it. NCCL waits without a word where the
ranks' sequences part; gloo may not, so this is checked on the CPU.
`sleepy_job` outlives a watch (tests/test_torch_parallel_probe.py).
"""

import torch
import torch.distributed as dist

from sedifoam_tpu_torch import bridge, graphs
from sedifoam_tpu_torch.parallel.mesh import shard_state
from sedifoam_tpu_torch.parallel.step import ShardedStep

CALLS = ("all_gather_into_tensor", "all_gather", "all_reduce",
         "all_to_all_single", "broadcast")


def _shape(x):
    if isinstance(x, (list, tuple)):
        return [tuple(t.shape) for t in x]
    return tuple(x.shape)


def _dtype(x):
    return str((x[0] if isinstance(x, (list, tuple)) else x).dtype)


def _relative(sizes, rank, ranks):
    return None if sizes is None else \
        [sizes[(rank + k) % ranks] for k in range(ranks)]


def _recording(record, rank, ranks):
    """{name: wrapper} of each of CALLS appending its entry to record."""
    real = {name: getattr(dist, name) for name in CALLS}

    def entry(name, args, kw):
        e = {"kind": name, "dtype": _dtype(args[0]),
             "shapes": [_shape(a) for a in args[:2]
                        if isinstance(a, (torch.Tensor, list, tuple))]}
        if name == "all_reduce":
            e["op"] = str(kw.get("op", args[1] if len(args) > 1
                                 else dist.ReduceOp.SUM))
        if name == "broadcast":
            e["src"] = kw.get("src", args[1] if len(args) > 1 else None)
        if name == "all_to_all_single":
            out_s = kw.get("output_split_sizes",
                           args[2] if len(args) > 2 else None)
            in_s = kw.get("input_split_sizes",
                          args[3] if len(args) > 3 else None)
            e["splits"] = [_relative(out_s, rank, ranks),
                           _relative(in_s, rank, ranks)]
            e["absolute"] = [out_s, in_s]
        return e

    def wrap(name):
        def call(*args, **kw):
            record.append(entry(name, args, kw))
            return real[name](*args, **kw)
        return call
    return {name: wrap(name) for name in CALLS}, real


def sequence_job(mesh, jobs):
    """For each (cfg, state_np) of jobs: the calls of one eager
    ShardedStep step from the state, then of one step from the same state
    under graphs.warming() (every cond's branch not taken run too, as a
    capture's warm-up runs it): {"eager": [...], "warming": [...]}."""
    out = []
    for cfg, snp in jobs:
        local = shard_state(bridge.sim_state_from_numpy(snp,
                                                        device=mesh.device),
                            mesh)
        step = ShardedStep(cfg, mesh, local.particles.pos.dtype)
        got = {}
        for mode in ("eager", "warming"):
            record = []
            wrappers, real = _recording(record, mesh.rank, mesh.ranks)
            for name, fn in wrappers.items():
                setattr(dist, name, fn)
            try:
                state = graphs.tree_map(torch.clone, local)
                if mode == "warming":
                    with graphs.warming():
                        step(state)
                else:
                    step(state)
            finally:
                for name, fn in real.items():
                    setattr(dist, name, fn)
            got[mode] = record
        out.append(got)
    return out


def sleepy_job(mesh, seconds):
    """Sleep, then return the rank: a job that outlives a caller's
    watch."""
    import time
    time.sleep(seconds)
    return mesh.rank
