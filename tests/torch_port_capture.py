"""The rank job of tests/test_torch_parallel_capture.py (JAX-free: a
spawned rank imports the module of the function it runs).

`rehearse_job` runs parallel/step.ShardedStep on the CPU as a capture of
it sees it: a warm-up step under graphs.warming() (every cond's branch
not taken run too, on a copy, as graphs.StepGraph.capture's warm-up
runs it), held against a plain eager step from the same state, then the
steps under graphs.host_reads_forbidden(), which raises HostRead on any
host read but the conds' and loops' own decisions.
"""

import torch

from sedifoam_tpu_torch import bridge, graphs
from sedifoam_tpu_torch.parallel import step as pstep
from sedifoam_tpu_torch.parallel.comm import Comm
from sedifoam_tpu_torch.parallel.mesh import gather_state, shard_state


def _recording(shards):
    """A Shard class that appends each instance to `shards`."""
    class Recording(pstep.Shard):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            shards.append(self)
    return Recording


def rehearse_job(mesh, cfg, state_np, n_steps):
    """For this rank: the warm-up step against a plain eager step (the
    fields that part, and the Shard's gathered arrays at the end of each
    step, equal or not by name), then n_steps steps under
    host_reads_forbidden() with check_replicas after each, and (rank 0)
    the whole state after each, by step number."""
    shards = []
    pstep.Shard = _recording(shards)
    local = shard_state(bridge.sim_state_from_numpy(state_np,
                                                    device=mesh.device),
                        mesh)
    step = pstep.ShardedStep(cfg, mesh, local.particles.pos.dtype)
    plain = step(graphs.tree_map(torch.clone, local))
    full_plain = shards[-1].full
    with graphs.warming():
        warm = step(graphs.tree_map(torch.clone, local))
    full_warm = shards[-1].full
    out = {"warm_parted": pstep._parted(plain, warm),
           "full_equal": {k: torch.equal(full_plain[k], full_warm[k])
                          for k in full_plain},
           "states": {}, "comm": []}
    for i in range(1, n_steps + 1):
        before = dict(step.comm.bytes)
        with graphs.host_reads_forbidden():
            local = step(local)
        out["comm"].append({k: v - before.get(k, 0)
                            for k, v in step.comm.bytes.items()})
        pstep.check_replicas(local.particles, Comm())
        whole = gather_state(local, mesh, step.comm)
        if mesh.rank == 0:
            out["states"][i] = bridge.sim_state_to_numpy(whole)
    return out


def rehearse_jobs(mesh, jobs):
    """rehearse_job(mesh, *job) for each job in one spawn of the ranks."""
    return [rehearse_job(mesh, *job) for job in jobs]


def exchange_job(mesh, n_rows, n_slab_cells, seed):
    """coupling/transfer._to_slabs on a shuffled bed's rows: each rank's
    block of n_rows rows of values and domain cells drawn from `seed`
    (cells of every slab, in no order). Returns the rows this rank's
    slab receives (those not at the dump cell), values and local cells,
    and the same rows picked from the whole bed in global row order, as
    the data-sized exchange it replaces delivered them."""
    import numpy as np

    from sedifoam_tpu_torch.coupling import transfer
    from sedifoam_tpu_torch.grid import Grid

    comm = Comm()
    rng = np.random.RandomState(seed)
    total = n_rows * mesh.ranks
    cells = torch.as_tensor(rng.randint(0, n_slab_cells * mesh.ranks,
                                        size=total))
    w = torch.as_tensor(rng.normal(size=(total, 3)))
    grid = Grid(nx=mesh.ranks * 2, ny=1, nz=n_slab_cells // 2, dx=1.0,
                dy=1.0, dz=1.0).slab(mesh.rank * 2, 2, comm)
    assert grid.n_cells == n_slab_cells
    own = slice(mesh.rank * n_rows, (mesh.rank + 1) * n_rows)
    with graphs.host_reads_forbidden():
        got_w, got_cells = transfer._to_slabs(w[own], cells[own], grid)
    keep = got_cells < n_slab_cells
    mine = (cells // n_slab_cells) == mesh.rank
    return {"w": got_w[keep].numpy(), "cells": got_cells[keep].numpy(),
            "ref_w": w[mine].numpy(),
            "ref_cells": (cells[mine] - mesh.rank * n_slab_cells).numpy(),
            "bytes": dict(comm.bytes)}
