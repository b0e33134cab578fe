"""Start ranks on this host: one process each, with its process group
(parallel/mesh.make_mesh takes it from there).

    results = run_ranks(fn, 2, args=(...,), device="cpu")

calls fn(mesh, *args) in every rank and returns the ranks' results in
rank order (each pickled through a file). Gloo carries the collectives
between processes, on the CPU or on CUDA tensors, several ranks sharing
one card; NCCL when each rank has a card, or alone. The group's store
is a file in a fresh temporary directory, so nothing listens on a port.
A rank that raises, or a run past `timeout` seconds, ends every rank and
raises here.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from sedifoam_tpu_torch.parallel.mesh import make_mesh


def _rank_main(rank, n_ranks, store, backend, device, timeout, fn, args,
               out_dir):
    # one host: the collectives go over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    # the ranks share the host's cores
    torch.set_num_threads(1)
    dist.init_process_group(
        backend, init_method=store, rank=rank, world_size=n_ranks,
        timeout=datetime.timedelta(seconds=timeout))
    try:
        mesh = make_mesh(n_ranks, device=device)
        if mesh.device.type == "cuda":
            torch.cuda.set_device(mesh.device)
        result = fn(mesh, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n_ranks: int, args=(), backend: str = "gloo",
              device=None, timeout: float = 600.0):
    """fn(mesh, *args) in n_ranks new processes, one PyTorch CPU thread
    each; their results in rank order. fn must be a module-level
    function and its result picklable (host tensors or numpy). device:
    as make_mesh's (None: the card)."""
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        ctx = mp.spawn(_rank_main, nprocs=n_ranks, join=False, args=(
            n_ranks, store, backend, None if device is None else str(device),
            timeout, fn, tuple(args), tmp))
        deadline = time.monotonic() + timeout
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() >= deadline:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"run_ranks: {n_ranks} ranks ran past "
                                   f"{timeout} s")
        out = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
