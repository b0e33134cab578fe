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

Each rank binds its card before the group starts and hands it to the
group (`device_id`): NCCL then sets up its communicator inside
init_process_group, on that card, rather than at the first collective
on a card it guesses. The group's own timeout is shorter than the
spawn's (`collective_timeout`, half of `timeout` unless given), so a
collective that one rank waits on in vain raises in that rank, with the
backend's own message on its standard error, before the spawn is
ended from outside. NCCL ranks run with NCCL_ENV set (the split step's
capture needs it).
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


def rank_device(rank: int, device=None) -> torch.device:
    """The device of `rank`: `device` if it names one, else
    cuda:(rank % cards) (make_mesh's rule); "cuda" without a card stays
    as it is, and make_mesh raises on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and \
            torch.cuda.is_available():
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


# NCCL's settings for a process whose collectives a CUDA graph captures.
# Its default support for mixing graph-captured and eager collectives on
# one communicator adds to each collective a graph captures dependencies
# that the body of a conditional node cannot hold: at two ranks and more
# every collective is refused there (cudaErrorInvalidValue;
# parallel/probe.py), and the split step's loops and branches hold
# collectives. Without it, no eager collective may follow a replay that
# is still running: parallel/comm.Comm waits for the last replay first.
NCCL_ENV = {"NCCL_GRAPH_MIXING_SUPPORT": "0"}


def nccl_environment():
    """Set NCCL_ENV in this process: before init_process_group, which
    reads it (run_ranks does it in every NCCL rank; a process started
    otherwise, as by torchrun, calls this first)."""
    os.environ.update(NCCL_ENV)


def _rank_main(rank, n_ranks, store, backend, device, timeout, fn, args,
               out_dir):
    # one host: the collectives go over the loopback interface
    os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    if backend == "nccl":
        nccl_environment()
    # the ranks share the host's cores
    torch.set_num_threads(1)
    dev = rank_device(rank, device)
    if dev.type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=store, rank=rank, world_size=n_ranks,
        timeout=datetime.timedelta(seconds=timeout),
        device_id=dev if backend == "nccl" else None)
    try:
        mesh = make_mesh(n_ranks, device=dev)
        result = fn(mesh, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, n_ranks: int, args=(), backend: str = "gloo",
              device=None, timeout: float = 600.0,
              collective_timeout: float | None = None, watch=None):
    """fn(mesh, *args) in n_ranks new processes, one PyTorch CPU thread
    each; their results in rank order. fn must be a module-level
    function and its result picklable (host tensors or numpy). device:
    as make_mesh's (None: the card). collective_timeout: the process
    group's, seconds (timeout / 2 by default). watch: called about once
    a second while the ranks run; a string it returns ends every rank
    and raises TimeoutError with it (a caller's own, finer limit)."""
    group_s = timeout / 2 if collective_timeout is None \
        else collective_timeout
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        ctx = mp.spawn(_rank_main, nprocs=n_ranks, join=False, args=(
            n_ranks, store, backend, None if device is None else str(device),
            group_s, fn, tuple(args), tmp))
        deadline = time.monotonic() + timeout
        while True:
            left = deadline - time.monotonic()
            if ctx.join(timeout=max(0.1, min(1.0, left))):
                break
            why = watch() if watch is not None else None
            if why is None and time.monotonic() >= deadline:
                why = f"run_ranks: {n_ranks} ranks ran past {timeout} s"
            if why is not None:
                for p in ctx.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(why)
        out = []
        for r in range(n_ranks):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
