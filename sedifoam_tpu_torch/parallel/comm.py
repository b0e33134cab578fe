"""The collectives of the split coupled step, over one torch.distributed
process group.

The DEM's (parallel/step.py): the ranks' blocks of a particle array put
together in rank order (`all_gather_rows`), the sum of the ranks'
partial grids after the particle-to-grid scatters where the fluid is
whole (`all_reduce_sum`), and the largest displacement since the last
neighbor build, so that every rank takes the same branch of the rebuild
test (`all_reduce_max`).

The fluid's, where it is split along grid-x (grid.SlabGrid): the ghost
planes of the stencils (`halo`: every rank's two end planes gathered,
each rank taking its two neighbours', wrapping cyclically), the per-plane partial sums of every
global reduction (`gather_planes`: each rank then sums all planes in x
order alike), the whole field from the slabs (`all_gather_rows`: the
FastDiag solves and the grid-to-particle gathers read it), the value of
one cell from its owner (`broadcast_cell`), and the particle rows'
contributions to the cells of another rank's slab (`all_to_all_blocks`:
each rank sends each rank a block of all its rows, coupling/transfer.py
masks the rows bound elsewhere).

Every call's shapes are fixed by the state's, never by its data, and
no call reads a tensor on the host: under NCCL the split step captures
as one CUDA graph with its collectives inside (parallel/step.py). No
call is point-to-point: NCCL carries sends and receives, and an
all_to_all_single of uneven splits, as point-to-point operations, which
the body of a CUDA graph's conditional node refused at one rank under
NCCL's default settings (parallel/probe.py), and the solvers' loops,
which hold halos, are such bodies. Every call
has run between NCCL ranks, one a card, eagerly and captured, at 2 and
4 ranks (parallel/probe.py; the split step in
tests/torch_port_measure_split_graph.py).

`Comm.bytes` counts, by kind, the bytes of the tensors each call
returns on this rank: the convention of the JAX package's dry run
(`__graft_entry__._collective_bytes` sums the result shapes of the
collectives in the compiled program), under its names:
``collective-permute`` (halos, at the bytes of the all-gather that
carries them), ``all-to-all``, ``all-gather``,
``all-reduce`` and ``collective-broadcast``. Nothing is counted where
nothing leaves the rank (one rank; a rank's own block of an
all-to-all). Under a capture the counts go to `device_bytes`, on the
device, which each replay adds to (`replayed_bytes`).

Over gloo the tensors may lie on the CPU or on a card: gloo carries a
CUDA tensor through host memory itself in all_gather and all_reduce
and into one tensor (on the H100, torch 2.11); the particle rows'
all-to-all and the broadcast are staged through host memory here. NCCL
takes them on the card.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist

from sedifoam_tpu_torch.graphs import capturing

# the event recorded after the last replay of a graph holding this
# process's collectives (parallel/step.GraphedShardedStep), until an
# eager collective waited for it
_REPLAY = []


def replay_launched():
    """Note that a graph holding collectives was launched on the current
    stream: the next eager collective waits for it to end. NCCL runs
    without its support for mixing graphs and eager calls on one
    communicator (parallel/launch.NCCL_ENV), which leaves an eager call
    while a replay runs undefined, whatever the streams."""
    ev = torch.cuda.Event()
    ev.record()
    _REPLAY[:] = [ev]


def _after_replays():
    """Before an eager collective: wait (on the host) for the last
    replay to end."""
    if _REPLAY and not capturing():
        _REPLAY.pop().synchronize()


# the kinds of collective `Comm.bytes` counts, under the JAX package's
# names
KINDS = ("collective-permute", "all-to-all", "all-gather", "all-reduce",
         "collective-broadcast")


class Comm:
    """Collectives over the default process group, with a byte counter
    by kind."""

    def __init__(self):
        self.ranks = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.bytes = collections.Counter()
        self.device_bytes = None
        self.captured = collections.Counter()

    def _count(self, kind, nbytes, device):
        """Count the bytes a call returns: on the host for an eager call;
        under a capture on the device, in `device_bytes`, so that a
        replay counts what it ran (a conditional node's body only when
        the branch was taken, a loop's body once an iteration), and in
        `captured` on the host, once for each call the graph holds."""
        i = KINDS.index(kind)
        if capturing():
            if self.device_bytes is None:
                raise RuntimeError("Comm: a collective's first call is under "
                                   "a capture: warm the step up first")
            self.device_bytes[i].add_(nbytes)
            self.captured[kind] += nbytes
            return
        if self.device_bytes is None and device.type == "cuda":
            self.device_bytes = torch.zeros(len(KINDS), dtype=torch.int64,
                                            device=device)
        self.bytes[kind] += nbytes

    def replayed_bytes(self) -> dict:
        """The bytes by kind the replays of captured steps have counted
        on the device so far (a host read)."""
        if self.device_bytes is None:
            return {}
        return {k: int(v) for k, v in zip(KINDS, self.device_bytes.tolist())
                if v}

    def _gather(self, src):
        """The ranks' blocks of src (one shape on every rank, contiguous)
        stacked along a new first axis: one all-gather into one
        tensor."""
        out = torch.empty((self.ranks * src.shape[0],) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        _after_replays()
        dist.all_gather_into_tensor(out, src)
        self._count("all-gather", out.numel() * out.element_size(),
                    src.device)
        return out.view((self.ranks,) + tuple(src.shape))

    def all_gather_rows(self, x, axis: int = 0):
        """The ranks' blocks of x (one shape on every rank) concatenated
        along `axis` in rank order: a new contiguous tensor."""
        flag = x.dtype == torch.bool    # gathered as bytes
        src = x.contiguous()
        src = src.view(torch.uint8) if flag else src
        parts = self._gather(src)
        out = parts.reshape((-1,) + tuple(src.shape[1:])) if axis == 0 \
            else torch.cat(parts.unbind(0), dim=axis)
        return out.view(torch.bool) if flag else out

    def _all_reduce(self, x, op):
        y = x.clone()
        _after_replays()
        dist.all_reduce(y, op=op)
        self._count("all-reduce", y.numel() * y.element_size(), y.device)
        return y

    def all_reduce_sum(self, x):
        """The sum over the ranks of x (a new tensor, the same on every
        rank)."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def all_reduce_max(self, x):
        """The largest x over the ranks, elementwise (a new tensor)."""
        return self._all_reduce(x, dist.ReduceOp.MAX)

    # ---- the fluid split along grid-x ----------------------------------

    def _staged(self, x):
        """x where the backend takes it: host memory for gloo."""
        return x.cpu() if self.backend == "gloo" else x

    def gather_planes(self, p):
        """The ranks' tensors p (one shape on every rank) in rank order: a
        list (the per-plane partial sums of a reduction)."""
        return list(self._gather(p.contiguous()).unbind(0))

    def broadcast_cell(self, local, owner: int, like):
        """A 0-d tensor on every rank: `local` on rank `owner` (None on
        the others), of like's dtype and device."""
        if self.ranks == 1:
            return local
        buf = local.reshape(1).clone() if self.rank == owner else \
            torch.empty(1, dtype=like.dtype, device=like.device)
        host = self._staged(buf)
        _after_replays()
        dist.broadcast(host, src=owner)
        self._count("collective-broadcast", host.element_size(),
                    like.device)
        return host.to(like.device).reshape(())

    def halo(self, x, dim: int):
        """(lo, hi): the plane of x along `dim` just below this rank's
        first (the last plane of rank - 1) and just above its last (the
        first plane of rank + 1), ranks wrapping cyclically (one rank:
        its own last and first planes).

        One all_gather_into_tensor of every rank's two end planes
        (`halo_exchange`), not point-to-point: NCCL carries an
        all_to_all_single of uneven splits as point-to-point sends and
        receives, which the body of a CUDA graph's conditional node
        refused at one rank under NCCL's default settings
        (parallel/probe.py), and the halos of the solvers' loops lie in
        such bodies. Counted under
        collective-permute (the halo's kind in the JAX package), at the
        all-gather's bytes: 2 x ranks planes."""
        first = x.narrow(dim, 0, 1)
        last = x.narrow(dim, x.shape[dim] - 1, 1)
        if self.ranks == 1:
            return last, first
        _after_replays()
        lo, hi = halo_exchange(first, last, self.rank, self.ranks)
        self._count("collective-permute", 2 * self.ranks * first.numel()
                    * first.element_size(), x.device)
        return lo, hi

    def all_to_all_blocks(self, blocks):
        """blocks[r] goes to rank r (blocks: (ranks, ...), one shape on
        every rank); returns the blocks received, stacked in rank order:
        a fixed-size all-to-all."""
        if self.ranks == 1:
            return blocks
        src = self._staged(blocks.contiguous())
        out = torch.empty_like(src)
        _after_replays()
        dist.all_to_all_single(out, src)
        self._count("all-to-all", (out.numel() - out[0].numel())
                    * out.element_size(), blocks.device)
        return out.to(blocks.device)

    def total_bytes(self) -> int:
        return sum(self.bytes.values())


def halo_exchange(first, last, rank: int, ranks: int):
    """(lo, hi) of parallel/comm.Comm.halo from this rank's end planes
    (two tensors of one shape): one all_gather_into_tensor of every
    rank's first and last plane, from which lo is rank - 1's last plane
    and hi rank + 1's first (a copy: the values are bit for bit the
    neighbours'). The caller counts the bytes."""
    plane = first.numel()
    src = torch.cat([first.reshape(-1), last.reshape(-1)])
    out = torch.empty(ranks * 2 * plane, dtype=src.dtype, device=src.device)
    dist.all_gather_into_tensor(out, src)
    ends = out.view(ranks, 2, plane)
    lo = ends[(rank - 1) % ranks, 1]
    hi = ends[(rank + 1) % ranks, 0]
    return lo.reshape(first.shape), hi.reshape(first.shape)
