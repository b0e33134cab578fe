"""The collectives of the split coupled step, over one torch.distributed
process group.

The DEM's (parallel/step.py): the ranks' blocks of a particle array put
together in rank order (`all_gather_rows`), the sum of the ranks'
partial grids after the particle-to-grid scatters where the fluid is
whole (`all_reduce_sum`), and the largest displacement since the last
neighbor build, so that every rank takes the same branch of the rebuild
test (`all_reduce_max`).

The fluid's, where it is split along grid-x (grid.SlabGrid): the ghost
planes of the stencils (`halo`, each slab's end planes to its two
neighbours, wrapping cyclically), the per-plane partial sums of every
global reduction (`gather_planes`: each rank then sums all planes in x
order alike), the whole field from the slabs (`all_gather_rows`: the
FastDiag solves and the grid-to-particle gathers read it), the value of
one cell from its owner (`broadcast_cell`), and the particle rows'
contributions to the cells of another rank's slab (`route_rows`).

`Comm.bytes` counts, by kind, the bytes of the tensors each call
returns on this rank: the convention of the JAX package's dry run
(`__graft_entry__._collective_bytes` sums the result shapes of the
collectives in the compiled program), under its names:
``collective-permute`` (halos), ``all-to-all``, ``all-gather``,
``all-reduce`` and ``collective-broadcast``. Nothing is counted where
nothing leaves the rank (one rank; a rank's own block of an
all-to-all).

Over gloo the tensors may lie on the CPU or on a card: gloo carries a
CUDA tensor through host memory itself in all_gather and all_reduce
(on the H100, torch 2.11); the point-to-point halos, the all-to-alls
and the broadcast are staged through host memory here. NCCL takes
them on the card.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist


class Comm:
    """Collectives over the default process group, with a byte counter
    by kind."""

    def __init__(self):
        self.ranks = dist.get_world_size()
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        self.bytes = collections.Counter()

    def all_gather_rows(self, x, axis: int = 0):
        """The ranks' blocks of x (one shape on every rank) concatenated
        along `axis` in rank order: a new contiguous tensor."""
        flag = x.dtype == torch.bool    # gathered as bytes
        src = x.contiguous()
        src = src.view(torch.uint8) if flag else src
        parts = [torch.empty_like(src) for _ in range(self.ranks)]
        dist.all_gather(parts, src)
        out = torch.cat(parts, dim=axis)
        self.bytes["all-gather"] += out.numel() * out.element_size()
        return out.view(torch.bool) if flag else out

    def _all_reduce(self, x, op):
        y = x.clone()
        dist.all_reduce(y, op=op)
        self.bytes["all-reduce"] += y.numel() * y.element_size()
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
        src = p.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.ranks)]
        dist.all_gather(parts, src)
        self.bytes["all-gather"] += src.numel() * src.element_size() \
            * self.ranks
        return parts

    def broadcast_cell(self, local, owner: int, like):
        """A 0-d tensor on every rank: `local` on rank `owner` (None on
        the others), of like's dtype and device."""
        if self.ranks == 1:
            return local
        buf = local.reshape(1).clone() if self.rank == owner else \
            torch.empty(1, dtype=like.dtype, device=like.device)
        host = self._staged(buf)
        dist.broadcast(host, src=owner)
        self.bytes["collective-broadcast"] += host.element_size()
        return host.to(like.device).reshape(())

    def halo(self, x, dim: int):
        """(lo, hi): the plane of x along `dim` just below this rank's
        first (the last plane of rank - 1) and just above its last (the
        first plane of rank + 1), ranks wrapping cyclically (one rank:
        its own last and first planes)."""
        first = x.narrow(dim, 0, 1)
        last = x.narrow(dim, x.shape[dim] - 1, 1)
        if self.ranks == 1:
            return last, first
        down, up = (self.rank - 1) % self.ranks, (self.rank + 1) % self.ranks
        send_lo = self._staged(first.contiguous())
        send_hi = self._staged(last.contiguous())
        lo, hi = torch.empty_like(send_lo), torch.empty_like(send_hi)
        # tags tell the two messages apart where both neighbours are one
        # rank (two ranks); NCCL matches them in this posting order
        ops = [dist.P2POp(dist.isend, send_lo, down, tag=0),
               dist.P2POp(dist.isend, send_hi, up, tag=1),
               dist.P2POp(dist.irecv, hi, up, tag=0),
               dist.P2POp(dist.irecv, lo, down, tag=1)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.bytes["collective-permute"] += 2 * lo.numel() \
            * lo.element_size()
        return lo.to(x.device), hi.to(x.device)

    def _all_to_all(self, blocks, recv_sizes):
        """blocks[r] goes to rank r; returns the blocks received, in rank
        order (flat tensors of recv_sizes elements)."""
        if self.ranks == 1:
            return [blocks[0].reshape(-1)]
        sizes = [b.numel() for b in blocks]
        src = self._staged(torch.cat([b.reshape(-1) for b in blocks]))
        out = torch.empty(sum(recv_sizes), dtype=src.dtype,
                          device=src.device)
        dist.all_to_all_single(out, src, recv_sizes, sizes)
        own = recv_sizes[self.rank]
        self.bytes["all-to-all"] += (out.numel() - own) * out.element_size()
        dev = blocks[0].device
        return [t.to(dev) for t in torch.split(out, recv_sizes)]

    def _exchange_counts(self, sizes):
        """The counts every rank sends to this one, given what this one
        sends to each (a host list)."""
        src = self._staged(torch.tensor(sizes, dtype=torch.int64))
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src)
        return out.tolist()

    def route_rows(self, dest, *rows):
        """Each row of the tensors `rows` (N, ...) sent to rank dest[row]:
        returns, per tensor, the rows this rank received, ordered by the
        sending rank and then by row (the rows' global order, a rank's
        rows being a block of them)."""
        order = torch.argsort(dest, stable=True)
        counts = torch.bincount(dest, minlength=self.ranks).tolist()
        recv = self._exchange_counts(counts) if self.ranks > 1 else counts
        out = []
        for x in rows:
            width = x[0].numel()
            blocks = torch.split(x[order], counts)
            got = self._all_to_all(list(blocks), [k * width for k in recv])
            out.append(torch.cat([g.reshape((-1,) + x.shape[1:])
                                  for g in got]))
        return out

    def total_bytes(self) -> int:
        return sum(self.bytes.values())
