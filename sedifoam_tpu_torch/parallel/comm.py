"""The collectives of the split coupled step, over one torch.distributed
process group.

The step needs three (parallel/step.py): the ranks' blocks of a particle
array put together in rank order (`all_gather_rows`), the sum of the
ranks' partial grids after the particle-to-grid scatters
(`all_reduce_sum`), and the largest displacement since the last
neighbor build, so that every rank takes the same branch of the rebuild
test (`all_reduce_max`).

`Comm.bytes` counts, by collective, the bytes of the tensors each call
returns on this rank: the convention of the JAX package's dry run
(`__graft_entry__._collective_bytes` sums the result shapes of the
collectives in the compiled program).

Over gloo the tensors may lie on the CPU or on a card (gloo carries a
CUDA tensor through host memory itself: on the H100, torch 2.11, it took
both kinds of call); NCCL takes them on the card.
"""

from __future__ import annotations

import collections

import torch
import torch.distributed as dist


class Comm:
    """Collectives over the default process group, with a byte counter."""

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
        self.bytes["all_gather"] += out.numel() * out.element_size()
        return out.view(torch.bool) if flag else out

    def _all_reduce(self, x, op):
        y = x.clone()
        dist.all_reduce(y, op=op)
        self.bytes["all_reduce"] += y.numel() * y.element_size()
        return y

    def all_reduce_sum(self, x):
        """The sum over the ranks of x (a new tensor, the same on every
        rank)."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def all_reduce_max(self, x):
        """The largest x over the ranks, elementwise (a new tensor)."""
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def total_bytes(self) -> int:
        return sum(self.bytes.values())
