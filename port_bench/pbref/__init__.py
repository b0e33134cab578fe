"""A frozen plain-PyTorch copy of the coupled CFD-DEM step, the
benchmark's reference.

Copied from the port's modules of the same names (the case loader, the
fluid, coupling and DEM steps) with every import pointed at this
package. What the copy leaves out: the CUDA contact-chain kernel (the
chain is `dem.neighbor.pair_forces_binned` plus `dem.walls.wall_forces`
on every device), CUDA graphs (`graphs.cond` and `graphs.while_loop`
read their predicates on the host), the split step across ranks, the
runner and the validators; and the features the benchmark's
configurations do not run: the lattice backend, rigid clumps, particle
injection and the DNS body force (`dem/lattice`, `dem/rigid`,
`dem/inject`, `fluid/bodyforce`), whose branches raise here; a
configuration that needs one adds its copy. It imports nothing of the
program, so a later change to the program is held against the step as
it stood when the benchmark was written.
"""

import functools

import torch


def default_device(device=None) -> torch.device:
    """`device` as a torch.device; with none given, the CUDA card."""
    return torch.device(device if device is not None else "cuda")


@functools.lru_cache(maxsize=256)
def device_vector(values: tuple, dtype, device) -> torch.Tensor:
    """A tuple of numbers from a config as a 1-D tensor, made once per
    (values, dtype, device). Never written in place."""
    return torch.tensor(values, dtype=dtype, device=device)
