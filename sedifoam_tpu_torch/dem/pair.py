"""Minimum-image helper (port of ``sedifoam_tpu/dem/pair.py::min_image``).

The dense all-pairs backend of the reference module is not ported.
"""

from __future__ import annotations

import torch


def min_image(delta, periodic_len):
    """Minimum-image convention per axis (LAMMPS domain->minimum_image;
    the particle side of the reference's cyclic transforms,
    lammpsFoam/softParticle.C:186-198). periodic_len: static 3-tuple of
    domain length (periodic axis) or None. torch.round rounds half to
    even, as jnp.round does."""
    if periodic_len is None or all(L is None for L in periodic_len):
        return delta
    return tuple(
        d - L * torch.round(d / L) if L is not None else d
        for d, L in zip(delta, periodic_len))
