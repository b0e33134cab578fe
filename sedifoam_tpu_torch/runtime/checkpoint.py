"""Full-state checkpoint/resume in the JAX package's own format (port of
``sedifoam_tpu/runtime/checkpoint.py``).

The file is an npz of ``leaf_<i>`` arrays in ``jax.tree.flatten`` order
of ``SimState``: NamedTuple fields in declaration order (the port's
NamedTuples match the reference's field for field), a ``FaceField``
expands to x, y, z, and None leaves are skipped: ``rigid`` when the case
has no clumps; with clumps it expands, after ``mol`` and ``displace``,
to ``RigidBodies``' seven fields (``valid`` as bool). The PRNG
keys (``rng_key``, ``dns_key``) are stored as uint32, as the reference
holds them. A checkpoint therefore crosses packages in both directions.
The DEM contact shear history rides the state, so a resume continues the
contacts LAMMPS cannot restart (softParticleCloud.C:525-528).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sedifoam_tpu_torch.bridge import KEY_FIELDS


def _flatten(obj, name=""):
    """[(field name, tensor)] in jax.tree.flatten order; None skipped."""
    if obj is None:
        return []
    if isinstance(obj, torch.Tensor):
        return [(name, obj)]
    if hasattr(obj, "_fields"):
        out = []
        for field, v in zip(obj._fields, obj):
            out += _flatten(v, field)
        return out
    raise TypeError(f"checkpoint: unexpected leaf {type(obj).__name__} "
                    f"in field {name!r}")


def _unflatten(template, leaves):
    """Rebuild template's NamedTuple tree from an iterator of leaves."""
    if template is None:
        return None
    if isinstance(template, torch.Tensor):
        return next(leaves)
    return type(template)(*(_unflatten(v, leaves) for v in template))


def save(path: str, state) -> None:
    arrays = {}
    for i, (name, x) in enumerate(_flatten(state)):
        a = x.detach().cpu().numpy()
        if name in KEY_FIELDS:
            a = a.astype(np.uint32)
        arrays[f"leaf_{i}"] = a
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **arrays)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)


def load(path: str, template):
    """Restore into the structure, dtypes and devices of `template`
    (shapes must match)."""
    flat = _flatten(template)
    new = []
    with np.load(path) as data:
        for i, (name, leaf) in enumerate(flat):
            arr = data[f"leaf_{i}"]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"checkpoint leaf {i} ({name}): "
                                 f"{arr.shape} != {tuple(leaf.shape)}")
            if arr.dtype == np.uint32:
                arr = arr.astype(np.int64)
            new.append(torch.as_tensor(arr, device=leaf.device)
                       .to(leaf.dtype))
    return _unflatten(template, iter(new))
