"""State exchange with the JAX package, by field name, through numpy.

A state crosses as a nested dict of numpy arrays keyed by field name:
``{"fluid": {"alpha": ..., "phia": {"x": ..., "y": ..., "z": ...}, ...},
"particles": {...}, "uf_smoothed": ..., "uf_smoothed_old": ...}``.
``sim_state_to_numpy`` makes that dict from either package's ``SimState``
(it only walks NamedTuples and converts leaves with numpy), and
``sim_state_from_numpy`` builds the port's ``SimState`` from it. The
tests use the pair to start both packages from the same state and to
compare them field by field.
"""

from __future__ import annotations

import numpy as np
import torch

from sedifoam_tpu_torch.dem.state import ParticleState
from sedifoam_tpu_torch.fluid.state import FluidState
from sedifoam_tpu_torch.grid import FaceField

# PRNG keys: uint32 in the reference; torch keeps them as int64
KEY_FIELDS = ("rng_key", "dns_key")


def tree_to_numpy(obj):
    """NamedTuple tree of arrays or tensors -> nested dict of numpy."""
    if obj is None:
        return None
    if hasattr(obj, "_asdict"):
        return {k: tree_to_numpy(v) for k, v in obj._asdict().items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def _tensor(a, device, dtype):
    a = np.array(a)                  # a writable copy
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    t = torch.as_tensor(a, device=device)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t


def _named(cls, d, device, dtype):
    out = {}
    for name, v in d.items():
        if name not in cls._fields:
            raise KeyError(f"{cls.__name__} has no field {name!r}")
        if v is None:
            out[name] = None
        elif isinstance(v, dict):
            out[name] = FaceField(*(_tensor(v[c], device, dtype)
                                    for c in "xyz"))
        else:
            out[name] = _tensor(v, device, dtype)
    return cls(**out)


def particle_state_from_numpy(d, device=None, dtype=None) -> ParticleState:
    """`rigid`, when set, crosses as a nested dict of the body fields."""
    ps = _named(ParticleState, {k: v for k, v in d.items() if k != "rigid"},
                device, dtype)
    if d.get("rigid") is not None:
        from sedifoam_tpu_torch.dem.rigid import RigidBodies
        ps = ps._replace(rigid=_named(RigidBodies, d["rigid"], device,
                                      dtype))
    return ps


def fluid_state_from_numpy(d, device=None, dtype=None) -> FluidState:
    return _named(FluidState, d, device, dtype)


def sim_state_from_numpy(d, device=None, dtype=None):
    """Nested numpy dict -> the port's SimState. dtype, when given, casts
    every floating field."""
    from sedifoam_tpu_torch.solver import SimState
    return SimState(
        fluid=fluid_state_from_numpy(d["fluid"], device, dtype),
        particles=particle_state_from_numpy(d["particles"], device, dtype),
        uf_smoothed=_tensor(d["uf_smoothed"], device, dtype),
        uf_smoothed_old=_tensor(d["uf_smoothed_old"], device, dtype))


def sim_state_to_numpy(state):
    """Either package's SimState -> nested numpy dict (keys as uint32)."""
    d = tree_to_numpy(state)
    for part in ("fluid", "particles"):
        for k in KEY_FIELDS:
            if k in d[part]:
                d[part][k] = d[part][k].astype(np.uint32)
    return d
