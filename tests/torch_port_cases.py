"""Cases shared by the tests that hold sedifoam_tpu_torch's runtime and
injection against sedifoam_tpu (they import JAX, unlike
torch_port_util.py, which the card's JAX-free kernel test also uses)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp

from sedifoam_tpu_torch import bc as tbc
from sedifoam_tpu_torch import config as tcfg
from sedifoam_tpu_torch import grid as tgrid
from sedifoam_tpu_torch import solver as tsolver
from sedifoam_tpu_torch.fluid import state as tfstate
from test_window import _inject_case

_PORT_CLASSES = {
    cls.__name__: cls for cls in (
        tsolver.SimConfig, tgrid.Grid, tfstate.FluidBCs, tbc.FieldBC,
        tbc.PatchBC, tbc.TimeTable, tbc.DiscRegion, tbc.RegionPatchBC,
        tcfg.FluidConfig, tcfg.PISOConfig, tcfg.ChannelForcing,
        tcfg.TurbulenceConfig, tcfg.CloudConfig, tcfg.DEMConfig,
        tcfg.PairParams, tcfg.WallSpec, tcfg.CohesionParams)}


def port_config(obj):
    """A reference config tree (SimConfig, or any dataclass/NamedTuple
    inside it) rebuilt from the port's classes, field by field."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        cls = _PORT_CLASSES[type(obj).__name__]
        return cls(**{f.name: port_config(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return _PORT_CLASSES[type(obj).__name__](
            *(port_config(v) for v in obj))
    if isinstance(obj, tuple):
        return tuple(port_config(v) for v in obj)
    return obj


@functools.lru_cache(maxsize=None)
def window_case(capacity=8192):
    """tests/test_window.py's injection column (f32, initialized):
    injects near the bottom every 2 steps, deletes near the top.
    Cached: the reference's states are immutable."""
    return _inject_case(capacity=capacity)


def f64(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)
