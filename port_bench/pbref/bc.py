"""Boundary conditions on the six box patches.

Replicates the fvPatchField zoology the reference cases use
(e.g. cases/auto-testing/test-cases/xiaocase3/0/{Ub,alpha,p}):
fixedValue, zeroGradient, empty, cyclic, inletOutlet.

BC specs are frozen dataclasses with scalar tuples for values, so a full
``FieldBC`` is hashable static configuration. A copy of
``sedifoam_tpu/bc.py``; only ``TimeTable.at`` differs (a torch
interpolation).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

FIXED_VALUE = "fixedValue"
ZERO_GRADIENT = "zeroGradient"
EMPTY = "empty"
CYCLIC = "cyclic"
INLET_OUTLET = "inletOutlet"
SLIP = "slip"  # zero normal component, zeroGradient tangential
REGION = "region"  # two sub-BCs selected by an in-plane mask (RegionPatchBC)

# patch ids in canonical order
PATCHES = ("xm", "xp", "ym", "yp", "zm", "zp")


@dataclasses.dataclass(frozen=True)
class TimeTable:
    """Piecewise-linear time-varying uniform BC value (OpenFOAM
    uniformFixedValue with a table, e.g. xiaocase1/0/Ub inlet ramp).

    Static (hashable); evaluation at a tensor time gives a 0-d tensor on
    the time's device, with no host sync: the table's knots go to the
    device once (device_vector), not at every call.
    """

    times: Tuple[float, ...]
    values: Tuple[Tuple[float, ...], ...]  # one tuple per time knot

    def at(self, t, comp: int):
        """np.interp semantics: linear between knots, clamped outside."""
        import torch
        from pbref import device_vector
        t = torch.as_tensor(t, dtype=torch.float64)
        ts = device_vector(tuple(self.times), t.dtype, t.device)
        vs = device_vector(tuple(v[comp] if len(v) > 1 else v[0]
                                 for v in self.values), t.dtype, t.device)
        if len(self.times) == 1:
            return vs[0]
        hi = torch.searchsorted(ts, t.reshape(1), right=True)
        hi = hi.clamp(1, len(self.times) - 1)
        t0, t1, v0, v1 = ts[hi - 1], ts[hi], vs[hi - 1], vs[hi]
        span = torch.where(t1 > t0, t1 - t0, torch.ones_like(t0))
        w = ((t.reshape(1) - t0) / span).clamp(0.0, 1.0)
        return (v0 + w * (v1 - v0)).reshape(())

    @property
    def n_comp(self) -> int:
        return max(len(v) for v in self.values)

    def map_values(self, fn) -> "TimeTable":
        return TimeTable(self.times,
                         tuple(tuple(fn(x) for x in v) for v in self.values))

    def component(self, i: int) -> "TimeTable":
        return TimeTable(self.times, tuple(
            (v[i] if len(v) > 1 else v[0],) for v in self.values))


@dataclasses.dataclass(frozen=True)
class PatchBC:
    kind: str
    # uniform value (1-tuple for scalars, 3-tuple for vectors) or a
    # TimeTable; for inletOutlet this is the inletValue.
    value: Union[Tuple[float, ...], TimeTable] = (0.0,)

    def component(self, i: int) -> "PatchBC":
        if isinstance(self.value, TimeTable):
            return PatchBC(self.kind, self.value.component(i))
        v = self.value[i] if len(self.value) > 1 else self.value[0]
        return PatchBC(self.kind, (v,))

    def value_at(self, t, comp: int = 0):
        """Uniform value at time t (traced-safe); scalar fields comp=0."""
        if isinstance(self.value, TimeTable):
            return self.value.at(t, comp)
        return self.value[comp] if len(self.value) > comp else self.value[0]


@dataclasses.dataclass(frozen=True)
class DiscRegion:
    """Disc-shaped sub-region of a boundary patch, defined analytically so
    the whole BC stays hashable/static under jit (the mask is rebuilt from
    the static grid at trace time and constant-folded by XLA).

    axis: the patch normal axis; (c0, c1): disc center in the two
    in-plane axes taken in ascending axis order; radius in meters.
    """

    axis: int
    c0: float
    c1: float
    radius: float

    def mask(self, grid):
        """(1, n_a, n_b) float coverage slab in the ops._mv(field, axis)
        layout: the fraction of each boundary face inside the disc
        (8x8 subsampling; <1% area error), so a blended inlet carries the
        disc's true flux even when the rim cuts through cells. NumPy —
        static at trace time, constant-folded by XLA."""
        import numpy as np
        oa, ob = (a for a in range(3) if a != self.axis)
        S = 8
        off = (np.arange(S) + 0.5) / S

        def sub(ax, c):
            f = np.asarray(grid.axis_faces(ax))
            return f[:-1, None] + (f[1:] - f[:-1])[:, None] * off[None] - c

        du = sub(oa, self.c0)                       # (n_a, S)
        dv = sub(ob, self.c1)                       # (n_b, S)
        inside = (du[:, :, None, None] ** 2 + dv[None, None] ** 2
                  <= self.radius ** 2)
        return inside.mean(axis=(1, 3))[None]


@dataclasses.dataclass(frozen=True)
class RegionPatchBC:
    """Mixed patch: ``inside`` applies within ``region``, ``outside``
    elsewhere on the same box face. Replicates jetFlow's bottom boundary
    (cases/example-cases/jetFlow/constant/polyMesh/blockMeshDict:84-110):
    the O-grid's separate `inlet` (jet column base) and `bottom` (annulus)
    patches both land on the embedded Cartesian mesh's ym face, so one
    face carries fixedValue-inside-a-slip-wall.

    Sub-BCs must be non-cyclic (a wrap across a partial face has no
    meaning); consumers blend the two sub-BC responses with the disc mask.
    """

    inside: PatchBC
    outside: PatchBC
    region: DiscRegion
    kind: str = REGION

    def __post_init__(self):
        assert self.inside.kind != CYCLIC and self.outside.kind != CYCLIC, \
            "cyclic sub-BCs are not meaningful inside a region patch"

    def component(self, i: int) -> "RegionPatchBC":
        return RegionPatchBC(
            _component_patch(self.inside, i, self.region.axis),
            _component_patch(self.outside, i, self.region.axis), self.region)


@dataclasses.dataclass(frozen=True)
class FieldBC:
    xm: PatchBC = PatchBC(ZERO_GRADIENT)
    xp: PatchBC = PatchBC(ZERO_GRADIENT)
    ym: PatchBC = PatchBC(ZERO_GRADIENT)
    yp: PatchBC = PatchBC(ZERO_GRADIENT)
    zm: PatchBC = PatchBC(ZERO_GRADIENT)
    zp: PatchBC = PatchBC(ZERO_GRADIENT)

    def patch(self, name: str) -> PatchBC:
        return getattr(self, name)

    def axis(self, axis: int) -> Tuple[PatchBC, PatchBC]:
        """(minus-side, plus-side) patches for an axis."""
        return (
            self.patch(PATCHES[2 * axis]),
            self.patch(PATCHES[2 * axis + 1]),
        )

    def component(self, i: int) -> "FieldBC":
        """Component i of a vector FieldBC, axis-aware: a slip patch is
        OpenFOAM's symmetry transform U_f = U_c - (U_c.n)n
        (slipFvPatchField), i.e. the wall-normal component is held at
        zero and the tangentials are zeroGradient."""
        return FieldBC(*(_component_patch(self.patch(p), i, k // 2)
                         for k, p in enumerate(PATCHES)))


def _component_patch(p, i: int, axis: int):
    """Component i of a (possibly region) vector patch on a given box
    axis. SLIP splits by direction: fixedValue 0 for the wall-normal
    component (i == axis), zeroGradient for tangentials."""
    if isinstance(p, RegionPatchBC):
        return RegionPatchBC(_component_patch(p.inside, i, axis),
                             _component_patch(p.outside, i, axis), p.region)
    if p.kind == SLIP:
        if i == axis:
            return PatchBC(FIXED_VALUE, (0.0,))
        return PatchBC(ZERO_GRADIENT, (0.0,))
    return p.component(i)


def uniform_bc(kind: str, value=0.0) -> FieldBC:
    v = value if isinstance(value, tuple) else (float(value),)
    return FieldBC(*(PatchBC(kind, v) for _ in PATCHES))


def zero_gradient() -> FieldBC:
    return uniform_bc(ZERO_GRADIENT)


def make_field_bc(patches: dict, default: Optional[PatchBC] = None) -> FieldBC:
    """Build a FieldBC from a {patch_name: PatchBC} dict."""
    default = default or PatchBC(ZERO_GRADIENT)
    return FieldBC(*(patches.get(p, default) for p in PATCHES))
