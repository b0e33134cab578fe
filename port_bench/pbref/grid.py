"""Structured tensor-product finite-volume grid.

The reference (sediFoam) runs on OpenFOAM meshes; every case is a blockMesh
box — uniform (all auto-testing cases), 1-D graded (`simpleGrading (1 10 1)`
in cases/example-cases/transport-bedload), or multiple hexes stacked along
one axis (transport-vortex-dune). All of these are tensor-product grids:
per-axis face-coordinate arrays, cell fields as dense (nx, ny, nz) tensors,
fluxes on three face arrays, every FV operator a shift-and-add stencil the
compiler fuses.

Uniform grids keep scalar spacing/area/volume; graded grids carry
per-axis coordinate tuples (static, hashable) from which
volumes/areas/distances/interp-weights are derived as numpy constants.

The numpy geometry is a copy of ``sedifoam_tpu/grid.py``; the methods
that make or read fields (``cell_centers``, ``locate``, ``flat_index``,
``zeros*``) work on tensors on an explicit device.

``SlabGrid`` is one rank's x-slab of a Grid, for a fluid split along
grid-x over ranks (parallel/step.py): the planes [x_start, x_start + nx)
of the whole grid, with the geometry of the whole grid's faces and the
collectives its stencils, sums and transforms exchange with.

The reference compiles a step into one program, so its numpy constants
are baked in once. Eager PyTorch would copy them to the device at every
stencil call (a synchronizing copy each); ``Grid.const`` keeps one tensor
per (constant, dtype, device) on the Grid object instead.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class FaceField(NamedTuple):
    """A quantity stored on cell faces (e.g. a volumetric flux phi).

    ``x`` has shape (nx+1, ny, nz): face i separates cell i-1 (owner/lower)
    from cell i; positive values point along +x.  Same convention for y/z.
    """

    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    def __add__(self, other):
        return FaceField(self.x + other.x, self.y + other.y, self.z + other.z)

    def __sub__(self, other):
        return FaceField(self.x - other.x, self.y - other.y, self.z - other.z)

    def __mul__(self, other):
        if isinstance(other, FaceField):
            return FaceField(self.x * other.x, self.y * other.y, self.z * other.z)
        return FaceField(self.x * other, self.y * other, self.z * other)

    __rmul__ = __mul__

    def __neg__(self):
        return FaceField(-self.x, -self.y, -self.z)


def _along(arr, axis: int):
    """Orient a 1-D numpy array along `axis` of a 3-D broadcast shape."""
    shape = [1, 1, 1]
    shape[axis] = len(arr)
    return np.asarray(arr, float).reshape(shape)


@dataclasses.dataclass(frozen=True)
class Grid:
    """Tensor-product box grid. Static (hashable). `faces` (per-axis face coordinates) is None for uniform
    grids; when set, dx/dy/dz hold the MEAN spacings and per-face geometry
    comes from the coordinate tuples."""

    nx: int
    ny: int
    nz: int
    dx: float
    dy: float
    dz: float
    x0: float = 0.0
    y0: float = 0.0
    z0: float = 0.0
    # per-axis face coordinates (len n+1 each); None = uniform
    faces: Optional[Tuple[Tuple[float, ...], Tuple[float, ...],
                          Tuple[float, ...]]] = None

    @classmethod
    def from_faces(cls, xf, yf, zf) -> "Grid":
        xf, yf, zf = (tuple(float(v) for v in f) for f in (xf, yf, zf))
        nx, ny, nz = len(xf) - 1, len(yf) - 1, len(zf) - 1

        def _uniform(f):
            w = np.diff(f)
            return np.allclose(w, w[0], rtol=1e-12, atol=0.0)

        if _uniform(xf) and _uniform(yf) and _uniform(zf):
            faces = None  # exact uniform: keep the scalar fast path
        else:
            faces = (xf, yf, zf)
        return cls(nx=nx, ny=ny, nz=nz,
                   dx=(xf[-1] - xf[0]) / nx, dy=(yf[-1] - yf[0]) / ny,
                   dz=(zf[-1] - zf[0]) / nz,
                   x0=xf[0], y0=yf[0], z0=zf[0], faces=faces)

    @property
    def uniform(self) -> bool:
        return self.faces is None

    # ---- geometry constants as tensors ------------------------------------

    def memo(self, key, make):
        """`make()`, computed once per key and kept on this Grid object
        (the cache is no dataclass field: it takes no part in equality or
        hashing and dies with the object)."""
        cache = self.__dict__.get("_memo")
        if cache is None:
            cache = {}
            object.__setattr__(self, "_memo", cache)
        if key not in cache:
            cache[key] = make()
        return cache[key]

    def __getstate__(self):
        """Pickled without the memo: its device tensors stay in this
        process (a rank spawned with a config builds its own)."""
        state = dict(self.__dict__)
        state.pop("_memo", None)
        return state

    def const(self, key, make, dtype, device):
        """The numpy constant `make()` as a tensor of `dtype` on `device`,
        copied there once per (key, dtype, device). Callers never write a
        returned tensor in place."""
        device = torch.device(device) if device is not None else None
        return self.memo((key, dtype, device), lambda: torch.as_tensor(
            make(), dtype=dtype, device=device))

    def geom(self, key, make, dtype, device):
        """A quantity made of cell volumes, face areas or widths, for
        arithmetic with tensors: `make()` itself on uniform grids (a
        scalar), else its array as the cached tensor of `const`."""
        if self.uniform:
            return make()
        return self.const(key, make, dtype, device)

    def cell_volume_like(self, like):
        """cell_volume for arithmetic with the tensor `like`."""
        return self.geom("cell_volume", lambda: self.cell_volume,
                         like.dtype, like.device)

    def face_area_like(self, a: int, like):
        """face_area[a] for arithmetic with the tensor `like`."""
        return self.geom(("face_area", a), lambda: self.face_area[a],
                         like.dtype, like.device)

    # ---- per-axis 1-D geometry (numpy) ------------------------------------

    def axis_faces(self, a: int) -> np.ndarray:
        """(n+1,) face coordinates along axis a."""
        if self.faces is not None:
            return np.asarray(self.faces[a], float)
        n = self.shape[a]
        o = (self.x0, self.y0, self.z0)[a]
        d = (self.dx, self.dy, self.dz)[a]
        return o + d * np.arange(n + 1)

    def axis_widths(self, a: int) -> np.ndarray:
        return np.diff(self.axis_faces(a))

    def axis_centers(self, a: int) -> np.ndarray:
        f = self.axis_faces(a)
        return 0.5 * (f[:-1] + f[1:])

    def axis_dists(self, a: int) -> np.ndarray:
        """(n+1,) face delta distances: center-to-center on internal faces,
        cell-center-to-face (half width) on the two boundary faces —
        OpenFOAM's deltaCoeffs convention."""
        w = self.axis_widths(a)
        return np.concatenate([[0.5 * w[0]], 0.5 * (w[:-1] + w[1:]),
                               [0.5 * w[-1]]])

    def seams(self, a: int):
        """(lo, hi): whether each side of axis a is a seam with another
        rank's slab (SlabGrid, axis 0) rather than a boundary patch."""
        return False, False

    def internal_weights(self, a: int) -> np.ndarray:
        """Owner weights of the faces with a cell on both sides, the
        ghost cells of a slab's seams included: axis_weights here."""
        return self.axis_weights(a)

    def internal_inv_dists(self, a: int) -> np.ndarray:
        """Inverse center distances of those faces."""
        return 1.0 / self.axis_dists(a)[1:-1]

    def axis_ends(self, a: int):
        """(first width, last width, their mean: the cyclic seam's
        distance) of axis a of the whole domain."""
        w = self.axis_widths(a)
        return float(w[0]), float(w[-1]), float(0.5 * (w[0] + w[-1]))

    def axis_weights(self, a: int) -> np.ndarray:
        """(n-1,) owner-side linear interpolation weight on internal faces
        (OpenFOAM surfaceInterpolation::weights): w = (c_N - x_f)/(c_N - c_P)."""
        f = self.axis_faces(a)[1:-1]
        c = self.axis_centers(a)
        return (c[1:] - f) / (c[1:] - c[:-1])

    @property
    def shape(self):
        return (self.nx, self.ny, self.nz)

    @property
    def n_cells(self):
        return self.nx * self.ny * self.nz

    @property
    def cell_volume(self):
        """Scalar (uniform) or (nx, ny, nz) numpy array of cell volumes."""
        if self.uniform:
            return self.dx * self.dy * self.dz
        return (_along(self.axis_widths(0), 0)
                * _along(self.axis_widths(1), 1)
                * _along(self.axis_widths(2), 2))

    @property
    def total_volume(self) -> float:
        return float((self.hi[0] - self.x0) * (self.hi[1] - self.y0)
                     * (self.hi[2] - self.z0))

    @property
    def spacing(self):
        """Mean spacings; exact only on uniform axes."""
        return (self.dx, self.dy, self.dz)

    @property
    def face_area(self):
        """Areas of x/y/z faces: scalars (uniform) or broadcastable arrays
        ((1,ny,nz) / (nx,1,nz) / (nx,ny,1)) matching face-field layouts."""
        if self.uniform:
            return (self.dy * self.dz, self.dx * self.dz, self.dx * self.dy)
        w = [self.axis_widths(a) for a in range(3)]
        return (
            _along(w[1], 1) * _along(w[2], 2),
            _along(w[0], 0) * _along(w[2], 2),
            _along(w[0], 0) * _along(w[1], 1),
        )

    def face_dist_inv(self, a: int) -> np.ndarray:
        """1/delta oriented along axis a, shape broadcastable to the
        axis-a face array ((n+1) along axis a)."""
        return _along(1.0 / self.axis_dists(a), a)

    @property
    def lengths(self):
        h = self.hi
        return (h[0] - self.x0, h[1] - self.y0, h[2] - self.z0)

    @property
    def hi(self):
        if self.faces is not None:
            return (self.faces[0][-1], self.faces[1][-1], self.faces[2][-1])
        return (
            self.x0 + self.nx * self.dx,
            self.y0 + self.ny * self.dy,
            self.z0 + self.nz * self.dz,
        )

    def cell_centers(self, dtype=torch.float64, device=None):
        """(3, nx, ny, nz) cell-center coordinates."""
        xs, ys, zs = (torch.as_tensor(self.axis_centers(a), dtype=dtype,
                                      device=device) for a in range(3))
        X, Y, Z = torch.meshgrid(xs, ys, zs, indexing="ij")
        return torch.stack([X, Y, Z])

    def locate(self, pos):
        """Map particle positions (N, 3) -> integer cell indices (N, 3).

        Clamps to the box (a particle outside the domain is assigned its
        nearest boundary cell; callers mask with in-domain checks).
        """
        dev = pos.device
        n = self.const("shape", lambda: np.array(self.shape), torch.int32,
                       dev)
        if self.uniform:
            lo = self.const("origin", lambda: np.array(
                [self.x0, self.y0, self.z0]), pos.dtype, dev)
            d = self.const("spacing", lambda: np.array(
                [self.dx, self.dy, self.dz]), pos.dtype, dev)
            idx = torch.floor((pos - lo) / d).to(torch.int32)
        else:
            cols = []
            for a in range(3):
                f = self.const(("axis_faces", a),
                               lambda: self.axis_faces(a), pos.dtype, dev)
                cols.append(torch.searchsorted(f, pos[:, a].contiguous(),
                                               right=True) - 1)
            idx = torch.stack(cols, dim=-1).to(torch.int32)
        return torch.minimum(torch.clamp(idx, min=0), n - 1)

    def flat_index(self, ijk):
        """(N, 3) integer cell indices -> flat (N,) indices."""
        return (ijk[:, 0] * self.ny + ijk[:, 1]) * self.nz + ijk[:, 2]

    # ---- reductions over the cells, plane by plane along grid-x ---------

    def plane_sums(self, x, x_faces: bool = False):
        """(..., planes) sums of x (..., planes, ny', nz') over its last two
        axes, one per grid-x plane (of faces when x_faces), all planes of
        the domain in x order. Each plane is summed in its row-major
        order, whatever x's strides: a field's layout must not change
        the bits of its sum."""
        return torch.sum(x.contiguous(), dim=(-2, -1))

    def total(self, x, x_faces: bool = False, compensated: bool = False):
        """The sum of x over its last three axes: each grid-x plane summed
        first, then the planes in x order; the same bits for a slab split
        over any number of ranks (SlabGrid). x_faces: x is on the x faces
        (nx+1 planes). compensated: an f32 x's plane sums are added in
        f64 and the total rounded once (utils/accum.py)."""
        p = self.plane_sums(x, x_faces)
        if compensated and p.dtype != torch.float64:
            return torch.sum(p, dim=-1, dtype=torch.float64).to(p.dtype)
        return torch.sum(p, dim=-1)

    def mean(self, x, x_faces: bool = False):
        """total(x) over the domain's count of its elements."""
        planes = self.whole_nx + (1 if x_faces else 0)
        n = x.numel() // x.shape[-3] * planes
        return self.total(x, x_faces) / n

    @property
    def whole_nx(self) -> int:
        return self.nx

    def cell_value(self, x, ijk):
        """x[ijk] at the domain's cell ijk, on every rank."""
        return x[tuple(ijk)]

    def join(self, x, axis=None):
        """x of the whole domain: x itself here; a slab's x gathered from
        the ranks along `axis` (by default the third from last: grid-x of
        a field; a flat axis of its cells works alike)."""
        return x

    def cut(self, x):
        """This grid's planes of grid-x (the third from last axis) of a
        field of the whole domain: x itself here; a slab's planes (a
        contiguous copy)."""
        return x

    @property
    def domain(self) -> "Grid":
        """The whole domain's Grid (this one; a slab's whole)."""
        return self

    def slab(self, x_start: int, n: int, comm) -> "SlabGrid":
        """The planes [x_start, x_start + n) of grid-x as one rank's
        SlabGrid; `comm` (parallel/comm.Comm) exchanges with the others."""
        faces = None if self.uniform else (
            tuple(self.faces[0][x_start:x_start + n + 1]), self.faces[1],
            self.faces[2])
        return SlabGrid(nx=n, ny=self.ny, nz=self.nz, dx=self.dx,
                        dy=self.dy, dz=self.dz, x0=self.x0, y0=self.y0,
                        z0=self.z0, faces=faces, whole=self,
                        x_start=x_start, comm=comm)

    def zeros(self, dtype=torch.float64, device=None):
        return torch.zeros(self.shape, dtype=dtype, device=device)

    def zeros_vec(self, dtype=torch.float64, device=None):
        return torch.zeros((3,) + self.shape, dtype=dtype, device=device)

    def zeros_faces(self, dtype=torch.float64, device=None):
        return FaceField(
            torch.zeros((self.nx + 1, self.ny, self.nz), dtype=dtype,
                        device=device),
            torch.zeros((self.nx, self.ny + 1, self.nz), dtype=dtype,
                        device=device),
            torch.zeros((self.nx, self.ny, self.nz + 1), dtype=dtype,
                        device=device),
        )


@dataclasses.dataclass(frozen=True)
class SlabGrid(Grid):
    """Planes [x_start, x_start + nx) of grid-x of the Grid `whole`: one
    rank's part of a fluid split along x (parallel/step.py), the
    analogue of an OpenFOAM processor mesh. Its cell and face fields are
    the slab's ((nx, ny, nz) cells, (nx+1, ny, nz) x faces, the faces on
    a seam held by both ranks alike); its geometry is the whole grid's,
    sliced, so every stencil's arithmetic is the whole grid's, cell by
    cell. A side of grid-x that is a seam with a neighbour's slab is
    the processor patch: the stencils read the neighbour's ghost plane
    (`halo`) and treat the seam's face as an internal face. The domain's
    own x patches stay on the first and last slab, where a cyclic patch
    reads its ghost plane from the slab across the wrap. `locate`, `hi`
    and the domain lengths are the whole grid's; reductions and `join`
    go through `comm`."""

    whole: Grid = None
    x_start: int = 0
    comm: object = dataclasses.field(default=None, compare=False)

    def seams(self, a: int):
        if a != 0:
            return False, False
        return self.x_start > 0, self.x_start + self.nx < self.whole.nx

    @property
    def whole_nx(self) -> int:
        return self.whole.nx

    def axis_faces(self, a: int) -> np.ndarray:
        if a != 0:
            return self.whole.axis_faces(a)
        return self.whole.axis_faces(0)[self.x_start:
                                        self.x_start + self.nx + 1]

    def _internal(self, arr):
        """The whole grid's internal-face array cut to this slab's faces
        with a cell (or a ghost cell) on both sides."""
        lo, hi = self.seams(0)
        f0 = self.x_start if lo else self.x_start + 1
        f1 = self.x_start + self.nx if hi else self.x_start + self.nx - 1
        return arr[f0 - 1:f1]

    def internal_weights(self, a: int) -> np.ndarray:
        if a != 0:
            return self.axis_weights(a)
        return self._internal(self.whole.axis_weights(0))

    def internal_inv_dists(self, a: int) -> np.ndarray:
        if a != 0:
            return 1.0 / self.axis_dists(a)[1:-1]
        return self._internal(self.whole.internal_inv_dists(0))

    def axis_ends(self, a: int):
        return self.whole.axis_ends(a)

    @property
    def hi(self):
        return self.whole.hi

    @property
    def total_volume(self) -> float:
        return self.whole.total_volume

    def locate(self, pos):
        """The domain's cells (N, 3), as Grid.locate."""
        return self.whole.locate(pos)

    def plane_sums(self, x, x_faces: bool = False):
        # each plane summed as the whole grid's call sums it: on the card
        # a reduction's order within each sum depends on how many sums it
        # makes, so the slab's planes are summed in a tensor of the whole
        # grid's planes, the rest zeros (Grid.plane_sums)
        planes = x.shape[-3]
        whole = self.whole_nx + (1 if x_faces else 0)
        if planes != whole:
            x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, whole - planes))
        p = torch.sum(x.contiguous(), dim=(-2, -1)).narrow(-1, 0, planes)
        if self.comm.ranks == 1:
            return p
        parts = self.comm.gather_planes(p)
        if x_faces:     # a seam's face once: the slab above it holds it
            parts = [q.narrow(-1, 0, self.nx) for q in parts[:-1]] \
                + [parts[-1]]
        return torch.cat(parts, dim=-1)

    def cell_value(self, x, ijk):
        i = int(ijk[0])
        owner = i // self.nx
        local = x[(i - self.x_start,) + tuple(ijk[1:])] \
            if owner == self.comm.rank else None
        return self.comm.broadcast_cell(local, owner, x)

    def join(self, x, axis=None):
        if self.comm.ranks == 1:
            return x
        return self.comm.all_gather_rows(
            x, axis=x.ndim - 3 if axis is None else axis)

    def cut(self, x):
        return x.narrow(x.ndim - 3, self.x_start, self.nx).contiguous()

    @property
    def domain(self) -> Grid:
        return self.whole

    def halo(self, x, dim: int):
        """(lo, hi) ghost planes of x along `dim` (its grid-x axis): the
        planes beyond each end of the slab, wrapping cyclically
        (parallel/comm.Comm.halo)."""
        return self.comm.halo(x, dim)
