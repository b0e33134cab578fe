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
        n = torch.tensor([self.nx, self.ny, self.nz], dtype=torch.int32,
                         device=pos.device)
        if self.uniform:
            lo = torch.tensor([self.x0, self.y0, self.z0], dtype=pos.dtype,
                              device=pos.device)
            d = torch.tensor([self.dx, self.dy, self.dz], dtype=pos.dtype,
                             device=pos.device)
            idx = torch.floor((pos - lo) / d).to(torch.int32)
        else:
            cols = []
            for a in range(3):
                f = torch.as_tensor(self.axis_faces(a), dtype=pos.dtype,
                                    device=pos.device)
                cols.append(torch.searchsorted(f, pos[:, a].contiguous(),
                                               right=True) - 1)
            idx = torch.stack(cols, dim=-1).to(torch.int32)
        return torch.minimum(torch.clamp(idx, min=0), n - 1)

    def flat_index(self, ijk):
        """(N, 3) integer cell indices -> flat (N,) indices."""
        return (ijk[:, 0] * self.ny + ijk[:, 1]) * self.nz + ijk[:, 2]

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
