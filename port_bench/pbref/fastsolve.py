"""Tensor-product fast diagonalization for separable constant-coefficient
operators on the box grid (port of ``sedifoam_tpu/fastsolve.py``).

For an operator  c0*I - sum_a D_a * L_a  (L_a = per-axis 1D volume-
integrated Laplacian with the patch BCs), the eigendecomposition
L_a = V_a diag(lam_a) V_a^T gives the exact inverse as six dense matmuls:

    x = V @ [ (V^T b) / (c0 - lam_x - lam_y - lam_z) ]

applied axis by axis. Used for the diffusion smoothing (exact solve) and
as the pressure-Poisson preconditioner. The eigendecompositions are built
once per (grid, BCs) in numpy (a copy of the reference's); the transforms
are matmuls on tensors, which must run in full precision on the card
(TF32 off: its ~1e-3 relative error breaks the smoothing's maximum
principle).

On a slab of a fluid split along grid-x (grid.SlabGrid) every rank
gathers the right-hand side, solves on the whole grid and keeps its
slab: one all-gather a solve. A transform split over the ranks (an
all-to-all to column blocks for x, the slab's planes for y and z) runs
its matmuls on fewer columns than one process, and cuBLAS may then pick
another kernel, which rounds otherwise: on the H100 the y transform of
a vector field on 32 x 16 x 32 cells parts from the whole grid's at 2
ranks, and x, y and z each part somewhere among a dozen grid shapes.
The whole solve is the one process's, bit for bit, on every shape; its
matmuls cost little beside the step.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
from torch import nn

from pbref import bc as _bc
from pbref.grid import Grid, SlabGrid

# BC kind per axis side for the 1D operators
DIRICHLET = "dirichlet"
NEUMANN = "neumann"
PERIODIC = "periodic"


def bc_kind_1d(patch_kind: str) -> str:
    if patch_kind in (_bc.FIXED_VALUE, _bc.INLET_OUTLET):
        return DIRICHLET
    if patch_kind == _bc.CYCLIC:
        return PERIODIC
    return NEUMANN  # zeroGradient / empty / slip


@lru_cache(maxsize=64)
def _axis_eig(faces: Tuple[float, ...], d_coef: float, lo: str, hi: str):
    """Eigendecomposition of the 1D volume-NORMALIZED Laplacian
    A = diag(1/w) L on the (possibly graded) axis with face coordinates
    `faces`: L is the symmetric tridiagonal with internal coefficients
    1/dist (center-to-center), Dirichlet boundary 1/(w/2), periodic seam
    1/((w0+wn)/2); w are cell widths.

    Solved as the generalized symmetric problem L v = lam diag(w) v via
    the similarity M = W^-1/2 L W^-1/2. Returns (fwd (n,n), bwd (n,n),
    lam (n,)) numpy with  A = bwd @ diag(lam) @ fwd  and fwd @ bwd = I.
    """
    f = np.asarray(faces)
    w = np.diff(f)
    n = len(w)
    c = 0.5 * (f[:-1] + f[1:])
    dist = np.diff(c)
    L = np.zeros((n, n))
    for k in range(n - 1):
        coef = d_coef / dist[k]
        L[k, k] -= coef
        L[k + 1, k + 1] -= coef
        L[k, k + 1] += coef
        L[k + 1, k] += coef
    if lo == PERIODIC or hi == PERIODIC:
        coef = d_coef / (0.5 * (w[0] + w[-1]))
        L[0, 0] -= coef
        L[-1, -1] -= coef
        L[0, -1] += coef
        L[-1, 0] += coef
    else:
        if lo == DIRICHLET:
            L[0, 0] -= d_coef * 2.0 / w[0]
        if hi == DIRICHLET:
            L[-1, -1] -= d_coef * 2.0 / w[-1]
    s = np.sqrt(w)
    M = L / s[:, None] / s[None, :]
    lam, U = np.linalg.eigh(M)
    bwd = U / s[:, None]            # W = D^-1/2 U  (eigenvectors of A)
    fwd = (U * s[:, None]).T        # W^-1 = U^T D^1/2
    return fwd, bwd, lam


def _fastdiag_arrays(grid: Grid, d_coefs: Tuple[float, float, float],
                     kinds: Tuple[Tuple[str, str], ...]):
    """Per-axis transforms + the 3D eigenvalue sum (numpy), once per
    Grid object (Grid.memo: a cache keyed on the Grid itself would keep
    it, and the device constants it carries, alive)."""
    return grid.memo(("fastdiag_arrays", d_coefs, kinds),
                     lambda: _fastdiag_build(grid, d_coefs, kinds))


def _fastdiag_build(grid, d_coefs, kinds):
    fwds, bwds, lams = [], [], []
    for a in range(3):
        faces = tuple(float(v) for v in grid.axis_faces(a))
        fwd, bwd, lam = _axis_eig(faces, float(d_coefs[a]), *kinds[a])
        fwds.append(fwd)
        bwds.append(bwd)
        lams.append(lam)
    lam3 = (lams[0][:, None, None] + lams[1][None, :, None]
            + lams[2][None, None, :])
    return tuple(fwds), tuple(bwds), lam3


class FastDiag(nn.Module):
    """Callable inverse of  c0*I - sum_a D_a A_a  where A_a is the
    volume-normalized per-axis 1D Laplacian (A = V^-1 L in 3D). The
    per-axis transforms (fwd0..2, bwd0..2) and the eigenvalue sum lam3
    are buffers, so they follow .to(device)."""

    def __init__(self, grid: Grid, d_coefs, kinds, dtype=torch.float64,
                 device=None):
        super().__init__()
        self.slab = grid if isinstance(grid, SlabGrid) else None
        fwds, bwds, lam3 = _fastdiag_arrays(
            grid.domain, tuple(float(d) for d in d_coefs), tuple(kinds))
        for a in range(3):
            self.register_buffer(f"fwd{a}", torch.as_tensor(
                fwds[a], dtype=dtype, device=device))
            self.register_buffer(f"bwd{a}", torch.as_tensor(
                bwds[a], dtype=dtype, device=device))
        self.register_buffer("lam3", torch.as_tensor(lam3, dtype=dtype,
                                                     device=device))
        # singular (all-Neumann) operators have one ~0 eigenvalue at c0=0;
        # flag it so callers can project it out
        self.null_tol = float(np.abs(lam3).max()) * 1e-12 + 1e-300

    @property
    def fwd(self):
        return [self.fwd0, self.fwd1, self.fwd2]

    @property
    def bwd(self):
        return [self.bwd0, self.bwd1, self.bwd2]

    def _transform(self, mats, b):
        off = b.ndim - 3
        for a in range(3):
            b = torch.movedim(
                torch.tensordot(mats[a], b, dims=([1], [off + a])),
                0, off + a)
        return b

    def _to_eig(self, b):
        return self._transform(self.fwd, b)

    def _from_eig(self, y):
        return self._transform(self.bwd, y)

    def _whole(self, solve, b):
        """solve(b) on the whole grid: on a slab, b gathered from the
        ranks and the slab's planes of the result kept (the module
        docstring)."""
        if self.slab is None:
            return solve(b)
        return self.slab.cut(solve(self.slab.join(b)))

    def solve_pow(self, b, c0, k: int):
        """x = [(c0*I - sum D_a L_a)^-1 c0]^k b — k implicit-Euler steps
        collapsed into one transform pair: in the eigenbasis each step
        multiplies by c0/(c0 - lam), so k steps multiply by that ratio
        to the k-th power."""
        def solve(b):
            bh = self._to_eig(b)
            ratio = c0 / (c0 - self.lam3)
            return self._from_eig(bh * ratio ** k)
        return self._whole(solve, b)

    def solve(self, b, c0, project_null: bool = False):
        """x with (c0*I - sum D_a L_a) x = b; leading batch dims allowed."""
        return self._whole(lambda b: self._solve(b, c0, project_null), b)

    def _solve(self, b, c0, project_null):
        bh = self._to_eig(b)
        denom = c0 - self.lam3
        if project_null:
            # zero the (near-)null mode instead of dividing by ~0
            safe = torch.abs(denom) > self.null_tol
            bh = torch.where(safe, bh / torch.where(
                safe, denom, torch.ones_like(denom)), torch.zeros_like(bh))
        else:
            bh = bh / denom
        return self._from_eig(bh)

    def forward(self, b, c0, project_null: bool = False):
        return self.solve(b, c0, project_null)


def smoothing_solver(grid: Grid, direction, dtype=torch.float64,
                     device=None) -> FastDiag:
    """Exact per-step inverse for the diffusion smoothing (zeroGradient)."""
    kinds = ((NEUMANN, NEUMANN),) * 3
    return FastDiag(grid, direction, kinds, dtype, device)


def pressure_preconditioner(grid: Grid, pbc: _bc.FieldBC, dtype=torch.float64,
                            device=None) -> FastDiag:
    """Constant-coefficient Poisson inverse with the p-field BCs."""
    kinds = []
    for a in range(3):
        lo, hi = pbc.axis(a)
        kinds.append((bc_kind_1d(lo.kind), bc_kind_1d(hi.kind)))
    return FastDiag(grid, (1.0, 1.0, 1.0), tuple(kinds), dtype, device)
