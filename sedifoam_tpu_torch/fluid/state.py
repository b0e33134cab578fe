"""Fluid solver state (the fields of lammpsFoam/createFields.H); port of
``sedifoam_tpu/fluid/state.py`` with the same field names."""

from __future__ import annotations

from typing import NamedTuple

import torch

from sedifoam_tpu_torch import bc as _bc
from sedifoam_tpu_torch.grid import FaceField, Grid


class FluidBCs(NamedTuple):
    """Static boundary conditions per solved field (hashable)."""

    alpha: _bc.FieldBC
    p: _bc.FieldBC
    Ub: _bc.FieldBC
    Ua: _bc.FieldBC


class FluidState(NamedTuple):
    # primary fields
    alpha: torch.Tensor      # solid volume fraction (set by particles)
    p: torch.Tensor          # pressure
    Ua: torch.Tensor         # (3,...) solid ensemble velocity
    Ub: torch.Tensor         # (3,...) fluid velocity
    phia: FaceField          # solid-phase volumetric face flux
    phib: FaceField          # fluid-phase volumetric face flux
    phi: FaceField           # mixture flux alphaf*phia + betaf*phib
    # previous-timestep copies (Euler ddt + ddtCorr)
    alpha_old: torch.Tensor
    Ua_old: torch.Tensor
    Ub_old: torch.Tensor
    phia_old: FaceField
    phib_old: FaceField
    # material derivatives (DDtU.H; not ported, stay zero)
    DDtUa: torch.Tensor
    DDtUb: torch.Tensor
    # particle->fluid explicit momentum source (enhancedCloud::Asrc)
    Asrc: torch.Tensor       # (3,...)
    drag_coef: torch.Tensor  # implicit drag coefficient (zero: explicit)
    lift_coeff: torch.Tensor  # (3,...) Cl*beta*rhob*(Ur x curl U)
    grad_p_value: torch.Tensor  # scalar channel forcing accumulator
    # turbulence state (zeros when laminar)
    k: torch.Tensor
    epsilon: torch.Tensor
    nut: torch.Tensor
    # body-force state (not ported, stays zero)
    ibm_indicator: torch.Tensor
    turbulence_force: torch.Tensor
    dns_f_hat: torch.Tensor
    dns_key: torch.Tensor     # (2,) int64 (uint32 in the reference)
    time: torch.Tensor        # scalar simulation time
    step: torch.Tensor        # scalar int32 time index

    @property
    def beta(self):
        return 1.0 - self.alpha

    @property
    def U(self):
        """Mixture velocity U = alpha*Ua + beta*Ub."""
        return self.alpha[None] * self.Ua + self.beta[None] * self.Ub

    @property
    def Uc(self):
        """Sediment flux Uc = alpha*Ua."""
        return self.alpha[None] * self.Ua


def init_fluid(grid: Grid, alpha=None, Ub=None, p=None, dtype=torch.float64,
               device=None) -> FluidState:
    z = grid.zeros(dtype, device)
    zv = grid.zeros_vec(dtype, device)
    zf = grid.zeros_faces(dtype, device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    alpha = z if alpha is None else t(alpha)
    Ub = zv if Ub is None else t(Ub)
    p = z if p is None else t(p)
    return FluidState(
        alpha=alpha, p=p, Ua=zv, Ub=Ub,
        phia=zf, phib=zf, phi=zf,
        alpha_old=alpha, Ua_old=zv, Ub_old=Ub,
        phia_old=zf, phib_old=zf,
        DDtUa=zv, DDtUb=zv,
        Asrc=zv, drag_coef=z, lift_coeff=zv,
        grad_p_value=torch.zeros((), dtype=dtype, device=device),
        k=z, epsilon=z, nut=z,
        ibm_indicator=z,
        turbulence_force=zv,
        dns_f_hat=torch.zeros((2, 3) + grid.shape, dtype=dtype,
                              device=device),
        dns_key=torch.zeros(2, dtype=torch.int64, device=device),
        time=torch.zeros((), dtype=dtype, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
    )
