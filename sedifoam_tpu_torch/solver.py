"""The coupled CFD-DEM solver step (port of ``sedifoam_tpu/solver.py``).

Reproduces the lammpsFoam main loop (lammpsFoam/lammpsFoam.C:52-129):

  init:  particleToEulerianField -> alpha/Ua; initial UfSmoothed;
         liftDragCoeffs (calcTcFields)
  step:  UEqns + PISO + gradP.adjust + turbulence     (fluid)
         moveParticles: evolve() (subcycled DEM + averaging) (particles)
         liftDragCoeffs: alpha cap + Asrc + lift        (coupling)

PyTorch runs eagerly: the reference's single XLA computation is a
sequence of kernels here, with a few host syncs per step (the Verlet
rebuild test once per DEM substep, the PCG stop test once per
iteration). `CoupledStep` owns the constant operators (the smoothing
solver and the pressure preconditioner) as submodules.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from sedifoam_tpu_torch import fastsolve
from sedifoam_tpu_torch.config import CloudConfig, DEMConfig, FluidConfig
from sedifoam_tpu_torch.coupling import cloud as _cloud
from sedifoam_tpu_torch.coupling import transfer as _transfer
from sedifoam_tpu_torch.dem import integrate as _dem
from sedifoam_tpu_torch.dem.state import ParticleState
from sedifoam_tpu_torch.fluid.state import FluidBCs, FluidState
from sedifoam_tpu_torch.fluid.step import advance_time, fluid_step
from sedifoam_tpu_torch.grid import Grid


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Full static configuration of a coupled case (hashable)."""

    grid: Grid
    bcs: FluidBCs
    fluid: FluidConfig
    cloud: CloudConfig
    dem: DEMConfig


class SimState(NamedTuple):
    fluid: FluidState
    particles: ParticleState
    uf_smoothed: torch.Tensor       # current smoothed fluid velocity
    uf_smoothed_old: torch.Tensor   # previous step's (history force)


def initialize(fluid: FluidState, particles: ParticleState,
               cfg: SimConfig, smoother=None) -> SimState:
    """enhancedCloud ctor + pre-loop liftDragCoeffs."""
    grid, bcs = cfg.grid, cfg.bcs
    smooth = _cloud._smooth_fn(grid, cfg.cloud, smoother)

    particles = particles._replace(
        time_to_add=torch.tensor(cfg.cloud.add_interval,
                                 dtype=particles.pos.dtype,
                                 device=particles.pos.device),
        rng_key=torch.zeros(2, dtype=torch.int64,
                            device=particles.pos.device))
    particles = _dem.setup_forces(particles, cfg.dem)

    alpha, Ua = _transfer.particle_to_eulerian(
        particles, grid, smooth, cfg.cloud.alpha_smooth, cfg.cloud.up_smooth)
    fluid = fluid._replace(alpha=alpha, Ua=Ua, alpha_old=alpha, Ua_old=Ua)

    if cfg.cloud.uf_smooth:
        uf_smoothed = _transfer.weighted_smooth_uf(fluid.Ub, alpha, smooth)
    else:
        uf_smoothed = fluid.Ub

    fluid = _cloud.lift_drag_coeffs(fluid, particles, uf_smoothed, grid,
                                    bcs, cfg.cloud, cfg.fluid, smoother)
    return SimState(fluid, particles, uf_smoothed, uf_smoothed)


def need_ddtu(cfg: SimConfig) -> bool:
    """DDtU.H consumers: the Cvm virtual-mass RHS, the particle
    added-mass force and fix fdrag's carrier_rho correction. With all
    three off the material derivatives are dead work and are skipped."""
    return (cfg.fluid.Cvm != 0.0 or cfg.cloud.particle_added_mass
            or cfg.dem.carrier_rho != 0.0)


def coupled_step(state: SimState, cfg: SimConfig, smoother=None,
                 pprecond=None) -> SimState:
    """One fluid timestep of the coupled system. `smoother` and
    `pprecond` are the prebuilt FastDiag operators (CoupledStep holds
    them); each is built on the fly when None."""
    grid, bcs = cfg.grid, cfg.bcs
    fluid, particles = state.fluid, state.particles

    fluid = advance_time(fluid, cfg.fluid)
    fluid = fluid_step(fluid, grid, bcs, cfg.fluid, advance=False,
                       need_ddtu=need_ddtu(cfg), pprecond=pprecond)

    fluid, particles, uf_smoothed = _cloud.evolve(
        fluid, particles, state.uf_smoothed, grid, bcs,
        cfg.cloud, cfg.dem, cfg.fluid, smoother)

    fluid = _cloud.lift_drag_coeffs(fluid, particles, uf_smoothed, grid,
                                    bcs, cfg.cloud, cfg.fluid, smoother)

    return SimState(fluid, particles, uf_smoothed, state.uf_smoothed)


class CoupledStep(nn.Module):
    """coupled_step with its constant operators built once: the
    diffusion-smoothing solver and the pressure preconditioner are
    buffers-only submodules, so .to(device) moves them. forward(state)
    is one coupled step."""

    def __init__(self, cfg: SimConfig, dtype=torch.float64, device=None):
        super().__init__()
        from sedifoam_tpu_torch import full_f32_precision
        full_f32_precision()
        self.cfg = cfg
        self.smoother = fastsolve.smoothing_solver(
            cfg.grid, tuple(float(d) for d in cfg.cloud.smooth_direction),
            dtype, device)
        self.pprecond = fastsolve.pressure_preconditioner(
            cfg.grid, cfg.bcs.p, dtype, device)

    def initialize(self, fluid: FluidState,
                   particles: ParticleState) -> SimState:
        return initialize(fluid, particles, self.cfg, self.smoother)

    def forward(self, state: SimState) -> SimState:
        return coupled_step(state, self.cfg, self.smoother, self.pprecond)


def make_step_fn(cfg: SimConfig, n_sub: int = 1, dtype=torch.float64,
                 device=None):
    """A function advancing n_sub coupled steps (one CoupledStep)."""
    step = CoupledStep(cfg, dtype, device)

    def run(state: SimState) -> SimState:
        for _ in range(n_sub):
            state = step(state)
        return state

    return run


def adjust_dem_timestep(dt_fluid: float, dt_dem_in: float, sub_cycles: int):
    """softParticleCloud::adjustLampTimestep (softParticleCloud.C:209-261).

    Returns (dt_dem_adjusted, sub_cycles, sub_steps).

    Matches the reference exactly, including its quirk: solidStepsPerDt is
    truncated down to a multiple of subCycles while the DEM dt stays
    dtFluid/dnSub, so for non-divisible ratios the DEM advances less than
    one fluid step per coupled step. The reference's FatalError for a
    nonzero remainder is unreachable after that truncation; we warn
    loudly instead of silently reproducing the mismatch.
    """
    dn_sub = round(dt_fluid / dt_dem_in)
    if dn_sub == 0:
        dn_sub = 1
    solid_steps = (int(dn_sub) // int(sub_cycles)) * int(sub_cycles)
    if solid_steps != int(dn_sub):
        import warnings
        warnings.warn(
            f"adjust_dem_timestep: dtFluid/dtDEM rounds to {int(dn_sub)} "
            f"substeps, not divisible by subCycles={sub_cycles}; truncating "
            f"to {solid_steps} (DEM advances {solid_steps}/{int(dn_sub)} of "
            "each fluid step — same as the reference's silent truncation at "
            "softParticleCloud.C:219-224). Pick dt values so that "
            "round(dtFluid/dtDEM) is a multiple of subCycles.",
            stacklevel=2)
    dt_dem = dt_fluid / dn_sub
    if sub_cycles >= solid_steps:
        return dt_dem, solid_steps, 1
    sub_steps, extra = divmod(solid_steps, sub_cycles)
    if extra != 0:
        raise ValueError(
            f"subCycles {sub_cycles} does not divide {solid_steps} DEM steps")
    return dt_dem, sub_cycles, sub_steps
