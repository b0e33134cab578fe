"""The coupled CFD-DEM solver step (port of ``sedifoam_tpu/solver.py``).

Reproduces the lammpsFoam main loop (lammpsFoam/lammpsFoam.C:52-129):

  init:  particleToEulerianField -> alpha/Ua; initial UfSmoothed;
         liftDragCoeffs (calcTcFields)
  step:  UEqns + PISO + gradP.adjust + turbulence     (fluid)
         moveParticles: evolve() (subcycled DEM + averaging) (particles)
         liftDragCoeffs: alpha cap + Asrc + lift        (coupling)

The reference jits the step into one XLA computation; here, on a CUDA
device, `GraphedStep` captures it once as a CUDA graph (graphs.py) and
replays it with one launch per step: its decisions (the Verlet rebuild
test once per DEM substep, the PCG and BiCGStab stop tests once per
iteration, injection and deletion) are conditional nodes, so a replayed
step makes no host sync. `make_step_fn` returns the graphed step on the
card, the counterpart of the reference's jitted one. `CoupledStep` owns
the constant operators (the smoothing solver and the pressure
preconditioner) as submodules; its forward is the eager step, which
reads each decision on the host: the CPU's step, and the oracle the
graph is held against on the card.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
from torch import nn

from sedifoam_tpu_torch import fastsolve, graphs, telemetry
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
                 pprecond=None, shard=None) -> SimState:
    """One fluid timestep of the coupled system. `smoother` and
    `pprecond` are the prebuilt FastDiag operators (CoupledStep holds
    them); each is built on the fly when None. `shard`: one rank's part
    in a step split over ranks (parallel/step.ShardedStep): the
    particles are its own block of rows; the fluid is whole, or its
    x-slab where cfg.grid is the rank's grid.SlabGrid."""
    grid, bcs = cfg.grid, cfg.bcs
    fluid, particles = state.fluid, state.particles
    dev = fluid.p.device

    telemetry.mark("gap", dev)
    fluid = advance_time(fluid, cfg.fluid)
    fluid = fluid_step(fluid, grid, bcs, cfg.fluid, advance=False,
                       need_ddtu=need_ddtu(cfg), pprecond=pprecond)
    telemetry.mark("fluid", dev)

    # marks "coupling" before each run of the DEM substeps, "dem" after
    fluid, particles, uf_smoothed = _cloud.evolve(
        fluid, particles, state.uf_smoothed, grid, bcs,
        cfg.cloud, cfg.dem, cfg.fluid, smoother, shard)

    fluid = _cloud.lift_drag_coeffs(fluid, particles, uf_smoothed, grid,
                                    bcs, cfg.cloud, cfg.fluid, smoother,
                                    shard)
    telemetry.mark("coupling", dev)

    return SimState(fluid, particles, uf_smoothed, state.uf_smoothed)


class CoupledStep(nn.Module):
    """coupled_step with its constant operators built once: the
    diffusion-smoothing solver and the pressure preconditioner are
    buffers-only submodules, so .to(device) moves them. forward(state)
    is one coupled step. Built on `device`: by default the CUDA card;
    device="cpu" for the CPU."""

    def __init__(self, cfg: SimConfig, dtype=torch.float64, device=None):
        super().__init__()
        from sedifoam_tpu_torch import default_device, full_f32_precision
        device = default_device(device)
        full_f32_precision()
        self.cfg = cfg
        self.device = device
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


class GraphedStep:
    """A CoupledStep captured as a CUDA graph (graphs.StepGraph) and
    replayed once per call: step(state) -> state after one coupled step.
    One graph per particle capacity: a state of another capacity (the
    runner's active window grew) frees the graph and captures anew, as
    jax.jit retraces per shape. The returned state is the graph's own
    buffers, valid until the next call; a call on it steps it without a
    host copy. A capture that fails raises."""

    CAPTURES = 0            # captures made in this process, all steps

    def __init__(self, step: CoupledStep):
        self.step = step
        self.graph = None
        self.captures = 0
        self.capture_seconds = 0.0

    def __call__(self, state: SimState) -> SimState:
        cap = state.particles.n_capacity
        if self.graph is None or self.graph.capacity != cap:
            self.graph = None                    # free the old one first
            # the capture's warm-up step is thrown away: its solves,
            # rebuilds and clock marks do not count (its chain launches
            # do, as launches of the kernel)
            saved = telemetry.snapshot(telemetry.CAPTURE_RESTORED)
            g = graphs.StepGraph(self.step).capture(state)
            telemetry.restore(saved, telemetry.CAPTURE_RESTORED)
            g.capacity = cap
            self.graph = g
            self.captures += 1
            GraphedStep.CAPTURES += 1
            self.capture_seconds += g.capture_seconds
        return self.graph.replay(state)


def make_step_fn(cfg: SimConfig, n_sub: int = 1, dtype=torch.float64,
                 device=None):
    """A function advancing n_sub coupled steps: on a CUDA device n_sub
    replays of the captured step (GraphedStep; the result is a copy, so
    the function is pure as the reference's jitted one), elsewhere n_sub
    eager CoupledSteps."""
    step = CoupledStep(cfg, dtype, device)
    on_card = step.device.type == "cuda"
    advance = GraphedStep(step) if on_card else step

    def run(state: SimState) -> SimState:
        for _ in range(n_sub):
            state = advance(state)
        return graphs.tree_map(torch.clone, state) if on_card else state

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
