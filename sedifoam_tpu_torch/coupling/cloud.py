"""Subcycled particle evolution (enhancedCloud::evolve,
enhancedCloud.C:669-787) and the post-move coupling-source computation
(calcTcFields via liftDragCoeffs.H); port of
``sedifoam_tpu/coupling/cloud.py``.

Per fluid step:
  1. UfSmoothed = smooth((1-gamma) Uf)/(1-gamma)
  2. for k in subCycles:
       - 7-force per-particle sum (forces.py)
       - subSteps DEM substeps with the force held constant (fdrag fix)
       - delete particles that left the domain (softParticle.C:177-184)
       - k == 0: particleToEulerianField -> (alpha, Ua)
  3. liftDragCoeffs.H: cap alpha, calcTcFields -> Asrc, lift coefficient

Particle injection and the semi-implicit drag are not ported.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import torch

from sedifoam_tpu_torch import bc as _bc
from sedifoam_tpu_torch import ops
from sedifoam_tpu_torch.config import CloudConfig, DEMConfig, FluidConfig
from sedifoam_tpu_torch.coupling import drag as _drag
from sedifoam_tpu_torch.coupling import forces as _forces
from sedifoam_tpu_torch.coupling import smoothing as _smoothing
from sedifoam_tpu_torch.coupling import transfer as _transfer
from sedifoam_tpu_torch.dem import integrate as _dem
from sedifoam_tpu_torch.dem.state import ParticleState
from sedifoam_tpu_torch.fluid.state import FluidBCs, FluidState
from sedifoam_tpu_torch.grid import Grid


def _smooth_fn(grid: Grid, ccfg: CloudConfig, solver=None):
    return partial(_smoothing.smooth, grid=grid,
                   bandwidth=ccfg.diffusion_band_width,
                   steps=ccfg.diffusion_steps,
                   direction=ccfg.smooth_direction, solver=solver)


def _delete_outside(state: ParticleState, grid: Grid, dcfg: DEMConfig
                    ) -> ParticleState:
    """Deactivate particles that left the fluid domain (OpenFOAM deletes
    them on wall-patch hit during Cloud::move). Periodic axes never
    delete — particles wrap instead.

    The neighbor table is then scrubbed of dead partners. The reference
    gates the scrub on an actual deletion; the scrub is idempotent, so
    it runs every time here and saves a host sync.
    """
    lo = (grid.x0, grid.y0, grid.z0)
    hi = grid.hi
    inside = torch.ones_like(state.active)
    for a in range(3):
        if not dcfg.periodic[a]:
            inside &= (state.pos[:, a] >= lo[a]) & (state.pos[:, a] <= hi[a])
    state = state._replace(active=state.active & inside)
    return _dem.scrub_deactivated(state, dcfg)


def evolve(fluid: FluidState, particles: ParticleState,
           uf_smoothed_old, grid: Grid, bcs: FluidBCs,
           ccfg: CloudConfig, dcfg: DEMConfig, fcfg: FluidConfig,
           smoother=None) -> Tuple[FluidState, ParticleState, torch.Tensor]:
    """One full evolve(). Returns (fluid', particles', UfSmoothed).
    `smoother` is the prebuilt smoothing FastDiag (built when None)."""
    if ccfg.add_particle > 0 or ccfg.delete_particle > 0:
        raise NotImplementedError(
            "CloudConfig.add_particle/delete_particle (injection) is not "
            "ported")
    smooth = _smooth_fn(grid, ccfg, smoother)
    gamma = fluid.alpha

    uf = fluid.Ub
    if ccfg.uf_smooth:
        uf_smoothed = _transfer.weighted_smooth_uf(uf, gamma, smooth)
    else:
        uf_smoothed = uf

    # frozen during the subcycle loop (p, Ub unchanged inside evolve)
    grad_p = ops.grad(fluid.p, grid, bcs.p, t=fluid.time)
    curl_u = ops.curl(fluid.Ub, grid, bcs.Ub, t=fluid.time) \
        if ccfg.particle_lift else None

    alpha, Ua = fluid.alpha, fluid.Ua
    for k in range(ccfg.sub_cycles):
        p_drag, p_dudt, particles = _forces.particle_forces(
            particles, uf_smoothed, uf_smoothed_old, grad_p, curl_u,
            fluid.DDtUb, grid, ccfg, fcfg, alpha, fluid.step,
            need_dudt=(ccfg.particle_added_mass or dcfg.carrier_rho != 0.0))

        vel_before = particles.vel
        particles = particles._replace(fdrag=p_drag, dudt=p_dudt)
        particles = _dem.run_dem(particles, dcfg, ccfg.sub_steps, t0=0.0)
        # p.UOld() = pre-DEM velocity (softParticleCloud.C:570)
        particles = particles._replace(vel_fluid_old=vel_before)

        if ccfg.delete_outside:
            particles = _delete_outside(particles, grid, dcfg)

        if k == 0:
            alpha, Ua = _transfer.particle_to_eulerian(
                particles, grid, smooth, ccfg.alpha_smooth, ccfg.up_smooth)

    fluid = fluid._replace(alpha=alpha, Ua=Ua)
    return fluid, particles, uf_smoothed


def lift_drag_coeffs(fluid: FluidState, particles: ParticleState,
                     uf_smoothed, grid: Grid, bcs: FluidBCs,
                     ccfg: CloudConfig, fcfg: FluidConfig,
                     smoother=None) -> FluidState:
    """liftDragCoeffs.H + calcTcFields: alpha cap, Asrc, lift coefficient."""
    if ccfg.semi_implicit_drag:
        raise NotImplementedError(
            "CloudConfig.semi_implicit_drag is not ported")
    smooth = _smooth_fn(grid, ccfg, smoother)

    # cap unphysical alpha (liftDragCoeffs.H:6-14)
    alpha = torch.clamp(fluid.alpha, max=fcfg.max_possible_alpha)

    # calcTcFields: per-particle Jd at current state (alpha + Uf in one
    # packed row gather)
    cells = _transfer.particle_cells(particles, grid)
    p_alpha, uf_at_p = _transfer.gather_fields(cells, alpha, uf_smoothed)
    uri = uf_at_p - particles.vel
    mag_uri = torch.sqrt(torch.sum(uri * uri, dim=-1))
    d = torch.clamp(2.0 * particles.radius, min=1e-300)
    jd_vals = _drag.jd(ccfg.drag_model, mag_uri, p_alpha, d,
                       fcfg.nub, fcfg.rhob)

    asrc = _transfer.calc_asrc(particles, jd_vals, uf_smoothed, alpha,
                               grid, smooth, ccfg.drag_smooth,
                               uf_at_p=uf_at_p)
    # Omega_ *= 0 (enhancedCloud.C:391): implicit drag disabled
    drag_coef = torch.zeros_like(alpha)

    # liftCoeff = Cl*beta*rhob*(Ur ^ curl U)  (liftDragCoeffs.H:23)
    if fcfg.Cl != 0.0:
        beta = 1.0 - alpha
        Ur = fluid.Ua - fluid.Ub
        U_mix = alpha[None] * fluid.Ua + beta[None] * fluid.Ub
        curl_U = ops.curl(U_mix, grid, _bc.uniform_bc(_bc.ZERO_GRADIENT,
                                                      (0.0, 0.0, 0.0)))
        lift = fcfg.Cl * (beta * fcfg.rhob)[None] * torch.linalg.cross(
            Ur, curl_U, dim=0)
    else:
        # Cl == 0 makes the whole term exact zeros: skip the mixture curl
        lift = torch.zeros_like(fluid.lift_coeff)

    return fluid._replace(alpha=alpha, Asrc=asrc, drag_coef=drag_coef,
                          lift_coeff=lift)
