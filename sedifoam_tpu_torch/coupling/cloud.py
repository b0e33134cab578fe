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

With injection on, each subcycle first runs inject.maybe_add_delete. Its
`lax.cond`s in the reference are graphs.conds here (conditional nodes in
a captured step): whether an add fired and whether the delete box
removed anyone stay on the device; an eager step reads them on the host
(inject.SYNCS counts those reads).

`shard` (parallel/mesh.Shard, None for the whole state): the particles
are one rank's own block of rows of a step split over ranks; the DEM,
the injection and deletion and the particle-to-grid scatters take it
(dem/integrate.py, dem/inject.py, transfer.py). The injection sites are
the whole domain's (`grid.domain`), on every rank.
The fluid is whole on every rank, or, where `grid` is a slab of it
(grid.SlabGrid), split along grid-x: the transfers then exchange with
the other slabs (transfer.py).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import torch

from sedifoam_tpu_torch import bc as _bc
from sedifoam_tpu_torch import graphs, telemetry
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


def _delete_outside(state: ParticleState, grid: Grid, dcfg: DEMConfig,
                    shard=None) -> ParticleState:
    """Deactivate particles that left the fluid domain (OpenFOAM deletes
    them on wall-patch hit during Cloud::move). Periodic axes never
    delete — particles wrap instead.

    The neighbor table is then scrubbed of dead partners. The reference
    gates the scrub on an actual deletion; the scrub is idempotent, so
    it runs every time here and needs no decision.
    """
    lo = (grid.x0, grid.y0, grid.z0)
    hi = grid.hi
    inside = torch.ones_like(state.active)
    for a in range(3):
        if not dcfg.periodic[a]:
            inside &= (state.pos[:, a] >= lo[a]) & (state.pos[:, a] <= hi[a])
    state = state._replace(active=state.active & inside)
    if shard is not None:
        shard.set_active(state.active)
    return _dem.scrub_deactivated(state, dcfg, shard)


def evolve(fluid: FluidState, particles: ParticleState,
           uf_smoothed_old, grid: Grid, bcs: FluidBCs,
           ccfg: CloudConfig, dcfg: DEMConfig, fcfg: FluidConfig,
           smoother=None, shard=None
           ) -> Tuple[FluidState, ParticleState, torch.Tensor]:
    """One full evolve(). Returns (fluid', particles', UfSmoothed).
    `smoother` is the prebuilt smoothing FastDiag (built when None).
    The phase clock (telemetry.mark) closes "coupling" before each run
    of the DEM substeps and "dem" after it."""
    smooth = _smooth_fn(grid, ccfg, smoother)
    dev = fluid.p.device
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

    # static injection sites (findAddParticleCells analogue)
    inject_on = ccfg.add_particle > 0 or ccfg.delete_particle > 0
    if inject_on:
        from sedifoam_tpu_torch.dem import inject as _inject
        domain = grid.domain
        sites = domain.const(
            ("inject_sites", tuple(ccfg.add_box), ccfg.reduce_number_factor),
            lambda: _inject.seed_positions(domain, ccfg.add_box,
                                           ccfg.reduce_number_factor),
            particles.pos.dtype, particles.pos.device)

    alpha, Ua = fluid.alpha, fluid.Ua
    for k in range(ccfg.sub_cycles):
        if inject_on:
            particles_, tta, key, added, deleted = _inject.maybe_add_delete(
                particles, particles.time_to_add, particles.rng_key,
                sites, grid, ccfg, fcfg.dt, shard)
            particles = particles_._replace(time_to_add=tta, rng_key=key)

            def setup(st, sh=shard):
                # newly added particles need a fresh neighbor table and
                # forces (their reused slots carry stale rows)
                st = _dem.maybe_rebuild_neighbors(st, dcfg, force=True,
                                                  shard=sh)
                return _dem.compute_forces(st, dcfg, shearupdate=False,
                                           shard=sh)

            # the reference's cond(added, setup, cond(deleted, scrub)) as
            # two conds in a row: deletions alone need no rebuild, but
            # stale partners must leave the table
            # (tests/test_ghost_partner.py)
            if ccfg.add_particle > 0:
                _inject.count_sync()
                # with a shard the rebuild changes its gathered arrays:
                # Shard.cond carries them
                particles = graphs.cond(added, setup, particles) \
                    if shard is None else shard.cond(added, setup, particles)
            if ccfg.delete_particle > 0 and len(ccfg.delete_box) == 6:
                _inject.count_sync()
                particles = graphs.cond(
                    deleted & ~added,
                    lambda st: _dem.scrub_deactivated(st, dcfg, shard),
                    particles)

        p_drag, p_dudt, particles = _forces.particle_forces(
            particles, uf_smoothed, uf_smoothed_old, grad_p, curl_u,
            fluid.DDtUb, grid, ccfg, fcfg, alpha, fluid.step,
            need_dudt=(ccfg.particle_added_mass or dcfg.carrier_rho != 0.0))

        # p.UOld() = pre-DEM velocity (softParticleCloud.C:570). It rides
        # the state through the substeps, so a bin-sorted rebuild
        # (DEMConfig.sort_on_rebuild) permutes it with its rows; nothing
        # reads it before the next particle_forces
        particles = particles._replace(fdrag=p_drag, dudt=p_dudt,
                                       vel_fluid_old=particles.vel)
        telemetry.mark("coupling", dev)
        particles = _dem.run_dem(particles, dcfg, ccfg.sub_steps, t0=0.0,
                                 shard=shard)
        telemetry.mark("dem", dev)

        if ccfg.delete_outside:
            particles = _delete_outside(particles, grid, dcfg, shard)

        if k == 0:
            alpha, Ua = _transfer.particle_to_eulerian(
                particles, grid, smooth, ccfg.alpha_smooth, ccfg.up_smooth,
                shard)

    fluid = fluid._replace(alpha=alpha, Ua=Ua)
    return fluid, particles, uf_smoothed


def lift_drag_coeffs(fluid: FluidState, particles: ParticleState,
                     uf_smoothed, grid: Grid, bcs: FluidBCs,
                     ccfg: CloudConfig, fcfg: FluidConfig,
                     smoother=None, shard=None) -> FluidState:
    """liftDragCoeffs.H + calcTcFields: alpha cap, Asrc, lift coefficient
    (and the implicit drag coefficient Omega with the semi-implicit drag)."""
    smooth = _smooth_fn(grid, ccfg, smoother)

    # cap unphysical alpha (liftDragCoeffs.H:6-14)
    alpha = torch.clamp(fluid.alpha, max=fcfg.max_possible_alpha)

    # calcTcFields: per-particle Jd at current state (alpha + Uf in one
    # packed row gather)
    cells = _transfer.particle_cells(particles, grid)
    p_alpha, uf_at_p = _transfer.gather_fields(cells, alpha, uf_smoothed,
                                               grid=grid)
    uri = uf_at_p - particles.vel
    mag_uri = torch.sqrt(torch.sum(uri * uri, dim=-1))
    d = torch.clamp(2.0 * particles.radius, min=1e-300)
    jd_vals = _drag.jd(ccfg.drag_model, mag_uri, p_alpha, d,
                       fcfg.nub, fcfg.rhob)

    if ccfg.semi_implicit_drag:
        # dormant reference branch (enhancedCloud.C:338-360): Omega on the
        # momentum diagonal makes stiff gas-solid drag unconditionally
        # stable; Asrc carries omg*U_p through the flux
        drag_coef, asrc = _transfer.calc_omega_asrc_semi(
            particles, jd_vals, grid, shard)
    else:
        asrc = _transfer.calc_asrc(particles, jd_vals, uf_smoothed, alpha,
                                   grid, smooth, ccfg.drag_smooth,
                                   uf_at_p=uf_at_p, shard=shard)
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
