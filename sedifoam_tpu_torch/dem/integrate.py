"""DEM time integration: nve/sphere velocity-Verlet with granular fixes
(port of ``sedifoam_tpu/dem/integrate.py``, binned backend only).

Reproduces one LAMMPS `run N pre no post no` as a Python loop over
substeps:

  initial_integrate (nve/sphere) -> pair+wall contact forces ->
  post_force fixes (gravity, fdrag incl. per-substep added mass) ->
  final_integrate

`setup_forces` is the one-time setup() pass (shearupdate off, matching
pair_gran_hertzFix_history.cpp:65-66). The Verlet-skin rebuild test is
Python control flow: one host sync per substep.
"""

from __future__ import annotations

import torch

from sedifoam_tpu_torch.config import DEMConfig
from sedifoam_tpu_torch.dem.state import ParticleState
from sedifoam_tpu_torch.dem.walls import wall_forces

_INERTIA = 0.4  # solid sphere moment-of-inertia factor (LAMMPS nve/sphere)


def _require_ported(cfg: DEMConfig):
    if cfg.backend != "binned":
        raise NotImplementedError(
            f"DEMConfig.backend={cfg.backend!r}: only 'binned' is ported")
    if cfg.cohesion is not None:
        raise NotImplementedError("DEMConfig.cohesion is not ported")
    if cfg.lubrication is not None:
        raise NotImplementedError("DEMConfig.lubrication is not ported")
    if cfg.sort_on_rebuild:
        raise NotImplementedError("DEMConfig.sort_on_rebuild is not ported")


def scrub_deactivated(state: ParticleState, cfg: DEMConfig) -> ParticleState:
    """Invalidate table slots pointing at deactivated particles (see
    neighbor.scrub_dead_partners). Idempotent, so callers may run it
    whether or not a particle was deleted."""
    if state.nbr_idx.shape[0] == 0:
        return state
    from sedifoam_tpu_torch.dem.neighbor import scrub_dead_partners
    return state._replace(
        nbr_idx=scrub_dead_partners(state.nbr_idx, state.active))


def maybe_rebuild_neighbors(state: ParticleState, cfg: DEMConfig,
                            force: bool = False) -> ParticleState:
    """Verlet-skin rebuild check (binned backend): rebuild when any
    active particle moved more than half the skin since the last build."""
    _require_ported(cfg)
    from sedifoam_tpu_torch.dem.neighbor import carry_over_shear, make_binner

    if not force:
        disp = state.pos - state.pos_at_build
        cols = []
        for a in range(3):
            da = disp[:, a]
            if cfg.periodic[a]:
                L = cfg.domain_hi[a] - cfg.domain_lo[a]
                da = da - L * torch.round(da / L)
            cols.append(da)
        disp = torch.stack(cols, dim=-1)
        max_d2 = torch.max(torch.sum(disp * disp, dim=-1) * state.active)
        if not bool(max_d2 > (0.5 * cfg.skin) ** 2):   # host sync
            return state

    rebuild_fn = make_binner(cfg.domain_lo, cfg.domain_hi, cfg.cutoff,
                             cfg.nbr_k, cfg.max_per_bin,
                             periodic=cfg.periodic,
                             audit_ring=cfg.audit_ring)
    idx, dropped = rebuild_fn(state.pos, state.active)
    shear = carry_over_shear(state.nbr_idx, idx, state.shear)
    return state._replace(nbr_idx=idx, shear=shear, pos_at_build=state.pos,
                          nbr_dropped=torch.maximum(state.nbr_dropped,
                                                    dropped))


def compute_forces(state: ParticleState, cfg: DEMConfig,
                   step_time: float = 0.0, shearupdate: bool = True
                   ) -> ParticleState:
    """Total force/torque + contact history update, LAMMPS fix order.

    With cfg.fused_chain the contact chain goes through
    dem.fused.contact_chain: the CUDA kernel for CUDA tensors, its plain
    version for CPU tensors. Walls the kernel cannot take (cylinder,
    wiggle, shear) run through walls.wall_forces beside it.
    """
    _require_ported(cfg)
    dt = cfg.dt
    plen = cfg.periodic_len()
    fused_wall_shear = None
    if cfg.fused_chain:
        from sedifoam_tpu_torch.dem.fused import contact_chain, walls_fusible
        fuse_walls = cfg.walls if walls_fusible(cfg.walls) else ()
        f_pair, tq_pair, shear, fused_wall_shear = contact_chain(
            state, cfg.pair, dt, state.nbr_idx, shearupdate,
            periodic_len=plen, walls=fuse_walls)
    else:
        from sedifoam_tpu_torch.dem.neighbor import pair_forces_binned
        f_pair, tq_pair, shear = pair_forces_binned(
            state, cfg.pair, dt, state.nbr_idx, shearupdate,
            periodic_len=plen)
    if fused_wall_shear is not None:
        # wall pass already fused into the chain
        f_wall = torch.zeros_like(state.vel)
        tq_wall = torch.zeros_like(state.vel)
        wall_shear = fused_wall_shear
    else:
        f_wall, tq_wall, wall_shear = wall_forces(
            state, cfg.walls, dt, step_time, shearupdate)

    g = torch.tensor(cfg.gravity, dtype=state.vel.dtype,
                     device=state.vel.device)
    f_grav = state.mass[:, None] * g[None, :]

    # fix fdrag post_force (fix_fluid_drag.cpp:114-164)
    f_drag = state.fdrag
    v_old = state.v_old
    if cfg.carrier_rho != 0.0:
        acc = (state.vel - v_old) / dt
        f_drag = f_drag + (cfg.carrier_rho / state.density)[:, None] * (
            0.5 * state.mass[:, None] * (state.dudt - acc))
    v_old = state.vel

    force = f_pair + f_wall + f_grav + f_drag
    torque = tq_pair + tq_wall

    if cfg.frozen_types:
        # `fix ... freeze`: zero total force/torque of the frozen types
        frozen = torch.zeros_like(state.active)
        for t in cfg.frozen_types:
            frozen = frozen | (state.ptype == t)
        force = torch.where(frozen[:, None], torch.zeros_like(force), force)
        torque = torch.where(frozen[:, None], torch.zeros_like(torque),
                             torque)

    amask = state.active[:, None]
    return state._replace(
        force=torch.where(amask, force, torch.zeros_like(force)),
        torque=torch.where(amask, torque, torch.zeros_like(torque)),
        shear=shear,
        wall_shear=wall_shear,
        v_old=torch.where(amask, v_old, torch.zeros_like(v_old)),
    )


def setup_forces(state: ParticleState, cfg: DEMConfig,
                 step_time: float = 0.0) -> ParticleState:
    """LAMMPS setup(): compute initial forces without advancing shear."""
    state = maybe_rebuild_neighbors(state, cfg, force=True)
    return compute_forces(state, cfg, step_time, shearupdate=False)


def _substep(state: ParticleState, cfg: DEMConfig, step_time):
    dtf = 0.5 * cfg.dt
    one = torch.ones_like(state.mass)
    zero = torch.zeros_like(state.mass)
    minv = torch.where(state.active, one / state.mass, zero)[:, None]
    iinv = torch.where(state.active,
                       one / (_INERTIA * state.mass * state.radius ** 2),
                       zero)[:, None]

    # initial_integrate (nve/sphere)
    vel = state.vel + dtf * state.force * minv
    pos = state.pos + cfg.dt * vel * state.active[:, None]
    # periodic wrap (LAMMPS Domain::pbc)
    if any(cfg.periodic):
        cols = []
        for a in range(3):
            pa = pos[:, a]
            if cfg.periodic[a]:
                lo = cfg.domain_lo[a]
                L = cfg.domain_hi[a] - lo
                pa = lo + torch.remainder(pa - lo, L)
            cols.append(pa)
        pos = torch.stack(cols, dim=-1)
    omega = state.omega + dtf * state.torque * iinv
    state = state._replace(pos=pos, vel=vel, omega=omega)

    # neighbor maintenance + forces at the new positions
    state = maybe_rebuild_neighbors(state, cfg)
    state = compute_forces(state, cfg, step_time, shearupdate=True)

    # final_integrate
    vel = state.vel + dtf * state.force * minv
    omega = state.omega + dtf * state.torque * iinv
    return state._replace(vel=vel, omega=omega)


def run_dem(state: ParticleState, cfg: DEMConfig, n_steps: int,
            t0: float = 0.0) -> ParticleState:
    """Advance n_steps DEM substeps (lammps_step equivalent)."""
    for i in range(n_steps):
        state = _substep(state, cfg, t0 + i * cfg.dt)
    return state
