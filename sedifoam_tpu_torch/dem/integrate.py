"""DEM time integration: nve/sphere velocity-Verlet with granular fixes
(port of ``sedifoam_tpu/dem/integrate.py``; dense, binned and lattice
backends).

Reproduces one LAMMPS `run N pre no post no` as a Python loop over
substeps:

  initial_integrate (nve/sphere) -> pair+wall contact forces ->
  post_force fixes (gravity, fdrag incl. per-substep added mass,
  cohesion) -> final_integrate

Rigid clumps (dem/rigid.py) replace the per-particle motion of their
members in both integrate halves.

`setup_forces` is the one-time setup() pass (shearupdate off, matching
pair_gran_hertzFix_history.cpp:65-66). The binned and lattice
Verlet-skin rebuild tests are the reference's lax.cond as graphs.cond: a
conditional node in a captured step, one host read per substep when run
eagerly. The dense backend has no table: no rebuild, no scrub, no test.

Every function that steps takes `shard`: None for the whole state, or
one rank's part in a step split over ranks (parallel/mesh.Shard; the
state is then the rank's own block of rows). The forces are the own
rows' against partners in all rows (pos, vel and omega gathered before
each force evaluation): the contact chain, cohesion and lubrication
alike; the walls are per row. The rebuild test's largest displacement
is the largest over the ranks, and a rebuild runs on the gathered state
on every rank alike, then cuts the own block out again. The lattice's
slot table and history are whole on every rank (parallel/mesh.py): its
force pass and rebuild run on the gathered rows, alike on every rank,
and each rank keeps its own rows' force and torque. The rigid bodies are
whole on every rank: their sums take the members' rows of all ranks in
row order (dem/rigid.py).
"""

from __future__ import annotations

import torch

from sedifoam_tpu_torch import device_vector, graphs, telemetry
from sedifoam_tpu_torch.config import DEMConfig
from sedifoam_tpu_torch.dem.cohesion import (cohesion_forces,
                                             cohesion_forces_binned)
from sedifoam_tpu_torch.dem.pair import pair_forces
from sedifoam_tpu_torch.dem.state import ParticleState
from sedifoam_tpu_torch.dem.walls import wall_forces

_INERTIA = 0.4  # solid sphere moment-of-inertia factor (LAMMPS nve/sphere)


def scrub_deactivated(state: ParticleState, cfg: DEMConfig,
                      shard=None) -> ParticleState:
    """Invalidate table slots pointing at deactivated particles (see
    neighbor.scrub_dead_partners): the binned (K, N) table and the
    lattice's (M, S) slot table alike. Idempotent, so callers may run it
    whether or not a particle was deleted. With a shard, the own
    columns against the active flags of all rows (shard.active)."""
    if state.nbr_idx.shape[0] == 0:
        return state
    from sedifoam_tpu_torch.dem.neighbor import scrub_dead_partners
    active = state.active if shard is None else shard.active
    return state._replace(
        nbr_idx=scrub_dead_partners(state.nbr_idx, active))


def _need_rebuild(state: ParticleState, cfg: DEMConfig, shard=None):
    """0-d bool: an active particle moved more than half the skin since
    the last build (periodic axes by the minimum image); with a shard,
    any rank's."""
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
    if shard is not None:
        max_d2 = shard.comm.all_reduce_max(max_d2)
    return max_d2 > (0.5 * cfg.skin) ** 2


def maybe_rebuild_neighbors(state: ParticleState, cfg: DEMConfig,
                            force: bool = False,
                            shard=None) -> ParticleState:
    """Verlet-skin rebuild check (binned and lattice backends): rebuild
    when any active particle moved more than half the skin since the
    last build. The test is the reference's lax.cond (graphs.cond: a
    conditional node inside a captured step); force=True rebuilds
    unconditionally. The dense backend has no table and returns the
    state unchanged.

    Lattice: new slots (lattice.bin_slots) and the shear carried onto
    them (lattice.carry_shear_lattice). No sort (sort_on_rebuild is the
    binned table's) and no nbr_dropped: a bin's overflow is reported by
    the diagnostics' lattice_unslotted. With a shard, from the gathered
    positions, alike on every rank.

    With a shard (binned): the whole state is gathered, rebuilt (sorted,
    binned, its shear carried over) as above on every rank alike, and
    the own block cut out: a particle sorted into another rank's block
    changes ranks here. nbr_dropped, counted on the whole state, is the
    same on every rank.

    Each rebuild adds one to telemetry's ``rebuilds`` counter on the
    device, inside the branch: it counts the rebuilds that ran."""
    if cfg.backend == "lattice":
        from sedifoam_tpu_torch.dem import lattice as _lat

        geom = _lat.make_geom(cfg)

        def do_rebuild_lat(st: ParticleState) -> ParticleState:
            telemetry.count("rebuilds", st.pos.device)
            pos, active = (st.pos, st.active) if shard is None else \
                (shard.comm.all_gather_rows(st.pos), shard.active)
            new_slot, _overflow = _lat.bin_slots(geom, pos, active)
            shear = _lat.carry_shear_lattice(
                st.nbr_idx, new_slot, st.shear, geom, pos.shape[0],
                k_compact=max(16, cfg.nbr_k))
            return st._replace(nbr_idx=new_slot, shear=shear,
                               pos_at_build=st.pos)

        if force:
            return do_rebuild_lat(state)
        return graphs.cond(_need_rebuild(state, cfg, shard), do_rebuild_lat,
                           state)

    if cfg.backend != "binned":
        return state
    from sedifoam_tpu_torch.dem.neighbor import (carry_over_shear,
                                                 make_binner,
                                                 make_sort_order,
                                                 permute_particle_state)

    rebuild_fn = make_binner(cfg.domain_lo, cfg.domain_hi, cfg.cutoff,
                             cfg.nbr_k, cfg.max_per_bin,
                             periodic=cfg.periodic,
                             audit_ring=cfg.audit_ring)
    sort_fn = make_sort_order(cfg.domain_lo, cfg.domain_hi, cfg.cutoff,
                              periodic=cfg.periodic) \
        if cfg.sort_on_rebuild else None

    def do_rebuild(st: ParticleState) -> ParticleState:
        telemetry.count("rebuilds", st.pos.device)
        if sort_fn is not None:
            st = permute_particle_state(st, sort_fn(st.pos, st.active))
        idx, dropped = rebuild_fn(st.pos, st.active)
        if st.rigid is not None:
            # intra-body contacts are excluded at the TABLE (rebuild-time
            # scrub, no per-substep cost), so the contact chain never
            # sees one: members at fixed overlap exert central
            # equal-opposite forces that cancel in the body sums anyway
            # (dem/rigid.py)
            from sedifoam_tpu_torch.dem.rigid import scrub_same_mol
            idx = scrub_same_mol(idx, st.mol)
        shear = carry_over_shear(st.nbr_idx, idx, st.shear)
        return st._replace(nbr_idx=idx, shear=shear, pos_at_build=st.pos,
                           nbr_dropped=torch.maximum(st.nbr_dropped,
                                                     dropped))

    if shard is not None:
        # the whole state gathered, rebuilt and cut: the rows' radius,
        # mass, active and mol of all ranks change with it, so the cond
        # carries them (parallel/mesh.Shard.cond)
        def rebuild_split(st: ParticleState, sh) -> ParticleState:
            return sh.cut(do_rebuild(sh.gather(st)))

        if force:
            return rebuild_split(state, shard)
        return shard.cond(_need_rebuild(state, cfg, shard), rebuild_split,
                          state)

    if force:
        return do_rebuild(state)
    return graphs.cond(_need_rebuild(state, cfg, shard), do_rebuild, state)


def compute_forces(state: ParticleState, cfg: DEMConfig,
                   step_time: float = 0.0, shearupdate: bool = True,
                   shard=None) -> ParticleState:
    """Total force/torque + contact history update, LAMMPS fix order.

    Binned with cfg.fused_chain: the contact chain goes through
    dem.fused.contact_chain, the CUDA kernel for CUDA tensors and its
    plain version for CPU tensors. Walls the kernel cannot take
    (cylinder, wiggle, shear) run through walls.wall_forces beside it.
    Dense: the all-pairs pair.pair_forces. Lattice: the half-offset rolls
    of lattice.lattice_pair_forces, the walls always through
    walls.wall_forces (the reference fuses no wall on this backend);
    cohesion and lubrication are not wired there and raise.
    With a shard, the contact chain (or the dense pairs), cohesion and
    lubrication take the own rows against the gathered rows of all
    (shard.view, rows=shard.rows); the lattice runs on the gathered rows
    and keeps the own rows; the rest is per row.
    """
    dt = cfg.dt
    plen = cfg.periodic_len()
    fused_wall_shear = None
    rows = None if shard is None else shard.rows
    contacts = state if shard is None else shard.view(state)
    if cfg.backend == "dense":
        f_pair, tq_pair, shear = pair_forces(contacts, cfg.pair, dt,
                                             shearupdate, periodic_len=plen,
                                             rows=rows)
    elif cfg.backend == "lattice":
        from sedifoam_tpu_torch.dem import lattice as _lat
        if cfg.cohesion is not None or cfg.lubrication is not None:
            raise NotImplementedError(
                "cohesion/lubrication are not wired for the lattice "
                "backend; use backend='binned'")
        f_pair, tq_pair, shear = _lat.lattice_pair_forces(
            contacts, cfg, _lat.make_geom(cfg), state.nbr_idx, state.shear,
            shearupdate)
        if shard is not None:
            f_pair, tq_pair = shard.own(f_pair), shard.own(tq_pair)
    elif cfg.fused_chain:
        from sedifoam_tpu_torch.dem.fused import contact_chain, walls_fusible
        fuse_walls = cfg.walls if walls_fusible(cfg.walls) else ()
        f_pair, tq_pair, shear, fused_wall_shear = contact_chain(
            contacts, cfg.pair, dt, state.nbr_idx, shearupdate,
            periodic_len=plen, walls=fuse_walls, rows=rows)
    else:
        from sedifoam_tpu_torch.dem.neighbor import pair_forces_binned
        f_pair, tq_pair, shear = pair_forces_binned(
            contacts, cfg.pair, dt, state.nbr_idx, shearupdate,
            periodic_len=plen, rows=rows)
    if fused_wall_shear is not None:
        # wall pass already fused into the chain
        f_wall = torch.zeros_like(state.vel)
        tq_wall = torch.zeros_like(state.vel)
        wall_shear = fused_wall_shear
    else:
        f_wall, tq_wall, wall_shear = wall_forces(
            state, cfg.walls, dt, step_time, shearupdate)

    g = device_vector(tuple(cfg.gravity), state.vel.dtype,
                      state.vel.device)
    f_grav = state.mass[:, None] * g[None, :]

    # fix fdrag post_force (fix_fluid_drag.cpp:114-164)
    f_drag = state.fdrag
    v_old = state.v_old
    if cfg.carrier_rho != 0.0:
        acc = (state.vel - v_old) / dt
        f_drag = f_drag + (cfg.carrier_rho / state.density)[:, None] * (
            0.5 * state.mass[:, None] * (state.dudt - acc))
    v_old = state.vel

    if cfg.backend == "binned":
        f_cohe = cohesion_forces_binned(contacts, cfg.cohesion,
                                        state.nbr_idx, periodic_len=plen,
                                        rows=rows)
    else:
        f_cohe = cohesion_forces(contacts, cfg.cohesion, periodic_len=plen,
                                 rows=rows)

    force = f_pair + f_wall + f_grav + f_drag + f_cohe
    torque = tq_pair + tq_wall

    if cfg.lubrication is not None:
        # wall-bounded suspension volume for the VF-corrected FLD terms
        # (pair_lubricate_poly.cpp:514-539, recomputed per step for
        # moving walls :152-177); falls back to the data-file box when
        # no plane walls bound the domain
        from sedifoam_tpu_torch.dem import lubrication as _lub
        vol_T = None
        if cfg.walls:
            vol_T = _lub.wall_bounded_volume(cfg.domain_lo, cfg.domain_hi,
                                             cfg.walls, step_time)
        if cfg.backend == "binned":
            f_lub, tq_lub = _lub.lubrication_forces_binned(
                contacts, cfg.lubrication, state.nbr_idx, periodic_len=plen,
                vol_T=vol_T, rows=rows)
        else:
            f_lub, tq_lub = _lub.lubrication_forces(
                contacts, cfg.lubrication, periodic_len=plen, vol_T=vol_T,
                rows=rows)
        force = force + f_lub
        torque = torque + tq_lub

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


def _substep(state: ParticleState, cfg: DEMConfig, step_time, shard=None):
    dtf = 0.5 * cfg.dt

    def inverses(st):
        one = torch.ones_like(st.mass)
        zero = torch.zeros_like(st.mass)
        return (torch.where(st.active, one / st.mass, zero)[:, None],
                torch.where(st.active,
                            one / (_INERTIA * st.mass * st.radius ** 2),
                            zero)[:, None])

    minv, iinv = inverses(state)

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

    # rigid clumps (fix rigid/small molecule): body velocity-Verlet
    # OVERWRITES member pos/vel/omega; the per-particle drift above is
    # discarded for members (dem/rigid.py)
    if state.rigid is not None:
        from sedifoam_tpu_torch.dem import rigid as _rig
        state = _rig.initial_integrate(state, cfg.dt, cfg.domain_lo,
                                       cfg.domain_hi, cfg.periodic, shard)

    # neighbor maintenance + forces at the new positions
    state = maybe_rebuild_neighbors(state, cfg, shard=shard)
    if cfg.sort_on_rebuild:
        # a rebuild may have permuted the rows: the inverse masses follow
        # them (the reference keeps the ones it took before the rebuild,
        # which is the same thing only while every particle has one mass
        # and radius and no row is inactive)
        minv, iinv = inverses(state)
    state = compute_forces(state, cfg, step_time, shearupdate=True,
                           shard=shard)

    # final_integrate
    vel = state.vel + dtf * state.force * minv
    omega = state.omega + dtf * state.torque * iinv
    state = state._replace(vel=vel, omega=omega)
    if state.rigid is not None:
        from sedifoam_tpu_torch.dem import rigid as _rig
        state = _rig.final_integrate(state, cfg.dt, shard)
    return state


def run_dem(state: ParticleState, cfg: DEMConfig, n_steps: int,
            t0: float = 0.0, shard=None) -> ParticleState:
    """Advance n_steps DEM substeps (lammps_step equivalent)."""
    for i in range(n_steps):
        state = _substep(state, cfg, t0 + i * cfg.dt, shard)
    return state
