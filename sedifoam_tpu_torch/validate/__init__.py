"""Case-level validators of the port (the counterparts of
``scripts/validate_irregular.py``, ``validate_bedload.py``,
``validate_suspended.py``, ``validate_dune.py``, ``validate_jetflow.py`` and
``scripts/run_all_cases.py``).

Each module runs with ``python -m`` and has a ``main(argv)`` that prints
one JSON line and returns the result dict, so tests and chip_smoke.py
call it in-process. The case directories are written by
``sedifoam_tpu_torch.cases`` (the reference's are not part of the
repository). Every validator runs on the CUDA card unless ``--device``
names another device.
"""

import dataclasses


def coarsened(cfg, factor: int):
    """cfg on the mesh with every `factor`-th face kept (the domain's end
    faces always), as the reference validators coarsen theirs."""
    if factor <= 1:
        return cfg
    import numpy as np

    from sedifoam_tpu_torch.grid import Grid
    from sedifoam_tpu_torch.utils.postprocess import coarsen_faces
    g = cfg.grid
    grid = Grid.from_faces(*(coarsen_faces(np.asarray(g.axis_faces(a)),
                                           factor) for a in range(3)))
    return dataclasses.replace(cfg, grid=grid)


def semi_implicit(cfg):
    """cfg with the semi-implicit fluid-side drag on: water and dense
    grains put the explicit drag reaction's coupling gain
    dt*Omega/(rhob*beta) far above 2 (tests/test_wachem_explicit.py), and
    the Ubar kick through the bed diverges in a few steps without it."""
    return dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=True))


def load(case_dir, coarsen, device, capacity=8192, neighbor_k=None):
    """(cfg, initialized state) of a written case directory, loaded as
    the reference validators load theirs: binned DEM, f32, capacity
    8,192 (the transport-suspended and -dune scripts: 65,536), the
    loader's K or `neighbor_k` (those two scripts pass 8, which the
    loader raises to what its ring needs), the semi-implicit drag, the
    mesh coarsened `coarsen` times (the fluid then starts anew, at rest,
    on the coarse mesh)."""
    import torch

    from sedifoam_tpu_torch.fluid.state import init_fluid
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.solver import initialize
    cfg, fluid, particles, _ = load_case(
        case_dir, backend="binned", neighbor_k=neighbor_k,
        dtype=torch.float32, capacity=capacity, device=device)
    cfg = semi_implicit(cfg)
    if coarsen > 1:
        cfg = coarsened(cfg, coarsen)
        fluid = init_fluid(cfg.grid, dtype=torch.float32, device=device)
    return cfg, initialize(fluid, particles, cfg)


def settle(cfg, state, t_settle, device, steps_per_host_visit=25):
    """The state after t_settle seconds with the channel forcing off, its
    clock set back to 0 (the transport validators' settling phase: the
    Ubar controller applies its whole velocity correction in one step,
    and a loose bed under that kick diverges)."""
    import torch

    from sedifoam_tpu_torch.config import ChannelForcing
    from sedifoam_tpu_torch.runtime.runner import Simulation
    if t_settle <= 0:
        return state
    cfg_settle = dataclasses.replace(cfg, fluid=dataclasses.replace(
        cfg.fluid, forcing=ChannelForcing(mode="none")))
    sim0 = Simulation(cfg_settle, state,
                      steps_per_host_visit=steps_per_host_visit,
                      device=device)
    sim0.run(t_settle)
    state = sim0.state
    return state._replace(fluid=state.fluid._replace(
        time=torch.zeros_like(state.fluid.time)))


def run_until(sim, t_end, max_wall=None, chunk_steps=250, **run_kw) -> bool:
    """sim.run(t_end), in chunks of `chunk_steps` steps (whole host
    visits, so the steps taken are those of one call) when `max_wall`
    seconds are given: the run stops before a chunk that would pass the
    limit, reckoned from the slowest chunk so far. Returns whether t_end
    was reached. A machine that is cut after a fixed time then still
    reports how far the run came."""
    import time
    if max_wall is None:
        sim.run(t_end, **run_kw)
        return True
    dt = sim.cfg.fluid.dt
    visit = sim.steps_per_visit
    chunk = max(visit, chunk_steps // visit * visit) * dt
    t0 = time.perf_counter()
    t, slowest = sim.t, 0.0
    while t < t_end - 1e-12:
        if time.perf_counter() - t0 + 1.2 * slowest > max_wall:
            return False
        c0 = time.perf_counter()
        # half a step short of the chunk's end: f32 time carries round-off
        sim.run(min(t_end, t + chunk - 0.5 * dt), **run_kw)
        slowest = max(slowest, time.perf_counter() - c0)
        t = sim.t
    return True


def finite(state) -> bool:
    """p and the particle velocities are finite."""
    import torch
    return bool(torch.isfinite(state.fluid.p).all()
                and torch.isfinite(state.particles.vel).all())
