"""Case-level validators of the port (the counterparts of
``scripts/validate_irregular.py``, ``validate_bedload.py``,
``validate_suspended.py``, ``validate_dune.py``, ``validate_jetflow.py``,
``validate_xiaocase1.py``, ``validate_expMueller.py``,
``validate_wachem.py``, ``validate_bl24.py``, the trace check of
``tests/test_golden_collide.py``, ``scripts/run_all_cases.py`` and
``scripts/generate_report.py``).

Each module runs with ``python -m`` and has a ``main(argv)`` that prints
one JSON line and returns the result dict, so tests and chip_smoke.py
call it in-process. The transport, irregular and jetFlow case
directories are written by ``sedifoam_tpu_torch.cases``; the reference's
own auto-testing and example cases (xiaocase1, expMueller06/09,
expWachem_PCM, BL24-TH1, multiParticlesCollide) are read from a
directory of the reference's cases that the caller names (the battery's
--cases-dir, a validator's --case, or ``$SEDIFOAM_CASES_DIR``). Every
validator runs on the CUDA card unless ``--device``
names another device.
"""

import dataclasses
import os
import re

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS = os.path.join(REPO, "results")
# the reference's case tree (auto-testing/test-cases/<case>,
# example-cases/<case>): $SEDIFOAM_CASES_DIR, else none (the reference's
# cases are then not run unless --cases-dir or --case names them)
CASES_DIR = os.environ.get("SEDIFOAM_CASES_DIR") or None
TEST_CASES = os.path.join("auto-testing", "test-cases")
EXAMPLE_CASES = "example-cases"
# what io.case.load_case reads from every case directory
LOADER_FILES = ("system/controlDict", "system/fvSolution",
                "constant/polyMesh/blockMeshDict",
                "constant/transportProperties",
                "constant/environmentalProperties",
                "constant/cloudProperties", "0/alpha", "0/p", "in.lammps")


def ref_case(*rel):
    """The path `rel` under CASES_DIR, or None where no tree is set."""
    return os.path.join(CASES_DIR, *rel) if CASES_DIR else None


def missing_files(case_dir, extra=()) -> list:
    """The files of `case_dir` that a run needs and that are absent, as
    paths relative to it: the loader's, the data file that in.lammps's
    read_data names, and `extra`."""
    need = list(LOADER_FILES) + list(extra)
    lmp = os.path.join(case_dir, "in.lammps")
    if os.path.isfile(lmp):
        with open(lmp) as f:
            m = re.search(r"^\s*read_data\s+(\S+)", f.read(), re.M)
        if m:
            need.append(m.group(1))
    return [rel for rel in need
            if not os.path.isfile(os.path.join(case_dir, rel))]


def torch_out(path: str) -> str:
    """`path` with its file name prefixed `torch_` (unless it is): the
    port's validators never write over the reference's results/ files."""
    if not path:
        return path
    head, name = os.path.split(path)
    return path if name.startswith("torch_") else os.path.join(
        head, "torch_" + name)


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
