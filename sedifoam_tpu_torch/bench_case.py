"""The coupled bed case that the reference's ``bench.py::build_case`` times,
built in the port: same grid, boundary conditions, fluid/cloud/DEM
settings and the same ``np.random.RandomState(42)`` jitter of the
particle lattice.

Full width: 131,072 particles at just-touching density (pitch 2.02 r),
a 32x64x32 grid of 2 mm cells, K = 8 neighbor slots, max_per_bin 10,
three plane walls, 10 DEM substeps per fluid step, ErgunWenYu drag,
4-step diffusion smoothing, 2-corrector PISO. backend="dense" gives
bench.py's default all-pairs variant (small sizes only);
backend="lattice" the roll-based bin lattice (dem/lattice.py) with
M = max_per_bin = 10 slots per bin, as bench.py builds it.
"""

from __future__ import annotations

import numpy as np
import torch

from sedifoam_tpu_torch import bc, default_device
from sedifoam_tpu_torch.config import (CloudConfig, DEMConfig, FluidConfig,
                                       PISOConfig, PairParams, WallSpec)
from sedifoam_tpu_torch.dem import lattice
from sedifoam_tpu_torch.dem.state import make_particles
from sedifoam_tpu_torch.fluid.state import FluidBCs, init_fluid
from sedifoam_tpu_torch.grid import Grid
from sedifoam_tpu_torch.solver import SimConfig

FULL = dict(n_particles=131072, nx=32, ny=64, nz=32)


def build_config(n_particles=131072, nx=32, ny=64, nz=32,
                 sub_steps=10, backend="binned",
                 sort_on_rebuild=False) -> SimConfig:
    dx = 2e-3
    grid = Grid(nx=nx, ny=ny, nz=nz, dx=dx, dy=dx, dz=dx)
    zg3 = bc.PatchBC(bc.ZERO_GRADIENT, (0.0, 0.0, 0.0))
    vin = 0.1
    bcs = FluidBCs(
        alpha=bc.make_field_bc({
            "ym": bc.PatchBC(bc.FIXED_VALUE, (0.0,)),
            "yp": bc.PatchBC(bc.INLET_OUTLET, (0.0,))}),
        p=bc.make_field_bc({"yp": bc.PatchBC(bc.FIXED_VALUE, (0.0,))}),
        Ub=bc.make_field_bc({
            "ym": bc.PatchBC(bc.FIXED_VALUE, (0.0, vin, 0.0)),
            "yp": bc.PatchBC(bc.INLET_OUTLET, (0.0, 0.0, 0.0))},
            default=bc.PatchBC(bc.FIXED_VALUE, (0.0, 0.0, 0.0))),
        Ua=bc.make_field_bc({}, default=zg3),
    )
    dt = 5e-5
    fluid_cfg = FluidConfig(
        dt=dt, rhob=1000.0, nub=1e-6, gravity=(0.0, -9.81, 0.0),
        piso=PISOConfig(n_correctors=2, p_tol=1e-6, p_max_iter=150),
    )
    cloud_cfg = CloudConfig(
        drag_model="ErgunWenYu", sub_cycles=1, sub_steps=sub_steps,
        diffusion_band_width=3 * dx, diffusion_steps=4,
        particle_buoyancy=True,
    )
    pair = PairParams(style="hertz_history", kn=1e5, gamman=0.7, xmu=0.3)
    L = (nx * dx, ny * dx, nz * dx)
    walls = (
        WallSpec(style="xplane", lo=0.0, hi=L[0], params=pair),
        WallSpec(style="yplane", lo=0.0, hi=L[1], params=pair),
        WallSpec(style="zplane", lo=0.0, hi=L[2], params=pair),
    )
    r = 5e-4
    dem_cfg = DEMConfig(dt=dt / sub_steps, pair=pair, walls=walls,
                        gravity=(0.0, -9.81, 0.0),
                        backend=backend, nbr_k=8, max_per_bin=10,
                        cutoff=2 * r * 1.6, skin=0.6 * r,
                        audit_ring=2 * r + 0.6 * r,
                        domain_lo=(0.0, 0.0, 0.0), domain_hi=L,
                        sort_on_rebuild=sort_on_rebuild)
    return SimConfig(grid=grid, bcs=bcs, fluid=fluid_cfg, cloud=cloud_cfg,
                     dem=dem_cfg)


def build_state(cfg: SimConfig, n_particles: int, dtype=torch.float32,
                device=None):
    """(fluid, particles) before initialize(): the jittered lattice in
    the lower part of the bed, fluid at the inlet velocity. On `device`:
    by default the CUDA card; device="cpu" for the CPU."""
    device = default_device(device)
    r = 5e-4
    L = cfg.grid.lengths
    rng = np.random.RandomState(42)
    pitch = 2.02 * r
    nxp = int((L[0] - 2 * r) / pitch)
    nzp = int((L[2] - 2 * r) / pitch)
    ii = np.arange(n_particles)
    ix, iz, iy = ii % nxp, (ii // nxp) % nzp, ii // (nxp * nzp)
    pos = np.stack([2 * r + ix * pitch, 2 * r + iy * pitch,
                    2 * r + iz * pitch], axis=1)
    pos += rng.uniform(-0.05 * r, 0.05 * r, pos.shape)
    particles = make_particles(pos=pos, radius=r, density=2500.0,
                               capacity=n_particles,
                               n_walls=len(cfg.dem.walls),
                               neighbor_k=(cfg.dem.nbr_k
                                           if cfg.dem.backend == "binned"
                                           else None),
                               lattice_geom=(lattice.make_geom(cfg.dem)
                                             if cfg.dem.backend == "lattice"
                                             else None),
                               dtype=dtype, device=device)
    Ub = np.zeros((3,) + cfg.grid.shape)
    Ub[1] = 0.1
    fluid = init_fluid(cfg.grid, Ub=Ub, dtype=dtype, device=device)
    return fluid, particles
