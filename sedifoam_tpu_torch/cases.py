"""Cases built in code for the port's runner: the xiaocase3 golden case
and a jetFlow-pattern injection column.

``xiaocase3`` is the case of tests/test_golden_xiaocase3.py (the
reference's cases/auto-testing/test-cases/xiaocase3, built from its own
dictionaries): one 0.083 mm, 2000 kg/m^3 sphere entrained by a 0.05 m/s
upward flow in a 4x4x0.5 mm quasi-2D duct, SyamlalOBrien drag, no
gravity, the dense DEM backend with 100 substeps per fluid step.

``inject_case`` follows tests/test_window.py's injection column at
jetFlow's capacity (65,536): a 2 mm grid fed by an add box one cell
layer thick over the inlet (one site per inlet cell), cleared before
each add, and a delete box over the top two cell layers. The add box is
a thin slab around the inlet cells' centre plane, so particles injected
at the inlet velocity leave it before the next add and the population
grows by one layer per add; the layers are spaced wider than a particle
diameter, so they do not collide.
"""

from __future__ import annotations

import numpy as np
import torch

from sedifoam_tpu_torch import bc
from sedifoam_tpu_torch.config import (CloudConfig, DEMConfig, FluidConfig,
                                       PISOConfig, PairParams, WallSpec)
from sedifoam_tpu_torch.dem.state import make_particles
from sedifoam_tpu_torch.fluid.state import FluidBCs, init_fluid
from sedifoam_tpu_torch.grid import Grid
from sedifoam_tpu_torch.solver import SimConfig, adjust_dem_timestep


def xiaocase3(dtype=torch.float64, device=None):
    """(cfg, fluid, particles) of xiaocase3, before initialize()."""
    # blockMeshDict: 4x4x0.5 mm box, 10x10x1 cells
    grid = Grid(nx=10, ny=10, nz=1, dx=4e-4, dy=4e-4, dz=5e-4)

    emp = bc.PatchBC(bc.EMPTY)
    # 0/Ub: inlet (ym) fixedValue (0 0.05 0); outlet (yp) inletOutlet;
    # walls (xm, xp) fixedValue 0
    vin = 0.05
    bcs = FluidBCs(
        alpha=bc.make_field_bc({
            "ym": bc.PatchBC(bc.FIXED_VALUE, (0.0,)),
            "yp": bc.PatchBC(bc.INLET_OUTLET, (0.0,)),
            "xm": bc.PatchBC(bc.ZERO_GRADIENT),
            "xp": bc.PatchBC(bc.ZERO_GRADIENT),
            "zm": emp, "zp": emp}),
        p=bc.make_field_bc({
            "ym": bc.PatchBC(bc.ZERO_GRADIENT),
            "yp": bc.PatchBC(bc.FIXED_VALUE, (0.0,)),
            "xm": bc.PatchBC(bc.ZERO_GRADIENT),
            "xp": bc.PatchBC(bc.ZERO_GRADIENT),
            "zm": emp, "zp": emp}),
        Ub=bc.make_field_bc({
            "ym": bc.PatchBC(bc.FIXED_VALUE, (0.0, vin, 0.0)),
            "yp": bc.PatchBC(bc.INLET_OUTLET, (0.0, 0.0, 0.0)),
            "xm": bc.PatchBC(bc.FIXED_VALUE, (0.0, 0.0, 0.0)),
            "xp": bc.PatchBC(bc.FIXED_VALUE, (0.0, 0.0, 0.0)),
            "zm": emp, "zp": emp}),
        Ua=bc.make_field_bc({"zm": emp, "zp": emp},
                            default=bc.PatchBC(bc.ZERO_GRADIENT,
                                               (0.0, 0.0, 0.0))),
    )

    # controlDict: deltaT 2e-5; in.lammps: timestep 2e-7 -> 100 substeps;
    # cloudProperties: subCycles 1
    dt_fluid = 2e-5
    dt_dem, sub_cycles, sub_steps = adjust_dem_timestep(dt_fluid, 2e-7, 1)

    fluid_cfg = FluidConfig(
        dt=dt_fluid, rhob=1000.0, nub=1e-6, rhoa=2000.0,
        Cvm=0.0, Cl=0.0, gravity=(0.0, 0.0, 0.0),
        piso=PISOConfig(n_correctors=2, p_tol=1e-10),
    )
    # cloudProperties: dragModel SyamlalOBrien; diffusionBandWidth 2e-4
    cloud_cfg = CloudConfig(
        drag_model="SyamlalOBrien",
        sub_cycles=sub_cycles, sub_steps=sub_steps,
        diffusion_band_width=2e-4, diffusion_steps=6,
    )
    # in.lammps: pair gran/hooke/history 5000 NULL 11200 NULL 0.1 0;
    # walls at x/y/z box faces; gravity magnitude 0; fix fdrag
    pair = PairParams(style="hooke_history", kn=5000.0, kt=None,
                      gamman=11200.0, gammat=None, xmu=0.1, dampflag=0)
    walls = (
        WallSpec(style="xplane", lo=0.0, hi=0.004, params=pair),
        WallSpec(style="yplane", lo=0.0, hi=0.004, params=pair),
        WallSpec(style="zplane", lo=0.0, hi=0.0005, params=pair),
    )
    dem_cfg = DEMConfig(dt=dt_dem, pair=pair, walls=walls,
                        gravity=(0.0, 0.0, 0.0), carrier_rho=0.0)

    cfg = SimConfig(grid=grid, bcs=bcs, fluid=fluid_cfg, cloud=cloud_cfg,
                    dem=dem_cfg)

    # IC_uniform.in: one atom, d=8.3e-5, rho=2000, at (2e-3, 1.9e-3, 2.5e-4)
    particles = make_particles(
        pos=[[2.0e-3, 1.9e-3, 2.5e-4]], radius=8.3e-5 / 2.0,
        density=2000.0, capacity=1, n_walls=len(walls), dtype=dtype,
        device=device)

    Ub = np.zeros((3,) + grid.shape)
    Ub[1] = vin
    fluid = init_fluid(grid, Ub=Ub, dtype=dtype, device=device)
    return cfg, fluid, particles


# inject_case at jetFlow's capacity (runtime/window.py); see the module
# docstring for why these values make the window grow
INJECT_FULL = dict(nx=32, ny=64, nz=32, capacity=65536)


def inject_case(nx=32, ny=64, nz=32, capacity=65536, dtype=torch.float32,
                device=None):
    """(cfg, fluid, particles) of the injection column, before
    initialize(): one seed particle mid-column; every add (every second
    fluid step: add_interval = dt) puts one particle (d = 0.2 mm) at
    each of the nx*nz inlet cell centres, moving up at the inlet
    velocity (1.2 m/s: 0.24 mm per add interval, more than a diameter)."""
    dx = 2e-3
    grid = Grid(nx=nx, ny=ny, nz=nz, dx=dx, dy=dx, dz=dx)
    L = grid.lengths
    zg3 = bc.PatchBC(bc.ZERO_GRADIENT, (0.0, 0.0, 0.0))
    vin = 1.2
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
    dt = 1e-4
    sub_steps = 10
    fluid_cfg = FluidConfig(
        dt=dt, rhob=1000.0, nub=1e-6, gravity=(0.0, -9.81, 0.0),
        piso=PISOConfig(n_correctors=2, p_tol=1e-6, p_max_iter=150))
    r = 1e-4
    half = 2.5e-5            # the add slab: inlet centre plane +- 25 um
    add_box = (0.0, L[0], 0.5 * dx - half, 0.5 * dx + half, 0.0, L[2])
    cloud_cfg = CloudConfig(
        drag_model="ErgunWenYu", sub_cycles=1, sub_steps=sub_steps,
        diffusion_band_width=3 * dx, diffusion_steps=4,
        particle_buoyancy=True,
        add_particle=1, add_interval=dt, add_box=add_box,
        add_info=(2 * r, 2500.0, 1), add_velocity=(0.0, vin, 0.0),
        random_perturb=2e-5,
        delete_particle=1,
        delete_box=(0.0, L[0], L[1] - 2 * dx, L[1], 0.0, L[2]),
        delete_before_add=1, clear_box=add_box)
    pair = PairParams(style="hertz_history", kn=1e5, gamman=0.7, xmu=0.3)
    walls = tuple(WallSpec(style=s, lo=0.0, hi=L[a], params=pair)
                  for a, s in enumerate(("xplane", "yplane", "zplane")))
    dem_cfg = DEMConfig(dt=dt / sub_steps, pair=pair, walls=walls,
                        gravity=(0.0, -9.81, 0.0),
                        backend="binned", nbr_k=8, max_per_bin=10,
                        cutoff=2 * r * 1.6, skin=0.6 * r,
                        audit_ring=2 * r + 0.6 * r,
                        domain_lo=(0.0, 0.0, 0.0), domain_hi=L)
    cfg = SimConfig(grid=grid, bcs=bcs, fluid=fluid_cfg, cloud=cloud_cfg,
                    dem=dem_cfg)
    particles = make_particles(
        pos=[[L[0] / 2, L[1] / 2, L[2] / 2]], radius=r, density=2500.0,
        vel=[[0.0, vin, 0.0]], capacity=capacity, n_walls=len(walls),
        neighbor_k=dem_cfg.nbr_k, dtype=dtype, device=device)
    Ub = np.zeros((3,) + grid.shape)
    Ub[1] = vin
    fluid = init_fluid(grid, Ub=Ub, dtype=dtype, device=device)
    return cfg, fluid, particles
