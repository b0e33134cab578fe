"""The bench bed: a just-touching jittered lattice of spheres in a
fluidized bed on a small grid (the sizes in bench_bed.json).

The geometry and physics are those of the program's `bench_case`
(kept here, since the program may change): a box of nx x ny x nz cells
of dx, an inlet of `inlet_velocity` at y-, a pressure outlet at y+,
no-slip side walls, three plane DEM walls, the binned neighbor table,
Hertz contacts with history, ErgunWenYu drag, diffusion smoothing and a
PISO pressure solve. The lattice jitter comes from the seed.

`load(pkg, ...)` builds the case from the classes of `pkg`, which is the
program's package or the reference's: both have the same module layout.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch


def _box(spec):
    return (spec["nx"] * spec["dx"], spec["ny"] * spec["dx"],
            spec["nz"] * spec["dx"])


def inputs(spec, seed, workdir):
    """The lattice's positions, (n, 3) float64, jittered from `seed`."""
    r = spec["radius"]
    L = _box(spec)
    pitch = spec["lattice_pitch_radii"] * r
    nxp = int((L[0] - 2 * r) / pitch)
    nzp = int((L[2] - 2 * r) / pitch)
    ii = np.arange(spec["n_particles"])
    ix, iz, iy = ii % nxp, (ii // nxp) % nzp, ii // (nxp * nzp)
    pos = np.stack([2 * r + ix * pitch, 2 * r + iy * pitch,
                    2 * r + iz * pitch], axis=1)
    jit = spec["jitter_radii"] * r
    pos += np.random.default_rng(seed).uniform(-jit, jit, pos.shape)
    return {"pos": pos}


def load(pkg, spec, inp, device):
    """(SimConfig, FluidState, ParticleState) of `pkg`, on `device`."""
    m = {k: importlib.import_module(f"{pkg}.{k}")
         for k in ("bc", "config", "grid", "solver", "fluid.state",
                   "dem.state")}
    bc, c = m["bc"], m["config"]
    dx, r = spec["dx"], spec["radius"]
    nx, ny, nz = spec["nx"], spec["ny"], spec["nz"]
    grid = m["grid"].Grid(nx=nx, ny=ny, nz=nz, dx=dx, dy=dx, dz=dx)
    zg3 = bc.PatchBC(bc.ZERO_GRADIENT, (0.0, 0.0, 0.0))
    vin = spec["inlet_velocity"]
    bcs = m["fluid.state"].FluidBCs(
        alpha=bc.make_field_bc({
            "ym": bc.PatchBC(bc.FIXED_VALUE, (0.0,)),
            "yp": bc.PatchBC(bc.INLET_OUTLET, (0.0,))}),
        p=bc.make_field_bc({"yp": bc.PatchBC(bc.FIXED_VALUE, (0.0,))}),
        Ub=bc.make_field_bc({
            "ym": bc.PatchBC(bc.FIXED_VALUE, (0.0, vin, 0.0)),
            "yp": bc.PatchBC(bc.INLET_OUTLET, (0.0, 0.0, 0.0))},
            default=bc.PatchBC(bc.FIXED_VALUE, (0.0, 0.0, 0.0))),
        Ua=bc.make_field_bc({}, default=zg3))
    dt, sub = spec["dt"], spec["sub_steps"]
    g = tuple(spec["gravity"])
    fluid_cfg = c.FluidConfig(
        dt=dt, rhob=spec["rhob"], nub=spec["nub"], gravity=g,
        piso=c.PISOConfig(n_correctors=spec["piso_correctors"],
                          p_tol=spec["p_tol"],
                          p_max_iter=spec["p_max_iter"]))
    cloud_cfg = c.CloudConfig(
        drag_model=spec["drag_model"], sub_cycles=1, sub_steps=sub,
        diffusion_band_width=spec["diffusion_band_cells"] * dx,
        diffusion_steps=spec["diffusion_steps"], particle_buoyancy=True)
    pair = c.PairParams(**spec["pair"])
    L = _box(spec)
    walls = tuple(c.WallSpec(style=s, lo=0.0, hi=L[a], params=pair)
                  for a, s in enumerate(("xplane", "yplane", "zplane")))
    cutoff = 2 * r * spec["cutoff_diameters"]
    skin = spec["skin_radii"] * r
    dem_cfg = c.DEMConfig(dt=dt / sub, pair=pair, walls=walls, gravity=g,
                          backend=spec["backend"], nbr_k=spec["nbr_k"],
                          max_per_bin=spec["max_per_bin"], cutoff=cutoff,
                          skin=skin, audit_ring=2 * r + skin,
                          domain_lo=(0.0, 0.0, 0.0), domain_hi=L)
    cfg = m["solver"].SimConfig(grid=grid, bcs=bcs, fluid=fluid_cfg,
                                cloud=cloud_cfg, dem=dem_cfg)
    dtype = getattr(torch, spec["dtype"])
    particles = m["dem.state"].make_particles(
        pos=inp["pos"], radius=r, density=spec["density"],
        capacity=spec["n_particles"], n_walls=len(walls),
        neighbor_k=spec["nbr_k"], dtype=dtype, device=device)
    Ub = np.zeros((3,) + grid.shape)
    Ub[1] = vin
    fluid = m["fluid.state"].init_fluid(grid, Ub=Ub, dtype=dtype,
                                        device=device)
    return cfg, fluid, particles


def probe_locations(spec, inp):
    """The four probe points, in and above the bed."""
    L = _box(spec)
    return [tuple(f * l for f, l in zip(p, L)) for p in spec["probes_of_box"]]
