"""Cases for the port's runner: the xiaocase3 golden case and a
jetFlow-pattern injection column built in code, and writers of
sediFoam-format case directories (0/, constant/, system/, in.lammps and
a LAMMPS data file) that both packages' loaders read.

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

``write_xiaocase3`` writes the dictionaries that ``xiaocase3``
transcribes; loading the directory gives the same case.
``write_channel_case`` writes a transport-bedload channel,
``write_suspended_case`` and ``write_dune_case`` the transport-suspended
and transport-vortex-dune channels of 0.5 mm sand, and
``write_irregular_case`` the irregular-grain channel of rigid trimer
clumps (see their docstrings for what they are built from and which
values they choose). ``extras_bed`` is the bench lattice with cohesion
and lubrication switched on.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from sedifoam_tpu_torch import bc, default_device
from sedifoam_tpu_torch.config import (CloudConfig, DEMConfig, FluidConfig,
                                       PISOConfig, PairParams, WallSpec)
from sedifoam_tpu_torch.dem.state import make_particles
from sedifoam_tpu_torch.fluid.state import FluidBCs, init_fluid
from sedifoam_tpu_torch.grid import Grid
from sedifoam_tpu_torch.solver import SimConfig, adjust_dem_timestep


def xiaocase3(dtype=torch.float64, device=None):
    """(cfg, fluid, particles) of xiaocase3, before initialize(), on
    `device` (by default the CUDA card; device="cpu" for the CPU)."""
    device = default_device(device)
    # blockMeshDict: 4x4x0.5 mm box, 10x10x1 cells
    grid = Grid(nx=10, ny=10, nz=1, dx=4e-4, dy=4e-4, dz=5e-4)

    emp = bc.PatchBC(bc.EMPTY)
    emp3 = bc.PatchBC(bc.EMPTY, (0.0, 0.0, 0.0))
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
            "zm": emp3, "zp": emp3}),
        Ua=bc.make_field_bc({"zm": emp3, "zp": emp3},
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
    velocity (1.2 m/s: 0.24 mm per add interval, more than a diameter).
    On `device`: by default the CUDA card; device="cpu" for the CPU."""
    device = default_device(device)
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


# ---------------------------------------------------------------------------
# case-directory writers
# ---------------------------------------------------------------------------

_FOAM_HEADER = """FoamFile
{{
    version     2.0;
    format      ascii;
    class       {cls};
    object      {obj};
}}
"""


def _write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def _foam(case_dir, rel, cls, body):
    _write(os.path.join(case_dir, rel),
           _FOAM_HEADER.format(cls=cls, obj=os.path.basename(rel)) + body)


def _field(case_dir, name, cls, dims, internal, patches):
    """0/<name> with `patches` {patch: 'entries;'}."""
    bf = "".join(f"    {p}\n    {{\n        {spec}\n    }}\n"
                 for p, spec in patches.items())
    _foam(case_dir, os.path.join("0", name), cls,
          f"dimensions {dims};\ninternalField {internal};\n"
          f"boundaryField\n{{\n{bf}}}\n")


def _data_file(path, rows, box, n_types, mol_rows=()):
    """A LAMMPS data file (atom_style sphere); `mol_rows` ('atom mol'
    lines) add the Molecules section that `read_data ... fix molprop
    NULL Molecules` reads."""
    lines = ["sedifoam case writer IC", "", f"{len(rows)} atoms",
             f"{n_types} atom types", "",
             f"{box[0]} {box[1]} xlo xhi", f"{box[2]} {box[3]} ylo yhi",
             f"{box[4]} {box[5]} zlo zhi", "", "Atoms", ""]
    lines += rows
    if mol_rows:
        lines += ["", "Molecules", ""] + list(mol_rows)
    _write(path, "\n".join(lines) + "\n")


def _probes(locations):
    pts = " ".join(f"({x} {y} {z})" for x, y, z in locations)
    return ("functions\n{\n    probes\n    {\n        type probes;\n"
            "        fields (p Ub);\n"
            f"        probeLocations ({pts});\n    }}\n}}\n")


_DIMS = {"alpha": "[0 0 0 0 0 0 0]", "p": "[1 -1 -2 0 0 0 0]",
         "U": "[0 1 -1 0 0 0 0]"}


def write_xiaocase3(case_dir: str) -> str:
    """Write xiaocase3 as a case directory: the dictionaries that
    ``xiaocase3`` transcribes (blockMesh 4x4x0.5 mm in 10x10x1 cells,
    deltaT 2e-5, timestep 2e-7, the gran/hooke/history 5000 NULL 11200
    NULL 0.1 0 pair and three wall pairs, SyamlalOBrien drag, band 2e-4,
    one 83 um sphere), a laminar flow as ``xiaocase3`` runs it, and one
    probe. Returns case_dir."""
    _foam(case_dir, "constant/polyMesh/blockMeshDict", "dictionary", """
convertToMeters 1;
vertices ( (0 0 0) (0.004 0 0) (0.004 0.004 0) (0 0.004 0)
           (0 0 0.0005) (0.004 0 0.0005) (0.004 0.004 0.0005)
           (0 0.004 0.0005) );
blocks ( hex (0 1 2 3 4 5 6 7) (10 10 1) simpleGrading (1 1 1) );
edges ();
boundary
(
    inlet  { type patch; faces ( (1 5 4 0) ); }
    outlet { type patch; faces ( (3 7 6 2) ); }
    walls  { type wall;  faces ( (0 4 7 3) (2 6 5 1) ); }
);
""")
    empty = {"defaultFaces": "type empty;"}
    _field(case_dir, "alpha", "volScalarField", _DIMS["alpha"], "uniform 0",
           {"inlet": "type fixedValue; value uniform 0;",
            "outlet": "type inletOutlet; inletValue uniform 0; "
                      "value uniform 0;",
            "walls": "type zeroGradient;", **empty})
    _field(case_dir, "p", "volScalarField", _DIMS["p"], "uniform 0",
           {"inlet": "type zeroGradient;",
            "outlet": "type fixedValue; value uniform 0;",
            "walls": "type zeroGradient;", **empty})
    _field(case_dir, "Ub", "volVectorField", _DIMS["U"], "uniform (0 0.05 0)",
           {"inlet": "type fixedValue; value uniform (0 0.05 0);",
            "outlet": "type inletOutlet; inletValue uniform (0 0 0); "
                      "value uniform (0 0 0);",
            "walls": "type fixedValue; value uniform (0 0 0);", **empty})
    _field(case_dir, "Ua", "volVectorField", _DIMS["U"], "uniform (0 0 0)",
           {"inlet": "type zeroGradient;", "outlet": "type zeroGradient;",
            "walls": "type zeroGradient;", **empty})
    _foam(case_dir, "system/controlDict", "dictionary", """
startTime 0;
endTime 0.005;
deltaT 2e-05;
writeInterval 0.001;
""" + _probes([(0.002, 0.003, 0.00025)]))
    _foam(case_dir, "system/fvSolution", "dictionary", """
solvers
{
    p { solver PCG; preconditioner DIC; tolerance 1e-10; relTol 0; }
}
PISO { nCorrectors 2; nNonOrthogonalCorrectors 0; pRefCell 0; pRefValue 0; }
""")
    _foam(case_dir, "constant/transportProperties", "dictionary", """
rhoa rhoa [1 -3 0 0 0 0 0] 2000;
rhob rhob [1 -3 0 0 0 0 0] 1000;
nub nub [0 2 -1 0 0 0 0] 1e-06;
Cvm Cvm [0 0 0 0 0 0 0] 0;
Cl Cl [0 0 0 0 0 0 0] 0;
""")
    _foam(case_dir, "constant/environmentalProperties", "dictionary",
          "g g [0 1 -2 0 0 0 0] (0 0 0);\n")
    _foam(case_dir, "constant/turbulenceProperties", "dictionary",
          "simulationType laminar;\n")
    _foam(case_dir, "constant/cloudProperties", "dictionary", """
dragModel SyamlalOBrien;
subCycles 1;
diffusionBandWidth 2e-4;
diffusionSteps 6;
""")
    _write(os.path.join(case_dir, "in.lammps"), """\
atom_style      sphere
boundary        f f f
newton          off
read_data       IC_uniform.in
pair_style      gran/hooke/history 5000 NULL 11200 NULL 0.1 0
pair_coeff      * *
timestep        2e-7
fix             1 all nve/sphere
fix             2 all gravity 0 vector 0 -1 0
fix             3 all fdrag
fix             xwalls all wall/gran 5000 NULL 11200 NULL 0.1 0 xplane 0.0 0.004
fix             ywalls all wall/gran 5000 NULL 11200 NULL 0.1 0 yplane 0.0 0.004
fix             zwalls all wall/gran 5000 NULL 11200 NULL 0.1 0 zplane 0.0 0.0005
""")
    _data_file(os.path.join(case_dir, "IC_uniform.in"),
               ["1 1 8.3e-05 2000 0.002 0.0019 0.00025"],
               (0.0, 0.004, 0.0, 0.004, 0.0, 0.0005), 1)
    return case_dir


# the transport-bedload box (scripts/validate_bedload.py:39) and its full
# mesh (tests/test_bedload_case.py:74)
CHANNEL_BOX = (0.0, 0.121250, 0.0, 0.04, 0.0, 0.06001)
CHANNEL_FULL = dict(counts=(140, 65, 60), layers=6)


def channel_bed(d=2.5e-3, n_layers=6, frozen_layers=1, seed=7,
                overlap=0.0):
    """scripts/validate_bedload.py's jittered simple-cubic bed over the
    channel's x-z extent: data-file rows (id type d rho x y z), the
    bottom `frozen_layers` of type 2, the rest type 1. The layers are
    2.05 r apart, as there; overlap > 0 stacks them d - overlap apart
    instead (each layer pressed into the one below: contacts from the
    first substep)."""
    box = CHANNEL_BOX
    rng = np.random.default_rng(seed)
    r = 0.5 * d
    pitch = 2.05 * r
    layer_pitch = d - overlap if overlap > 0 else pitch
    nx = int((box[1] - box[0] - d) / pitch)
    nz = int((box[5] - box[4] - d) / pitch)
    rows = []
    tag = 1
    for layer in range(n_layers):
        y = box[2] + r + layer * layer_pitch
        for i in range(nx):
            for k in range(nz):
                x = box[0] + r + (i + 0.5) * (box[1] - box[0] - d) / nx
                z = box[4] + r + (k + 0.5) * (box[5] - box[4] - d) / nz
                jx, jz = rng.uniform(-0.02 * r, 0.02 * r, 2)
                t = 2 if layer < frozen_layers else 1
                rows.append(f"{tag} {t} {d} 2650.0 "
                            f"{x + jx:.8f} {y:.8f} {z + jz:.8f}")
                tag += 1
    return rows


def write_channel_case(case_dir: str, counts=(140, 65, 60), layers=6,
                       d=2.5e-3, frozen_layers=1, seed=7,
                       overlap=0.0) -> str:
    """Write a transport-bedload channel (the SediFoam paper's sediment
    transport case) as a case directory. Returns case_dir.

    From what the repo records:
    - the 0.12125 x 0.04 x 0.06001 m box meshed as one hex with
      `simpleGrading (1 10 1)`, patches bottom (y-) and top (y+) walls,
      left/right (x) and front/back (z) cyclic
      (tests/test_bedload_case.py:92-109); full counts 140 x 65 x 60;
    - scripts/validate_bedload.py's jittered bed (d = 2.5 mm, rhoa 2650,
      seed 7, the bottom layer type 2 and frozen; 46 x 22 per layer;
      `overlap` presses the layers together, see channel_bed);
    - water (rhob 1000, nub 1e-6), top slip, kEqn LES, Ubar (0.8 0 0),
      `boundary p f p`, a `freeze` fix on the type-2 group, y walls.

    Chosen here (the repo does not record them):
    - the pair (and wall) line: xiaocase3's gran/hooke/history 5000 NULL
      11200 NULL 0.1 0;
    - DEM timestep 2.5e-6 s, below 1/50 of the Hooke contact time
      pi*sqrt(m_eff/kn) = 1.46e-4 s at d = 2.5 mm;
    - deltaT 1e-4 s: 40 substeps, Courant 0.09 at 0.8 m/s on the full
      mesh;
    - `fix fdrag` with carrier density 1000, so the DDtU path runs;
    - ErgunWenYu drag; the loader's defaults for the smoothing;
    - the pressure solve: PCG tolerance 1e-6, 2 PISO correctors;
    - the fluid starts at rest; 0/Ua pins the bottom to its internal
      field ($internalField).
    """
    box = CHANNEL_BOX
    nx, ny, nz = counts
    mesh = _y_stacked_mesh(box, nx, nz, [(box[3], ny, 10)])
    L = box[1], box[3], box[5]
    _transport_case(
        case_dir, box, mesh, top_wall=False, end_time=3, ubar=0.8,
        cloud="dragModel ErgunWenYu;\nsubCycles 1;\n",
        gran="5000 NULL 11200 NULL 0.1 0", dem_dt="2.5e-6",
        rows=channel_bed(d, layers, frozen_layers, seed, overlap),
        probes=[(0.5 * L[0], 0.5 * L[1], 0.5 * L[2]),
                (0.5 * L[0], 0.9 * L[1], 0.5 * L[2])])
    return case_dir


def _transport_case(case_dir, box, mesh, top_wall, end_time, ubar, cloud,
                    gran, dem_dt, rows, probes):
    """The dictionaries the transport channels share, written into
    case_dir: `mesh` (a blockMeshDict body with patches bottom, top,
    left/right and front/back), cyclic x/z, a no-slip bottom and a top
    that is a no-slip wall (`top_wall`) or slip; the fluid at rest; deltaT
    1e-4 to `end_time`, `probes`; PCG tolerance 1e-6 with 2 PISO
    correctors; water (rhob 1000, nub 1e-6) with 2650 kg/m^3 grains,
    Ubar (`ubar` 0 0), gravity 9.81; kEqn LES; `cloud` as
    cloudProperties; an in.lammps with `boundary p f p`, the
    gran/hooke/history pair and y-wall line `gran`, timestep `dem_dt`,
    gravity, `fix fdrag 1000`, a `freeze` fix on the type-2 group; the
    data file of `rows`."""
    _foam(case_dir, "constant/polyMesh/blockMeshDict", "dictionary", mesh)
    cyc = {p: "type cyclic;" for p in ("left", "right", "front", "back")}
    zg = "type zeroGradient;"
    wall_ua = "type fixedValue; value $internalField;"
    _field(case_dir, "alpha", "volScalarField", _DIMS["alpha"], "uniform 0",
           {"bottom": zg, "top": zg, **cyc})
    _field(case_dir, "p", "volScalarField", _DIMS["p"], "uniform 0",
           {"bottom": zg, "top": zg, **cyc})
    _field(case_dir, "Ub", "volVectorField", _DIMS["U"], "uniform (0 0 0)",
           {"bottom": "type fixedValue; value uniform (0 0 0);",
            "top": "type fixedValue; value uniform (0 0 0);" if top_wall
            else "type slip;", **cyc})
    _field(case_dir, "Ua", "volVectorField", _DIMS["U"], "uniform (0 0 0)",
           {"bottom": wall_ua, "top": wall_ua if top_wall else "type slip;",
            **cyc})
    _foam(case_dir, "system/controlDict", "dictionary", f"""
startTime 0;
endTime {end_time};
deltaT 1e-4;
writeInterval 0.1;
""" + _probes(probes))
    _foam(case_dir, "system/fvSolution", "dictionary", """
solvers
{
    p { solver PCG; preconditioner DIC; tolerance 1e-6; relTol 0; }
}
PISO { nCorrectors 2; nNonOrthogonalCorrectors 0; pRefCell 0; pRefValue 0; }
""")
    _foam(case_dir, "constant/transportProperties", "dictionary", f"""
rhoa rhoa [1 -3 0 0 0 0 0] 2650;
rhob rhob [1 -3 0 0 0 0 0] 1000;
nub nub [0 2 -1 0 0 0 0] 1e-06;
Ubar Ubar [0 1 -1 0 0 0 0] ({ubar} 0 0);
""")
    _foam(case_dir, "constant/environmentalProperties", "dictionary",
          "g g [0 1 -2 0 0 0 0] (0 -9.81 0);\n")
    _foam(case_dir, "constant/turbulenceProperties", "dictionary", """
simulationType LES;
LES { LESModel kEqn; turbulence on; delta cubeRootVol; }
""")
    _foam(case_dir, "constant/cloudProperties", "dictionary", "\n" + cloud)
    _write(os.path.join(case_dir, "in.lammps"), f"""\
atom_style      sphere
boundary        p f p
newton          off
read_data       In_initial.in
pair_style      gran/hooke/history {gran}
pair_coeff      * *
timestep        {dem_dt}
group           bed type 2
fix             1 all nve/sphere
fix             2 all gravity 9.81 vector 0 -1 0
fix             3 all fdrag 1000
fix             4 bed freeze
fix             ywalls all wall/gran {gran} yplane {box[2]} {box[3]}
""")
    _data_file(os.path.join(case_dir, "In_initial.in"), rows, box, 2)


# the transport-suspended box (scripts/validate_suspended.py:42, the
# bedload box) and the transport-vortex-dune box
# (scripts/validate_dune.py:37)
SUSPENDED_BOX = CHANNEL_BOX
SUSPENDED_FULL = dict(counts=(140, 65, 60), layers=2)
DUNE_BOX = (0.0, 0.155885, 0.0, 0.0167, 0.0, 0.040001)
DUNE_FULL = dict(counts=(156, 26, 40), bed_cells=8, crest_layers=6)
DUNE_BED_TOP = 0.004          # the lower y-block: the bed and the hump
SAND_D = 0.5e-3               # both cases' grain (d = 0.5 mm, rhoa 2650)
# gran/hooke/history kn kt gamman gammat xmu dampflag of both cases: the
# dune's recorded kn 200 and xmu 0.4 (its in.lammps:15), the rest as
# write_irregular_case chose
SAND_GRAN = "200 NULL 50000 NULL 0.4 0"
SAND_DEM_DT = "1.25e-6"
SAND_CLOUD = "diffusionBandWidth 0.003;\n"


def suspended_bed(d=SAND_D, n_layers=2, frozen_layers=1, seed=11,
                  box=SUSPENDED_BOX):
    """scripts/validate_suspended.py's bed (`synth_bed`): data-file rows
    (id type d rho x y z) of a jittered simple-cubic bed over the box's
    x-z extent, the bottom `frozen_layers` dense and of type 2, the mobile
    layers above at half the density in x and z (pitch 2d). At the full
    box and 2 layers: 27,260 frozen + 6,786 mobile = 34,046 grains."""
    rng = np.random.default_rng(seed)
    r = 0.5 * d
    pitch = 2.05 * r
    nx = int((box[1] - box[0] - d) / pitch)
    nz = int((box[5] - box[4] - d) / pitch)
    rows = []
    tag = 1
    for layer in range(n_layers):
        y = box[2] + r + layer * pitch
        frozen = layer < frozen_layers
        mx, mz = (nx, nz) if frozen else (nx // 2, nz // 2)
        for i in range(mx):
            for k in range(mz):
                x = box[0] + r + (i + 0.5) * (box[1] - box[0] - d) / mx
                z = box[4] + r + (k + 0.5) * (box[5] - box[4] - d) / mz
                jx, jz = rng.uniform(-0.02 * r, 0.02 * r, 2)
                t = 2 if frozen else 1
                rows.append(f"{tag} {t} {d} 2650.0 "
                            f"{x + jx:.8f} {y:.8f} {z + jz:.8f}")
                tag += 1
    return rows


def write_suspended_case(case_dir: str, counts=(140, 65, 60), layers=2,
                         box=SUSPENDED_BOX, d=SAND_D) -> str:
    """Write the transport-suspended channel (the suspended-load case of
    the SediFoam paper, Sun & Xiao 2016, arXiv:1601.03801) as a case
    directory. Returns case_dir.

    From what the repo records (scripts/validate_suspended.py):
    - the 0.12125 x 0.04 x 0.06001 m box (CHANNEL_BOX), x and z cyclic,
      walls at both y faces ("ff walls in y": the top is a no-slip wall,
      not bedload's slip), `boundary p f p`;
    - water, Ubar (0.8 0 0), SyamlalOBrien drag, gran/hooke/history DEM,
      a `freeze` fix on the type-2 group;
    - the bed: suspended_bed (d = 0.5 mm, rhoa 2650, seed 11, one dense
      frozen layer and `layers - 1` sparse mobile ones; 34,046 grains at
      2 layers).

    Chosen here (the repo does not record them):
    - the mesh: the bedload mesh of the same box, 140 x 65 x 60 with
      `simpleGrading (1 10 1)` (`counts`);
    - the pair and wall line `gran/hooke/history 200 NULL 50000 NULL 0.4
      0` (the dune's recorded kn and xmu, the rest as
      write_irregular_case chose);
    - DEM timestep 1.25e-6 s, 1/52 of the Hooke contact time
      pi*sqrt(m_eff/kn) = 6.54e-5 s at d = 0.5 mm, and deltaT 1e-4 s: 80
      substeps;
    - kEqn LES, PCG tolerance 1e-6 with 2 PISO correctors, `fix fdrag`
      with carrier density 1000, diffusionBandWidth 3 mm (six grains; the
      loader's 6 mm default is twelve), the fluid at rest, endTime 1.5 s
      (the validator's t_end), as write_channel_case chose the rest.

    `box`, `counts` and `layers` shrink the case (tests); the validator
    reads the same box for the bed area and the depth.
    """
    nx, ny, nz = counts
    mesh = _y_stacked_mesh(box, nx, nz, [(box[3], ny, 10)])
    L = box[1] - box[0], box[3] - box[2], box[5] - box[4]
    _transport_case(
        case_dir, box, mesh, top_wall=True, end_time=1.5, ubar=0.8,
        cloud="dragModel SyamlalOBrien;\nsubCycles 1;\n" + SAND_CLOUD,
        gran=SAND_GRAN, dem_dt=SAND_DEM_DT,
        rows=suspended_bed(d, layers, box=box),
        probes=[(box[0] + 0.5 * L[0], box[2] + f * L[1], box[4] + 0.5 * L[2])
                for f in (0.25, 0.5)])
    return case_dir


def dune_bed(d=SAND_D, crest_layers=6, sigma_frac=0.10, seed=13,
             box=DUNE_BOX):
    """scripts/validate_dune.py's bed (`synth_dune`): a frozen type-2
    base layer over the whole channel and a mobile Gaussian hump of
    `crest_layers` layers at its crest, sigma = sigma_frac Lx, centred at
    x0 = 0.4 Lx (jittered simple-cubic, pitch 2.05 r). Returns (data-file
    rows, x0). At the full box: 58,212 grains, x0 = 0.062354 m."""
    rng = np.random.default_rng(seed)
    r = 0.5 * d
    pitch = 2.05 * r
    Lx = box[1] - box[0]
    nx = int((Lx - d) / pitch)
    nz = int((box[5] - box[4] - d) / pitch)
    x0 = box[0] + 0.4 * Lx
    sigma = sigma_frac * Lx
    rows = []
    tag = 1
    for i in range(nx):
        x = box[0] + r + (i + 0.5) * (Lx - d) / nx
        n_here = 1 + int(round(crest_layers
                               * np.exp(-0.5 * ((x - x0) / sigma) ** 2)))
        for layer in range(n_here):
            y = box[2] + r + layer * pitch
            t = 2 if layer == 0 else 1
            for k in range(nz):
                z = box[4] + r + (k + 0.5) * (box[5] - box[4] - d) / nz
                jx, jz = rng.uniform(-0.02 * r, 0.02 * r, 2)
                rows.append(f"{tag} {t} {d} 2650.0 "
                            f"{x + jx:.8f} {y:.8f} {z + jz:.8f}")
                tag += 1
    return rows, x0


def write_dune_case(case_dir: str, counts=(156, 26, 40), bed_cells=8,
                    crest_layers=6, box=DUNE_BOX, d=SAND_D) -> str:
    """Write the transport-vortex-dune channel (the current-induced dune
    case of Sun & Xiao, arXiv:1510.07201) as a case directory. Returns
    case_dir.

    From what the repo records (scripts/validate_dune.py,
    io/case.read_block_mesh):
    - the 0.155885 x 0.0167 x 0.040001 m box, x and z cyclic, meshed as
      two y-stacked hex blocks;
    - water, Ubar (0.34 0 0), SyamlalOBrien drag, `subCycles 5`;
    - `gran/hooke/history` with kn 200 and xmu 0.4, a frozen type-2 base;
    - the bed: dune_bed (d = 0.5 mm, seed 13, a frozen base layer and a
      mobile Gaussian hump of `crest_layers` crest layers, sigma 0.1 Lx,
      centred at 0.4 Lx; 58,212 grains at the full box).

    Chosen here (the repo does not record them):
    - the mesh: `counts` = (156, 26, 40) cells of about 1 mm in x and z;
      in y a lower block from the floor to 4 mm (above the hump's 3.6 mm
      crest) of `bed_cells` = 8 uniform 0.5 mm cells, and an upper block
      of the other 18 cells to the top, `simpleGrading (1 2 1)` (0.49 to
      0.98 mm, so the cell height runs on across the joint);
    - the pair and wall line `200 NULL 50000 NULL 0.4 0` (kt, gamman,
      gammat and the damping flag as write_irregular_case chose);
    - DEM timestep 1.25e-6 s (1/52 of the Hooke contact time 6.54e-5 s)
      and deltaT 1e-4 s: 80 substeps, 16 in each of the 5 coupling cycles
      (solver.adjust_dem_timestep);
    - a slip top (an open channel), a no-slip bottom, y walls for the
      grains at the box faces; kEqn LES, PCG tolerance 1e-6 with 2 PISO
      correctors, `fix fdrag` with carrier density 1000,
      diffusionBandWidth 3 mm, the fluid at rest, endTime 1.5 s (the
      validator's t_end; the reference controlDict's 50 s of morphology
      is beyond a validation run).

    `box`, `counts`, `bed_cells` and `crest_layers` shrink the case
    (tests).
    """
    nx, ny, nz = counts
    mesh = _y_stacked_mesh(box, nx, nz, [(box[2] + DUNE_BED_TOP, bed_cells, 1),
                                         (box[3], ny - bed_cells, 2)])
    L = box[1] - box[0], box[3] - box[2], box[5] - box[4]
    rows, _ = dune_bed(d, crest_layers, box=box)
    _transport_case(
        case_dir, box, mesh, top_wall=False, end_time=1.5, ubar=0.34,
        cloud="dragModel SyamlalOBrien;\nsubCycles 5;\n" + SAND_CLOUD,
        gran=SAND_GRAN, dem_dt=SAND_DEM_DT, rows=rows,
        probes=[(box[0] + f * L[0], box[2] + 0.5 * L[1], box[4] + 0.5 * L[2])
                for f in (0.4, 0.8)])
    return case_dir


def _y_stacked_mesh(box, nx, nz, y_blocks):
    """A blockMeshDict body: the box as hex blocks stacked in y, one per
    (y_top, cells, y grading) of `y_blocks` from the floor up, nx and nz
    cells each; patches bottom, top (walls) and left/right, front/back
    (cyclic), the side patches one face per block."""
    X, Z = box[1], box[5]
    levels = [box[2]] + [b[0] for b in y_blocks]
    verts = " ".join(f"({x} {y} {z})" for y in levels
                     for x, z in ((box[0], box[4]), (X, box[4]), (X, Z),
                                  (box[0], Z)))

    def v(j):        # (x0 z0, x1 z0, x1 z1, x0 z1) at level j
        return 4 * j, 4 * j + 1, 4 * j + 2, 4 * j + 3

    hexes, sides = [], {"left": [], "right": [], "front": [], "back": []}
    for j, (_, ny, grading) in enumerate(y_blocks):
        a, b, c, d = v(j)
        A, B, C, D = v(j + 1)
        hexes.append(f"    hex ({a} {b} {B} {A} {d} {c} {C} {D}) "
                     f"({nx} {ny} {nz}) simpleGrading (1 {grading} 1)")
        sides["left"].append(f"({a} {d} {D} {A})")
        sides["right"].append(f"({B} {C} {c} {b})")
        sides["front"].append(f"({a} {b} {B} {A})")
        sides["back"].append(f"({d} {c} {C} {D})")
    left, right, front, back = (" ".join(sides[k]) for k in sides)
    a, b, c, d = v(0)
    A, B, C, D = v(len(y_blocks))
    return f"""
convertToMeters 1;
vertices ( {verts} );
blocks
(
{chr(10).join(hexes)}
);
edges ();
boundary
(
    bottom {{ type wall; faces ( ({b} {c} {d} {a}) ); }}
    top    {{ type wall; faces ( ({A} {D} {C} {B}) ); }}
    left   {{ type cyclic; neighbourPatch right; faces ( {left} ); }}
    right  {{ type cyclic; neighbourPatch left;  faces ( {right} ); }}
    front  {{ type cyclic; neighbourPatch back;  faces ( {front} ); }}
    back   {{ type cyclic; neighbourPatch front; faces ( {back} ); }}
);
"""


# the irregular case's box and grain (scripts/validate_irregular.py:42-44)
IRREGULAR_BOX = (0.0, 0.072, 0.0, 0.04, 0.0, 0.036)
IRREGULAR_D = 0.00035
IRREGULAR_FULL = dict(n_clumps=600, counts=(72, 50, 36), floor_d=0.001)


def trimer_bed(n_clumps=600, floor_d=0.001, press=0.0):
    """scripts/validate_irregular.py's synthetic bed (`synth_clumps`): one
    layer of frozen type-2 floor spheres of diameter `floor_d` on a
    lattice over the box floor, and above it `n_clumps` trimers of three
    collinear 0.35 mm spheres (types 3, 4, 5) on a jittered lattice, each
    lying in the x-z plane at a random angle. The trimers start half a
    floor diameter and half a grain above the floor's top, as there;
    press > 0 lowers them until a member right above a floor sphere
    overlaps it by `press` (contacts from the first substep, for the few
    percent of members that lie over a sphere's top). Returns (data-file
    rows, Molecules rows `atom mol`)."""
    box, D, rhoa = IRREGULAR_BOX, IRREGULAR_D, 2650.0
    rng = np.random.default_rng(11)        # the validator's seed
    rows, mol_rows = [], []
    tag = 1
    nx = int((box[1] - box[0]) / floor_d)
    nz = int((box[5] - box[4]) / floor_d)
    y0 = box[2] + 0.5 * floor_d
    for i in range(nx):
        for k in range(nz):
            x = box[0] + (i + 0.5) * (box[1] - box[0]) / nx
            z = box[4] + (k + 0.5) * (box[5] - box[4]) / nz
            rows.append(f"{tag} 2 {floor_d} {rhoa} "
                        f"{x:.8f} {y0:.8f} {z:.8f}")
            tag += 1
    span = 2 * D            # trimer end-to-end center distance
    pitch = 1.6 * (span + D)
    nxc = int((box[1] - box[0] - span) / pitch)
    nzc = int((box[5] - box[4] - span) / pitch)
    per_layer = max(nxc * nzc, 1)
    for c in range(n_clumps):
        layer, r = divmod(c, per_layer)
        i, k = divmod(r, max(nzc, 1))
        x = box[0] + span + (i + 0.5) * pitch
        z = box[4] + span + (k + 0.5) * pitch
        y = (floor_d + 0.5 * D - press if press > 0 else y0 + floor_d + D) \
            + layer * pitch
        th = rng.uniform(0, 2 * np.pi)
        u = np.array([np.cos(th), 0.0, np.sin(th)])
        base = np.array([x, y, z]) + rng.uniform(-0.1 * D, 0.1 * D, 3)
        for m, t in enumerate((3, 4, 5)):
            p = base + (m - 1) * D * u
            rows.append(f"{tag} {t} {D} {rhoa} "
                        f"{p[0]:.8f} {p[1]:.8f} {p[2]:.8f}")
            mol_rows.append(f"{tag} {c + 1}")
            tag += 1
    return rows, mol_rows


def _molecule_template(path, coords, types, d):
    """A LAMMPS `molecule` file of spheres of diameter d (mass at 2650
    kg/m^3)."""
    n = len(coords)
    mass = 2650.0 * np.pi / 6.0 * d ** 3
    text = [f"# rigid clump template: {n} spheres", "", f"{n} atoms", "",
            "Coords", ""]
    text += [f"{i + 1} {x:.6g} {y:.6g} {z:.6g}"
             for i, (x, y, z) in enumerate(coords)]
    text += ["", "Types", ""] + [f"{i + 1} {t}" for i, t in enumerate(types)]
    text += ["", "Diameters", ""] + [f"{i + 1} {d:.6g}" for i in range(n)]
    text += ["", "Masses", ""] + [f"{i + 1} {mass:.6g}" for i in range(n)]
    _write(path, "\n".join(text) + "\n")


def write_irregular_case(case_dir: str, n_clumps=600, counts=(72, 50, 36),
                         floor_d=0.001, press=0.0) -> str:
    """Write the irregular-grain channel (bonded-sphere grains, Sun & Xiao
    arXiv:1608.01049; the reference's example-case `irregular`) as a case
    directory. Returns case_dir.

    From what the repo records (scripts/validate_irregular.py, README
    validation table, tests/test_rigid.py):
    - the 0.072 x 0.04 x 0.036 m box, cyclic in x and z, a y-graded mesh;
    - grains as rigid trimers of three collinear 0.35 mm spheres (types
      3, 4, 5; `molecule object1 in.pairA`; four templates in.pairA-D, the
      second of six spheres), density 2650, integrated by `fix 5 big
      rigid/small molecule`, read with `read_data In_initial.in fix
      molprop NULL Molecules`;
    - a floor of frozen 1 mm type-2 spheres: types 1 and 2 carry no
      integration fix, which is what keeps them still;
    - gran/hooke/history contacts, water (rhob 1000, nub 1e-6), kEqn LES,
      Ubar (0.5 0 0), maxPossibleAlpha 0.8;
    - the bed: trimer_bed (the validator's synthetic bed, seed 11): with
      the defaults 2,592 floor spheres and 600 trimers, 4,392 particles
      (`press` lowers the trimers into contact with the floor).

    Chosen here (the repo does not record them):
    - the mesh: 72 x 50 x 36 cells with `simpleGrading (1 10 1)` (1 mm
      cells in x and z; 0.2 mm to 2 mm in y, the bottom cells thinner than
      a floor sphere, as the validator notes of the reference's mesh);
    - the pair and wall line `gran/hooke/history 200 NULL 50000 NULL 0.5
      0`: a contact between two members lasts pi*sqrt(m_eff/kn) = 3.8e-5
      s, and an impact at 0.1 m/s overlaps by 0.7% of a radius;
    - DEM timestep 2e-6 s (19 per contact) and deltaT 1e-4 s: 50 substeps,
      Courant 0.05 at 0.5 m/s;
    - `fix fdrag` without a carrier density; ErgunWenYu drag; the loader's
      defaults for the smoothing; PCG tolerance 1e-6, 2 PISO correctors;
    - the fluid starts at rest, top slip, bottom no-slip, y walls for the
      particles at the box faces;
    - the members of templates B-D (the loader parses them; no grain of
      the bed uses them): a 3 x 2 raft, a tetrahedron and a dimer of 0.25
      mm spheres.
    """
    box, D = IRREGULAR_BOX, IRREGULAR_D
    nx, ny, nz = counts
    _foam(case_dir, "constant/polyMesh/blockMeshDict", "dictionary",
          _y_stacked_mesh(box, nx, nz, [(box[3], ny, 10)]))
    cyc = {p: "type cyclic;" for p in ("left", "right", "front", "back")}
    zg = "type zeroGradient;"
    _field(case_dir, "alpha", "volScalarField", _DIMS["alpha"], "uniform 0",
           {"bottom": zg, "top": zg, **cyc})
    _field(case_dir, "p", "volScalarField", _DIMS["p"], "uniform 0",
           {"bottom": zg, "top": zg, **cyc})
    _field(case_dir, "Ub", "volVectorField", _DIMS["U"], "uniform (0 0 0)",
           {"bottom": "type fixedValue; value uniform (0 0 0);",
            "top": "type slip;", **cyc})
    _field(case_dir, "Ua", "volVectorField", _DIMS["U"], "uniform (0 0 0)",
           {"bottom": "type fixedValue; value $internalField;",
            "top": "type slip;", **cyc})
    _foam(case_dir, "system/controlDict", "dictionary", """
startTime 0;
endTime 0.6;
deltaT 1e-4;
writeInterval 0.1;
""" + _probes([(0.5 * box[1], 0.5 * box[3], 0.5 * box[5])]))
    _foam(case_dir, "system/fvSolution", "dictionary", """
solvers
{
    p { solver PCG; preconditioner DIC; tolerance 1e-6; relTol 0; }
}
PISO { nCorrectors 2; nNonOrthogonalCorrectors 0; pRefCell 0; pRefValue 0; }
""")
    _foam(case_dir, "constant/transportProperties", "dictionary", """
rhoa rhoa [1 -3 0 0 0 0 0] 2650;
rhob rhob [1 -3 0 0 0 0 0] 1000;
nub nub [0 2 -1 0 0 0 0] 1e-06;
Ubar Ubar [0 1 -1 0 0 0 0] (0.5 0 0);
""")
    _foam(case_dir, "constant/environmentalProperties", "dictionary",
          "g g [0 1 -2 0 0 0 0] (0 -9.81 0);\n")
    _foam(case_dir, "constant/turbulenceProperties", "dictionary", """
simulationType LES;
LES { LESModel kEqn; turbulence on; delta cubeRootVol; }
""")
    _foam(case_dir, "constant/cloudProperties", "dictionary", """
dragModel ErgunWenYu;
subCycles 1;
maxPossibleAlpha 0.8;
""")
    gran = "200 NULL 50000 NULL 0.5 0"
    _write(os.path.join(case_dir, "in.lammps"), f"""\
atom_style      sphere
atom_modify     map array
boundary        p f p
newton          off
fix             molprop all property/atom mol
molecule        object1 in.pairA
molecule        object2 in.pairB
molecule        object3 in.pairC
molecule        object4 in.pairD
read_data       In_initial.in fix molprop NULL Molecules
pair_style      gran/hooke/history {gran}
pair_coeff      * *
timestep        2e-6
group           big type 3 4 5
fix             2 all gravity 9.81 vector 0 -1 0
fix             3 all fdrag
fix             ywalls all wall/gran {gran} yplane {box[2]} {box[3]}
fix             5 big rigid/small molecule
""")
    a = 0.00025
    h = a * np.sqrt(3.0) / 2.0
    templates = {
        "in.pairA": ([(-D, 0, 0), (0, 0, 0), (D, 0, 0)], (3, 4, 5), D),
        "in.pairB": ([(i * a, 0, k * a) for i in range(3) for k in range(2)],
                     (6,) * 6, a),
        "in.pairC": ([(0, 0, 0), (a, 0, 0), (a / 2, 0, h),
                      (a / 2, a * np.sqrt(2.0 / 3.0), h / 3)], (7,) * 4, a),
        "in.pairD": ([(0, 0, 0), (a, 0, 0)], (8, 8), a),
    }
    for name, (coords, types, d) in templates.items():
        _molecule_template(os.path.join(case_dir, name), coords, types, d)
    rows, mol_rows = trimer_bed(n_clumps, floor_d, press)
    _data_file(os.path.join(case_dir, "In_initial.in"), rows, box, 8,
               mol_rows)
    return case_dir


def extras_bed(n_particles=131072, cohesion_model=None, lubrication=False,
               dtype=torch.float32, device=None):
    """(DEMConfig, particles) of the bench lattice (bench_case: 1 mm
    spheres at pitch 1.01 mm between three wall pairs) with `fix cohesive`
    (cohesion_model 0 or 1; None = off) and/or `pair lubricate/poly`
    switched on, the table sized by the case loader's ring rule
    (io.case.neighbor_ring). With smax a fifth of a diameter and the
    lubrication cutoff at gaps of a quarter of a diameter the ring stays
    the contact cutoff 1.6 d and K = 29: the 18 lattice neighbours
    inside it fit, and the (K, N, 11) partner gather is 167 MB in f32 at
    131,072 particles. Cohesion: Hamaker 1e-15 J, lam = smin = 1e-7 m
    (the saturated force is 5% of a particle's weight). Lubrication:
    water, log terms, FLD drag with the volume-fraction correction, the
    inner cutoff just above a diameter. The particles get seeded random
    velocities up to 0.01 m/s and spins to match, so that the
    velocity-proportional lubrication terms are not zero. Before
    setup_forces; on `device` (by default the CUDA card)."""
    import dataclasses

    from sedifoam_tpu_torch import bench_case
    from sedifoam_tpu_torch.config import CohesionParams
    from sedifoam_tpu_torch.dem.lubrication import LubricationParams
    from sedifoam_tpu_torch.io.case import neighbor_ring

    device = default_device(device)
    size = dict(bench_case.FULL)
    if n_particles < size["n_particles"]:
        # a window of the lattice's first particles in the same box
        size["n_particles"] = n_particles
    cfg = bench_case.build_config(**size)
    _, particles = bench_case.build_state(cfg, n_particles, dtype=dtype,
                                          device=device)
    d = 1e-3
    L = cfg.grid.lengths
    cohe = None if cohesion_model is None else CohesionParams(
        ah=1e-15, lam=1e-7, smin=1e-7, smax=0.2 * d, model=cohesion_model)
    lub = LubricationParams(
        mu=1e-3, flaglog=1, flagfld=1, cut_inner=1.001 * d, cut=1.25 * d,
        flag_hi=1, flag_vf=1, box_volume=L[0] * L[1] * L[2]) \
        if lubrication else None
    skin, cutoff, ring, k = neighbor_ring(d, d, cohe, lub)
    dem = dataclasses.replace(cfg.dem, cohesion=cohe, lubrication=lub,
                              skin=skin, cutoff=cutoff, audit_ring=ring,
                              nbr_k=k)
    n = particles.n_capacity
    particles = particles._replace(
        shear=torch.zeros((3, k, n), dtype=dtype, device=device),
        nbr_idx=torch.full((k, n), n, dtype=torch.int32, device=device))
    rng = np.random.RandomState(43)
    vmax = 0.01
    vel = torch.as_tensor(rng.uniform(-vmax, vmax, (n, 3)), dtype=dtype,
                          device=device)
    omega = torch.as_tensor(rng.uniform(-1.0, 1.0, (n, 3)) * vmax / (0.5 * d),
                            dtype=dtype, device=device)
    return dem, particles._replace(vel=vel, v_old=vel.clone(), omega=omega)


# ---------------------------------------------------------------------------
# jetFlow: the particle-laden round jet on an O-grid
# ---------------------------------------------------------------------------

# the tank and jet (scripts/validate_jetflow.py:3-6: a D = 5 mm jet at
# 1.72 m/s into a 0.1 x 0.3 x 0.1 m tank, 0.5 mm particles added every
# 2.5 ms) and the embedded mesh (tests/test_jetflow.py:34-53)
JET_BOX = (-0.05, 0.05, 0.0, 0.3, -0.05, 0.05)
JET_D = 0.005
JET_U = 1.72
JET_COLUMN = 0.0044           # the O-grid's square jet column
JET_FULL = dict(counts=(56, 120, 56), column_cells=8)
JET_PARTICLE_D = 5e-4
JET_RHOA = 2500.0
JET_ADD_INTERVAL = 0.0025
JET_DEM_DT = 1e-6
JET_SIDE_GRADING = 0.06       # side blocks, outer -> inner
JET_AXIAL_GRADING = 4.0       # last/first axial cell


def jetflow_seed():
    """The LAMMPS data file's rows (id type d rho x y z) of jetFlow's seed
    particles: four frozen type-2 particles (the `bottom` group) on the
    floor 20 mm off the axis, outside the inlet disc, and two type-1
    particles resting on the floor 30 mm off the axis in x and z."""
    d = JET_PARTICLE_D
    y = JET_BOX[2] + 0.5 * d
    sites = [(2, 0.02, 0.0), (2, -0.02, 0.0), (2, 0.0, 0.02),
             (2, 0.0, -0.02), (1, 0.03, 0.03), (1, -0.03, -0.03)]
    return [f"{i} {t} {d} {JET_RHOA} {x:.8f} {y:.8f} {z:.8f}"
            for i, (t, x, z) in enumerate(sites, start=1)]


def _ogrid_mesh(counts, column_cells):
    """jetFlow's five-block O-grid (a blockMeshDict body): a square jet
    column JET_COLUMN m wide along y through JET_BOX's x-z centre, its
    vertical edges bulged by arcs through points on the inlet disc's rim
    (diameter JET_D), and four side blocks out to the box, graded
    JET_SIDE_GRADING from the outer face to the column. Every block is
    right-handed and has `counts[1]` axial cells, graded
    JET_AXIAL_GRADING.
    Patches: `inlet` (the column's floor), `bottom` (the rest of the
    floor), `top` and `outer` (the four side faces)."""
    nx, ny, nz = counts
    side = (nx - column_cells) // 2
    if nx != nz or side < 1 or 2 * side + column_cells != nx:
        raise ValueError(f"counts {counts}: the two cross axes must each be "
                         f"two equal side segments around {column_cells} "
                         "column cells")
    box, mm = JET_BOX, 1e3
    cx, cz = 0.5 * (box[0] + box[1]) * mm, 0.5 * (box[4] + box[5]) * mm
    h, R = 0.5 * JET_COLUMN * mm, 0.5 * JET_D * mm
    x0, x1, z0, z1 = box[0] * mm, box[1] * mm, box[4] * mm, box[5] * mm
    ring = [(x0, z0), (x1, z0), (x1, z1), (x0, z1),
            (cx - h, cz - h), (cx + h, cz - h), (cx + h, cz + h),
            (cx - h, cz + h)]
    verts = "\n".join(f"    ({x:.10g} {y:.10g} {z:.10g})"
                      for y in (box[2] * mm, box[3] * mm) for x, z in ring)
    g, gy, nc = JET_SIDE_GRADING, JET_AXIAL_GRADING, column_cells
    blocks = [
        ((4, 7, 6, 5), (nc, nc), (1, 1)),             # the column
        ((0, 4, 5, 1), (side, nc), (g, 1)),           # -z side
        ((2, 6, 7, 3), (side, nc), (g, 1)),           # +z side
        ((3, 7, 4, 0), (side, nc), (g, 1)),           # -x side
        ((1, 5, 6, 2), (side, nc), (g, 1)),           # +x side
    ]
    hexes = "\n".join(
        f"    hex ({' '.join(map(str, q))} {' '.join(str(v + 8) for v in q)}) "
        f"({n1} {n2} {ny}) simpleGrading ({g1:g} {g2:g} {gy:g})"
        for q, (n1, n2), (g1, g2) in blocks)
    arcs = []
    for lvl, y in ((0, box[2] * mm), (8, box[3] * mm)):
        for (a, b), (mx, mz) in (((4, 5), (cx, cz - R)),
                                 ((5, 6), (cx + R, cz)),
                                 ((6, 7), (cx, cz + R)),
                                 ((7, 4), (cx - R, cz))):
            arcs.append(f"    arc {a + lvl} {b + lvl} "
                        f"({mx:.10g} {y:.10g} {mz:.10g})")
    arcs = "\n".join(arcs)
    return f"""
convertToMeters 0.001;
vertices
(
{verts}
);
blocks
(
{hexes}
);
edges
(
{arcs}
);
boundary
(
    inlet  {{ type patch; faces ( (4 7 6 5) ); }}
    bottom {{ type wall; faces ( (0 4 5 1) (2 6 7 3) (3 7 4 0) (1 5 6 2) ); }}
    top    {{ type patch; faces ( (12 13 14 15) (8 9 13 12) (10 11 15 14)
                                 (11 8 12 15) (9 10 14 13) ); }}
    outer  {{ type wall; faces ( (0 1 9 8) (2 3 11 10) (3 0 8 11)
                                 (1 2 10 9) ); }}
);
"""


def jetflow_boxes(counts=JET_FULL["counts"]):
    """(add box, delete box) of write_jetflow_case, each (x0 x1 y0 y1 z0
    z1): the add box is the square inscribed in the inlet disc, from the
    floor to halfway between the full mesh's second-layer centre plane
    and the 2x-coarsened mesh's first: it holds the first cell layer's
    centres on both meshes and nothing above them. The delete box is the
    top two cell layers over the whole cross-section."""
    from sedifoam_tpu_torch.io.case import _graded_faces
    box = JET_BOX
    y = _graded_faces(box[2], box[3], counts[1], JET_AXIAL_GRADING)
    cx, cz = 0.5 * (box[0] + box[1]), 0.5 * (box[4] + box[5])
    half = 0.5 * JET_D / np.sqrt(2.0)
    y_add = 0.25 * (y[1] + 2.0 * y[2])
    add = (cx - half, cx + half, box[2], y_add, cz - half, cz + half)
    delete = (box[0], box[1], y[-3], box[3], box[4], box[5])
    return add, delete


def write_jetflow_case(case_dir: str, counts=JET_FULL["counts"],
                       column_cells=JET_FULL["column_cells"],
                       add_interval=JET_ADD_INTERVAL,
                       dem_dt=JET_DEM_DT) -> str:
    """Write jetFlow, the particle-laden round jet (the reference's
    cases/example-cases/jetFlow, after Wang's LES of starting and
    developed particle-laden jets), as a case directory that both
    packages load with load_case(..., embed_ogrid=True). Returns
    case_dir.

    From what the repo records:
    - the O-grid (tests/test_jetflow.py:34-53): four side blocks of 24
      cells graded 0.06 from outer to inner around a column 4.4 mm wide
      of 8 uniform cells, 120 axial cells; x and z from -0.05 to 0.05 m;
      the column's end on the floor is the `inlet` patch, an arc-edged
      disc of radius 2.5 mm inside the `bottom` patch; `top` is the y+
      face and `outer` the four side faces. Embedded: 56 x 120 x 56;
    - the tank 0.1 x 0.3 x 0.1 m, the D = 5 mm jet at 1.72 m/s along +y,
      0.5 mm particles added every 2.5 ms near the inlet and deleted near
      the outlet (scripts/validate_jetflow.py:1-20);
    - the BCs (tests/test_jetflow.py:55-83): Ub fixedValue (0 1.72 0) on
      the inlet and slip on the rest of the floor, inletOutlet at the
      top with p fixedValue 0 there; alpha and Ua slip on the floor
      (zeroGradient for the scalar); kEqn LES chosen by the `LES`
      subdict of turbulenceProperties (a stale constant/LESProperties
      naming Smagorinsky is written too, as the reference ships one);
      the type-2 `bottom` group excluded from `fix nve/sphere`, so
      frozen; addParticle and deleteParticle on, add velocity (0 1.72
      0);
    - deltaT 2e-4 s to endTime 1.5 s and a DEM timestep of 1e-6 s: 200
      substeps, 7,500 steps (STATUS.md:5-20).

    Chosen here (the repo does not record them):
    - the axial grading: last cell 4x the first (1.15 mm at the inlet,
      4.6 mm at the top; Courant 0.30 at 1.72 m/s in the first layer);
      the side grading's direction and the arcs through the disc's rim
      at the column's edge midpoints; straight outer edges (the tank is
      the box the embedding keeps);
    - the outer walls: slip for Ub and Ua, zeroGradient for alpha and
      p; alpha inletOutlet 0 and Ua zeroGradient at the top;
    - the grains: glass, 2500 kg/m^3; water (rhob 1000, nub 1e-6; jet Re
      8,600); gravity 9.81 m/s^2 along -y; ErgunWenYu drag (Wen-Yu at
      these dilute fractions), diffusionBandWidth 3 mm, the explicit
      drag (the script sets no semi-implicit one), pressure gradient on
      and no separate buoyancy (the loader's defaults);
    - the pair and wall line `gran/hooke/history 200 NULL 50000 NULL
      0.4 0` (the sand cases'): the Hooke contact time
      pi*sqrt(m_eff/kn) = 6.4e-5 s is 64 DEM steps; walls on the vertex
      bounding box; `boundary f f f`;
    - the add box (jetflow_boxes): the square inscribed in the inlet
      disc over the first cell layer, 6 x 6 = 36 sites (the column's
      middle cells, 0.55 mm apart: no two seeds touch), cleared before
      each add (deleteBeforeAdd, clearInitialBox = the add box),
      randomPerturb 5e-5 m (+-25 um); the delete box: the top two cell
      layers (9.2 mm) over the whole cross-section;
    - the seed particles (jetflow_seed): four frozen type-2 and two
      type-1 particles on the floor off the disc;
    - PCG tolerance 1e-6 with 2 PISO correctors; the fluid at rest; the
      five axis probes of the validator (y/D 10 to 50).

    The population: 36 particles an add, 400 adds a second, so 14,400
    a second. None leaves before it has crossed the 0.29 m to the
    delete box, at 1.72 m/s at most (0.17 s), so at t = 1.5 s at least
    the last 0.17 s of adds are in the tank (2,450 > 100), and at most
    every add of the run (600 x 36 + 6 = 21,606 < 65,536): the bounds of
    the validator's `particles_flowing` gate hold whatever the jet does
    with them.

    `counts` and `column_cells` shrink the mesh (each cross axis is two
    equal side segments around the column), `add_interval` and `dem_dt`
    the run (tests).
    """
    box = JET_BOX
    _foam(case_dir, "constant/polyMesh/blockMeshDict", "dictionary",
          _ogrid_mesh(counts, column_cells))
    zg = "type zeroGradient;"
    slip = "type slip;"
    _field(case_dir, "alpha", "volScalarField", _DIMS["alpha"], "uniform 0",
           {"inlet": slip, "bottom": slip,
            "top": "type inletOutlet; inletValue uniform 0; value uniform 0;",
            "outer": zg})
    _field(case_dir, "p", "volScalarField", _DIMS["p"], "uniform 0",
           {"inlet": zg, "bottom": zg,
            "top": "type fixedValue; value uniform 0;", "outer": zg})
    _field(case_dir, "Ub", "volVectorField", _DIMS["U"], "uniform (0 0 0)",
           {"inlet": f"type fixedValue; value uniform (0 {JET_U} 0);",
            "bottom": slip,
            "top": "type inletOutlet; inletValue uniform (0 0 0); "
                   "value uniform (0 0 0);",
            "outer": slip})
    _field(case_dir, "Ua", "volVectorField", _DIMS["U"], "uniform (0 0 0)",
           {"inlet": slip, "bottom": slip, "top": zg, "outer": slip})
    D = JET_D
    _foam(case_dir, "system/controlDict", "dictionary", f"""
startTime 0;
endTime 1.5;
deltaT 2e-4;
writeInterval 0.1;
""" + _probes([(0.0, s * D, 0.0) for s in (10, 20, 30, 40, 50)]))
    _foam(case_dir, "system/fvSolution", "dictionary", """
solvers
{
    p { solver PCG; preconditioner DIC; tolerance 1e-6; relTol 0; }
}
PISO { nCorrectors 2; nNonOrthogonalCorrectors 0; pRefCell 0; pRefValue 0; }
""")
    _foam(case_dir, "constant/transportProperties", "dictionary", f"""
rhoa rhoa [1 -3 0 0 0 0 0] {JET_RHOA};
rhob rhob [1 -3 0 0 0 0 0] 1000;
nub nub [0 2 -1 0 0 0 0] 1e-06;
Cvm Cvm [0 0 0 0 0 0 0] 0;
Cl Cl [0 0 0 0 0 0 0] 0;
""")
    _foam(case_dir, "constant/environmentalProperties", "dictionary",
          "g g [0 1 -2 0 0 0 0] (0 -9.81 0);\n")
    _foam(case_dir, "constant/turbulenceProperties", "dictionary", """
simulationType LES;
LES { LESModel kEqn; turbulence on; delta cubeRootVol; }
""")
    _foam(case_dir, "constant/LESProperties", "dictionary",
          "LESModel Smagorinsky;\ndelta cubeRootVol;\n")
    add, delete = jetflow_boxes(counts)

    def vec(v):
        return "(" + " ".join(repr(float(x)) for x in v) + ")"

    _foam(case_dir, "constant/cloudProperties", "dictionary", f"""
dragModel ErgunWenYu;
subCycles 1;
diffusionBandWidth 0.003;
addParticle 1;
addParticleTimeStep {add_interval};
addParticleInfo ({JET_PARTICLE_D} {JET_RHOA} 1);
addParticleVelocity (0 {JET_U} 0);
addParticleBox {vec(add)};
deleteBeforeAdd 1;
clearInitialBox {vec(add)};
randomPerturb 5e-05;
deleteParticle 1;
deleteParticleBox {vec(delete)};
""")
    _write(os.path.join(case_dir, "in.lammps"), f"""\
atom_style      sphere
boundary        f f f
newton          off
read_data       In_initial.in
pair_style      gran/hooke/history {SAND_GRAN}
pair_coeff      * *
timestep        {dem_dt}
group           bottom type 2
group           active subtract all bottom
fix             1 active nve/sphere
fix             2 all gravity 9.81 vector 0 -1 0
fix             3 all fdrag
fix             xwalls all wall/gran {SAND_GRAN} xplane {box[0]} {box[1]}
fix             ywalls all wall/gran {SAND_GRAN} yplane {box[2]} {box[3]}
fix             zwalls all wall/gran {SAND_GRAN} zplane {box[4]} {box[5]}
""")
    _data_file(os.path.join(case_dir, "In_initial.in"), jetflow_seed(),
               box, 2)
    return case_dir
