"""Stand-in case directories for the reference's own auto-testing and
example cases (xiaocase1, expMueller06/09, expWachem_PCM, BL24-TH1,
multiParticlesCollideDia/Rho), written in the reference's formats and
laid out as its case tree (auto-testing/test-cases/<case>,
example-cases/<case>).

The reference's case directories are not part of this repository. The
stand-ins exist so that the port's validators and the JAX package's get
the same inputs: they carry every format the real cases use (the
controlDict `functions` probes, a `uniformFixedValue` `table` inlet ramp,
a sampleDict `sets` list, a LAMMPS data file such as In_initial.in, the
data/ curves), at the real cases' particle counts where asked. Their
geometry, material constants and data/ curves are chosen here, fixed
curves and seeded lattices: they say nothing of the physics, and no gate
judged on them is evidence of it.

Imports nothing of JAX (chip_smoke.py writes them on the card's host).
"""

import os

import numpy as np

from sedifoam_tpu_torch.cases import (_DIMS, _data_file, _field, _foam,
                                      _probes, _transport_case, _write,
                                      _y_stacked_mesh)

TEST_CASES = os.path.join("auto-testing", "test-cases")
EXAMPLE_CASES = "example-cases"

# the real cases' particle counts (scripts/validate_*.py, results/
# report.json) and the stand-ins' meshes at that scale
# (the lattices pressed 0.1% of d into each other and the walls: contacts
# from the first substep; DEM timesteps below a tenth of the Hooke
# contact time)
FULL = {
    "xiaocase1": dict(n=2160, counts=(16, 80, 3), dem_dt=1e-5, pitch=0.999),
    "expMueller06": dict(n=9240, counts=(22, 60, 5), dem_dt=5e-6,
                         pitch=0.999),
    "expMueller09": dict(n=9240, counts=(22, 60, 5), dem_dt=5e-6,
                         pitch=0.999),
    "expWachem_PCM": dict(n=17562, counts=(30, 100, 3), dem_dt=1e-5,
                          pitch=0.999),
    "BL24-TH1": dict(n=9341, counts=(16, 100, 4), dem_dt=2.5e-6,
                     pitch=0.999),
}

XIAO_BOX = (0.0, 0.04, 0.0, 0.2, 0.0, 0.006)
MUELLER_BOX = (0.0, 0.044, 0.0, 0.12, 0.0, 0.01)
WACHEM_BOX = (0.0, 0.09, 0.0, 0.5, 0.0, 0.008)
BL24_BOX = (0.0, 0.016, 0.0, 0.1, 0.0, 0.004)
COLLIDE_BOX = (0.0, 0.2, 0.0, 0.1, 0.0, 0.1)


def lattice_rows(n, box, d, rho, seed, pitch=1.05, ptype=None, y0=None):
    """n data-file rows (id type d rho x y z): a simple-cubic lattice of
    spheres of diameter d, each in a cell `pitch` d wide, filled from the
    floor (or y0) up inside the box, each jittered by up to 2% r in x and
    z (seeded; with a pitch above 1 + 4% no sphere touches a wall or
    another, below 1 each presses into its neighbours and the walls);
    `ptype(layer)` gives a layer's type (default 1)."""
    rng = np.random.RandomState(seed)
    r = 0.5 * d
    a = pitch * d
    nx = int((box[1] - box[0]) / a)
    nz = int((box[5] - box[4]) / a)
    rows = []
    layer = 0
    base = box[2] if y0 is None else y0
    while len(rows) < n:
        y = base + (layer + 0.5) * a
        if y + r > box[3]:
            raise ValueError(f"{n} spheres of {d} m do not fit the box")
        for i in range(nx):
            for k in range(nz):
                if len(rows) == n:
                    break
                x = box[0] + (i + 0.5) * a
                z = box[4] + (k + 0.5) * a
                jx, jz = rng.uniform(-0.02 * r, 0.02 * r, 2)
                t = 1 if ptype is None else ptype(layer)
                rows.append(f"{len(rows) + 1} {t} {d} {rho} "
                            f"{x + jx:.9f} {y:.9f} {z + jz:.9f}")
        layer += 1
    return rows


def _column_mesh(box, counts):
    """A one-block blockMeshDict body: inlet at y-, outlet at y+, walls
    on the x and z sides."""
    X, Y, Z = box[1], box[3], box[5]
    nx, ny, nz = counts
    return f"""
convertToMeters 1;
vertices ( (0 0 0) ({X} 0 0) ({X} {Y} 0) (0 {Y} 0)
           (0 0 {Z}) ({X} 0 {Z}) ({X} {Y} {Z}) (0 {Y} {Z}) );
blocks ( hex (0 1 2 3 4 5 6 7) ({nx} {ny} {nz}) simpleGrading (1 1 1) );
edges ();
boundary
(
    inlet  {{ type patch; faces ( (1 5 4 0) ); }}
    outlet {{ type patch; faces ( (3 7 6 2) ); }}
    walls  {{ type wall;  faces ( (0 4 7 3) (2 6 5 1) (0 3 2 1)
                                 (4 5 6 7) ); }}
);
"""


def _column_case(case_dir, box, counts, rows, inlet, rhob, nub, rhoa,
                 gran, dem_dt, sub_cycles, drag, dt, end_time,
                 probes=(), n_types=1, cloud_extra=""):
    """A fluidized column (the xiaocase1 / Mueller / Wachem pattern):
    `inlet` the 0/Ub inlet entries, gas or liquid of density rhob at
    rest, outlet p = 0, no-slip walls, laminar, gravity 9.8 in -y for
    both the fluid and the DEM, the `gran` pair on hooke/history and the
    three wall planes, `rows` in the data file IC.in."""
    _foam(case_dir, "constant/polyMesh/blockMeshDict", "dictionary",
          _column_mesh(box, counts))
    zg = "type zeroGradient;"
    _field(case_dir, "alpha", "volScalarField", _DIMS["alpha"], "uniform 0",
           {"inlet": "type fixedValue; value uniform 0;",
            "outlet": zg, "walls": zg})
    _field(case_dir, "p", "volScalarField", _DIMS["p"], "uniform 0",
           {"inlet": zg, "outlet": "type fixedValue; value uniform 0;",
            "walls": zg})
    _field(case_dir, "Ub", "volVectorField", _DIMS["U"], "uniform (0 0 0)",
           {"inlet": inlet,
            "outlet": "type inletOutlet; inletValue uniform (0 0 0); "
                      "value uniform (0 0 0);",
            "walls": "type fixedValue; value uniform (0 0 0);"})
    _field(case_dir, "Ua", "volVectorField", _DIMS["U"], "uniform (0 0 0)",
           {"inlet": zg, "outlet": zg, "walls": zg})
    _foam(case_dir, "system/controlDict", "dictionary", f"""
startFrom latestTime;
startTime 0;
endTime {end_time};
deltaT {dt};
writeInterval 1;
""" + (_probes(probes) if probes else ""))
    _foam(case_dir, "system/fvSolution", "dictionary", """
solvers
{
    p { solver PCG; preconditioner DIC; tolerance 1e-8; relTol 0; }
}
PISO { nCorrectors 2; nNonOrthogonalCorrectors 0; pRefCell 0; pRefValue 0; }
""")
    _foam(case_dir, "constant/transportProperties", "dictionary", f"""
rhoa rhoa [1 -3 0 0 0 0 0] {rhoa};
rhob rhob [1 -3 0 0 0 0 0] {rhob};
nub nub [0 2 -1 0 0 0 0] {nub};
Cvm Cvm [0 0 0 0 0 0 0] 0;
Cl Cl [0 0 0 0 0 0 0] 0;
""")
    _foam(case_dir, "constant/environmentalProperties", "dictionary",
          "g g [0 1 -2 0 0 0 0] (0 -9.8 0);\n")
    _foam(case_dir, "constant/turbulenceProperties", "dictionary",
          "simulationType laminar;\n")
    _foam(case_dir, "constant/cloudProperties", "dictionary", f"""
dragModel {drag};
subCycles {sub_cycles};
diffusionBandWidth {2.0 * (box[1] - box[0]) / counts[0]};
diffusionSteps 6;
""" + cloud_extra)
    X, Y, Z = box[1], box[3], box[5]
    _write(os.path.join(case_dir, "in.lammps"), f"""\
atom_style      sphere
processors      2 1 1
boundary        f f f
newton          off
read_data       IC.in
pair_style      gran/hooke/history {gran}
pair_coeff      * *
timestep        {dem_dt}
fix             1 all nve/sphere
fix             2 all gravity 9.8 vector 0 -1 0
fix             3 all fdrag
fix             xwalls all wall/gran {gran} xplane 0.0 {X}
fix             ywalls all wall/gran {gran} yplane 0.0 {Y}
fix             zwalls all wall/gran {gran} zplane 0.0 {Z}
""")
    _data_file(os.path.join(case_dir, "IC.in"), rows, box, n_types)
    return case_dir


def _curve(path, cols):
    _write(path, "\n".join(" ".join(f"{v:.9g}" for v in row)
                           for row in np.column_stack(cols)) + "\n")


def write_xiaocase1(case_dir, n=40, counts=(6, 16, 2), dem_dt=2.5e-5,
                    seed=1, y0=None, pitch=1.05):
    """xiaocase1's pattern: 1.5 mm glass spheres (2,500 kg/m^3) in a 4 x
    20 cm air column, the inlet's Ub a uniformFixedValue table ramping 0
    -> 1.5 m/s over 15 s and back by 30 s, deltaT 1e-4, subCycles 2, the
    gran/hooke/history 4910 pair, the probes at y = 0.002 and 0.16;
    data/p_bench.dat a fixed curve. The lattice stands on the floor, or
    from `y0` up (free of contacts for a while: a short comparison then
    follows no chaotic collision); `pitch` as lattice_rows."""
    rows = lattice_rows(n, XIAO_BOX, 1.5e-3, 2500.0, seed, pitch, y0=y0)
    inlet = ("type uniformFixedValue; uniformValue table ( (0 (0 0 0)) "
             "(15 (0 1.5 0)) (30 (0 0 0)) );")
    _column_case(case_dir, XIAO_BOX, counts, rows, inlet, rhob=1.2,
                 nub=1.5e-5, rhoa=2500, gran="4910 NULL 20 NULL 0.3 0",
                 dem_dt=dem_dt, sub_cycles=2, drag="SyamlalOBrien",
                 dt=1e-4, end_time=30,
                 probes=[(0.02, 0.002, 0.003), (0.02, 0.16, 0.003)])
    t = np.linspace(0.0, 30.0, 61)
    _curve(os.path.join(case_dir, "data", "p_bench.dat"),
           [t, 150.0 + 100.0 * np.sin(np.pi * t / 30.0)])
    return case_dir


def write_wachem(case_dir, n=60, counts=(6, 20, 2), dem_dt=2.5e-5, seed=2,
                 y0=None, pitch=1.05):
    """expWachem_PCM's pattern: a gas-fluidized bed of 1.5 mm spheres
    (2,500 kg/m^3) in a 9 cm column, a constant inlet (0 1.2 0) m/s,
    the controlDict probes at y = 0.005 and 0.045 inside the bed, no
    data/ curve (the reference ships none); `y0` and `pitch` as
    write_xiaocase1."""
    rows = lattice_rows(n, WACHEM_BOX, 1.5e-3, 2500.0, seed, pitch, y0=y0)
    _column_case(case_dir, WACHEM_BOX, counts, rows,
                 "type fixedValue; value uniform (0 1.2 0);", rhob=1.2,
                 nub=1.5e-5, rhoa=2500, gran="5000 NULL 20 NULL 0.3 0",
                 dem_dt=dem_dt, sub_cycles=1, drag="SyamlalOBrien",
                 dt=1e-4, end_time=3,
                 probes=[(0.045, 0.005, 0.004), (0.045, 0.045, 0.004)])
    return case_dir


def mueller_lines(name):
    """The sampleDict's lines: lineY1..Y3 (06) or lineY1..Y5 (09), across
    x at heights 5 mm apart, mid-depth."""
    n = 3 if name.endswith("06") else 5
    return {f"lineY{i}": 0.005 * i for i in range(1, n + 1)}


def write_mueller(case_dir, n=60, counts=(8, 12, 2), dem_dt=2.5e-5, seed=3,
                  n_points=20, y0=None, pitch=1.05):
    """expMueller06/09's pattern (by the directory's name): 1.2 mm
    spheres (1,000 kg/m^3) in a 44 mm gas column, inlet (0 0.9 0) m/s,
    a system/sampleDict `sets` list, and data/sets_bench lineY*_UaMean.xy
    (x ux uy uz) and lineY1/Y2_alphaMean.xy (x alpha): fixed curves;
    `y0` and `pitch` as write_xiaocase1."""
    name = os.path.basename(os.path.normpath(case_dir))
    rows = lattice_rows(n, MUELLER_BOX, 1.2e-3, 1000.0, seed, pitch, y0=y0)
    _column_case(case_dir, MUELLER_BOX, counts, rows,
                 "type fixedValue; value uniform (0 0.9 0);", rhob=1.2,
                 nub=1.5e-5, rhoa=1000, gran="3000 NULL 20 NULL 0.3 0",
                 dem_dt=dem_dt, sub_cycles=1, drag="SyamlalOBrien",
                 dt=1e-4, end_time=10)
    X, Z = MUELLER_BOX[1], MUELLER_BOX[5]
    sets = "".join(
        f"    {line}\n    {{\n        type uniform;\n        axis x;\n"
        f"        start (0 {y} {0.5 * Z});\n        end ({X} {y} {0.5 * Z});"
        f"\n        nPoints {n_points};\n    }}\n"
        for line, y in mueller_lines(name).items())
    _foam(case_dir, "system/sampleDict", "dictionary", f"""
interpolationScheme cellPoint;
setFormat raw;
sets
(
{sets});
fields ( UaMean alphaMean );
""")
    x = np.linspace(0.0, X, 15)
    for i, line in enumerate(mueller_lines(name), start=1):
        uy = 0.05 * i * np.cos(2.0 * np.pi * x / X)
        _curve(os.path.join(case_dir, "data", "sets_bench",
                            f"{line}_UaMean.xy"),
               [x, np.zeros_like(x), uy, np.zeros_like(x)])
        if i <= 2:
            _curve(os.path.join(case_dir, "data", "sets_bench",
                                f"{line}_alphaMean.xy"),
                   [x, 0.3 + 0.05 * i * np.sin(np.pi * x / X)])
    return case_dir


def write_bl24(case_dir, n=9341, counts=(16, 100, 4), dem_dt=2.5e-5,
               seed=4, y_blocks=None, pitch=1.02):
    """BL24-TH1's pattern: a 3-block y-graded channel, cyclic in x and z,
    kEqn LES, Ubar 0.167 m/s, 0.5 mm sand (2,500 kg/m^3) as In_initial.in
    with its bottom layer type 2 (frozen), `boundary p f p`; `pitch` as
    lattice_rows."""
    box = BL24_BOX
    nx, ny, nz = counts
    if y_blocks is None:
        n1 = max(1, ny // 2)
        n2 = max(1, (ny - n1) // 2)
        y_blocks = [(0.03, n1, 1), (0.06, n2, 2), (box[3], ny - n1 - n2, 2)]
    rows = lattice_rows(n, box, 0.5e-3, 2500.0, seed, pitch,
                        ptype=lambda layer: 2 if layer == 0 else 1)
    _transport_case(case_dir, box, _y_stacked_mesh(box, nx, nz, y_blocks),
                    top_wall=False, end_time=2, ubar=0.167,
                    cloud="dragModel ErgunWenYu;\nsubCycles 1;\n"
                          "diffusionBandWidth 0.002;\n",
                    gran="2000 NULL 20 NULL 0.3 0", dem_dt=dem_dt,
                    rows=rows, probes=[(0.008, 0.05, 0.002)])
    return case_dir


def collide_rows(name):
    """The four particles at the traces' t = 0 rows
    (tests/golden_data/<name>/p*.dat: id type d m x y z ...), their
    density from d and m."""
    here = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "golden_data", name)
    rows = []
    for i in range(4):
        r0 = np.loadtxt(os.path.join(here, f"p{i + 1}.dat"))[0]
        d, m = r0[2], r0[3]
        rho = m / (np.pi / 6.0 * d ** 3)
        rows.append(f"{i + 1} 1 {d} {rho:.6f} {r0[4]} {r0[5]} {r0[6]}")
    return rows


def write_collide(case_dir, counts=(20, 10, 1), end_time=0.2, dt=1e-3,
                  dem_dt=1e-5):
    """multiParticlesCollide{Dia,Rho}'s pattern (by the directory's
    name): the four particles of the traces' first rows settling in
    water in a 0.2 x 0.1 m tank one cell deep, deltaT 1e-3 to endTime,
    DEM timestep 1e-5."""
    name = os.path.basename(os.path.normpath(case_dir))
    box = COLLIDE_BOX
    _column_case(case_dir, box, counts, collide_rows(name),
                 "type fixedValue; value uniform (0 0 0);", rhob=1000.0,
                 nub=1e-6, rhoa=2650, gran="5000 NULL 50 NULL 0.3 0",
                 dem_dt=dem_dt, sub_cycles=1, drag="SyamlalOBrien", dt=dt,
                 end_time=end_time)
    return case_dir


def write_tree(root, sizes=None, collide_end=0.2):
    """Every stand-in under `root`, laid out as the reference's case tree;
    `sizes` {case: writer keywords} (default: the small ones). Returns
    {case: directory}."""
    sizes = sizes or {}
    t = os.path.join(root, TEST_CASES)
    e = os.path.join(root, EXAMPLE_CASES)
    dirs = {
        "xiaocase1": write_xiaocase1(os.path.join(t, "xiaocase1"),
                                     **sizes.get("xiaocase1", {})),
        "expMueller06": write_mueller(os.path.join(t, "expMueller06"),
                                      **sizes.get("expMueller06", {})),
        "expMueller09": write_mueller(os.path.join(t, "expMueller09"),
                                      **sizes.get("expMueller09", {})),
        "expWachem_PCM": write_wachem(os.path.join(t, "expWachem_PCM"),
                                      **sizes.get("expWachem_PCM", {})),
        "BL24-TH1": write_bl24(os.path.join(e, "BL24-TH1"),
                               **sizes.get("BL24-TH1",
                                           dict(n=96, counts=(8, 9, 2)))),
    }
    for name in ("multiParticlesCollideDia", "multiParticlesCollideRho"):
        dirs[name] = write_collide(os.path.join(t, name),
                                   end_time=collide_end)
    return dirs
