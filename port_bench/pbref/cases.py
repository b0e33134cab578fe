"""The transport-bedload channel written as a sediFoam case directory
(0/, constant/, system/, in.lammps and a LAMMPS data file): a frozen copy
of the port's `cases.write_channel_case` and the helpers it uses. The
benchmark writes the directory once and both the program's loader and
the reference's read it."""

from __future__ import annotations

import os

import numpy as np


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


def channel_bed(box, d, rho, n_layers, frozen_layers, seed):
    """scripts/validate_bedload.py's jittered simple-cubic bed over the
    channel's x-z extent: data-file rows (id type d rho x y z), the
    bottom `frozen_layers` of type 2, the rest type 1, the layers 2.05 r
    apart."""
    rng = np.random.default_rng(seed)
    r = 0.5 * d
    pitch = 2.05 * r
    nx = int((box[1] - box[0] - d) / pitch)
    nz = int((box[5] - box[4] - d) / pitch)
    rows = []
    tag = 1
    for layer in range(n_layers):
        y = box[2] + r + layer * pitch
        for i in range(nx):
            for k in range(nz):
                x = box[0] + r + (i + 0.5) * (box[1] - box[0] - d) / nx
                z = box[4] + r + (k + 0.5) * (box[5] - box[4] - d) / nz
                jx, jz = rng.uniform(-0.02 * r, 0.02 * r, 2)
                t = 2 if layer < frozen_layers else 1
                rows.append(f"{tag} {t} {d} {rho} "
                            f"{x + jx:.8f} {y:.8f} {z + jz:.8f}")
                tag += 1
    return rows


def write_channel_case(case_dir: str, counts, box, y_grading, layers, d,
                       rho, frozen_layers, seed, ubar, dt, dem_dt,
                       les_model) -> str:
    """Write a transport-bedload channel (the SediFoam paper's sediment
    transport case) as a case directory; returns case_dir. Every size
    is an argument (the configuration's file gives them):

    - the `box` (x0 x1 y0 y1 z0 z1) meshed as one hex of `counts` cells
      with `simpleGrading (1 y_grading 1)`, patches bottom (y-) and top
      (y+) walls, left/right (x) and front/back (z) cyclic;
    - scripts/validate_bedload.py's jittered bed of `layers` layers of
      grains of diameter `d` and density `rho`, the bottom
      `frozen_layers` of type 2 and frozen, the jitter from `seed`;
    - water (rhob 1000, nub 1e-6), top slip, the LES model `les_model`,
      Ubar (`ubar` 0 0), `boundary p f p`, y walls;
    - deltaT `dt`, DEM timestep `dem_dt`.

    Chosen by the port's writer (the repo does not record them), kept
    here as they are:
    - the pair (and wall) line: xiaocase3's gran/hooke/history 5000 NULL
      11200 NULL 0.1 0;
    - `fix fdrag` with carrier density 1000, so the DDtU path runs;
    - ErgunWenYu drag; the loader's defaults for the smoothing;
    - the pressure solve: PCG tolerance 1e-6, 2 PISO correctors;
    - the fluid starts at rest; 0/Ua pins the bottom to its internal
      field ($internalField).
    """
    nx, ny, nz = counts
    mesh = _y_stacked_mesh(box, nx, nz, [(box[3], ny, y_grading)])
    L = box[1], box[3], box[5]
    _transport_case(
        case_dir, box, mesh, top_wall=False, end_time=3, ubar=ubar,
        cloud="dragModel ErgunWenYu;\nsubCycles 1;\n",
        gran="5000 NULL 11200 NULL 0.1 0", dt=dt, dem_dt=dem_dt,
        rho=rho, les_model=les_model,
        rows=channel_bed(box, d, rho, layers, frozen_layers, seed),
        probes=[(0.5 * L[0], 0.5 * L[1], 0.5 * L[2]),
                (0.5 * L[0], 0.9 * L[1], 0.5 * L[2])])
    return case_dir


def _transport_case(case_dir, box, mesh, top_wall, end_time, ubar, cloud,
                    gran, dt, dem_dt, rho, les_model, rows, probes):
    """The dictionaries the transport channels share, written into
    case_dir: `mesh` (a blockMeshDict body with patches bottom, top,
    left/right and front/back), cyclic x/z, a no-slip bottom and a top
    that is a no-slip wall (`top_wall`) or slip; the fluid at rest; deltaT
    `dt` to `end_time`, `probes`; PCG tolerance 1e-6 with 2 PISO
    correctors; water (rhob 1000, nub 1e-6) with grains of density
    `rho`, Ubar (`ubar` 0 0), gravity 9.81; LES `les_model`; `cloud` as
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
deltaT {dt};
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
rhoa rhoa [1 -3 0 0 0 0 0] {rho};
rhob rhob [1 -3 0 0 0 0 0] 1000;
nub nub [0 2 -1 0 0 0 0] 1e-06;
Ubar Ubar [0 1 -1 0 0 0 0] ({ubar} 0 0);
""")
    _foam(case_dir, "constant/environmentalProperties", "dictionary",
          "g g [0 1 -2 0 0 0 0] (0 -9.81 0);\n")
    _foam(case_dir, "constant/turbulenceProperties", "dictionary", f"""
simulationType LES;
LES {{ LESModel {les_model}; turbulence on; delta cubeRootVol; }}
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
