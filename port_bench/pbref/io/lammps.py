"""LAMMPS input-script + granular data-file reader (port of
``sedifoam_tpu/io/lammps.py``; numpy only).

Parses the subset of commands the reference's in.lammps scripts use
(pair_style gran/*, fix wall/gran, fix gravity, fix fdrag, fix cohesive,
timestep, read_data; see cases/auto-testing/test-cases/*/in.lammps) and
the `atom_style sphere` data file (id type diameter density x y z).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import List, Optional, Tuple

import numpy as np

from pbref.config import CohesionParams, PairParams, WallSpec
from pbref.dem.lubrication import LubricationParams

_STYLE_MAP = {
    "gran/hooke": "hooke",
    "gran/hooke/history": "hooke_history",
    "gran/hertz/history": "hertz_history",
    "gran/hertzFix/history": "hertz_history",
}


class MissingICError(ValueError):
    """The in.lammps script reads a particle data file that is absent.

    Several reference example-cases ship without their `In_initial.in`
    (the bed IC was generated out-of-repo; e.g.
    cases/example-cases/transport-suspended/in.lammps:9). The reference
    would die inside LAMMPS read_data the same way — this error makes
    the refusal a one-line actionable diagnostic instead of a crash.
    """


def _lenient_float(tok: str) -> float:
    """atof-style parse: take the leading numeric prefix (the reference's
    cases contain tokens like '1.91+e2' that LAMMPS reads as 1.91)."""
    try:
        return float(tok)
    except ValueError:
        m = re.match(r"^[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?", tok)
        if m:
            return float(m.group(0))
        raise


def _num(tok: str) -> Optional[float]:
    if tok.upper() == "NULL":
        return None
    return _lenient_float(tok)


def _parse_pair_params(args: List[str], style: str) -> PairParams:
    kn = _lenient_float(args[0])
    kt = _num(args[1])
    gamman = _lenient_float(args[2])
    gammat = _num(args[3])
    xmu = _lenient_float(args[4])
    dampflag = int(args[5])
    return PairParams(style=style, kn=kn, kt=kt, gamman=gamman,
                      gammat=gammat, xmu=xmu, dampflag=dampflag)


@dataclasses.dataclass
class LammpsCase:
    dt: float = 1e-6
    pair: PairParams = PairParams()
    walls: Tuple[WallSpec, ...] = ()
    gravity: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    carrier_rho: float = 0.0
    cohesion: Optional[CohesionParams] = None
    lubrication: Optional[object] = None  # LubricationParams when parsed
    data_file: Optional[str] = None
    initial_velocity: Optional[Tuple[float, float, float]] = None
    # `boundary pp ff pp` (p = periodic; f/ff/m = fixed)
    periodic: Tuple[bool, bool, bool] = (False, False, False)
    # particle types frozen via `fix ID GROUP freeze` on `group GROUP type T`
    frozen_types: Tuple[int, ...] = ()
    # when EVERY integration fix (nve*/rigid*) is restricted to an
    # explicit type group, the union of those groups; data-file types
    # outside it never move (LAMMPS: atoms with no integration fix keep
    # x/v — irregular's type-1/2 floor). None = an integrator covers a
    # non-type group ('all', subtract groups) -> no inference
    integrated_types: Optional[Tuple[int, ...]] = None
    # data file contents
    box: Tuple[float, ...] = ()
    pos: Optional[np.ndarray] = None
    diameter: Optional[np.ndarray] = None
    density: Optional[np.ndarray] = None
    ptype: Optional[np.ndarray] = None
    tag: Optional[np.ndarray] = None
    # multisphere rigid clumps (`fix ... rigid/small molecule`,
    # cases/example-cases/irregular/in.lammps:36): per-atom molecule ids
    # from the data file's Molecules section (read via
    # `read_data ... fix molprop NULL Molecules`, in.lammps:13), plus the
    # `molecule NAME FILE` templates (in.pairA-D)
    rigid: bool = False
    mol: Optional[np.ndarray] = None
    molecule_templates: dict = dataclasses.field(default_factory=dict)


def parse_input_script(path: str) -> LammpsCase:
    case = LammpsCase()
    walls: List[WallSpec] = []
    group_types = {}  # group name -> tuple of particle types
    subtract_excluded = {}  # subtract-from-all group -> excluded types
    integrator_groups = []  # group names carrying nve*/rigid* fixes
    with open(path) as f:
        for raw in f:
            line = raw.split("#")[0].strip()
            if not line:
                continue
            toks = line.split()
            cmd = toks[0]
            if cmd == "timestep":
                case.dt = float(toks[1])
            elif cmd == "boundary":
                # `boundary pp ff pp`: one token per axis, first char rules
                case.periodic = tuple(t[0] == "p" for t in toks[1:4])
            elif cmd == "group" and len(toks) >= 4 and toks[2] == "type":
                # `group NAME type 1 2`, `type >= 3`, `type 2:5` forms
                args = toks[3:]
                types: List[int] = []
                if args[0] in (">=", ">", "<=", "<", "=="):
                    bound = int(args[1])
                    rng = {">=": range(bound, 33), ">": range(bound + 1, 33),
                           "<=": range(1, bound + 1), "<": range(1, bound),
                           "==": range(bound, bound + 1)}[args[0]]
                    types = list(rng)
                else:
                    for t in args:
                        if ":" in t:
                            a, b = t.split(":")[:2]
                            types.extend(range(int(a), int(b) + 1))
                        else:
                            types.append(int(t))
                group_types[toks[1]] = tuple(types)
            elif cmd == "group" and len(toks) >= 4 and toks[2] == "subtract":
                # `group active subtract all bottom` (jetFlow/in.lammps):
                # integration fixes applied to such a group exclude the
                # subtracted types -> those types are frozen (the same
                # immobilization the reference gets from restricting
                # fix nve/sphere to the group)
                if toks[3] == "all":
                    excluded = set()
                    for g in toks[4:]:
                        excluded |= set(group_types.get(g, ()))
                    subtract_excluded[toks[1]] = tuple(sorted(excluded))
            elif cmd == "read_data":
                case.data_file = toks[1]
            elif cmd == "molecule" and len(toks) >= 3:
                # molecule NAME FILE (rigid-clump template, in.pairA-D)
                tpath = os.path.join(os.path.dirname(path), toks[2])
                if os.path.exists(tpath):
                    case.molecule_templates[toks[1]] = \
                        parse_molecule_template(tpath)
            elif cmd == "pair_style":
                style = toks[1]
                if style in _STYLE_MAP:
                    case.pair = _parse_pair_params(toks[2:8],
                                                   _STYLE_MAP[style])
                elif style in ("lubricate/poly", "lubricate"):
                    # pair_style lubricate/poly mu flaglog flagfld
                    #   cutinner cutoff [flagHI flagVF]
                    # (stock PairLubricate::settings; poly compute in
                    # interfaceToLammps/pair_lubricate_poly.cpp:65-430)
                    a = toks[2:]
                    case.lubrication = LubricationParams(
                        mu=_lenient_float(a[0]), flaglog=int(a[1]),
                        flagfld=int(a[2]), cut_inner=_lenient_float(a[3]),
                        cut=_lenient_float(a[4]),
                        flag_hi=int(a[5]) if len(a) > 5 else 1,
                        flag_vf=int(a[6]) if len(a) > 6 else 1)
                elif style == "none":
                    case.pair = PairParams(style="none")
            elif cmd == "velocity" and len(toks) >= 6 and toks[2] == "set":
                case.initial_velocity = (float(toks[3]), float(toks[4]),
                                         float(toks[5]))
            elif cmd == "fix":
                fstyle = toks[3]
                if fstyle == "freeze":
                    # fix ID GROUP freeze: immobilize the group's types
                    case.frozen_types = tuple(sorted(
                        set(case.frozen_types)
                        | set(group_types.get(toks[2], ()))))
                elif fstyle == "gravity":
                    mag = float(toks[4])
                    if toks[5] == "vector":
                        v = np.array([float(toks[6]), float(toks[7]),
                                      float(toks[8])])
                        n = np.linalg.norm(v)
                        g = mag * v / n if n > 0 else v * 0.0
                        case.gravity = tuple(g.tolist())
                elif fstyle == "fdrag":
                    case.carrier_rho = float(toks[4]) if len(toks) > 4 else 0.0
                elif fstyle in ("wall/gran", "wall/granFix"):
                    # fix ID group wall/gran kn kt gamman gammat xmu damp
                    #   style lo hi [args]
                    params = _parse_pair_params(toks[4:10], case.pair.style
                                                if case.pair.style != "none"
                                                else "hooke_history")
                    wstyle = toks[10]
                    rest = toks[11:]
                    if wstyle == "zcylinder":
                        walls.append(WallSpec(style="zcylinder",
                                              cylradius=float(rest[0]),
                                              params=params))
                    else:
                        lo = _num(rest[0]) if len(rest) > 0 else None
                        hi = _num(rest[1]) if len(rest) > 1 else None
                        walls.append(WallSpec(style=wstyle, lo=lo, hi=hi,
                                              params=params))
                elif fstyle == "cohesive":
                    # fix ID group cohesive ah lam smin smax opt
                    case.cohesion = CohesionParams(
                        ah=float(toks[4]), lam=float(toks[5]),
                        smin=float(toks[6]), smax=float(toks[7]),
                        model=int(toks[8]) if len(toks) > 8 else 0)
                elif fstyle in ("rigid", "rigid/small", "rigid/nve",
                                "rigid/small/nve") and "molecule" in toks:
                    # fix ID GROUP rigid/small molecule: atoms sharing a
                    # molecule id move as one rigid clump (irregular case)
                    case.rigid = True
                elif fstyle in ("nve/sphere", "nve") \
                        and toks[2] in subtract_excluded:
                    # integration restricted to a subtract-from-all group:
                    # the excluded types never move (jetFlow's frozen
                    # `bottom` type-2 bed)
                    case.frozen_types = tuple(sorted(
                        set(case.frozen_types)
                        | set(subtract_excluded[toks[2]])))
                if fstyle.split("/")[0] in ("nve", "rigid", "move",
                                            "nvt", "npt", "langevin"):
                    # any motion-integrating fix counts (ADVICE r4: a
                    # `fix move` on remaining types must disqualify the
                    # frozen-type inference below, not freeze them)
                    integrator_groups.append(toks[2])
    case.walls = tuple(walls)
    if integrator_groups and \
            all(g in group_types for g in integrator_groups):
        # every integrator is restricted to an explicit type group:
        # data-file types outside their union never move (LAMMPS atoms
        # with no integration fix keep x/v — irregular's type-1/2)
        moving = set()
        for g in integrator_groups:
            moving |= set(group_types[g])
        case.integrated_types = tuple(sorted(moving))
    if case.data_file:
        data_path = os.path.join(os.path.dirname(path), case.data_file)
        if not os.path.exists(data_path):
            raise MissingICError(
                f"{path} reads particle IC data file "
                f"'{case.data_file}', which does not exist at "
                f"{data_path} (the reference ships several "
                "example-cases without their generated bed IC). "
                "Generate an IC data file, point read_data at an "
                "existing one, or use the case's synthetic-bed "
                "validator (scripts/validate_bedload.py style).")
        _read_data_file(data_path, case)
    return case


def _read_data_file(path: str, case: LammpsCase) -> None:
    with open(path) as f:
        lines = f.readlines()

    box = [0.0] * 6
    atoms_start = None
    n_atoms = 0
    for i, line in enumerate(lines):
        s = line.split("#")[0].strip()
        if not s:
            continue
        if re.match(r"^\d+\s+atoms$", s):
            n_atoms = int(s.split()[0])
        m = re.match(r"^([-\d.eE+]+)\s+([-\d.eE+]+)\s+([xyz])lo\s+\3hi", s)
        if m:
            ax = "xyz".index(m.group(3))
            box[2 * ax] = float(m.group(1))
            box[2 * ax + 1] = float(m.group(2))
        if s == "Atoms" or s.startswith("Atoms "):
            atoms_start = i + 1
    case.box = tuple(box)

    if atoms_start is None:
        return
    rows = []
    for line in lines[atoms_start:]:
        s = line.split("#")[0].strip()
        if not s:
            if rows:
                break
            continue
        parts = s.split()
        if not parts[0].lstrip("-").isdigit():
            break
        rows.append([float(x) for x in parts])
        if len(rows) == n_atoms:
            break
    arr = np.asarray(rows)
    # atom_style sphere: id type diameter density x y z [ix iy iz]
    case.tag = arr[:, 0].astype(np.int32)
    case.ptype = arr[:, 1].astype(np.int32)
    case.diameter = arr[:, 2]
    case.density = arr[:, 3]
    case.pos = arr[:, 4:7]

    # Molecules section (read_data's `fix molprop NULL Molecules` target:
    # per-atom molecule ids for rigid clumps): lines `atom-id mol-id`
    mol_start = None
    for i, line in enumerate(lines):
        s = line.split("#")[0].strip()
        if s == "Molecules" or s.startswith("Molecules "):
            mol_start = i + 1
            break
    if mol_start is not None:
        mol = np.zeros(n_atoms, np.int64)
        seen = 0
        for line in lines[mol_start:]:
            s = line.split("#")[0].strip()
            if not s:
                if seen:
                    break
                continue
            parts = s.split()
            if not parts[0].lstrip("-").isdigit():
                break
            mol[int(parts[0]) - 1] = int(parts[1])
            seen += 1
            if seen == n_atoms:
                break
        # data-file atom rows may be in any tag order; align mol to rows
        case.mol = mol[case.tag - 1]

    if case.integrated_types is not None:
        # atoms of types outside every integrator's group never move
        case.frozen_types = tuple(sorted(
            set(case.frozen_types)
            | (set(int(t) for t in np.unique(case.ptype))
               - set(case.integrated_types))))


def parse_molecule_template(path: str) -> dict:
    """LAMMPS `molecule` template file (irregular/in.pairA-D): sections
    `N atoms`, Coords, Types, Diameters, Masses -> dict of arrays."""
    with open(path) as f:
        lines = [ln.split("#")[0].rstrip() for ln in f]
    n = 0
    for ln in lines:
        m = re.match(r"^\s*(\d+)\s+atoms\s*$", ln)
        if m:
            n = int(m.group(1))
            break
    out = {"n_atoms": n}
    sections = {"Coords": 3, "Types": 1, "Diameters": 1, "Masses": 1}
    for name, width in sections.items():
        try:
            start = next(i for i, ln in enumerate(lines)
                         if ln.strip() == name) + 1
        except StopIteration:
            continue
        vals = np.zeros((n, width))
        seen = 0
        for ln in lines[start:]:
            s = ln.strip()
            if not s:
                if seen:
                    break
                continue
            parts = s.split()
            vals[int(parts[0]) - 1] = [float(x) for x in parts[1:1 + width]]
            seen += 1
            if seen == n:
                break
        key = name.lower()
        out[key] = vals[:, 0] if width == 1 else vals
        if name == "Types":
            out[key] = out[key].astype(np.int32)
    return out
