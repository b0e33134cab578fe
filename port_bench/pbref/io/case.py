"""Assemble a runnable simulation from a reference-format case directory
(port of ``sedifoam_tpu/io/case.py``).

A sediFoam case is an OpenFOAM case dir (0/, constant/, system/) plus an
in.lammps script + IC data file. This loader reads both with no
modification and produces (SimConfig, FluidState, ParticleState,
CaseControls). The dictionaries and meshes are parsed in numpy; the
initial fields are built in numpy and moved to the device once.
"""

from __future__ import annotations

import dataclasses
import math
import os
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from pbref import bc as _bc
from pbref import default_device
from pbref.config import (ChannelForcing, CloudConfig, DEMConfig,
                                       FluidConfig, PISOConfig,
                                       TurbulenceConfig)
from pbref.dem.state import make_particles
from pbref.fluid.state import FluidBCs, init_fluid
from pbref.grid import Grid
from pbref.io import foamdict, lammps
from pbref.solver import SimConfig, adjust_dem_timestep

_BC_TYPE_MAP = {
    "fixedValue": _bc.FIXED_VALUE,
    "zeroGradient": _bc.ZERO_GRADIENT,
    "empty": _bc.EMPTY,
    "cyclic": _bc.CYCLIC,
    "inletOutlet": _bc.INLET_OUTLET,
    "slip": _bc.SLIP,
    "calculated": _bc.ZERO_GRADIENT,
    "fixedFluxPressure": _bc.ZERO_GRADIENT,
    "pressureInletOutletVelocity": _bc.INLET_OUTLET,
    "symmetryPlane": _bc.ZERO_GRADIENT,
    "noSlip": _bc.FIXED_VALUE,
}


@dataclasses.dataclass
class CaseControls:
    dt: float
    end_time: float
    write_interval: float
    start_time: float = 0.0


def _graded_faces(lo: float, hi: float, n: int, ratio: float) -> np.ndarray:
    """simpleGrading face coordinates: ratio = width(last)/width(first)
    (blockMesh expansion-ratio convention), geometric progression."""
    L = hi - lo
    if n == 1 or abs(ratio - 1.0) < 1e-12:
        return lo + (L / n) * np.arange(n + 1)
    r = ratio ** (1.0 / (n - 1))
    w0 = L * (1.0 - r) / (1.0 - r ** n)
    w = w0 * r ** np.arange(n)
    return np.concatenate([[lo], lo + np.cumsum(w)])


# re-export: load_case raises this for cases whose in.lammps reads an
# absent IC data file (several example-cases ship without theirs)
MissingICError = lammps.MissingICError


class UnsupportedMeshError(ValueError):
    """blockMeshDict outside the tensor-product mesh model.

    The fluid discretization is a structured tensor-product grid (the
    basis of the fast-diagonalization smoothing solver and the stencil
    ops). Straight-edged hex blocks that tile the box
    as 1-D stacks load directly; curved (arc) edges and O-grid style
    composite blocks — jetFlow's 4-side-blocks-around-a-jet-column
    arrangement (cases/example-cases/jetFlow/constant/polyMesh/
    blockMeshDict:52-56) is the one reference case that uses them —
    raise this error. jetFlow-style O-grids can instead run through the
    explicit Cartesian embedding: load_case(..., embed_ogrid=True) /
    read_block_mesh_embedded.
    """


def _parse_blocks(blocks, verts):
    """blocks list -> [(bbox_lo, bbox_hi, counts, grading)] per hex."""
    out = []
    i = 0
    while i < len(blocks):
        if blocks[i] != "hex":
            i += 1
            continue
        vidx = blocks[i + 1]
        counts = blocks[i + 2]
        grading = [1.0, 1.0, 1.0]
        j = i + 3
        if j < len(blocks) and blocks[j] in ("simpleGrading", "edgeGrading"):
            g = blocks[j + 1]
            if blocks[j] == "simpleGrading":
                grading = [float(v) for v in g[:3]]
            else:  # edgeGrading: take the first edge of each direction
                grading = [float(g[0]), float(g[4]), float(g[8])]
            j += 2
        pts = verts[vidx]
        out.append((pts.min(axis=0), pts.max(axis=0),
                    [int(c) for c in counts], grading))
        i = j
    return out


def _merge_block_axes(blocks_info) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-axis face coordinates for hexes tiling a box as a 1-D stack
    (covers every reference multi-block case, e.g. transport-vortex-dune's
    two y-stacked blocks)."""
    axes_faces = []
    for a in range(3):
        segs = {}
        for (lo, hi, counts, grading) in blocks_info:
            key = (round(float(lo[a]), 12), round(float(hi[a]), 12),
                   counts[a], grading[a])
            segs[key] = None
        keys = sorted(segs.keys())
        # contiguity check for stacked segments
        faces = _graded_faces(keys[0][0], keys[0][1], keys[0][2], keys[0][3])
        for k in keys[1:]:
            if abs(k[0] - faces[-1]) > 1e-9 * max(1.0, abs(k[0])):
                raise UnsupportedMeshError(
                    f"hex blocks do not tile the domain as a 1-D stack "
                    f"along axis {a} (segments {keys}): composite/O-grid "
                    f"block arrangements are outside the tensor-product "
                    f"mesh model (see UnsupportedMeshError)")
            faces = np.concatenate(
                [faces, _graded_faces(k[0], k[1], k[2], k[3])[1:]])
        axes_faces.append(faces)
    return tuple(axes_faces)


def read_block_mesh(path: str):
    """blockMeshDict -> (Grid, {patch_name: [face_ids]}).

    face ids: 0..5 = xm, xp, ym, yp, zm, zp. Supports single or 1-D
    stacked multi-hex meshes with simpleGrading (transport-bedload's
    `simpleGrading (1 10 1)`, transport-vortex-dune's two y-blocks).
    """
    d = foamdict.parse_file(path)
    scale = float(d.get("convertToMeters", 1.0))
    verts = np.asarray(d["vertices"], float) * scale
    blocks_info = _parse_blocks(d["blocks"], verts)
    assert blocks_info, "no hex blocks in blockMeshDict"
    edges = d.get("edges", ())
    if any(e == "arc" for e in edges):
        raise UnsupportedMeshError(
            "blockMeshDict uses curved (arc) block edges — the tensor-"
            "product mesh model supports straight-edged hex blocks only "
            "(jetFlow's O-grid jet column is the one reference case "
            "outside it)")
    xf, yf, zf = _merge_block_axes(blocks_info)
    grid = Grid.from_faces(xf, yf, zf)
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)

    def face_id_of_quad(quad: List[int]) -> Optional[int]:
        pts = verts[quad]
        for ax in range(3):
            if np.allclose(pts[:, ax], lo[ax]):
                return 2 * ax
            if np.allclose(pts[:, ax], hi[ax]):
                return 2 * ax + 1
        return None

    patch_faces: Dict[str, List[int]] = {}
    assigned = set()

    def add(name: str, quads):
        ids = patch_faces.setdefault(name, [])
        for q in quads:
            fid = face_id_of_quad(q)
            if fid is not None:
                ids.append(fid)
                assigned.add(fid)

    patches = d.get("patches")
    if patches:
        i = 0
        while i < len(patches):
            # pattern: type name (quads) — `wall walls ((...)(...))`
            ptype, name = patches[i], patches[i + 1]
            quads = patches[i + 2]
            add(name, quads)
            i += 3
    bnd = d.get("boundary")
    if bnd and not patches:
        i = 0
        while i < len(bnd):
            name = bnd[i]
            spec = bnd[i + 1]
            add(name, spec.get("faces", []))
            i += 2

    # unassigned faces -> blockMesh defaultFaces (empty)
    rest = [f for f in range(6) if f not in assigned]
    if rest:
        patch_faces.setdefault("defaultFaces", []).extend(rest)
    return grid, patch_faces


_HEX_EDGE_SETS = (
    ((0, 1), (3, 2), (7, 6), (4, 5)),   # local x1
    ((0, 3), (1, 2), (5, 6), (4, 7)),   # local x2
    ((0, 4), (1, 5), (2, 6), (3, 7)),   # local x3
)


def _block_axes_global(vidx, verts, counts, grading):
    """Map a hex block's local (x1,x2,x3) counts/grading to global axes.

    The mean of the four edge vectors of each local direction cancels the
    transverse components of an O-grid side block's trapezoidal faces and
    leaves the dominant global direction; grading inverts when the local
    axis points along -global (blockMesh expansion ratios are directed).
    """
    counts_g = [None, None, None]
    grading_g = [None, None, None]
    for L, edges in enumerate(_HEX_EDGE_SETS):
        mean = np.mean([verts[vidx[b]] - verts[vidx[a]] for a, b in edges],
                       axis=0)
        g_ax = int(np.argmax(np.abs(mean)))
        if counts_g[g_ax] is not None:
            raise UnsupportedMeshError(
                "hex block local axes do not map 1:1 onto global axes")
        counts_g[g_ax] = counts[L]
        grading_g[g_ax] = grading[L] if mean[g_ax] > 0 \
            else 1.0 / grading[L]
    return counts_g, grading_g


def _parse_blocks_full(blocks, verts):
    """Like _parse_blocks but keeps the hex vertex indices and maps
    counts/grading onto global axes (needed for rotated O-grid blocks)."""
    out = []
    i = 0
    while i < len(blocks):
        if blocks[i] != "hex":
            i += 1
            continue
        vidx = blocks[i + 1]
        counts = [int(c) for c in blocks[i + 2]]
        grading = [1.0, 1.0, 1.0]
        j = i + 3
        if j < len(blocks) and blocks[j] in ("simpleGrading", "edgeGrading"):
            g = blocks[j + 1]
            if blocks[j] == "simpleGrading":
                grading = [float(v) for v in g[:3]]
            else:
                grading = [float(g[0]), float(g[4]), float(g[8])]
            j += 2
        pts = verts[vidx]
        counts_g, grading_g = _block_axes_global(vidx, verts, counts, grading)
        out.append({"vidx": list(vidx), "lo": pts.min(axis=0),
                    "hi": pts.max(axis=0), "counts": counts_g,
                    "grading": grading_g})
        i = j
    return out


def read_block_mesh_embedded(path: str):
    """jetFlow-style O-grid -> embedded Cartesian tensor mesh.

    The reference's one non-tensor mesh (cases/example-cases/jetFlow/
    constant/polyMesh/blockMeshDict:52-56) wraps 4 graded side blocks
    around a jet column, body-fitted to a circular outer boundary via arc
    edges. A tensor-product grid cannot represent it; this embedding keeps
    the case's physics on the vertex bounding box instead (which is
    exactly the DEM wall box of jetFlow/in.lammps:30-32):

    - the column axis keeps the blocks' axial cell distribution;
    - each cross axis is three stacked segments: the side block's radial
      grading (directed outer->inner, fine at the column), the column's
      own segment, and the mirrored side grading;
    - column-end patches that share a box face with the surrounding
      annulus patch (jetFlow's `inlet` disc inside `bottom`) become
      region entries {face_id: (inner_name, outer_name, DiscRegion)};
      the disc radius is read from the column's arc-edge midpoints.

    Returns (grid, patch_faces, regions).
    """
    d = foamdict.parse_file(path)
    scale = float(d.get("convertToMeters", 1.0))
    verts = np.asarray(d["vertices"], float) * scale
    blocks = _parse_blocks_full(d["blocks"], verts)
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    tol = 1e-9 * max(np.max(hi - lo), 1.0)

    # the column: inside the domain in exactly two axes, spanning the third
    def spans(b, a):
        return abs(b["lo"][a] - lo[a]) < tol and abs(b["hi"][a] - hi[a]) < tol

    col = None
    for b in blocks:
        span_axes = [a for a in range(3) if spans(b, a)]
        if len(span_axes) == 1:
            if col is not None:
                raise UnsupportedMeshError(
                    "O-grid embedding supports exactly one inner column")
            col, ax_col = b, span_axes[0]
    if col is None or len(blocks) != 5:
        raise UnsupportedMeshError(
            "unrecognized composite block arrangement (expected a "
            "4-sides-around-a-column O-grid)")
    cross = [a for a in range(3) if a != ax_col]

    # per-axis face coordinates
    faces = [None, None, None]
    faces[ax_col] = _graded_faces(lo[ax_col], hi[ax_col],
                                  col["counts"][ax_col],
                                  col["grading"][ax_col])
    for a in cross:
        in_lo, in_hi = col["lo"][a], col["hi"][a]
        seg_lo = seg_hi = None
        for b in blocks:
            if b is col:
                continue
            if abs(b["lo"][a] - lo[a]) < tol and abs(b["hi"][a] - in_lo) < tol:
                seg_lo = (b["counts"][a], b["grading"][a])
            if abs(b["lo"][a] - in_hi) < tol and abs(b["hi"][a] - hi[a]) < tol:
                seg_hi = (b["counts"][a], b["grading"][a])
        if seg_lo is None or seg_hi is None:
            raise UnsupportedMeshError(
                f"no side block tiles axis {a} of the O-grid ring")
        faces[a] = np.concatenate([
            _graded_faces(lo[a], in_lo, seg_lo[0], seg_lo[1]),
            _graded_faces(in_lo, in_hi, col["counts"][a],
                          col["grading"][a])[1:],
            _graded_faces(in_hi, hi[a], seg_hi[0], seg_hi[1])[1:]])
    grid = Grid.from_faces(*faces)

    # disc radius from the column's arc-edge midpoints (fallback: the
    # equal-area disc of the column cross-section)
    cvx = set(col["vidx"])
    center = [float(0.5 * (col["lo"][a] + col["hi"][a])) for a in range(3)]
    radii = []
    edges = d.get("edges", ())
    i = 0
    while i < len(edges):
        if edges[i] == "arc":
            v0, v1, mid = int(edges[i + 1]), int(edges[i + 2]), edges[i + 3]
            if v0 in cvx and v1 in cvx:
                mp = np.asarray(mid, float) * scale
                radii.append(float(np.hypot(mp[cross[0]] - center[cross[0]],
                                            mp[cross[1]] - center[cross[1]])))
            i += 4
        else:
            i += 1
    if radii:
        radius = float(np.max(radii))
    else:
        w0 = col["hi"][cross[0]] - col["lo"][cross[0]]
        w1 = col["hi"][cross[1]] - col["lo"][cross[1]]
        radius = math.sqrt(w0 * w1 / math.pi)

    # patch faces on the union box; column-end quads that share a face id
    # with ring quads under a DIFFERENT name become regions
    def face_id_of_quad(quad):
        pts = verts[quad]
        for ax in range(3):
            if np.allclose(pts[:, ax], lo[ax], atol=tol):
                return 2 * ax
            if np.allclose(pts[:, ax], hi[ax], atol=tol):
                return 2 * ax + 1
        return None

    patch_faces: Dict[str, List[int]] = {}
    quad_names: Dict[int, List[Tuple[str, bool]]] = {}  # fid -> (name, is_col)
    bnd = d.get("boundary")
    i = 0
    while i < len(bnd):
        name, spec = bnd[i], bnd[i + 1]
        for q in spec.get("faces", []):
            fid = face_id_of_quad(q)
            if fid is None:
                continue
            is_col = all(v in cvx for v in q)
            quad_names.setdefault(fid, []).append((name, is_col))
            ids = patch_faces.setdefault(name, [])
            if fid not in ids:
                ids.append(fid)
        i += 2

    regions: Dict[int, Tuple[str, str, _bc.DiscRegion]] = {}
    for fid, entries in quad_names.items():
        names = {n for n, _ in entries}
        if len(names) < 2:
            continue
        inner = {n for n, c in entries if c}
        outer = names - inner
        if len(inner) != 1 or len(outer) != 1:
            raise UnsupportedMeshError(
                f"box face {fid} is claimed by patches {sorted(names)} in a "
                f"pattern the disc-region embedding cannot express")
        regions[fid] = (inner.pop(), outer.pop(), _bc.DiscRegion(
            axis=fid // 2, c0=center[cross[0]], c1=center[cross[1]],
            radius=radius))
    return grid, patch_faces, regions


def _parse_uniform_value(entry, n_comp: int):
    """uniformFixedValue uniformValue: constant or `table ((t (v)) ...)`."""
    if isinstance(entry, list) and entry and entry[0] == "table":
        knots = entry[1]
        times, values = [], []
        for knot in knots:
            t = float(knot[0])
            v = knot[1]
            if isinstance(v, list):
                values.append(tuple(float(x) for x in v))
            else:
                values.append((float(v),) * n_comp)
            times.append(t)
        return _bc.TimeTable(tuple(times), tuple(values))
    val = foamdict.uniform_value(entry)
    if isinstance(val, list):
        return tuple(float(v) for v in val)
    return (float(val),) * n_comp


def _patch_bc_from_spec(spec: dict, n_comp: int, internal) -> _bc.PatchBC:
    kind_str = spec.get("type", "zeroGradient")
    if kind_str == "uniformFixedValue":
        # time-varying uniform value (e.g. the xiaocase1 inlet ramp)
        return _bc.PatchBC(_bc.FIXED_VALUE,
                           _parse_uniform_value(spec.get("uniformValue"),
                                                n_comp))
    kind = _BC_TYPE_MAP.get(kind_str, _bc.ZERO_GRADIENT)
    if kind_str == "slip" and n_comp == 1:
        # slip on a scalar field is plain symmetry = zeroGradient; keep
        # the SLIP kind only on vectors (normal-component handling)
        kind = _bc.ZERO_GRADIENT
    if kind == _bc.FIXED_VALUE:
        val = foamdict.uniform_value(spec.get("value", 0.0))
    elif kind == _bc.INLET_OUTLET:
        val = foamdict.uniform_value(spec.get("inletValue", 0.0))
    else:
        val = 0.0
    if val == "$internalField":  # OpenFOAM macro expansion
        val = internal
    if isinstance(val, list):
        vt = tuple(float(v) for v in val)
    else:
        vt = (float(val),) * n_comp
    return _bc.PatchBC(kind, vt)


def _read_field_bc(field_file: str, patch_faces: Dict[str, List[int]],
                   n_comp: int, regions=None) -> Tuple[_bc.FieldBC, object]:
    """0/<field> -> (FieldBC, uniform internal value).

    regions: optional {face_id: (inner_name, outer_name, DiscRegion)} from
    an O-grid embedding — those faces get a RegionPatchBC blending the two
    named patch specs (collapsed to the plain patch when the specs agree).
    """
    d = foamdict.parse_file(field_file)
    internal = foamdict.uniform_value(d.get("internalField", 0.0))
    bf = d.get("boundaryField", {})

    slots: List[Optional[_bc.PatchBC]] = [None] * 6
    by_name: Dict[str, _bc.PatchBC] = {}
    region_fids = set(regions or ())
    for name, spec in bf.items():
        if name not in patch_faces or not isinstance(spec, dict):
            continue
        pb = _patch_bc_from_spec(spec, n_comp, internal)
        by_name[name] = pb
        for fid in patch_faces[name]:
            if fid not in region_fids:
                slots[fid] = pb
    for fid, (inner_n, outer_n, disc) in (regions or {}).items():
        inner = by_name.get(inner_n)
        outer = by_name.get(outer_n)
        if inner is None or outer is None:
            # one of the face's two named patches is absent from this
            # 0/<field> file — blend the present spec against the
            # zeroGradient default over its OWN region only (applying it
            # across the whole mixed face would e.g. paint a disc-inlet
            # velocity over the entire bottom wall); OpenFOAM would
            # abort on the missing patch, so warn loudly
            missing = outer_n if outer is None else inner_n
            warnings.warn(
                f"{field_file}: patch '{missing}' missing for the mixed "
                f"face {fid}; using zeroGradient for its region",
                stacklevel=2)
            zg = _bc.PatchBC(_bc.ZERO_GRADIENT, (0.0,) * n_comp)
            slots[fid] = _bc.RegionPatchBC(inner or zg, outer or zg, disc)
        elif inner == outer:
            slots[fid] = inner
        else:
            slots[fid] = _bc.RegionPatchBC(inner, outer, disc)
    default = _bc.PatchBC(_bc.ZERO_GRADIENT, (0.0,) * n_comp)
    return _bc.FieldBC(*(s or default for s in slots)), internal


def neighbor_ring(d_max, d_min, cohesion=None, lubrication=None,
                  neighbor_k=None):
    """(skin, cutoff, audit ring, K) of the binned neighbor table.

    The table is shared by contact, cohesion, and lubrication: its
    cutoff must cover the widest interaction ring, and K (slots per
    particle) must cover the densest packing of that ring or the
    K-nearest truncation silently drops in-range partners (~5.2 spheres
    per cubic diameter at random close packing). With contact only,
    correctness needs all partners within 2*r_max + skin; the default K
    derives from that bound with ~35% headroom (d_min in the denominator
    guards polydispersity). A given `neighbor_k` is raised where the
    cutoff needs more."""
    skin = 0.3 * d_max
    cutoff = 1.6 * d_max
    if cohesion is not None:
        cutoff = max(cutoff, d_max + cohesion.smax + skin)
    if lubrication is not None:
        cutoff = max(cutoff, lubrication.cut + skin)
    ring = (d_max + skin) if (cohesion is None and lubrication is None) \
        else cutoff
    if neighbor_k is None:
        k_needed = int(max(16, math.ceil(1.35 * 5.2 * (ring / d_min) ** 3)))
        neighbor_k = min(k_needed, 160)
    else:
        k_needed = int(math.ceil(5.5 * (cutoff / d_max) ** 3))
        if k_needed > neighbor_k:
            neighbor_k = min(k_needed, 160)
    if k_needed > 160:
        # the K-nearest table would silently drop in-range partners: be
        # loud instead of clamping quietly (wide cohesion/lubrication
        # rings with small d_min under polydispersity land here)
        warnings.warn(
            f"neighbor table needs K={k_needed} slots to cover the "
            f"interaction ring (cutoff={cutoff:.4g}, d_min={d_min:.4g}) "
            f"but is capped at 160; in-range partners beyond the 160 "
            f"nearest will be DROPPED", stacklevel=3)
    return skin, cutoff, ring, neighbor_k


def load_case(case_dir: str, capacity: Optional[int] = None,
              backend: str = "dense", neighbor_k: Optional[int] = None,
              dtype=torch.float64, embed_ogrid: bool = False, device=None):
    """Load a reference case -> (SimConfig, FluidState, ParticleState,
    CaseControls) with the state's tensors in `dtype` on `device` (by
    default the CUDA card; device="cpu" for the CPU).
    backend: DEM contact backend ('dense' | 'binned' | 'lattice'; the
    lattice's slots per bin M are sized to the initial packing: the
    fullest bin + 2, at least 4).

    embed_ogrid: opt-in for O-grid cases (jetFlow): embed the mesh into
    its Cartesian bounding box (see read_block_mesh_embedded) instead of
    refusing. Off by default — the embedding changes the discretization
    (circular outer wall -> box walls, matching the case's own DEM box),
    so it must be an explicit choice.
    """
    device = default_device(device)
    sys_d = os.path.join(case_dir, "system")
    const_d = os.path.join(case_dir, "constant")
    zero_d = os.path.join(case_dir, "0")

    mesh_path = os.path.join(const_d, "polyMesh", "blockMeshDict")
    regions = None
    try:
        grid, patch_faces = read_block_mesh(mesh_path)
    except UnsupportedMeshError:
        if not embed_ogrid:
            raise UnsupportedMeshError(
                "blockMeshDict is outside the tensor-product mesh model; "
                "pass embed_ogrid=True to run this case on an embedded "
                "Cartesian mesh (O-grid -> bounding box, see "
                "read_block_mesh_embedded)") from None
        grid, patch_faces, regions = read_block_mesh_embedded(mesh_path)

    control = foamdict.parse_file(os.path.join(sys_d, "controlDict"))
    controls = CaseControls(
        dt=float(control["deltaT"]),
        end_time=float(control["endTime"]),
        write_interval=float(control.get("writeInterval", 1.0)),
        start_time=float(control.get("startTime", 0.0)),
    )

    fv_solution = foamdict.parse_file(os.path.join(sys_d, "fvSolution"))
    piso_d = fv_solution.get("PISO", {})
    p_solver = fv_solution.get("solvers", {}).get("p", {})
    piso = PISOConfig(
        n_correctors=int(piso_d.get("nCorrectors", 2)),
        n_non_orth=int(piso_d.get("nNonOrthogonalCorrectors", 0)),
        p_ref_cell=int(piso_d.get("pRefCell", 0)),
        p_ref_value=float(piso_d.get("pRefValue", 0.0)),
        p_tol=float(p_solver.get("tolerance", 1e-10)),
        p_rel_tol=float(p_solver.get("relTol", 0.0)),
    )

    transport = foamdict.parse_file(os.path.join(const_d,
                                                 "transportProperties"))
    env = foamdict.parse_file(os.path.join(const_d,
                                           "environmentalProperties"))
    g = foamdict.dimensioned_vector(env.get("g", ["g", (0, 0, 0)]))

    turb_file = os.path.join(const_d, "turbulenceProperties")
    turb = TurbulenceConfig(model="laminar")
    if os.path.exists(turb_file):
        td = foamdict.parse_file(turb_file)
        sim_type = td.get("simulationType", "laminar")
        if sim_type == "laminar":
            pass
        elif sim_type in ("RAS", "RASModel") or "RAS" in td:
            model = td.get("RAS", {}).get("RASModel", "kEpsilon") \
                if isinstance(td.get("RAS"), dict) else "kEpsilon"
            if td.get("RAS", {}).get("turbulence", "on") in ("off", False):
                model = "laminar"
            turb = TurbulenceConfig(model=model)
        elif sim_type in ("LES", "LESModel") or "LES" in td:
            les = td.get("LES", {}) if isinstance(td.get("LES"), dict) else {}
            model = les.get("LESModel", "Smagorinsky")
            if les.get("turbulence", "on") in ("off", False):
                model = "laminar"
            turb = TurbulenceConfig(model=model)

    cloud_d = foamdict.parse_file(os.path.join(const_d, "cloudProperties"))
    lod = foamdict.lookup_or_default

    # LAMMPS side
    lmp = lammps.parse_input_script(os.path.join(case_dir, "in.lammps"))
    sub_cycles_req = int(lod(cloud_d, "subCycles", 1))
    dt_dem, sub_cycles, sub_steps = adjust_dem_timestep(
        controls.dt, lmp.dt, sub_cycles_req)

    smooth_dir = lod(cloud_d, "smoothDirection",
                     [1.0, 0, 0, 0, 1.0, 0, 0, 0, 1.0])
    if isinstance(smooth_dir, list) and len(smooth_dir) == 9:
        smooth_diag = (float(smooth_dir[0]), float(smooth_dir[4]),
                       float(smooth_dir[8]))
    else:
        smooth_diag = (1.0, 1.0, 1.0)

    inlet_force = lod(cloud_d, "inletForce", [0.0, 0.0, 0.0])
    if not isinstance(inlet_force, list):
        inlet_force = [0.0, 0.0, 0.0]

    def box6(key):
        b = lod(cloud_d, key, [0.0] * 9)
        if isinstance(b, list) and len(b) >= 6:
            return tuple(float(x) for x in b[:6])
        return ()

    add_info = lod(cloud_d, "addParticleInfo", [1e-3, 1000.0, 1])
    add_vel = lod(cloud_d, "addParticleVelocity", [0.0, 0.0, 0.0])
    if not isinstance(add_vel, list):
        add_vel = [0.0, 0.0, 0.0]

    cloud_cfg = CloudConfig(
        drag_model=str(lod(cloud_d, "dragModel", "SyamlalOBrien")),
        sub_cycles=sub_cycles,
        sub_steps=sub_steps,
        diffusion_band_width=float(lod(cloud_d, "diffusionBandWidth", 0.006)),
        diffusion_steps=int(lod(cloud_d, "diffusionSteps", 6)),
        smooth_direction=smooth_diag,
        uf_smooth=bool(lod(cloud_d, "UfSmooth", True)),
        up_smooth=bool(lod(cloud_d, "UpSmooth", True)),
        drag_smooth=bool(lod(cloud_d, "dragSmooth", True)),
        alpha_smooth=bool(lod(cloud_d, "alphaSmooth", True)),
        particle_drag=bool(lod(cloud_d, "particleDrag", True)),
        particle_pressure_grad=bool(lod(cloud_d, "particlePressureGrad", True)),
        particle_buoyancy=bool(lod(cloud_d, "particleBuoyancy", False)),
        particle_added_mass=bool(lod(cloud_d, "particleAddedMass", False)),
        particle_lift=bool(lod(cloud_d, "particleLift", False)),
        particle_history_force=bool(lod(cloud_d, "particleHistoryForce", False)),
        lubrication_force=bool(lod(cloud_d, "lubricationForce", False)),
        inlet_force=tuple(float(v) for v in inlet_force),
        inlet_box=box6("inletBox"),
        add_particle=int(lod(cloud_d, "addParticle", 0)),
        add_interval=float(lod(cloud_d, "addParticleTimeStep", 1e30)),
        add_box=box6("addParticleBox"),
        add_info=tuple(add_info[:3]) if isinstance(add_info, list)
        else (1e-3, 1000.0, 1),
        add_velocity=tuple(float(v) for v in add_vel),
        random_perturb=float(lod(cloud_d, "randomPerturb", 0.0)),
        reduce_number_factor=int(lod(cloud_d, "reduceNumberFactor", 1)),
        delete_particle=int(lod(cloud_d, "deleteParticle", 0)),
        delete_box=box6("deleteParticleBox"),
        delete_before_add=int(lod(cloud_d, "deleteBeforeAdd", 0)),
        clear_box=box6("clearInitialBox"),
    )

    # channel forcing (chPressureGrad::initPressureGrad,
    # chPressureGrad.C:48-130): Ubar XOR gradPbar XOR varyingGradP in
    # constant/transportProperties
    forcing = ChannelForcing()

    def _vec(key):
        v = foamdict.dimensioned_vector(transport[key])
        return np.asarray([float(x) for x in v])

    if "Ubar" in transport:
        assert "gradPbar" not in transport, \
            "set only one of Ubar/gradPbar (chPressureGrad.C:53-59)"
        ubar = _vec("Ubar")
        mag = float(np.linalg.norm(ubar))
        forcing = ChannelForcing(mode="Ubar",
                                 flow_direction=tuple(ubar / (mag + 1e-300)),
                                 mag_ubar=mag)
    elif "gradPbar" in transport:
        gp = _vec("gradPbar")
        mag = float(np.linalg.norm(gp))
        dpdt = 0.0
        if "dpdt" in transport:
            dpdt = float(np.linalg.norm(_vec("dpdt")))
        forcing = ChannelForcing(mode="gradPbar",
                                 flow_direction=tuple(gp / (mag + 1e-300)),
                                 grad_pbar=mag, dpdt=dpdt)
    elif "varyingGradP" in transport:
        gp = _vec("varyingGradP")
        mag = float(np.linalg.norm(gp))
        forcing = ChannelForcing(
            mode="varyingGradP",
            flow_direction=tuple(gp / (mag + 1e-300)),
            grad_pbar=mag,
            period=foamdict.dimensioned_value(transport["varyingPeriod"]),
            varying_type=str(transport.get("varyingType", "sinusoidal")))

    # IBM relaxation zone + DNS spectral forcing switches
    # (createIBMForce.H:1-21, createTurbulence.H:29-49: both read from
    # transportProperties; the UOprocess coefficients use OpenFOAM's
    # standard UO* keys)
    def _switch(key):
        v = lod(transport, key, False)
        return str(v).lower() in ("on", "true", "yes", "1")

    add_ibm = _switch("addIBMForce")
    add_dns = _switch("addDNSForce")
    ibm_relax = float(foamdict.dimensioned_value(
        transport["ibmRelaxTime"])) if "ibmRelaxTime" in transport else 0.0

    fluid_cfg = FluidConfig(
        dt=controls.dt,
        forcing=forcing,
        add_ibm_force=add_ibm,
        ibm_relax_time=ibm_relax,
        add_dns_force=add_dns,
        dns_alpha=foamdict.dimensioned_value(lod(transport, "UOalpha", 1.0)),
        dns_sigma=foamdict.dimensioned_value(lod(transport, "UOsigma", 0.1)),
        dns_k_upper=foamdict.dimensioned_value(
            lod(transport, "UOKupper", 1e9)),
        dns_k_lower=foamdict.dimensioned_value(
            lod(transport, "UOKlower", 0.0)),
        rhob=foamdict.dimensioned_value(transport["rhob"]),
        nub=foamdict.dimensioned_value(transport["nub"]),
        rhoa=foamdict.dimensioned_value(transport.get("rhoa", 2000.0)),
        Cvm=foamdict.dimensioned_value(transport.get("Cvm", 0.0)),
        Cl=foamdict.dimensioned_value(transport.get("Cl", 0.0)),
        gravity=tuple(g),
        max_possible_alpha=float(lod(cloud_d, "maxPossibleAlpha", 0.70)),
        piso=piso,
        turbulence=turb,
    )

    d_max = float(np.max(lmp.diameter)) if lmp.diameter is not None else 1e-3
    box = lmp.box if lmp.box else (grid.x0, grid.hi[0], grid.y0, grid.hi[1],
                                   grid.z0, grid.hi[2])
    lub = lmp.lubrication
    if lub is not None:
        lub = dataclasses.replace(lub, box_volume=float(
            (box[1] - box[0]) * (box[3] - box[2]) * (box[5] - box[4])))
    d_min = float(np.min(lmp.diameter)) if lmp.diameter is not None \
        else d_max
    skin, cutoff, ring, neighbor_k = neighbor_ring(
        d_max, d_min, lmp.cohesion, lub, neighbor_k)
    dem_cfg = DEMConfig(
        dt=dt_dem, pair=lmp.pair, walls=lmp.walls, gravity=lmp.gravity,
        carrier_rho=lmp.carrier_rho, cohesion=lmp.cohesion,
        lubrication=lub,
        backend=backend, nbr_k=neighbor_k, max_per_bin=10,
        cutoff=cutoff, skin=skin, audit_ring=ring,
        domain_lo=(box[0], box[2], box[4]),
        domain_hi=(box[1], box[3], box[5]),
        periodic=lmp.periodic,
        frozen_types=lmp.frozen_types,
    )

    # boundary conditions + initial fields
    bcs_alpha, alpha0 = _read_field_bc(os.path.join(zero_d, "alpha"),
                                       patch_faces, 1, regions)
    bcs_p, p0 = _read_field_bc(os.path.join(zero_d, "p"), patch_faces, 1,
                               regions)
    ub_file = os.path.join(zero_d, "Ub")
    if os.path.exists(ub_file):
        bcs_Ub, Ub0 = _read_field_bc(ub_file, patch_faces, 3, regions)
    else:
        # some example cases ship no 0/Ub (e.g. transport-bedload):
        # mirror Ua's patch kinds with no-slip walls, start from rest
        bcs_Ua_tmp, _ = _read_field_bc(os.path.join(zero_d, "Ua"),
                                       patch_faces, 3, regions)
        bcs_Ub = _bc.FieldBC(*(
            _bc.PatchBC(_bc.FIXED_VALUE, (0.0, 0.0, 0.0))
            if bcs_Ua_tmp.patch(p).kind in (_bc.SLIP, _bc.FIXED_VALUE)
            else bcs_Ua_tmp.patch(p)
            for p in _bc.PATCHES))
        Ub0 = 0.0
    ua_file = os.path.join(zero_d, "Ua")
    if os.path.exists(ua_file):
        bcs_Ua, _ = _read_field_bc(ua_file, patch_faces, 3, regions)
    else:
        bcs_Ua = _bc.uniform_bc(_bc.ZERO_GRADIENT, (0.0, 0.0, 0.0))
        # mirror empty patches from Ub
        bcs_Ua = _bc.FieldBC(*(
            _bc.PatchBC(_bc.EMPTY, (0.0, 0.0, 0.0))
            if bcs_Ub.patch(p).kind == _bc.EMPTY else bcs_Ua.patch(p)
            for p in _bc.PATCHES))
    bcs = FluidBCs(alpha=bcs_alpha, p=bcs_p, Ub=bcs_Ub, Ua=bcs_Ua)

    cfg = SimConfig(grid=grid, bcs=bcs, fluid=fluid_cfg, cloud=cloud_cfg,
                    dem=dem_cfg)

    # fluid initial state (numpy, moved to the device once)
    def uniform_field(val, vec=False):
        if vec:
            vals = val if isinstance(val, list) else [0.0, 0.0, 0.0]
            arr = np.zeros((3,) + grid.shape)
            arr[:] = np.asarray([float(v) for v in vals[:3]]
                                )[:, None, None, None]
            return arr
        return np.full(grid.shape, float(val))

    fluid = init_fluid(grid,
                       alpha=uniform_field(alpha0),
                       Ub=uniform_field(Ub0, vec=True),
                       p=uniform_field(p0), dtype=dtype, device=device)

    # IBM indicator field (createIBMForce.H:25-53 reads 0/ibmIndicator);
    # uniform or nonuniform List<scalar> internal fields supported
    if add_ibm:
        ind_file = os.path.join(zero_d, "ibmIndicator")
        if os.path.exists(ind_file):
            d_ind = foamdict.parse_file(ind_file)
            entry = d_ind.get("internalField", 0.0)
            if isinstance(entry, list) and "nonuniform" in entry:
                # ["nonuniform", "List<scalar>", N, [v0, v1, ...]] in
                # OpenFOAM blockMesh cell order (x fastest: i + j*nx +
                # k*nx*ny) -> our (i, j, k) layout
                inner = next(e for e in entry if isinstance(e, list))
                vals = np.asarray(inner, float)
                ind = vals.reshape(grid.nz, grid.ny, grid.nx
                                   ).transpose(2, 1, 0)
            else:
                ind = np.full(grid.shape,
                              float(foamdict.uniform_value(entry)))
            fluid = fluid._replace(ibm_indicator=torch.as_tensor(
                np.ascontiguousarray(ind), dtype=dtype, device=device))

    # particles from the LAMMPS data file
    n = len(lmp.pos)
    vel = None
    if lmp.initial_velocity is not None:
        vel = np.tile(np.asarray(lmp.initial_velocity), (n, 1))
    lat_geom = None
    if backend == "lattice":
        from pbref.dem import lattice as _lat
        lat_geom = _lat.make_geom(dem_cfg)
        # size M to the initial packing with headroom (overflowing a bin
        # silently drops contacts; diagnostics reports lattice_unslotted);
        # counted on the host, in the state's dtype
        slot, _ = _lat.bin_slots(lat_geom, torch.as_tensor(lmp.pos,
                                                           dtype=dtype),
                                 torch.ones(n, dtype=torch.bool))
        occ = int((slot < n).sum(dim=0).max())
        m_needed = max(occ + 2, 4)   # headroom for local densification
        if m_needed != lat_geom.M:
            dem_cfg = dataclasses.replace(dem_cfg, max_per_bin=m_needed)
            cfg = dataclasses.replace(cfg, dem=dem_cfg)
            lat_geom = _lat.make_geom(dem_cfg)
    mol = lmp.mol if (lmp.rigid and lmp.mol is not None) else None
    if mol is not None and backend == "binned":
        # intra-body partners win the K-nearest selection but are
        # scrubbed from the table (dem/rigid.scrub_same_mol): budget
        # extra slots for the worst member's in-ring sibling count so
        # real neighbors are not displaced
        ring = dem_cfg.audit_ring or dem_cfg.cutoff
        k_intra = 0
        for mid in np.unique(mol[mol > 0]):
            x = lmp.pos[mol == mid]
            dist = np.linalg.norm(x[:, None] - x[None], axis=-1)
            k_intra = max(k_intra, int(
                ((dist < ring) & (dist > 0)).sum(axis=1).max()))
        if k_intra:
            neighbor_k = min(neighbor_k + k_intra, 160)
            dem_cfg = dataclasses.replace(dem_cfg, nbr_k=neighbor_k)
            cfg = dataclasses.replace(cfg, dem=dem_cfg)
    particles = make_particles(
        pos=lmp.pos, radius=lmp.diameter / 2.0, density=lmp.density,
        vel=vel, ptype=lmp.ptype, tag=lmp.tag, mol=mol,
        capacity=capacity or n, n_walls=len(lmp.walls),
        lattice_geom=lat_geom,
        neighbor_k=neighbor_k if backend == "binned" else None, dtype=dtype,
        device=device)

    return cfg, fluid, particles, controls
