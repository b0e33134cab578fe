"""The port's case IO against sedifoam_tpu's, on the CPU.

The reference case directories are not mounted here, so the cases are
written into tmp_path by sedifoam_tpu_torch.cases (xiaocase3 and a
coarse transport-bedload channel: 14 x 13 x 6 cells, two bed layers)
and by the O-grid writer below (the jetFlow pattern: 5 hex blocks with
arc edges, an inlet disc inside the bottom patch). Both packages load
each directory; the SimConfig must be equal field by field (the
reference's rebuilt from the port's classes), every array of the fluid
and particle state bitwise equal, and the CaseControls equal, for the
dense and the binned backends. Variants cover the loader's time-table
(uniformFixedValue), $internalField and missing-0/Ub paths.

Also: the mesh readers, the dictionary and in.lammps parsers on a table
of snippets, the error cases, read_field and DumpWriter.
"""

import dataclasses
import os
import shutil
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu.io import case as jcase  # noqa: E402
from sedifoam_tpu.io import dump as jdump  # noqa: E402
from sedifoam_tpu.io import foamdict as jfd  # noqa: E402
from sedifoam_tpu.io import foamwrite as jfw  # noqa: E402
from sedifoam_tpu.io import lammps as jlmp  # noqa: E402
from sedifoam_tpu_torch import bc as tbc  # noqa: E402
from sedifoam_tpu_torch import bridge, cases  # noqa: E402
from sedifoam_tpu_torch.io import case as tcase  # noqa: E402
from sedifoam_tpu_torch.io import dump as tdump  # noqa: E402
from sedifoam_tpu_torch.io import foamdict as tfd  # noqa: E402
from sedifoam_tpu_torch.io import foamwrite as tfw  # noqa: E402
from sedifoam_tpu_torch.io import lammps as tlmp  # noqa: E402
from torch_port_cases import port_config  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import assert_tree_close  # noqa: E402

COARSE = dict(counts=(14, 13, 6), layers=2)

OGRID_BMD = """
convertToMeters 0.001;
vertices
(
    (0 0 0) (10 0 0) (10 0 10) (0 0 10)
    (4 0 4) (6 0 4) (6 0 6) (4 0 6)
    (0 20 0) (10 20 0) (10 20 10) (0 20 10)
    (4 20 4) (6 20 4) (6 20 6) (4 20 6)
);
blocks
(
    hex (4 5 7 6 12 13 15 14) (4 4 12) simpleGrading (1 1 1)
    hex (0 1 5 4 8 9 13 12) (4 5 12) simpleGrading (1 0.5 1)
    hex (7 6 2 3 15 14 10 11) (4 5 12) simpleGrading (1 2 1)
    hex (0 4 7 3 8 12 15 11) (5 4 12) simpleGrading (0.5 1 1)
    hex (5 1 2 6 13 9 10 14) (5 4 12) simpleGrading (2 1 1)
);
edges
(
    arc 4 5 (5 0 3.5)
    arc 5 6 (6.5 0 5)
    arc 6 7 (5 0 6.5)
    arc 7 4 (3.5 0 5)
    arc 0 1 (5 0 -2)
);
boundary
(
    inlet  { type patch; faces ( (4 5 6 7) ); }
    bottom { type wall; faces ( (0 1 5 4) (0 4 7 3) (5 1 2 6) (7 6 2 3) ); }
    top    { type patch; faces ( (12 13 14 15) (8 9 13 12) (8 12 15 11)
                                 (13 9 10 14) (15 14 10 11) ); }
    walls  { type wall; faces ( (0 1 9 8) (3 11 10 2) (0 3 11 8)
                                (1 9 10 2) ); }
);
"""


def _replace_in(path, old, new):
    with open(path) as f:
        text = f.read()
    assert old in text, (path, old)
    with open(path, "w") as f:
        f.write(text.replace(old, new))


def write_ogrid_case(case_dir):
    """xiaocase3's dictionaries and particle on a jetFlow-pattern O-grid
    (10 x 20 x 10 mm box, a 2 mm jet column, the inlet disc of radius
    1.5 mm inside the bottom patch)."""
    cases.write_xiaocase3(case_dir)
    with open(os.path.join(case_dir, "constant/polyMesh/blockMeshDict"),
              "w") as f:
        f.write("FoamFile { version 2.0; format ascii; class dictionary; "
                "object blockMeshDict; }\n" + OGRID_BMD)
    fixed0 = "type fixedValue; value uniform 0;"
    zg = "type zeroGradient;"
    wall = "type fixedValue; value uniform (0 0 0);"
    fields = {   # name: (class, inlet, bottom, top, walls)
        "alpha": ("volScalarField", fixed0, zg,
                  "type inletOutlet; inletValue uniform 0;", zg),
        "p": ("volScalarField", zg, zg, fixed0, zg),
        "Ub": ("volVectorField", "type fixedValue; value uniform (0 0.05 0);",
               wall, "type inletOutlet; inletValue uniform (0 0 0);", wall),
        "Ua": ("volVectorField", zg, zg, zg, zg)}
    for name, (cls, *specs) in fields.items():
        cases._field(case_dir, name, cls, "[0 0 0 0 0 0 0]", "uniform 0"
                     if cls == "volScalarField" else "uniform (0 0 0)",
                     dict(zip(("inlet", "bottom", "top", "walls"), specs)))
    return case_dir


@pytest.fixture(scope="module")
def case_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cases")
    out = {"xiaocase3": cases.write_xiaocase3(str(root / "xiaocase3"))}
    # the inlet velocity as a uniformFixedValue time table
    table = cases.write_xiaocase3(str(root / "xiaocase3_table"))
    _replace_in(os.path.join(table, "0", "Ub"),
                "type fixedValue; value uniform (0 0.05 0);",
                "type uniformFixedValue; uniformValue table "
                "((0 (0 0 0)) (1e-4 (0 0.05 0)) (1 (0 0.06 0)));")
    _replace_in(os.path.join(table, "0", "alpha"),
                "type fixedValue; value uniform 0;",
                "type uniformFixedValue; uniformValue table "
                "((0 0.1) (1 0));")
    out["xiaocase3_table"] = table
    out["channel"] = cases.write_channel_case(str(root / "channel"),
                                              **COARSE)
    no_ub = cases.write_channel_case(str(root / "channel_no_Ub"), **COARSE)
    os.remove(os.path.join(no_ub, "0", "Ub"))
    out["channel_no_Ub"] = no_ub
    out["ogrid"] = write_ogrid_case(str(root / "ogrid"))
    return out


def _load_both(path, **kw):
    jkw = {k: v for k, v in kw.items() if k != "device"}
    jkw["dtype"] = jnp.float32 if kw.get("dtype") == torch.float32 \
        else jnp.float64
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return jcase.load_case(path, **jkw), tcase.load_case(
            path, **{"device": "cpu", **kw})


@pytest.mark.parametrize("backend", ["dense", "binned"])
@pytest.mark.parametrize("name", ["xiaocase3", "xiaocase3_table", "channel",
                                  "channel_no_Ub", "ogrid"])
def test_load_case_matches_reference(case_dirs, name, backend):
    kw = dict(backend=backend, embed_ogrid=(name == "ogrid"))
    (cj, fj, pj, kj), (ct, ft, pt, kt) = _load_both(case_dirs[name], **kw)
    assert port_config(cj) == ct
    assert dataclasses.asdict(kj) == dataclasses.asdict(kt)
    assert_tree_close(bridge.tree_to_numpy(fj), bridge.tree_to_numpy(ft), 0.0)
    assert_tree_close(bridge.tree_to_numpy(pj), bridge.tree_to_numpy(pt), 0.0)
    assert ft.p.dtype == torch.float64
    if name.startswith("channel"):
        assert ct.dem.nbr_k == 16 and ct.dem.periodic == (True, False, True)
        assert ct.dem.frozen_types == (2,) and ct.fluid.forcing.mode == "Ubar"
        assert ct.fluid.turbulence.model == "kEqn"
        assert ct.dem.carrier_rho == 1000.0
        # no 0/Ub: Ua's slip top becomes a no-slip Ub wall
        top = tbc.SLIP if name == "channel" else tbc.FIXED_VALUE
        assert ct.bcs.Ub.yp.kind == top
    if name == "xiaocase3_table":
        assert isinstance(ct.bcs.Ub.ym.value, tbc.TimeTable)
        assert isinstance(ct.bcs.alpha.ym.value, tbc.TimeTable)
    if name == "ogrid":
        assert isinstance(ct.bcs.Ub.ym, tbc.RegionPatchBC)
        assert abs(ct.bcs.Ub.ym.region.radius - 1.5e-3) < 1e-12


def test_load_case_f32_on_device(case_dirs):
    (_, fj, pj, _), (ct, ft, pt, _) = _load_both(
        case_dirs["channel"], backend="binned", dtype=torch.float32,
        capacity=4096, device=torch.device("cpu"))
    assert ft.Ub.dtype == pt.pos.dtype == torch.float32
    assert_tree_close(bridge.tree_to_numpy(fj), bridge.tree_to_numpy(ft), 0.0)
    assert_tree_close(bridge.tree_to_numpy(pj), bridge.tree_to_numpy(pt), 0.0)
    assert pt.n_capacity == 4096 and int(pt.active.sum()) == 2024
    assert tuple(pt.nbr_idx.shape) == (16, 4096)


def test_xiaocase3_directory_is_the_built_case(case_dirs):
    """The written xiaocase3 loads as cases.xiaocase3() builds it. The
    loader also fills fields that only other paths read: the binned
    table's sizing and the DEM box (the dense backend reads neither) and
    all-zero injection boxes (read only with injection on)."""
    ct, ft, pt, _ = tcase.load_case(case_dirs["xiaocase3"], device="cpu")
    cb, fb, pb = cases.xiaocase3(device="cpu")
    assert ct.grid == cb.grid and ct.bcs == cb.bcs and ct.fluid == cb.fluid
    loader_only = {"nbr_k", "max_per_bin", "cutoff", "skin", "audit_ring",
                   "domain_hi"}
    da, db = dataclasses.asdict(ct.dem), dataclasses.asdict(cb.dem)
    assert {k for k in da if da[k] != db[k]} == loader_only
    ca, cbd = dataclasses.asdict(ct.cloud), dataclasses.asdict(cb.cloud)
    boxes = {"inlet_box", "add_box", "delete_box", "clear_box"}
    assert {k for k in ca if ca[k] != cbd[k]} == boxes
    assert all(ca[k] == (0.0,) * 6 and cbd[k] == () for k in boxes)
    assert ct.cloud.add_particle == 0 and ct.cloud.delete_particle == 0
    assert_tree_close(bridge.tree_to_numpy(fb), bridge.tree_to_numpy(ft), 0.0)
    assert_tree_close(bridge.tree_to_numpy(pb), bridge.tree_to_numpy(pt), 0.0)


def test_lattice_backend_refused(tmp_path):
    """The lattice backend loads (tests/test_torch_lattice.py), but a
    case of rigid clumps on it is refused, by both loaders alike: the
    clumps run on the dense and binned backends only."""
    path = cases.write_irregular_case(str(tmp_path / "irregular"),
                                      n_clumps=30, counts=(9, 8, 6),
                                      floor_d=0.002)
    for load, kw in ((jcase.load_case, {}), (tcase.load_case,
                                             {"device": "cpu"})):
        with pytest.raises(NotImplementedError,
                           match="rigid clumps .* dense and binned"), \
                warnings.catch_warnings():
            # the loader's K-cap warning of this shrunken bed
            warnings.simplefilter("ignore")
            load(path, backend="lattice", **kw)


@pytest.mark.parametrize("name", ["LubricationParams", "CaseControls",
                                  "LammpsCase"])
def test_io_dataclasses_match_reference(name):
    from sedifoam_tpu.dem import lubrication as jlub
    from sedifoam_tpu_torch.dem import lubrication as tlub
    mods = {"LubricationParams": (jlub, tlub), "CaseControls": (jcase, tcase),
            "LammpsCase": (jlmp, tlmp)}[name]
    fa, fb = (dataclasses.fields(getattr(m, name)) for m in mods)
    assert [f.name for f in fa] == [f.name for f in fb]
    for x, y in zip(fa, fb):
        if dataclasses.is_dataclass(x.default):
            assert dataclasses.asdict(x.default) == \
                dataclasses.asdict(y.default)
        else:
            assert x.default == y.default, x.name
        assert x.default_factory == y.default_factory or \
            x.default_factory() == y.default_factory()


# -- mesh readers -----------------------------------------------------------

STACKED_BMD = """
convertToMeters 1;
vertices ( (0 0 0) (3 0 0) (3 0.1 0) (0 0.1 0)
           (0 0 1) (3 0 1) (3 0.1 1) (0 0.1 1)
           (0 1.5 0) (3 1.5 0) (0 1.5 1) (3 1.5 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (12 4 4) simpleGrading (1 0.5 1)
         hex (3 2 9 8 7 6 11 10) (12 13 4) edgeGrading
             (1 1 1 1 2.2 2.2 2.2 2.2 1 1 1 1) );
boundary ( walls { type wall; faces ( (1 5 4 0) ); } );
"""


def _bmd(tmp_path, body):
    p = tmp_path / "blockMeshDict"
    p.write_text("FoamFile { version 2.0; format ascii; class dictionary;"
                 " object blockMeshDict; }\n" + body)
    return str(p)


def _same_mesh(a, b):
    (ga, pa), (gb, pb) = a[:2], b[:2]
    assert dataclasses.asdict(ga) == dataclasses.asdict(gb)
    assert pa == pb


@pytest.mark.parametrize("mesh", ["graded", "stacked", "ogrid"])
def test_mesh_readers_match_reference(tmp_path, case_dirs, mesh):
    if mesh == "graded":
        path = os.path.join(case_dirs["channel"],
                            "constant/polyMesh/blockMeshDict")
    else:
        path = _bmd(tmp_path, STACKED_BMD if mesh == "stacked"
                    else OGRID_BMD)
    if mesh == "ogrid":
        for m in (jcase, tcase):
            with pytest.raises(m.UnsupportedMeshError, match="arc"):
                m.read_block_mesh(path)
        a = jcase.read_block_mesh_embedded(path)
        b = tcase.read_block_mesh_embedded(path)
        _same_mesh(a, b)
        assert {f: (i, o, dataclasses.asdict(r))
                for f, (i, o, r) in a[2].items()} == \
            {f: (i, o, dataclasses.asdict(r))
             for f, (i, o, r) in b[2].items()}
        assert set(b[2]) == {2}
        assert b[0].shape == (14, 12, 14)
        return
    a, b = jcase.read_block_mesh(path), tcase.read_block_mesh(path)
    _same_mesh(a, b)
    assert not b[0].uniform


def test_errors_match_reference(tmp_path, case_dirs):
    """UnsupportedMeshError for an O-grid without the opt-in and for a
    non-stacked block layout; MissingICError for an absent data file."""
    cpu = {jcase: {}, tcase: {"device": "cpu"}}
    for m in (jcase, tcase):
        with pytest.raises(m.UnsupportedMeshError, match="embed_ogrid"):
            m.load_case(case_dirs["ogrid"], **cpu[m])
    bad = _bmd(tmp_path, """
vertices ( (0 0 0) (1 0 0) (1 1 0) (0 1 0) (0 0 1) (1 0 1) (1 1 1) (0 1 1)
           (2 0 0) (2 0.5 0) (2 0.5 1) (2 0 1) (1 0.5 0) (1 0.5 1) );
blocks ( hex (0 1 2 3 4 5 6 7) (2 2 2) simpleGrading (1 1 1)
         hex (1 8 9 12 5 11 10 13) (2 2 2) simpleGrading (1 1 1) );
boundary ();
""")
    for m in (jcase, tcase):
        with pytest.raises(m.UnsupportedMeshError, match="1-D stack"):
            m.read_block_mesh(bad)
    missing = str(tmp_path / "missing")
    shutil.copytree(case_dirs["xiaocase3"], missing)
    os.remove(os.path.join(missing, "IC_uniform.in"))
    for m in (jcase, tcase):
        with pytest.raises(m.MissingICError, match="IC_uniform.in"):
            m.load_case(missing, **cpu[m])
    assert issubclass(tcase.MissingICError, ValueError)


# -- dictionary and in.lammps parsers --------------------------------------

FOAM_SNIPPETS = [
    "nub nub [0 2 -1 0 0 0 0] 1e-06; rhob 1000;",
    "g g [0 1 -2 0 0 0 0] (0 -9.81 0);",
    "/* block */ a 1; // line\nb (1 2 (3 4)); c { d e; f { g 1.5; } }",
    "smoothDirection (1 0 0 0 1 0 0 0 0.5); flag on; other off;",
    "internalField nonuniform List<scalar> 3 (0.1 0.2 0.3);",
    'functionObjectLibs ("libsampling.so"); name "quoted";',
    "inlet { type uniformFixedValue; uniformValue table ((0 (0 0 0)) "
    "(1 (0 1 0))); }",
    "value $internalField; key word { nested 1; }",
]


def _helpers(m, d):
    """The parsed dict with module m's helpers applied where they apply."""
    out = {}
    for k, v in d.items():
        entry = {"raw": v, "lookup": m.lookup_or_default(d, k, None)}
        for fn in ("dimensioned_value", "dimensioned_vector",
                   "uniform_value"):
            try:
                entry[fn] = getattr(m, fn)(v)
            except (ValueError, TypeError):
                entry[fn] = "raises"
        out[k] = entry
    return out


@pytest.mark.parametrize("text", FOAM_SNIPPETS)
def test_foamdict_matches_reference(text, tmp_path):
    a, b = jfd.parse_string(text), tfd.parse_string(text)
    assert a == b
    p = tmp_path / "dict"
    p.write_text("FoamFile { version 2.0; }\n" + text)
    assert tfd.parse_file(str(p)) == b
    assert _helpers(jfd, a) == _helpers(tfd, b)
    assert tfd.lookup_or_default(b, "absent", 7) == 7


DATA = """synthetic

4 atoms
3 atom types

0 0.01 xlo xhi
0 0.02 ylo yhi
0 0.01 zlo zhi

Atoms

1 1 0.001 2500 0.002 0.002 0.002
2 2 0.001 2500 0.004 0.002 0.002
3 3 0.0012 2600 0.006 0.002 0.002
4 1 0.001 2500 0.008 0.002 0.002

Molecules

1 1
2 1
3 2
4 2
"""

LAMMPS_SNIPPETS = [
    "pair_style gran/hertz/history 1e5 NULL 0.7 NULL 0.3 1\n"
    "fix w all wall/gran 1e5 NULL 0.7 NULL 0.3 1 zcylinder 0.004\n"
    "fix g all gravity 9.81 vector 0 0 -1\nfix d all fdrag 1.2",
    "group bottom type 2\ngroup active subtract all bottom\n"
    "fix 1 active nve/sphere",
    "group bed type >= 2\nfix f bed freeze\nfix 1 all nve/sphere",
    "group a type 1:2\ngroup b type < 2\nfix 1 a nve/sphere\n"
    "fix 2 b rigid/small molecule",
    "group m type 1\nfix 1 m nve/sphere",
    "pair_style gran/hooke 2000 1000 10 5 0.5 0\n"
    "fix c all cohesive 1e-20 1e-7 1e-9 1e-6 1\n"
    "velocity all set 0.1 -0.2 0.3\nboundary p f pp",
    "pair_style lubricate/poly 1e-3 1 1 1e-6 2e-3 1 0\n"
    "fix x all wall/granFix 1e4 NULL 5 NULL 0.5 1 xplane NULL 0.01",
    "pair_style none\ntimestep 2e-6\nfix w all wall/gran 1.91+e2 2 3 4 0.5 "
    "1 yplane 0.0 NULL",
]


def _lammps_dict(case, np_mod=np):
    d = {}
    for f in dataclasses.fields(case):
        v = getattr(case, f.name)
        if isinstance(v, np_mod.ndarray):
            v = (v.dtype.str, v.tolist())
        elif dataclasses.is_dataclass(v):
            v = dataclasses.asdict(v)
        elif isinstance(v, tuple):
            v = tuple(dataclasses.asdict(x) if dataclasses.is_dataclass(x)
                      else x for x in v)
        d[f.name] = v
    return d


@pytest.mark.parametrize("script", LAMMPS_SNIPPETS)
def test_lammps_parser_matches_reference(script, tmp_path):
    (tmp_path / "data.in").write_text(DATA)
    (tmp_path / "in.lammps").write_text(
        "atom_style sphere\nread_data data.in\n" + script + "\n")
    a = jlmp.parse_input_script(str(tmp_path / "in.lammps"))
    b = tlmp.parse_input_script(str(tmp_path / "in.lammps"))
    assert _lammps_dict(a) == _lammps_dict(b)


def test_molecule_template_matches_reference(tmp_path):
    p = tmp_path / "mol.txt"
    p.write_text("# trimer\n\n3 atoms\n\nCoords\n\n1 0 0 0\n2 0.001 0 0\n"
                 "3 0.002 0 0\n\nTypes\n\n1 1\n2 1\n3 2\n\nDiameters\n\n"
                 "1 0.001\n2 0.001\n3 0.0012\n\nMasses\n\n1 1e-6\n2 1e-6\n"
                 "3 2e-6\n")
    a = jlmp.parse_molecule_template(str(p))
    b = tlmp.parse_molecule_template(str(p))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype


# -- field files and dumps --------------------------------------------------

def test_read_field_round_trip(tmp_path, case_dirs):
    grid = tcase.read_block_mesh(os.path.join(
        case_dirs["channel"], "constant/polyMesh/blockMeshDict"))[0]
    jgrid = jcase.read_block_mesh(os.path.join(
        case_dirs["channel"], "constant/polyMesh/blockMeshDict"))[0]
    rng = np.random.RandomState(50)
    for name, arr in (("p", rng.randn(*grid.shape)),
                      ("Ub", rng.randn(3, *grid.shape))):
        path = str(tmp_path / name)
        tfw.write_field(path, name, arr, grid, patch_names=["bottom", "top"])
        a, b = jfw.read_field(path, jgrid), tfw.read_field(path, grid)
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(b, arr, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("native", [True, False])
def test_dump_writer_bytes_match_reference(tmp_path, case_dirs, native,
                                           monkeypatch):
    """One small state (the channel bed, some slots dead), written twice
    by each package: the files are byte-equal, through the native async
    writer and through the Python fallback."""
    (_, _, pj, _), (_, _, pt, _) = _load_both(case_dirs["channel"],
                                              backend="binned")
    active = np.ones(pt.n_capacity, bool)
    active[::7] = False
    pj = pj._replace(active=jnp.asarray(active))
    pt = pt._replace(active=torch.as_tensor(active))
    if not native:
        monkeypatch.setattr(jdump, "_load_native", lambda: None)
        monkeypatch.setattr(tdump, "_load_native", lambda: None)
    box = (0.0, 0.12125, 0.0, 0.04, 0.0, 0.06001)
    paths = []
    for m, st in ((jdump, pj), (tdump, pt)):
        path = str(tmp_path / f"{m.__name__.split('.')[0]}.dump")
        with m.DumpWriter(path, box=box) as w:
            if native and not w.native:
                pytest.skip("the native dump writer did not build here")
            w.write(10, st)
            w.write(20, st)
        paths.append(path)
    a, b = (open(p, "rb").read() for p in paths)
    assert a == b and b.count(b"ITEM: TIMESTEP") == 2
