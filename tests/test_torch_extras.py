"""sedifoam_tpu_torch's cohesion, lubrication and contact observables
against sedifoam_tpu, on the CPU.

Inputs come from a numpy seed (tests/test_binned_extras.py's polydisperse
packing) and go through both packages. The pair laws span many decades
(one close pair outweighs the rest by 1e10), so a force evaluation is
compared row by row, each particle's force against its own largest
component, and the law itself element by element:
- f64: 1e-12 (measured: at most 7.6e-16 per row and 7.3e-16 per element
  of the law; 3.5e-16 of each field's scale after 10 substeps with both
  extras on);
- f32 against JAX f32: 5e-6 (measured: at most 3.3e-7 per row, 3.9e-7
  per element of the law; XLA and PyTorch round `pow` and `log`
  differently in the last bit). The reference's `1e-300` guards flush to
  0 in f32 in both packages; the branches they feed are masked.
The tables are compared pair by pair on (tag_i, tag_j), each column to
1e-12 of its scale. utils/postprocess (host side, numpy in both
packages) is compared exactly, on a graded grid, fed with tensors.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu import config as jcfg  # noqa: E402
from sedifoam_tpu.dem import cohesion as jcoh  # noqa: E402
from sedifoam_tpu.dem import integrate as jint  # noqa: E402
from sedifoam_tpu.dem import lubrication as jlub  # noqa: E402
from sedifoam_tpu.dem import observables as jobs  # noqa: E402
from sedifoam_tpu.dem.state import make_particles as jmake  # noqa: E402
from sedifoam_tpu import grid as jgrid  # noqa: E402
from sedifoam_tpu.utils import postprocess as jpost  # noqa: E402
from sedifoam_tpu_torch import grid as tgrid  # noqa: E402
from sedifoam_tpu_torch.utils import postprocess as tpost  # noqa: E402
from sedifoam_tpu_torch import bridge  # noqa: E402
from sedifoam_tpu_torch import config as tcfg  # noqa: E402
from sedifoam_tpu_torch.dem import cohesion as tcoh  # noqa: E402
from sedifoam_tpu_torch.dem import integrate as tint  # noqa: E402
from sedifoam_tpu_torch.dem import lubrication as tlub  # noqa: E402
from sedifoam_tpu_torch.dem import observables as tobs  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import (assert_tree_close,  # noqa: E402
                             particles_to_torch)

L = 1.0e-2
R = 5e-4
TOL = {"f64": 1e-12, "f32": 5e-6}
JDT = {"f64": jnp.float64, "f32": jnp.float32}
TDT = {"f64": torch.float64, "f32": torch.float32}
COHE = dict(ah=1e-17, lam=1e-7, smin=1e-7, smax=3e-3)
LUB = dict(mu=1e-3, flaglog=1, flagfld=1, cut_inner=1.05e-3, cut=4e-3,
           flag_hi=1, flag_vf=1, box_volume=L ** 3)


def _packing(n=30, seed=0, squeeze=1.0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0.05 * L, 0.95 * L, size=(n, 3))
    pos = squeeze * (pos - L / 2) + L / 2
    vel = rng.uniform(-0.02, 0.02, size=(n, 3))
    omega = rng.uniform(-5.0, 5.0, size=(n, 3))
    rad = rng.uniform(0.8 * R, 1.2 * R, size=n)  # polydisperse
    return pos, vel, omega, rad


def _cfgs(backend, extra=None, walls=False, **kw):
    """The same DEM config in both packages; `extra` switches cohesion
    (model 0 or 1), lubrication, or both on."""
    out = []
    for m, lub_mod in ((jcfg, jlub), (tcfg, tlub)):
        pair = m.PairParams(style="hertz_history", kn=1e5, gamman=0.7,
                            xmu=0.5)
        args = dict(dt=1e-6, pair=pair, gravity=(0.0, 0.0, 0.0),
                    backend=backend, nbr_k=16, max_per_bin=8,
                    cutoff=4.2e-3, skin=5e-4,
                    domain_lo=(0.0, 0.0, 0.0), domain_hi=(L, L, L))
        if extra in ("cohesion", "cohesion_m1", "both"):
            args["cohesion"] = m.CohesionParams(
                model=1 if extra == "cohesion_m1" else 0, **COHE)
        if extra in ("lubrication", "both"):
            args["lubrication"] = lub_mod.LubricationParams(**LUB)
        if walls:
            args["walls"] = (m.WallSpec(style="yplane", lo=0.0, hi=L,
                                        params=pair),)
        args.update(kw)
        out.append(m.DEMConfig(**args))
    return out


def _states(backend, cfg, prec, packing):
    pos, vel, omega, rad = packing
    sj = jmake(pos=pos, radius=rad, density=2500.0, vel=vel, omega=omega,
               capacity=len(pos) + 2, n_walls=len(cfg.walls),
               neighbor_k=cfg.nbr_k if backend == "binned" else None,
               dtype=JDT[prec])
    return sj, particles_to_torch(sj)


def _row_err(ref, got):
    """Worst deviation of a row of an (N, 3) field relative to that row's
    largest component, over the rows that are not zero."""
    ref = np.asarray(ref, np.float64)
    got = got.numpy().astype(np.float64)
    scale = np.abs(ref).max(axis=1)
    assert np.all(got[scale == 0.0] == 0.0)
    rows = scale > 0.0
    return float((np.abs(ref - got).max(axis=1)[rows] / scale[rows]).max())


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("backend", ["dense", "binned"])
@pytest.mark.parametrize("extra", ["cohesion", "cohesion_m1", "lubrication"])
def test_extra_forces(extra, backend, prec):
    cj, ct = _cfgs(backend, extra)
    sj, st = _states(backend, cj, prec, _packing())
    assert st.pos.dtype == TDT[prec]
    sj = jint.setup_forces(sj, cj)
    st = tint.setup_forces(st, ct)
    assert float(jnp.abs(sj.force).max()) > 0.0
    assert _row_err(sj.force, st.force) <= TOL[prec]
    assert _row_err(sj.torque, st.torque) <= TOL[prec]
    if backend == "binned":
        np.testing.assert_array_equal(np.asarray(sj.nbr_idx),
                                      st.nbr_idx.numpy())


@pytest.mark.parametrize("prec", ["f64", "f32"])
@pytest.mark.parametrize("model", [0, 1])
def test_cohesion_ccel(model, prec):
    """The piecewise law itself, over every branch: separations from deep
    contact (negative) through smin and lam/pi to beyond smax."""
    rng = np.random.RandomState(4)
    radsum = 2 * R * (0.8 + 0.4 * rng.rand(3, 400))
    sep = np.concatenate([-1e-5 * rng.rand(3, 100),
                          10 ** rng.uniform(-9, -2.4, size=(3, 300))], axis=1)
    r = radsum + sep
    within = rng.rand(3, 400) < 0.9
    pj = jcfg.CohesionParams(model=model, **COHE)
    pt = tcfg.CohesionParams(model=model, **COHE)
    ref = jcoh.cohesion_ccel(jnp.asarray(r, JDT[prec]),
                             jnp.asarray(radsum, JDT[prec]),
                             jnp.asarray(within), pj)
    got = tcoh.cohesion_ccel(torch.as_tensor(r, dtype=TDT[prec]),
                             torch.as_tensor(radsum, dtype=TDT[prec]),
                             torch.as_tensor(within), pt)
    assert got.dtype == TDT[prec]
    ref, got = np.asarray(ref, np.float64), got.numpy().astype(np.float64)
    assert np.all(np.isfinite(got))
    # elementwise: the law spans many decades
    np.testing.assert_allclose(got, ref, rtol=TOL[prec], atol=0.0)


@pytest.mark.parametrize("wiggle", [False, True])
def test_wall_bounded_volume(wiggle):
    out = []
    for m, lub_mod in ((jcfg, jlub), (tcfg, tlub)):
        pair = m.PairParams()
        walls = (
            m.WallSpec(style="yplane", lo=1e-3, hi=8e-3, params=pair,
                       wiggle=wiggle, wiggle_axis=1, amplitude=2e-4,
                       period=0.01),
            m.WallSpec(style="xplane", lo=None, hi=9e-3, params=pair),
            m.WallSpec(style="zcylinder", cylradius=3e-3, params=pair),
        )
        out.append([float(lub_mod.wall_bounded_volume(
            (0.0, 0.0, 0.0), (L, L, L), walls, t))
            for t in (0.0, 1.3e-3, 7.7e-3)])
    assert isinstance(tlub.wall_bounded_volume(
        (0.0, 0.0, 0.0), (L, L, L), (), 0.0), float)
    np.testing.assert_allclose(out[1], out[0], rtol=1e-14)
    assert out[0][0] == pytest.approx(9e-3 * 7e-3 * L, rel=1e-12)


def _pairs(tab, keys):
    tab = {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
           for k, v in tab.items()}
    mask = tab["touching"]
    return {(int(a), int(b)): tuple(float(tab[k][mask][i]) for k in keys)
            for i, (a, b) in enumerate(zip(tab["tag_i"][mask],
                                           tab["tag_j"][mask]))}


@pytest.mark.parametrize("backend", ["dense", "binned"])
@pytest.mark.parametrize("which", ["contact", "cohesion"])
def test_tables(which, backend):
    if which == "contact":
        cj, ct = _cfgs(backend)
        packing = _packing(n=40, seed=2, squeeze=0.35)   # into contact
        keys = ("dist", "fn", "fx", "fy", "fz")
        fj, ft = jobs.contact_table, tobs.contact_table
    else:
        cj, ct = _cfgs(backend, "cohesion")
        packing = _packing(n=25, seed=3)
        keys = ("dist", "force", "fx", "fy", "fz")
        fj, ft = jobs.cohesion_table, tobs.cohesion_table
    sj, st = _states(backend, cj, "f64", packing)
    sj = jint.run_dem(jint.setup_forces(sj, cj), cj, 3)   # some shear
    st = tint.run_dem(tint.setup_forces(st, ct), ct, 3)
    ref, got = _pairs(fj(sj, cj), keys), _pairs(ft(st, ct), keys)
    assert len(ref) > 0, "no pairs in fixture"
    assert ref.keys() == got.keys()
    a = np.asarray([ref[k] for k in ref])
    b = np.asarray([got[k] for k in ref])
    worst = (np.abs(a - b).max(axis=0) / np.abs(a).max(axis=0)).max()
    assert worst <= TOL["f64"], worst


@pytest.mark.parametrize("backend", ["dense", "binned"])
def test_run_dem_with_both_extras(backend):
    """10 substeps with cohesion and lubrication on, between wiggle-free
    y walls (the wall-bounded volume feeds the FLD terms), field by field."""
    cj, ct = _cfgs(backend, "both", walls=True)
    sj, st = _states(backend, cj, "f64", _packing(seed=5))
    sj = jint.run_dem(jint.setup_forces(sj, cj), cj, 10)
    st = tint.run_dem(tint.setup_forces(st, ct), ct, 10)
    worst = assert_tree_close(bridge.tree_to_numpy(sj),
                              bridge.tree_to_numpy(st), TOL["f64"])
    assert worst <= TOL["f64"]


@pytest.mark.parametrize("what", ["channel_collapse", "line_sample",
                                  "TimeAverager", "find_faces_on_patch",
                                  "coarsen_faces"])
def test_postprocess(what):
    rng = np.random.RandomState(8)
    shape = (6, 9, 5)
    faces = [np.concatenate([[0.0], np.cumsum(0.5 + rng.rand(n))]) * 1e-3
             for n in shape]
    gj, gt = jgrid.Grid.from_faces(*faces), tgrid.Grid.from_faces(*faces)
    scal, vec = rng.randn(*shape), rng.randn(3, *shape)
    tscal, tvec = torch.as_tensor(scal), torch.as_tensor(vec)
    if what == "channel_collapse":
        for axis in range(3):
            for a, t in ((scal, tscal), (vec, tvec)):
                np.testing.assert_array_equal(
                    jpost.channel_collapse(a, axis),
                    tpost.channel_collapse(t, axis))
    elif what == "line_sample":
        start, end = [0.0, 0.0, 1e-3], [f[-1] for f in faces]
        for a, t in ((scal, tscal), (vec, tvec)):
            pj, vj = jpost.line_sample(a, gj, start, end, n=37)
            pt, vt = tpost.line_sample(t, gt, start, end, n=37)
            np.testing.assert_array_equal(pj, pt)
            np.testing.assert_array_equal(vj, vt)
            assert vt.shape[0] == 37
    elif what == "TimeAverager":
        aj, at = jpost.TimeAverager(), tpost.TimeAverager()
        for i in range(3):
            aj.add(U=vec * (i + 1), alpha=scal + i)
            at.add(U=tvec * (i + 1), alpha=tscal + i)
        for name in ("U", "alpha"):
            np.testing.assert_array_equal(aj.mean(name), at.mean(name))
        assert at.n == 3 and isinstance(at.mean("U"), np.ndarray)
    elif what == "find_faces_on_patch":
        hi = [f[-1] for f in faces]
        boxes = [([0.0, 0.0, 0.0], [0.4 * hi[0], hi[1], 0.5 * hi[2]]),
                 ([0.7 * hi[0], 0.0, 0.2 * hi[2]],
                  [0.7 * hi[0], hi[1], 0.9 * hi[2]])]   # degenerate in x
        for face_id in range(6):
            ij, cj = jpost.find_faces_on_patch(gj, face_id, boxes)
            it, ct = tpost.find_faces_on_patch(gt, face_id, boxes)
            np.testing.assert_array_equal(ij, it)
            np.testing.assert_array_equal(cj, ct)
        assert len(tpost.find_faces_on_patch(gt, 2, boxes)[0]) > 0
    else:
        for step in (2, 3, 4):
            np.testing.assert_array_equal(
                jpost.coarsen_faces(faces[1], step),
                tpost.coarsen_faces(torch.as_tensor(faces[1]), step))
        assert tpost.coarsen_faces(faces[1], 4)[-1] == faces[1][-1]
