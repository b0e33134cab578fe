"""The last single-device functions of sedifoam_tpu ported into
sedifoam_tpu_torch, against the JAX package in f64 on the CPU, from the
same numpy-seeded inputs:

- ops.laplacian and ops.limited_weights (with _limited_weights_axis) on
  tests/test_ops.py's cases (a quadratic field, a uniform field, a step)
  and on random fields with mixed boundary conditions, on a uniform and
  a graded grid: 1e-12 of each field's scale;
- linop.laplacian_flux and linop.zero_term, which nothing in the JAX
  package calls, directly on a graded grid: 1e-12 / exactly;
- linsolve.pcg_multi on a batch of three systems of one SPD operator:
  solution and residuals 1e-9 of scale, the same iteration count;
- the smoothing's PCG branch (USE_FASTDIAG off on both modules through
  monkeypatch), scalar (pcg) and vector (pcg_multi): 1e-9 of scale.
  The stop rule reads the residual, so round-off can move a stop by an
  iteration; the solves converge to 1e-10, which bounds the gap.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sedifoam_tpu import bc as jbc  # noqa: E402
from sedifoam_tpu import linop as jlinop  # noqa: E402
from sedifoam_tpu import linsolve as jsolve  # noqa: E402
from sedifoam_tpu import ops as jops  # noqa: E402
from sedifoam_tpu.coupling import smoothing as jsmooth  # noqa: E402
from sedifoam_tpu.grid import FaceField as JFace  # noqa: E402
from sedifoam_tpu.grid import Grid as JGrid  # noqa: E402
from sedifoam_tpu_torch import bc as tbc  # noqa: E402
from sedifoam_tpu_torch import linop as tlinop  # noqa: E402
from sedifoam_tpu_torch import linsolve as tsolve  # noqa: E402
from sedifoam_tpu_torch import ops as tops  # noqa: E402
from sedifoam_tpu_torch.coupling import smoothing as tsmooth  # noqa: E402
from sedifoam_tpu_torch.grid import FaceField as TFace  # noqa: E402
from sedifoam_tpu_torch.grid import Grid as TGrid  # noqa: E402
from torch_port_util import few_threads, rel_err  # noqa: E402,F401

TOL = 1e-12
SOLVE_TOL = 1e-9


def _graded(m):
    """An 8x6x5 grid graded along x (cells growing 4x) and z (shrinking
    to 0.3x), uniform along y."""
    xf = np.concatenate([[0.0], np.cumsum(np.geomspace(1.0, 4.0, 8))])
    zf = np.concatenate([[0.0], np.cumsum(np.geomspace(1.0, 0.3, 5))])
    return m.from_faces(0.1 * xf, np.linspace(0.0, 1.2, 7), 0.25 * zf)


def _grids():
    """(uniform, graded) grids in both packages, as tests/test_ops.py's."""
    out = []
    for m in (JGrid, TGrid):
        out.append((m(nx=8, ny=6, nz=4, dx=0.1, dy=0.2, dz=0.25),
                    _graded(m)))
    return out


GRIDS = _grids()


def _bcs(spec):
    return tuple(m.make_field_bc({k: m.PatchBC(kind, v) for k, (kind, v)
                                  in spec.items()}) for m in (jbc, tbc))


def _faces(values):
    return (JFace(*(jnp.asarray(v) for v in values)),
            TFace(*(torch.as_tensor(v) for v in values)))


def _face_arrays(g, rng, kind="randn"):
    shapes = ((g.nx + 1, g.ny, g.nz), (g.nx, g.ny + 1, g.nz),
              (g.nx, g.ny, g.nz + 1))
    if kind == "area":
        return [np.broadcast_to(np.asarray(g.face_area[a], float),
                                shapes[a]).copy() for a in range(3)]
    return [getattr(rng, kind)(*s) for s in shapes]


MIXED = {"xm": (jbc.FIXED_VALUE, (1.0,)), "yp": (jbc.FIXED_VALUE, (-2.0,)),
         "zm": (jbc.CYCLIC, (0.0,)), "zp": (jbc.CYCLIC, (0.0,))}


@pytest.mark.parametrize("graded", [False, True])
def test_ops_laplacian_matches_reference(graded):
    (jg, tg) = (GRIDS[0][graded], GRIDS[1][graded])
    X = jg.cell_centers()
    quad = np.asarray(X[0] ** 2 + 2.0 * X[1] ** 2)     # laplacian 6
    rng = np.random.RandomState(0)
    zg = _bcs({})
    mixed = _bcs(MIXED)
    gj, gt = _faces(_face_arrays(jg, rng, "rand"))
    for f, (fj, ft), gamma in ((quad, zg, (1.0, 1.0)),
                               (rng.rand(*jg.shape), mixed, (0.7, 0.7)),
                               (rng.rand(*jg.shape), mixed, (gj, gt))):
        a = jops.laplacian(gamma[0], jnp.asarray(f), jg, fj)
        b = tops.laplacian(gamma[1], torch.as_tensor(f), tg, ft)
        assert rel_err(a, b) <= TOL
    if not graded:
        interior = (slice(1, -1),) * 3
        b = tops.laplacian(1.0, torch.as_tensor(quad), tg, zg[1])
        np.testing.assert_allclose(b[interior].numpy(), 6.0, rtol=1e-10)


@pytest.mark.parametrize("graded", [False, True])
def test_ops_limited_weights_matches_reference(graded):
    jg, tg = GRIDS[0][graded], GRIDS[1][graded]
    rng = np.random.RandomState(1)
    zg = _bcs({})
    inout = _bcs({"xm": (jbc.FIXED_VALUE, (0.3,)),
                  "xp": (jbc.INLET_OUTLET, (0.1,))})
    step = np.zeros(jg.shape)
    step[: jg.nx // 2] = 1.0
    x_only = [np.ones((jg.nx + 1, jg.ny, jg.nz)),
              np.zeros((jg.nx, jg.ny + 1, jg.nz)),
              np.zeros((jg.nx, jg.ny, jg.nz + 1))]
    cases = (
        (np.full(jg.shape, 2.0), zg, _face_arrays(jg, rng, "area"), 1.0),
        (step, zg, x_only, 1.0),
        (rng.rand(*jg.shape), inout, _face_arrays(jg, rng), 1.0),
        (rng.rand(*jg.shape), inout, _face_arrays(jg, rng), 0.5))
    for f, (fj, ft), phi, k in cases:
        pj, pt = _faces(phi)
        a = jops.limited_weights(jnp.asarray(f), jg, fj, pj, k)
        b = tops.limited_weights(torch.as_tensor(f), tg, ft, pt, k)
        for x, y in zip(a, b):
            assert rel_err(x, y) <= TOL
        gj = jops.grad(jnp.asarray(f), jg, fj, pj)
        gt = tops.grad(torch.as_tensor(f), tg, ft, pt)
        for ax in range(3):
            assert rel_err(
                jops._limited_weights_axis(jnp.asarray(f), gj, ax, jg, fj,
                                           pj, k),
                tops._limited_weights_axis(torch.as_tensor(f), gt, ax, tg,
                                           ft, pt, k)) <= TOL
    # tests/test_ops.py's own checks, on the port
    w = tops.limited_weights(torch.full(tg.shape, 2.0, dtype=torch.float64),
                             tg, zg[1], _faces(_face_arrays(
                                 jg, rng, "area"))[1])
    if not graded:
        np.testing.assert_allclose(w.x[1:-1].numpy(), 0.5)
    w = tops.limited_weights(torch.as_tensor(step), tg, zg[1],
                             _faces(x_only)[1])
    assert float(w.x[jg.nx // 2, 0, 0]) == pytest.approx(1.0)


def test_linop_laplacian_flux_and_zero_term_match_reference():
    jg, tg = GRIDS[0][1], GRIDS[1][1]
    rng = np.random.RandomState(2)
    x = rng.rand(*jg.shape)
    gj, gt = _faces(_face_arrays(jg, rng, "rand"))
    phi_j, phi_t = _faces(_face_arrays(jg, rng))
    for gamma, (fj, ft), phi in ((1.3, _bcs(MIXED), (None, None)),
                                 ((gj, gt), _bcs({
                                     "xm": (jbc.FIXED_VALUE, (0.3,)),
                                     "xp": (jbc.INLET_OUTLET, (0.1,))}),
                                  (phi_j, phi_t))):
        g = gamma if isinstance(gamma, tuple) else (gamma, gamma)
        a = jlinop.laplacian_flux(g[0], jnp.asarray(x), jg, fj, phi[0])
        b = tlinop.laplacian_flux(g[1], torch.as_tensor(x), tg, ft, phi[1])
        for u, v in zip(a, b):
            assert rel_err(u, v) <= TOL
    # the flux's divergence is the laplacian operator's full action
    fj, ft = _bcs(MIXED)
    flux = tlinop.laplacian_flux(0.7, torch.as_tensor(x), tg, ft)
    div = sum(tops._face_diff(flux[a], a) for a in range(3))
    term = tlinop.laplacian(0.7, tg, ft)
    assert rel_err(term.apply(torch.as_tensor(x)) - term.rhs, div) <= 1e-12
    zj = jlinop.zero_term(jg)
    zt = tlinop.zero_term(tg)
    assert zt.diag.shape == tg.shape and zt.diag.dtype == torch.float64
    np.testing.assert_array_equal(zt.diag.numpy(), np.asarray(zj.diag))
    np.testing.assert_array_equal(zt.rhs.numpy(), np.asarray(zj.rhs))
    np.testing.assert_array_equal(
        zt.apply(torch.as_tensor(x)).numpy(),
        np.asarray(zj.apply(jnp.asarray(x))))
    # zero_term is the identity of term addition
    s = term + zt
    assert rel_err(term.apply(torch.as_tensor(x)),
                   s.apply(torch.as_tensor(x))) == 0.0


def test_pcg_multi_matches_reference():
    """Three right-hand sides of one Helmholtz-type operator (V/dt - L)
    on the graded grid, mixed boundary conditions."""
    jg, tg = GRIDS[0][1], GRIDS[1][1]
    fj, ft = _bcs(MIXED)
    lj = jlinop.laplacian(0.7, jg, fj)
    lt = tlinop.laplacian(0.7, tg, ft)
    vj = jnp.asarray(np.asarray(jg.cell_volume) / 1e-3)
    vt = tg.cell_volume_like(torch.zeros((), dtype=torch.float64)) / 1e-3
    rng = np.random.RandomState(3)
    b = rng.randn(3, *jg.shape)
    x0 = 0.1 * rng.randn(3, *jg.shape)
    ref = jsolve.pcg_multi(lambda x: vj * x - lj.apply(x), jnp.asarray(b),
                           jnp.asarray(x0), vj - lj.diag, tol=1e-10,
                           max_iter=300)
    tsolve.reset_stats()
    got = tsolve.pcg_multi(lambda x: vt * x - lt.apply(x),
                           torch.as_tensor(b), torch.as_tensor(x0),
                           vt - lt.diag, tol=1e-10, max_iter=300)
    assert int(got.n_iterations) == int(ref.n_iterations) > 1
    assert tsolve.STATS["pcg_multi"] == [1, int(got.n_iterations)]
    assert rel_err(ref.x, got.x) <= SOLVE_TOL
    assert rel_err(ref.initial_residual, got.initial_residual) <= TOL
    assert float(got.final_residual.max()) <= 1e-10
    # each system is solved: the residual of each is small
    for i in range(3):
        r = torch.as_tensor(b[i]) - (vt * got.x[i] - lt.apply(got.x[i]))
        assert float(r.abs().max()) <= 1e-6 * float(np.abs(b[i]).max())


def test_smoothing_pcg_branch_matches_reference(monkeypatch):
    """USE_FASTDIAG off in both packages: the scalar smooth through pcg,
    the vector one through pcg_multi, on the graded grid with an
    anisotropic direction; the result also stays close to the FastDiag
    smoothing (the same implicit steps solved exactly)."""
    jg, tg = GRIDS[0][1], GRIDS[1][1]
    rng = np.random.RandomState(4)
    fields = (rng.rand(*jg.shape), rng.randn(3, *jg.shape))
    exact = [tsmooth.smooth(torch.as_tensor(f), tg, 0.3, 3,
                            (1.0, 0.5, 2.0)) for f in fields]
    monkeypatch.setattr(jsmooth, "USE_FASTDIAG", False)
    monkeypatch.setattr(tsmooth, "USE_FASTDIAG", False)
    tsolve.reset_stats()
    for f, ex in zip(fields, exact):
        a = jsmooth.smooth(jnp.asarray(f), jg, 0.3, 3, (1.0, 0.5, 2.0))
        b = tsmooth.smooth(torch.as_tensor(f), tg, 0.3, 3, (1.0, 0.5, 2.0))
        assert rel_err(a, b) <= SOLVE_TOL
        assert rel_err(ex, b) <= 1e-6
    assert tsolve.STATS["pcg"][0] == 3 and tsolve.STATS["pcg_multi"][0] == 3
