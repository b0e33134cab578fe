"""sedifoam_tpu_torch turbulence models and BiCGStab against
sedifoam_tpu, f64 on the CPU.

A graded grid with a no-slip wall (y-), an inlet (x-), an inletOutlet
outlet (x+), a zeroGradient top and cyclic z patches, a random velocity
field with its flux and random positive k, epsilon and nut. For each
model (Smagorinsky, mySmagorinsky, kEqn, kEpsilon with and without wall
functions): nu_eff, two correct() calls and reynolds_stress. Tolerance:
1e-12 of each field's scale for the closed-form models; 1e-10 through the
BiCGStab solves of kEqn and kEpsilon (measured: 2e-15 at worst; both
packages take the same iteration counts here). BiCGStab alone: a
nonsymmetric upwind convection-diffusion operator, the same iteration
count and 1e-10 of scale.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu import bc as jbc  # noqa: E402
from sedifoam_tpu import grid as jgrid  # noqa: E402
from sedifoam_tpu import linop as jlin  # noqa: E402
from sedifoam_tpu import linsolve as jsolve  # noqa: E402
from sedifoam_tpu import ops as jops  # noqa: E402
from sedifoam_tpu.config import FluidConfig as JFC  # noqa: E402
from sedifoam_tpu.config import TurbulenceConfig as JTC  # noqa: E402
from sedifoam_tpu.fluid import state as jstate  # noqa: E402
from sedifoam_tpu.fluid import turbulence as jturb  # noqa: E402
from sedifoam_tpu_torch import bc as tbc  # noqa: E402
from sedifoam_tpu_torch import grid as tgrid  # noqa: E402
from sedifoam_tpu_torch import linop as tlin  # noqa: E402
from sedifoam_tpu_torch import linsolve as tsolve  # noqa: E402
from sedifoam_tpu_torch.config import FluidConfig as TFC  # noqa: E402
from sedifoam_tpu_torch.config import TurbulenceConfig as TTC  # noqa: E402
from sedifoam_tpu_torch.fluid import state as tstate  # noqa: E402
from sedifoam_tpu_torch.fluid import turbulence as tturb  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import fluid_to_torch, rel_err  # noqa: E402

SHAPE = (7, 9, 5)


def _grids():
    rng = np.random.RandomState(40)
    faces = [np.concatenate([[0.0], np.cumsum(0.5 + rng.rand(n))]) * 1e-3
             for n in SHAPE]
    return jgrid.Grid.from_faces(*faces), tgrid.Grid.from_faces(*faces)


def _bcs(m, st):
    P = m.PatchBC
    zg1, zg3 = P(m.ZERO_GRADIENT), P(m.ZERO_GRADIENT, (0.0, 0.0, 0.0))
    cyc = P(m.CYCLIC)
    return st.FluidBCs(
        alpha=m.make_field_bc({"zm": cyc, "zp": cyc}, default=zg1),
        p=m.make_field_bc({"xp": P(m.FIXED_VALUE, (0.0,)), "zm": cyc,
                           "zp": cyc}, default=zg1),
        Ub=m.make_field_bc({"xm": P(m.FIXED_VALUE, (0.3, 0.05, 0.0)),
                            "xp": P(m.INLET_OUTLET, (0.0, 0.0, 0.0)),
                            "ym": P(m.FIXED_VALUE, (0.0, 0.0, 0.0)),
                            "zm": cyc, "zp": cyc}, default=zg3),
        Ua=m.make_field_bc({"zm": cyc, "zp": cyc}, default=zg3))


def _case(model, wall_functions=True):
    gj, gt = _grids()
    bj, bt = _bcs(jbc, jstate), _bcs(tbc, tstate)
    rng = np.random.RandomState(41)
    fj = JFC(dt=1e-3, turbulence=JTC(model=model,
                                     wall_functions=wall_functions))
    ft = TFC(dt=1e-3, turbulence=TTC(model=model,
                                     wall_functions=wall_functions))
    Ub = 0.3 * rng.rand(3, *SHAPE) + 0.1 * rng.randn(3, *SHAPE)
    fs = jstate.init_fluid(gj, dtype=jnp.float64)._replace(
        alpha=jnp.asarray(0.3 * rng.rand(*SHAPE)),
        Ub=jnp.asarray(Ub),
        k=jnp.asarray(1e-3 * (0.5 + rng.rand(*SHAPE))),
        epsilon=jnp.asarray(1e-2 * (0.5 + rng.rand(*SHAPE))),
        nut=jnp.asarray(1e-5 * rng.rand(*SHAPE)))
    fs = fs._replace(phib=jops.flux_of(fs.Ub, gj, bj.Ub))
    return (gj, bj, fj, fs), (gt, bt, ft, fluid_to_torch(fs))


MODELS = [("Smagorinsky", True, 1e-12), ("mySmagorinsky", True, 1e-12),
          ("kEqn", True, 1e-10), ("kEpsilon", True, 1e-10),
          ("kEpsilon", False, 1e-10)]


@pytest.mark.parametrize("model,wall_functions,tol", MODELS)
def test_turbulence_model_matches_reference(model, wall_functions, tol):
    (gj, bj, fj, sj), (gt, bt, ft, st) = _case(model, wall_functions)
    for _ in range(2):
        sj = jturb.correct(sj, gj, bj, fj)
        st = tturb.correct(st, gt, bt, ft)
    for name in ("k", "epsilon", "nut"):
        assert rel_err(getattr(sj, name), getattr(st, name)) <= tol, name
    assert rel_err(jturb.nu_eff(sj, gj, fj), tturb.nu_eff(st, gt, ft)) <= tol
    assert rel_err(jturb.reynolds_stress(sj, gj, bj, fj),
                   tturb.reynolds_stress(st, gt, bt, ft)) <= tol
    assert bool(torch.all(st.nut >= 0)) and bool(torch.any(st.nut > 0))


def test_wall_layers_and_laminar():
    (gj, bj, fj, sj), (gt, bt, ft, st) = _case("kEpsilon")
    mj, yj = jturb._wall_layers(gj, bj)
    mt, yt = tturb._wall_layers(gt, bt)
    np.testing.assert_array_equal(mj, mt)
    np.testing.assert_array_equal(yj, yt)
    # the no-slip y- wall only: the inlet is fixedValue but not no-slip
    assert mt[:, 0].all() and mt.sum() == SHAPE[0] * SHAPE[2]
    w1 = tturb._wall_tensors(gt, bt, torch.float64, torch.device("cpu"))
    w2 = tturb._wall_tensors(gt, bt, torch.float64, torch.device("cpu"))
    assert w1 is w2                         # built once per (grid, BCs)
    lam_j = dataclasses.replace(fj, turbulence=JTC(model="laminar"))
    lam_t = dataclasses.replace(ft, turbulence=TTC(model="laminar"))
    assert rel_err(jturb.nu_eff(sj, gj, lam_j),
                   tturb.nu_eff(st, gt, lam_t)) == 0.0
    assert tturb.correct(st, gt, bt, lam_t) is st


def test_bicgstab_nonsymmetric_upwind():
    gj, gt = _grids()
    rng = np.random.RandomState(42)
    kj = jbc.make_field_bc({"xm": jbc.PatchBC(jbc.FIXED_VALUE, (0.2,))})
    kt = tbc.make_field_bc({"xm": tbc.PatchBC(tbc.FIXED_VALUE, (0.2,))})
    phi = [rng.randn(*s) * 1e-6 for s in ((8, 9, 5), (7, 10, 5), (7, 9, 6))]
    gam = [1e-7 * (0.5 + rng.rand(*p.shape)) for p in phi]
    up = [(p >= 0).astype(float) for p in phi]
    x_old = rng.rand(*SHAPE)

    def term(lin, grid, fbc, ff, arr):
        F = [ff(*(arr(a) for a in f)) for f in (phi, gam, up)]
        return (lin.ddt(arr(x_old), 1e-3, grid)
                + lin.div(F[0], arr(x_old), grid, fbc, F[2])
                - lin.laplacian(F[1], grid, fbc))

    tj = term(jlin, gj, kj, jgrid.FaceField, jnp.asarray)
    tt = term(tlin, gt, kt, tgrid.FaceField, torch.as_tensor)
    x0 = 0.1 * rng.rand(*SHAPE)
    # the operator is nonsymmetric
    e = np.zeros(SHAPE)
    e[3, 4, 2] = 1.0
    col = tt.apply(torch.as_tensor(e)).numpy()
    assert not np.allclose(col[4, 4, 2], tt.apply(torch.as_tensor(
        np.roll(e, 1, axis=0))).numpy()[3, 4, 2])
    tsolve.reset_stats()
    iters = 0
    for tol in (1e-6, 1e-10):
        rj = jsolve.bicgstab(tj.apply, tj.rhs, jnp.asarray(x0), tj.diag,
                             tol=tol, max_iter=200)
        rt = tsolve.bicgstab(tt.apply, tt.rhs, torch.as_tensor(x0), tt.diag,
                             tol=tol, max_iter=200)
        assert int(rj.n_iterations) == int(rt.n_iterations) > 1
        assert rel_err(rj.x, rt.x) <= 1e-10
        assert float(rt.final_residual) <= tol
        iters += int(rt.n_iterations)
    assert tsolve.STATS["bicgstab"] == [2, iters]
