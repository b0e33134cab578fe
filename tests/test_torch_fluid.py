"""sedifoam_tpu_torch fluid modules against sedifoam_tpu, f64 on the CPU.

ops stencils, linop terms, pcg, FastDiag, assemble_ub_eqn + piso and
fluid_step (with Ubar forcing, DDtU, the Cvm block and the IBM term), on
a uniform and a graded grid with a mix of patch kinds (fixedValue incl.
a time table, zeroGradient, inletOutlet, cyclic, slip, empty). Inputs
come from a seeded numpy generator. Tolerance: 1e-10 relative to each
field's scale (measured: the stencils and linop terms agree bitwise;
7e-16 for FastDiag; 3e-14 at worst through the PCG, PISO and
fluid_step). Ubar's compensated means alone: 1e-12 in f64 and 1e-5 in
f32 (the block partials are summed in another order).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from sedifoam_tpu import bc as jbc  # noqa: E402
from sedifoam_tpu import fastsolve as jfs  # noqa: E402
from sedifoam_tpu import grid as jgrid  # noqa: E402
from sedifoam_tpu import linop as jlin  # noqa: E402
from sedifoam_tpu import linsolve as jsolve  # noqa: E402
from sedifoam_tpu import ops as jops  # noqa: E402
from sedifoam_tpu.fluid import piso as jpiso  # noqa: E402
from sedifoam_tpu.fluid import pprecond as jpp  # noqa: E402
from sedifoam_tpu.fluid import step as jstep  # noqa: E402
from sedifoam_tpu_torch import bc as tbc  # noqa: E402
from sedifoam_tpu_torch import bench_case  # noqa: E402
from sedifoam_tpu_torch import fastsolve as tfs  # noqa: E402
from sedifoam_tpu_torch import grid as tgrid  # noqa: E402
from sedifoam_tpu_torch import linop as tlin  # noqa: E402
from sedifoam_tpu_torch import linsolve as tsolve  # noqa: E402
from sedifoam_tpu_torch import ops as tops  # noqa: E402
from sedifoam_tpu_torch.fluid import piso as tpiso  # noqa: E402
from sedifoam_tpu_torch.fluid import pprecond as tpp  # noqa: E402
from sedifoam_tpu_torch.fluid import step as tstep  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import fluid_to_torch, rel_err  # noqa: E402

TOL = 1e-10
SHAPE = (6, 8, 5)


def _grids(graded):
    if graded:
        rng = np.random.RandomState(11)
        faces = [np.concatenate([[0.0], np.cumsum(0.5 + rng.rand(n))]) * 1e-3
                 for n in SHAPE]
        return (jgrid.Grid.from_faces(*faces),
                tgrid.Grid.from_faces(*faces))
    return tuple(m.Grid(*SHAPE, dx=1e-3, dy=2e-3, dz=1.5e-3)
                 for m in (jgrid, tgrid))


def _bcs(m):
    """(scalar FieldBC, vector FieldBC) with every patch kind, a region
    patch (fixedValue inside a disc, zeroGradient/slip outside) among
    them."""
    P = m.PatchBC
    table = m.TimeTable((0.0, 1.0), ((0.2,), (0.6,)))
    disc = m.DiscRegion(axis=0, c0=4e-3, c1=2.5e-3, radius=2.5e-3)
    s = m.make_field_bc({"xm": m.RegionPatchBC(P(m.FIXED_VALUE, (0.3,)),
                                               P(m.ZERO_GRADIENT), disc),
                         "xp": P(m.INLET_OUTLET, (0.1,)),
                         "ym": P(m.CYCLIC), "yp": P(m.CYCLIC),
                         "zm": P(m.EMPTY), "zp": P(m.FIXED_VALUE, table)})
    v = m.make_field_bc({"xm": m.RegionPatchBC(
                             P(m.FIXED_VALUE, (0.1, 0.2, 0.0)),
                             P(m.SLIP), disc),
                         "xp": P(m.INLET_OUTLET, (0.0, 0.0, 0.0)),
                         "ym": P(m.SLIP), "yp": P(m.SLIP),
                         "zm": P(m.ZERO_GRADIENT), "zp": P(m.CYCLIC)})
    return s, v


def _pair(a):
    """The same numpy array as a JAX array and a torch tensor."""
    return jnp.asarray(a), torch.as_tensor(a)


def _faces(rng, m, shape):
    nx, ny, nz = shape
    return m.FaceField(*(np.asarray(a) for a in (
        rng.randn(nx + 1, ny, nz), rng.randn(nx, ny + 1, nz),
        rng.randn(nx, ny, nz + 1))))


def _ff_pair(rng, shape):
    f = [rng.randn(shape[0] + 1, *shape[1:]),
         rng.randn(shape[0], shape[1] + 1, shape[2]),
         rng.randn(*shape[:2], shape[2] + 1)]
    return (jgrid.FaceField(*(jnp.asarray(a) for a in f)),
            tgrid.FaceField(*(torch.as_tensor(a) for a in f)))


def _close(ref, got, tol=TOL):
    if isinstance(ref, tuple):
        for a, b in zip(ref, got):
            _close(a, b, tol)
        return
    assert rel_err(ref, got) <= tol


@pytest.mark.parametrize("graded", [False, True])
def test_ops_stencils(graded):
    gj, gt = _grids(graded)
    sj, vj = _bcs(jbc)
    st, vt = _bcs(tbc)
    rng = np.random.RandomState(12)
    cj, ct = _pair(rng.randn(*SHAPE))
    uj, ut = _pair(rng.randn(3, *SHAPE))
    phij, phit = _ff_pair(rng, SHAPE)
    tj, tt = _pair(np.asarray(0.3))
    for fj, ft in ((jops.face_interp, tops.face_interp),
                   (jops.sn_grad, tops.sn_grad),
                   (jops.grad, tops.grad)):
        _close(fj(cj, gj, sj, phij, tj), ft(ct, gt, st, phit, tt))
        _close(fj(cj, gj, sj, None, tj), ft(ct, gt, st, None, tt))
    _close(jops.grad_vec(uj, gj, vj, phij), tops.grad_vec(ut, gt, vt, phit))
    _close(jops.curl(uj, gj, vj), tops.curl(ut, gt, vt))
    _close(jops.div_flux(phij, gj), tops.div_flux(phit, gt))
    _close(jops.flux_of(uj, gj, vj, phij), tops.flux_of(ut, gt, vt, phit))
    _close(jops.average_to_cells(phij, gj, sj),
           tops.average_to_cells(phit, gt, st))
    _close(jops.limited_weights_vec(uj, gj, vj, phij),
           tops.limited_weights_vec(ut, gt, vt, phit))


@pytest.mark.parametrize("graded", [False, True])
def test_linop_terms(graded):
    gj, gt = _grids(graded)
    sj, vj = _bcs(jbc)
    st, vt = _bcs(tbc)
    rng = np.random.RandomState(13)
    xj, xt = _pair(rng.randn(*SHAPE))
    oj, ot = _pair(rng.randn(*SHAPE))
    kj, kt = _pair(0.5 + rng.rand(*SHAPE))
    phij, phit = _ff_pair(rng, SHAPE)
    gam = [np.abs(a) + 0.1 for a in (phij.x, phij.y, phij.z)]
    gamj = jgrid.FaceField(*(jnp.asarray(a) for a in gam))
    gamt = tgrid.FaceField(*(torch.as_tensor(np.asarray(a)) for a in gam))
    # limitedLinearV weights of a random vector field, as piso makes them
    wj = jops.limited_weights_vec(jnp.stack([xj, oj, kj]), gj, vj, phij)
    wt = tops.limited_weights_vec(torch.stack([xt, ot, kt]), gt, vt, phit)
    termj = (jlin.ddt(oj, 1e-3, gj, coeff=kj)
             + jlin.div(phij, xj, gj, sj, wj, t=0.5)
             - jlin.laplacian(gamj, gj, sj, phi=phij, t=0.5)
             + kj * jlin.Sp(kj, gj) - jlin.source(oj, gj)).relax(xj, 0.7)
    termt = (tlin.ddt(ot, 1e-3, gt, coeff=kt)
             + tlin.div(phit, xt, gt, st, wt, t=0.5)
             - tlin.laplacian(gamt, gt, st, phi=phit, t=0.5)
             + kt * tlin.Sp(kt, gt) - tlin.source(ot, gt)).relax(xt, 0.7)
    _close(termj.diag, termt.diag)
    _close(termj.rhs, termt.rhs)
    _close(termj.apply(xj), termt.apply(xt))
    _close(termj.H(xj, gj), termt.H(xt, gt))
    _close(termj.A(gj), termt.A(gt))


def test_pcg():
    gj, gt = _grids(True)
    rng = np.random.RandomState(14)
    pj = jbc.make_field_bc({"yp": jbc.PatchBC(jbc.FIXED_VALUE, (0.0,))})
    pt = tbc.make_field_bc({"yp": tbc.PatchBC(tbc.FIXED_VALUE, (0.0,))})
    gam = [0.5 + rng.rand(*s) for s in ((7, 8, 5), (6, 9, 5), (6, 8, 6))]
    termj = jlin.laplacian(jgrid.FaceField(*map(jnp.asarray, gam)), gj, pj)
    termt = tlin.laplacian(tgrid.FaceField(*map(torch.as_tensor, gam)),
                           gt, pt)
    bj, bt = _pair(rng.randn(*SHAPE))
    x0j, x0t = _pair(0.1 * rng.randn(*SHAPE))
    # Jacobi (stops on stagnation here) and the FastDiag preconditioner
    # piso uses (converges)
    prj = jpp.make_preconditioner(gj, pj, False, 0, jnp.float64)
    prt = tpp.make_preconditioner(gt, pt, False, 0, torch.float64)
    for tol, pcj, pct in ((1e-6, None, None),
                          (1e-6, lambda r: prj(r, 1.0),
                           lambda r: prt(r, 1.0)),
                          (1e-12, lambda r: prj(r, 1.0),
                           lambda r: prt(r, 1.0))):
        rj = jsolve.pcg(termj.apply, bj, x0j, termj.diag, tol=tol,
                        max_iter=500, precond=pcj)
        rt = tsolve.pcg(termt.apply, bt, x0t, termt.diag, tol=tol,
                        max_iter=500, precond=pct)
        assert int(rj.n_iterations) == int(rt.n_iterations) > 3
        _close(rj.x, rt.x)
        _close(rj.initial_residual, rt.initial_residual)
        _close(rj.final_residual, rt.final_residual, 1e-6)
        if pcj is not None:
            assert float(rt.final_residual) <= tol


@pytest.mark.parametrize("graded", [False, True])
def test_fastdiag_solve(graded):
    gj, gt = _grids(graded)
    kinds = ((jfs.DIRICHLET, jfs.NEUMANN), (jfs.PERIODIC, jfs.PERIODIC),
             (jfs.NEUMANN, jfs.NEUMANN))
    fj = jfs.FastDiag(gj, (1.0, 0.5, 2.0), kinds, jnp.float64)
    ft = tfs.FastDiag(gt, (1.0, 0.5, 2.0), kinds, torch.float64)
    rng = np.random.RandomState(15)
    bj, bt = _pair(rng.randn(4, *SHAPE))
    _close(fj.solve(bj, 3e5), ft.solve(bt, 3e5))
    _close(fj.solve(bj, 0.0, project_null=True),
           ft.solve(bt, 0.0, project_null=True))
    _close(fj.solve_pow(bj[0], 3e5, 4), ft.solve_pow(bt[0], 3e5, 4))
    nj = jfs.smoothing_solver(gj, (1.0, 1.0, 1.0), jnp.float64)
    nt = tfs.smoothing_solver(gt, (1.0, 1.0, 1.0), torch.float64)
    _close(nj.solve(bj, 0.0, project_null=True),
           nt.solve(bt, 0.0, project_null=True))


def _fluid_case(seed=16):
    """bench-case BCs on the small grid, random two-phase fluid state."""
    kw = dict(n_particles=256, nx=8, ny=16, nz=8)
    cfg_j, _ = bench.build_case(backend="binned", **kw)
    cfg_t = bench_case.build_config(**kw)
    g = cfg_j.grid
    rng = np.random.RandomState(seed)
    from sedifoam_tpu.fluid.state import init_fluid
    fs = init_fluid(g, dtype=jnp.float64)
    shp = g.shape
    alpha = 0.4 * rng.rand(*shp)
    Ub = np.zeros((3,) + shp)
    Ub[1] = 0.1
    Ub = Ub + 0.02 * rng.randn(3, *shp)
    fs = fs._replace(alpha=jnp.asarray(alpha),
                     alpha_old=jnp.asarray(alpha + 0.01 * rng.rand(*shp)),
                     Ub=jnp.asarray(Ub), Ub_old=jnp.asarray(Ub),
                     Ua=jnp.asarray(0.01 * rng.randn(3, *shp)),
                     Asrc=jnp.asarray(10.0 * rng.randn(3, *shp)),
                     p=jnp.asarray(rng.randn(*shp)),
                     time=jnp.asarray(0.01))
    phib = jops.flux_of(fs.Ub, g, cfg_j.bcs.Ub)
    fs = fs._replace(phib=phib, phib_old=phib)
    return cfg_j, cfg_t, fs


def test_assemble_ub_eqn_and_piso():
    cfg_j, cfg_t, fs_j = _fluid_case()
    fs_t = fluid_to_torch(fs_j)
    nu_j = jnp.full(cfg_j.grid.shape, cfg_j.fluid.nub)
    nu_t = torch.full(cfg_t.grid.shape, cfg_t.fluid.nub, dtype=torch.float64)
    ej = jpiso.assemble_ub_eqn(fs_j, cfg_j.grid, cfg_j.bcs, cfg_j.fluid, nu_j)
    et = tpiso.assemble_ub_eqn(fs_t, cfg_t.grid, cfg_t.bcs, cfg_t.fluid, nu_t)
    _close(ej.A(cfg_j.grid), et.A(cfg_t.grid))
    _close(ej.H(fs_j.Ub, cfg_j.grid), et.H(fs_t.Ub, cfg_t.grid))
    oj = jax.jit(lambda fs: jpiso.piso(
        fs, jpiso.assemble_ub_eqn(fs, cfg_j.grid, cfg_j.bcs, cfg_j.fluid,
                                  nu_j),
        cfg_j.grid, cfg_j.bcs, cfg_j.fluid))(fs_j)
    ot = tpiso.piso(fs_t, et, cfg_t.grid, cfg_t.bcs, cfg_t.fluid)
    for name in ("p", "Ub", "phia", "phib", "phi"):
        _close(getattr(oj, name), getattr(ot, name))


@pytest.mark.parametrize("forcing", [
    dict(mode="none"),
    dict(mode="varyingGradP", grad_pbar=2.0, period=0.05,
         varying_type="square"),
    dict(mode="Ubar", mag_ubar=0.3)])
def test_fluid_step(forcing):
    cfg_j, cfg_t, fs_j = _fluid_case(seed=17)
    from sedifoam_tpu.config import ChannelForcing as JCF
    from sedifoam_tpu_torch.config import ChannelForcing as TCF
    fj = dataclasses.replace(cfg_j.fluid, forcing=JCF(**forcing))
    ft = dataclasses.replace(cfg_t.fluid, forcing=TCF(**forcing))
    fs_t = fluid_to_torch(fs_j)
    for _ in range(2):
        fs_j = jstep.fluid_step(fs_j, cfg_j.grid, cfg_j.bcs, fj,
                                need_ddtu=False)
        fs_t = tstep.fluid_step(fs_t, cfg_t.grid, cfg_t.bcs, ft,
                                need_ddtu=False)
    for name in ("p", "Ub", "phia", "phib", "phi", "Ub_old", "grad_p_value",
                 "time"):
        _close(getattr(fs_j, name), getattr(fs_t, name))
    assert int(fs_j.step) == int(fs_t.step) == 2


@pytest.mark.parametrize("forcing", [
    dict(mode="gradPbar", grad_pbar=2.0, dpdt=1.0),
    dict(mode="varyingGradP", grad_pbar=2.0, period=0.05),
    dict(mode="varyingGradP", grad_pbar=2.0, period=0.05,
         varying_type="square")])
def test_adjust_channel_forcing(forcing):
    cfg_j, cfg_t, fs_j = _fluid_case(seed=18)
    from sedifoam_tpu.config import ChannelForcing as JCF
    from sedifoam_tpu_torch.config import ChannelForcing as TCF
    fj = dataclasses.replace(cfg_j.fluid, forcing=JCF(**forcing))
    ft = dataclasses.replace(cfg_t.fluid, forcing=TCF(**forcing))
    fs_t = fluid_to_torch(fs_j)
    for t in (0.01, 0.03, 0.07):
        a = jpiso.adjust_channel_forcing(
            fs_j._replace(time=jnp.asarray(t)), None, cfg_j.grid, fj)
        b = tpiso.adjust_channel_forcing(
            fs_t._replace(time=torch.tensor(t, dtype=torch.float64)), None,
            cfg_t.grid, ft)
        _close(a.grad_p_value, b.grad_p_value)


@pytest.mark.parametrize("dtype,tol", [("float64", 1e-12),
                                       ("float32", 1e-5)])
@pytest.mark.parametrize("policy", ["compensated", "native"])
def test_ubar_forcing(dtype, tol, policy):
    """adjust_channel_forcing(mode='Ubar') alone on 3,840 cells (more
    than one accumulation block): Ub and grad_p_value."""
    shape = (16, 20, 12)
    gj, gt = jgrid.Grid(*shape, dx=1e-3, dy=2e-3, dz=1.5e-3), \
        tgrid.Grid(*shape, dx=1e-3, dy=2e-3, dz=1.5e-3)
    rng = np.random.RandomState(30)
    from sedifoam_tpu.config import ChannelForcing as JCF, FluidConfig as JFC
    from sedifoam_tpu.fluid.state import init_fluid
    from sedifoam_tpu_torch.config import (ChannelForcing as TCF,
                                           FluidConfig as TFC)
    forcing = dict(mode="Ubar", mag_ubar=0.3,
                   flow_direction=(0.8, 0.0, 0.6))
    fj = JFC(dt=1e-4, forcing=JCF(**forcing), dtype_policy=policy)
    ft = TFC(dt=1e-4, forcing=TCF(**forcing), dtype_policy=policy)
    fs = init_fluid(gj, dtype=jnp.float64)._replace(
        alpha=jnp.asarray(0.4 * rng.rand(*shape)),
        Ub=jnp.asarray(0.1 + 0.05 * rng.randn(3, *shape)),
        Ua=jnp.asarray(0.02 * rng.randn(3, *shape)),
        grad_p_value=jnp.asarray(1.5))
    from torch_port_cases import f64
    fs = jax.tree_util.tree_map(
        lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating)
        else x, f64(fs))
    rua = (1e-3 * (1.0 + rng.rand(*shape))).astype(dtype)
    a = jpiso.adjust_channel_forcing(fs, jnp.asarray(rua), gj, fj)
    b = tpiso.adjust_channel_forcing(fluid_to_torch(fs), torch.as_tensor(rua),
                                     gt, ft)
    assert b.Ub.dtype == getattr(torch, dtype)
    _close(a.Ub, b.Ub, tol)
    _close(a.grad_p_value, b.grad_p_value, tol)
    assert float(b.grad_p_value) != 1.5


@pytest.mark.parametrize("extra", [
    dict(),
    dict(Cvm=0.5),
    dict(add_ibm_force=True),
    dict(add_ibm_force=True, ibm_relax_time=2e-3)])
def test_fluid_step_ddtu_cvm_ibm(extra):
    """fluid_step with DDtU on, and the Cvm block (fed by a random
    DDtUa) or the IBM relaxation (a random indicator field)."""
    cfg_j, cfg_t, fs_j = _fluid_case(seed=31)
    rng = np.random.RandomState(32)
    shp = cfg_j.grid.shape
    fs_j = fs_j._replace(DDtUa=jnp.asarray(rng.randn(3, *shp)),
                         ibm_indicator=jnp.asarray(
                             (rng.rand(*shp) > 0.7) * rng.rand(*shp)))
    fj = dataclasses.replace(cfg_j.fluid, **extra)
    ft = dataclasses.replace(cfg_t.fluid, **extra)
    fs_t = fluid_to_torch(fs_j)
    for _ in range(2):
        fs_j = jstep.fluid_step(fs_j, cfg_j.grid, cfg_j.bcs, fj,
                                need_ddtu=True)
        fs_t = tstep.fluid_step(fs_t, cfg_t.grid, cfg_t.bcs, ft,
                                need_ddtu=True)
    for name in ("p", "Ub", "phia", "phib", "phi", "DDtUa", "DDtUb"):
        _close(getattr(fs_j, name), getattr(fs_t, name))
    assert bool(torch.any(fs_t.DDtUb != 0))


def test_ddtu_alone():
    cfg_j, cfg_t, fs_j = _fluid_case(seed=33)
    rng = np.random.RandomState(34)
    shp = cfg_j.grid.shape
    fs_j = fs_j._replace(Ub_old=fs_j.Ub + 0.01 * jnp.asarray(
        rng.randn(3, *shp)), Ua_old=jnp.asarray(0.01 * rng.randn(3, *shp)),
        phia=jops.flux_of(fs_j.Ua, cfg_j.grid, cfg_j.bcs.Ua))
    a = jpiso.ddtu(fs_j, cfg_j.grid, cfg_j.bcs, cfg_j.fluid)
    b = tpiso.ddtu(fluid_to_torch(fs_j), cfg_t.grid, cfg_t.bcs, cfg_t.fluid)
    _close(a.DDtUa, b.DDtUa)
    _close(a.DDtUb, b.DDtUb)


@pytest.mark.parametrize("graded", [False, True])
def test_grid_locate_and_fields(graded):
    gj, gt = _grids(graded)
    rng = np.random.RandomState(19)
    lo, hi = np.asarray([gj.x0, gj.y0, gj.z0]), np.asarray(gj.hi)
    pos = lo + (hi - lo) * rng.uniform(-0.1, 1.1, size=(300, 3))
    a = gj.locate(jnp.asarray(pos))
    b = gt.locate(torch.as_tensor(pos))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    np.testing.assert_array_equal(np.asarray(gj.flat_index(a)),
                                  gt.flat_index(b).numpy())
    _close(gj.cell_centers(), gt.cell_centers())
    assert tuple(gt.zeros_faces().y.shape) == tuple(gj.zeros_faces().y.shape)
    assert gt.zeros_vec(torch.float32).dtype == torch.float32


def test_graded_constants_are_copied_once():
    """A graded grid's numpy geometry goes to the device once: a second
    round of stencil calls makes no torch.as_tensor call on numpy input
    (on a CUDA device each was a synchronizing host-to-device copy),
    gives the same bits, leaves the cached tensors as they were, and the
    cache dies with its Grid."""
    import gc
    import weakref

    _, g = _grids(True)
    s, v = _bcs(tbc)
    rng = np.random.RandomState(3)
    c = torch.as_tensor(rng.randn(*SHAPE))
    u = torch.as_tensor(rng.randn(3, *SHAPE))
    _, phi = _ff_pair(rng, SHAPE)
    pos = torch.as_tensor(rng.rand(7, 3) * 4e-3)
    # the solver is built once per run (CoupledStep holds it)
    solver = tfs.pressure_preconditioner(g, s, torch.float64, "cpu")

    def round_of_calls():
        lap = tlin.laplacian(tops.face_interp(c * c + 1.0, g, s), g, s,
                             phi=phi)
        pre = tpp.make_preconditioner(g, s, False, 0, torch.float64, "cpu",
                                      solver=solver)
        return (tops.face_interp(c, g, s, phi), tops.sn_grad(c, g, s, phi),
                tops.grad(c, g, s), tops.div_flux(phi, g),
                tops.flux_of(u, g, v, phi), lap.apply(c), lap.diag,
                tlin.ddt(c, 1e-3, g).rhs, tlin.Sp(c, g).diag,
                tlin.source(c, g).rhs, tpiso.reconstruct(phi, g),
                tpiso.div_tensor(torch.stack([u, u, u]), g),
                tpiso.gravity_flux(g, (0.0, -9.81, 0.0)),
                g.locate(pos), pre(c, 1.0))

    copies = []
    real = torch.as_tensor

    def counting(data, *a, **kw):
        if isinstance(data, np.ndarray):
            copies.append(data.shape)
        return real(data, *a, **kw)

    torch.as_tensor = counting
    try:
        first = round_of_calls()
        n_first = len(copies)
        kept = {k: t.clone() for k, t in g._memo.items()
                if isinstance(t, torch.Tensor)}
        second = round_of_calls()
    finally:
        torch.as_tensor = real
    assert n_first > 0 and len(kept) == n_first
    assert len(copies) == n_first, copies[n_first:]
    for a, b in zip(first, second):
        for x, y in zip(a, b) if isinstance(a, tuple) else ((a, b),):
            assert torch.equal(x, y)
    for k, t in kept.items():
        assert torch.equal(g._memo[k], t), k
    # another dtype is another entry; the cache is no field of the Grid
    tops.div_flux(tgrid.FaceField(*(f.float() for f in phi)), g)
    assert len(g._memo) > len(kept) + 3
    _, g2 = _grids(True)
    assert g2 == g and hash(g2) == hash(g) and "_memo" not in g2.__dict__
    ref = weakref.ref(g._memo[next(iter(kept))])
    del g, first, second, kept, a, b, x, y, t
    gc.collect()
    assert ref() is None
