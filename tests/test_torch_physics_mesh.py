"""The reference's graded-mesh and region-BC gates on sedifoam_tpu_torch
alone: tests/test_graded.py:82-199 (FastDiag on a graded mesh against
the operator, the smoothing's conservation and positivity, the Gauss
divergence, the graded Poiseuille channel (`slow` as in the reference),
the k-step collapse = k sequential solves) and tests/test_region_bc.py
(all seven, the one-sided region spec through the port's case reader
among them), case for case: the same set-ups, step counts, assertions
and tolerances, in f64, on the CPU and (marked `cuda`) on the card.
The blockMeshDict parsing of tests/test_graded.py:33-80 is the case
loader's, held against the JAX package in tests/test_torch_case_io.py.

Where the reference wraps a step in jax.jit, the port calls its own
eager function (fluid_step with the pressure preconditioner built once,
as the port's coupled step does); on the card the long runs replay
captured blocks of steps (torch_port_util.Stepper).

Runs on the port alone: nothing here imports JAX or the JAX package, so the
file runs on the card under `python -m pytest --noconftest`.
"""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sedifoam_tpu_torch import bc  # noqa: E402
from sedifoam_tpu_torch import fastsolve, linop, ops  # noqa: E402
from sedifoam_tpu_torch.config import (ChannelForcing,  # noqa: E402
                                       FluidConfig, PISOConfig)
from sedifoam_tpu_torch.fluid.state import FluidBCs, init_fluid  # noqa: E402
from sedifoam_tpu_torch.grid import FaceField, Grid  # noqa: E402
from torch_port_util import (DEVICES, few_threads,  # noqa: E402,F401
                             fluid_stepper)

F64 = torch.float64


def _np(t):
    return t.detach().cpu().numpy()


def _t(a, device):
    return torch.as_tensor(np.asarray(a), dtype=F64, device=device)



# ---- tests/test_graded.py:82-199 --------------------------------------------

def _graded_grid():
    yf = np.concatenate([[0.0], np.cumsum(
        0.01 * 1.15 ** np.arange(12))])
    return Grid.from_faces(np.linspace(0, 0.06, 7), yf,
                           np.linspace(0, 0.03, 4))


@pytest.mark.parametrize("device", DEVICES)
def test_fastsolve_graded_matches_operator(device):
    """FastDiag on a graded grid inverts the volume-normalized operator."""
    grid = _graded_grid()
    kinds = ((fastsolve.NEUMANN, fastsolve.NEUMANN),
             (fastsolve.DIRICHLET, fastsolve.NEUMANN),
             (fastsolve.PERIODIC, fastsolve.PERIODIC))
    solver = fastsolve.FastDiag(grid, (1.0, 1.0, 1.0), kinds, F64, device)

    bcs = bc.FieldBC(
        xm=bc.PatchBC(bc.ZERO_GRADIENT), xp=bc.PatchBC(bc.ZERO_GRADIENT),
        ym=bc.PatchBC(bc.FIXED_VALUE, (0.0,)),
        yp=bc.PatchBC(bc.ZERO_GRADIENT),
        zm=bc.PatchBC(bc.CYCLIC), zp=bc.PatchBC(bc.CYCLIC))
    lap = linop.laplacian(1.0, grid, bcs, dtype=F64, device=device)

    rng = np.random.RandomState(0)
    b = _t(rng.randn(*grid.shape), device)
    c0 = 37.0
    x = solver.solve(b, c0)
    # residual of (c0*V*x - L x) vs V*b  (volume-integrated form)
    V = _t(grid.cell_volume, device)
    res = c0 * V * x - lap.apply(x) - V * b
    assert float(torch.max(torch.abs(res))) < \
        1e-8 * float(torch.max(torch.abs(b)))


@pytest.mark.parametrize("device", DEVICES)
def test_smoothing_conserves_and_positive_graded(device):
    from sedifoam_tpu_torch.coupling.smoothing import smooth
    grid = _graded_grid()
    rng = np.random.RandomState(1)
    f = _t(np.abs(rng.rand(*grid.shape)), device)
    f[3, 5, 1] = 50.0  # sharp spike
    out = smooth(f, grid, bandwidth=0.02, steps=3)
    V = _t(grid.cell_volume, device)
    # conservation of the volume integral + maximum principle
    np.testing.assert_allclose(float(torch.sum(out * V)),
                               float(torch.sum(f * V)), rtol=1e-10)
    assert float(out.min()) > -1e-12
    assert float(out.max()) < 50.0


@pytest.mark.parametrize("device", DEVICES)
def test_gauss_divergence_graded(device):
    """div of a linear field is exact on the graded grid interior."""
    grid = _graded_grid()
    X = grid.cell_centers(F64, device)
    zg = bc.zero_gradient()
    # U = (x, 2y, 3z) -> div = 6; use fixedValue-free interior check
    U = torch.stack([X[0], 2.0 * X[1], 3.0 * X[2]])
    phi = ops.flux_of(U, grid, bc.uniform_bc(bc.ZERO_GRADIENT,
                                             (0.0, 0.0, 0.0)))
    div = ops.div_flux(phi, grid)
    interior = _np(div)[1:-1, 1:-1, 1:-1]
    np.testing.assert_allclose(interior, 6.0, rtol=1e-9)
    # gradient of a linear scalar is exact in the interior too
    s = X[0] + 2.0 * X[1] + 3.0 * X[2]
    g = _np(ops.grad(s, grid, zg))
    for c, v in enumerate((1.0, 2.0, 3.0)):
        np.testing.assert_allclose(g[c][1:-1, 1:-1, 1:-1], v, rtol=1e-9)


@pytest.mark.slow
@pytest.mark.parametrize("device", DEVICES)
def test_poiseuille_on_graded_mesh(device):
    """Steady laminar channel driven by gradPbar on a y-graded mesh matches
    the analytic parabola (the chPressureGrad + graded-mesh pipeline of
    transport-bedload, without particles)."""
    H = 0.01      # channel height
    nu = 1e-4
    gp = 0.02     # pressure gradient / rho  [m/s^2]
    yf = H * (np.linspace(0.0, 1.0, 17)) ** 1.5  # graded toward y=0
    grid = Grid.from_faces(np.linspace(0, 0.02, 4), yf,
                           np.linspace(0, 0.005, 2))
    assert not grid.uniform

    zg3 = bc.PatchBC(bc.ZERO_GRADIENT, (0.0, 0.0, 0.0))
    noslip = bc.PatchBC(bc.FIXED_VALUE, (0.0, 0.0, 0.0))
    bcs = FluidBCs(
        alpha=bc.make_field_bc({}),
        p=bc.make_field_bc({
            "xm": bc.PatchBC(bc.CYCLIC), "xp": bc.PatchBC(bc.CYCLIC),
            "zm": bc.PatchBC(bc.EMPTY), "zp": bc.PatchBC(bc.EMPTY)}),
        Ub=bc.make_field_bc({
            "xm": bc.PatchBC(bc.CYCLIC), "xp": bc.PatchBC(bc.CYCLIC),
            "ym": noslip, "yp": noslip,
            "zm": bc.PatchBC(bc.EMPTY, (0.0, 0.0, 0.0)),
            "zp": bc.PatchBC(bc.EMPTY, (0.0, 0.0, 0.0))}, default=zg3),
        Ua=bc.make_field_bc({}, default=zg3))
    cfg = FluidConfig(
        dt=2e-3, rhob=1000.0, nub=nu, gravity=(0.0, 0.0, 0.0),
        piso=PISOConfig(n_correctors=2, p_tol=1e-9, p_max_iter=400),
        forcing=ChannelForcing(mode="gradPbar",
                               flow_direction=(1.0, 0.0, 0.0),
                               grad_pbar=gp))
    fs = init_fluid(grid, dtype=F64, device=device)
    fs = fs._replace(grad_p_value=torch.tensor(gp, dtype=F64, device=device))

    fs = fluid_stepper(grid, bcs, cfg, device).run(fs, 600)

    y = grid.axis_centers(1)
    u_exact = gp / (2.0 * nu) * y * (H - y)
    u = _np(fs.Ub[0][1, :, 0])
    err = np.abs(u - u_exact).max() / u_exact.max()
    assert err < 0.02, (err, u, u_exact)


@pytest.mark.parametrize("device", DEVICES)
def test_smoothing_pow_collapse_equals_sequential(device):
    """FastDiag.solve_pow (the k implicit-Euler steps collapsed into one
    transform pair) must agree with k sequential solves to roundoff —
    it is the same diagonal operator applied in the same eigenbasis."""
    grid = _graded_grid()
    rng = np.random.RandomState(7)
    f = _t(rng.rand(*grid.shape), device)
    solver = fastsolve.smoothing_solver(grid, (1.0, 0.5, 2.0), f.dtype,
                                        device)
    k, c0 = 6, 1.0 / ((0.02 ** 2 / 4.0) / 6)
    seq = f
    for _ in range(k):
        seq = solver.solve(c0 * seq, c0)
    pw = solver.solve_pow(f, c0, k)
    np.testing.assert_allclose(_np(pw), _np(seq),
                               rtol=1e-11, atol=1e-13)


# ---- tests/test_region_bc.py ------------------------------------------------

def _setup(device):
    grid = Grid(nx=6, ny=8, nz=6, dx=1.0 / 6, dy=1.0 / 8, dz=1.0 / 6)
    region = bc.DiscRegion(axis=1, c0=0.5, c1=0.5, radius=0.3)
    inside = bc.PatchBC(bc.FIXED_VALUE, (2.0,))
    outside = bc.PatchBC(bc.ZERO_GRADIENT, (0.0,))
    mixed = bc.RegionPatchBC(inside, outside, region)
    rng = np.random.default_rng(0)
    c = _t(rng.normal(size=grid.shape), device)
    return grid, region, inside, outside, mixed, c


def _fbc(patch):
    return bc.make_field_bc({"ym": patch})


def test_mask_geometry():
    """Coverage fractions: 1 deep inside, 0 far outside, fractional at the
    rim, and the summed covered area matches pi r^2 to the subsampling.
    The mask is a host array: one case, no device."""
    grid, region, *_ = _setup("cpu")
    m = np.asarray(region.mask(grid))[0]
    assert m.shape == (6, 6)
    assert m.max() == 1.0 and m.min() == 0.0
    assert ((m > 0) & (m < 1)).any()
    area = m.sum() * (1.0 / 6) * (1.0 / 6)
    np.testing.assert_allclose(area, np.pi * 0.3 ** 2, rtol=2e-2)


@pytest.mark.parametrize("device", DEVICES)
def test_face_ops_blend(device):
    grid, region, inside, outside, mixed, c = _setup(device)
    m = np.asarray(region.mask(grid))  # (1, nx, nz)
    for op in (ops.face_interp, ops.sn_grad):
        fi = op(c, grid, _fbc(inside))
        fo = op(c, grid, _fbc(outside))
        fm = op(c, grid, _fbc(mixed))
        # ym boundary faces blend; everything else identical to both
        np.testing.assert_allclose(
            _np(fm.y[:, 0]),
            m[0] * _np(fi.y[:, 0]) + (1 - m[0]) * _np(fo.y[:, 0]),
            atol=1e-13)
        np.testing.assert_allclose(_np(fm.y[:, 1:]), _np(fi.y[:, 1:]))
        for a in ("x", "z"):
            np.testing.assert_allclose(_np(getattr(fm, a)),
                                       _np(getattr(fi, a)))


@pytest.mark.parametrize("device", DEVICES)
def test_linop_blend(device):
    grid, region, inside, outside, mixed, c = _setup(device)
    m = torch.movedim(_t(region.mask(grid), device), 0, 1)  # (nx, 1, nz)
    mask_cells = torch.cat(
        [m, torch.zeros((grid.nx, grid.ny - 1, grid.nz), dtype=F64,
                        device=device)], dim=1)
    rng = np.random.default_rng(1)
    phi = FaceField(
        _t(rng.normal(size=(grid.nx + 1, grid.ny, grid.nz)), device),
        _t(rng.normal(size=(grid.nx, grid.ny + 1, grid.nz)), device),
        _t(rng.normal(size=(grid.nx, grid.ny, grid.nz + 1)), device))
    x = _t(rng.normal(size=grid.shape), device)

    def check(make):
        ti, to, tm = make(inside), make(outside), make(mixed)
        for attr in ("diag", "rhs"):
            vi, vo, vm = (getattr(t, attr) for t in (ti, to, tm))
            np.testing.assert_allclose(
                _np(vm), _np(mask_cells * vi + (1 - mask_cells) * vo),
                atol=1e-13)
        ai, ao, am = ti.apply(x), to.apply(x), tm.apply(x)
        np.testing.assert_allclose(
            _np(am), _np(mask_cells * ai + (1 - mask_cells) * ao),
            atol=1e-13)

    check(lambda p: linop.div(phi, c, grid, _fbc(p)))
    check(lambda p: linop.laplacian(0.7, grid, _fbc(p), dtype=x.dtype,
                                    device=device))


@pytest.mark.parametrize("device", DEVICES)
def test_degenerate_region_equals_uniform(device):
    grid, region, inside, _, _, c = _setup(device)
    same = bc.RegionPatchBC(inside, inside, region)
    fi = ops.face_interp(c, grid, _fbc(inside))
    fm = ops.face_interp(c, grid, _fbc(same))
    for a in range(3):
        np.testing.assert_allclose(_np(fm[a]), _np(fi[a]), atol=1e-14)


@pytest.mark.parametrize("device", DEVICES)
def test_slip_normal_component_blocks_flux(device):
    """SLIP is OpenFOAM's symmetry transform: zero wall-normal velocity,
    zeroGradient tangential — a slip-walled box admits no boundary flux."""
    grid = Grid(nx=4, ny=4, nz=4, dx=0.25, dy=0.25, dz=0.25)
    slip3 = bc.PatchBC(bc.SLIP, (0.0, 0.0, 0.0))
    vbc = bc.make_field_bc({}, default=slip3)
    rng = np.random.default_rng(2)
    U = _t(rng.normal(size=(3,) + grid.shape), device)
    phi = ops.flux_of(U, grid, vbc)
    for a, f in enumerate((phi.x, phi.y, phi.z)):
        fm = ops._mv(f, a)
        assert float(torch.abs(fm[0]).max()) == 0.0
        assert float(torch.abs(fm[-1]).max()) == 0.0
    # tangential components still extrapolate (zeroGradient)
    fy_of_ux = ops.face_interp(U[0], grid, vbc.component(0)).y
    np.testing.assert_allclose(_np(fy_of_ux[:, 0]), _np(U[0][:, 0]))


@pytest.mark.parametrize("device", DEVICES)
def test_disc_inlet_jet_conserves_mass(device):
    """A disc inlet in a slip bottom drives a jet through a duct: inflow
    flux equals the coverage-weighted disc area times vin (~pi r^2 vin),
    equals outflow."""
    n = 8
    grid = Grid(nx=n, ny=12, nz=n, dx=1.0 / n, dy=1.5 / 12, dz=1.0 / n)
    vin = 0.3
    region = bc.DiscRegion(axis=1, c0=0.5, c1=0.5, radius=0.27)
    inlet = bc.PatchBC(bc.FIXED_VALUE, (0.0, vin, 0.0))
    slip3 = bc.PatchBC(bc.SLIP, (0.0, 0.0, 0.0))
    mixed = bc.RegionPatchBC(inlet, slip3, region)
    outlet_u = bc.PatchBC(bc.INLET_OUTLET, (0.0, 0.0, 0.0))
    bcs = FluidBCs(
        alpha=bc.make_field_bc({}),
        p=bc.make_field_bc({"yp": bc.PatchBC(bc.FIXED_VALUE, (0.0,))}),
        Ub=bc.make_field_bc({"ym": mixed, "yp": outlet_u}, default=slip3),
        Ua=bc.make_field_bc({}, default=slip3),
    )
    cfg = FluidConfig(dt=5e-3, rhob=1000.0, nub=1e-4,
                      piso=PISOConfig(n_correctors=2, p_tol=1e-12))
    fs = init_fluid(grid, device=device)
    fs = fluid_stepper(grid, bcs, cfg, device).run(fs, 40)

    m = np.asarray(region.mask(grid))[0]
    q_exact = vin * m.sum() * grid.dx * grid.dz
    np.testing.assert_allclose(q_exact, vin * np.pi * 0.27 ** 2, rtol=2e-2)
    qin = float(torch.sum(fs.phib.y[:, 0]))
    qout = float(torch.sum(fs.phib.y[:, -1]))
    np.testing.assert_allclose(qin, q_exact, rtol=1e-10)
    np.testing.assert_allclose(qout, qin, rtol=1e-6)
    # the jet core above the disc moves; the pressure field stays finite
    u = _np(fs.Ub[1])
    assert u[n // 2, 6, n // 2] > 0.05 * vin
    assert np.isfinite(_np(fs.p)).all()
    # continuity
    assert float(torch.abs(ops.div_flux(fs.phib, grid)).max()) < 1e-8


def test_one_sided_region_spec_blends_against_default(tmp_path):
    """A mixed O-grid face whose 0/<field> file names only one of its two
    patches must blend that spec against zeroGradient over its own
    region (with a warning), NOT paint it across the whole face
    (io/case.py _read_field_bc). The reader makes no tensor: one case,
    no device."""
    from sedifoam_tpu_torch.io.case import _read_field_bc

    f = tmp_path / "Ubad"
    f.write_text("""
FoamFile { version 2.0; format ascii; class volVectorField; object Ub; }
dimensions [0 1 -1 0 0 0 0];
internalField uniform (0 0 0);
boundaryField
{
    inlet { type fixedValue; value uniform (0 1.72 0); }
    top   { type zeroGradient; }
}
""")
    region = bc.DiscRegion(axis=1, c0=0.0, c1=0.0, radius=0.0025)
    regions = {2: ("inlet", "bottom", region)}   # `bottom` spec missing
    patch_faces = {"inlet": [2], "bottom": [2], "top": [3]}
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        fbc, _ = _read_field_bc(str(f), patch_faces, 3, regions)
    assert any("bottom" in str(x.message) for x in w)
    ym = fbc.ym
    assert isinstance(ym, bc.RegionPatchBC)
    assert ym.inside.kind == bc.FIXED_VALUE
    assert ym.outside.kind == bc.ZERO_GRADIENT   # default, not the inlet
