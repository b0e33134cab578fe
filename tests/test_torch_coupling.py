"""sedifoam_tpu_torch coupling modules against sedifoam_tpu, f64 on the CPU.

particle_to_eulerian, calc_asrc, smooth, the drag laws, particle_forces
(every force switch), evolve and lift_drag_coeffs, on the bench case
(small) with seeded random perturbations of the fluid fields.
Tolerance: 1e-10 relative to each field's scale (measured: 1e-15 at
worst, except the ensemble velocity Ua = smoothed(vol*U)/alpha, which
divides by alpha at round-off level in empty cells: 5e-11 in evolve and
particle_to_eulerian).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from sedifoam_tpu.coupling import cloud as jcloud  # noqa: E402
from sedifoam_tpu.coupling import drag as jdrag  # noqa: E402
from sedifoam_tpu.coupling import forces as jforces  # noqa: E402
from sedifoam_tpu.coupling import smoothing as jsmooth  # noqa: E402
from sedifoam_tpu.coupling import transfer as jtr  # noqa: E402
from sedifoam_tpu_torch import bench_case, bridge  # noqa: E402
from sedifoam_tpu_torch.coupling import cloud as tcloud  # noqa: E402
from sedifoam_tpu_torch.coupling import drag as tdrag  # noqa: E402
from sedifoam_tpu_torch.coupling import forces as tforces  # noqa: E402
from sedifoam_tpu_torch.coupling import smoothing as tsmooth  # noqa: E402
from sedifoam_tpu_torch.coupling import transfer as ttr  # noqa: E402
from torch_port_util import assert_tree_close, rel_err  # noqa: E402

TOL = 1e-10
SMALL = dict(n_particles=256, nx=8, ny=16, nz=8)


@pytest.fixture(scope="module")
def case():
    """(cfg_j, cfg_t, state_j, state_t): the initialized bench case in
    f64 with randomized fluid fields and particle velocities."""
    cfg_j, st = bench.build_case(backend="binned", **SMALL)
    st = jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, st)
    rng = np.random.RandomState(21)
    shp = cfg_j.grid.shape
    fl = st.fluid._replace(
        Ub=st.fluid.Ub + 0.05 * jnp.asarray(rng.randn(3, *shp)),
        p=jnp.asarray(rng.randn(*shp)),
        alpha=jnp.clip(st.fluid.alpha
                       + 0.05 * jnp.asarray(rng.rand(*shp)), 0.0, 0.9))
    pa = st.particles._replace(
        vel=st.particles.vel + 0.01 * jnp.asarray(
            rng.randn(*st.particles.vel.shape)))
    st = st._replace(fluid=fl, particles=pa,
                     uf_smoothed=fl.Ub + 0.01 * jnp.asarray(
                         rng.randn(3, *shp)))
    st_t = bridge.sim_state_from_numpy(bridge.sim_state_to_numpy(st))
    return cfg_j, bench_case.build_config(**SMALL), st, st_t


def _smooths(cfg_j, cfg_t):
    return jcloud._smooth_fn(cfg_j.grid, cfg_j.cloud), \
        tcloud._smooth_fn(cfg_t.grid, cfg_t.cloud)


def test_smooth(case):
    cfg_j, cfg_t, st, st_t = case
    for fj, ft in ((st.fluid.alpha, st_t.fluid.alpha),
                   (st.fluid.Ub, st_t.fluid.Ub)):
        for steps, direction in ((4, (1.0, 1.0, 1.0)), (3, (1.0, 0.0, 2.0))):
            a = jsmooth.smooth(fj, cfg_j.grid, 6e-3, steps, direction)
            b = tsmooth.smooth(ft, cfg_t.grid, 6e-3, steps, direction)
            assert rel_err(a, b) <= TOL


@pytest.mark.parametrize("flags", [(True, True), (True, False),
                                   (False, True), (False, False)])
def test_particle_to_eulerian(case, flags):
    cfg_j, cfg_t, st, st_t = case
    sj, stt = _smooths(cfg_j, cfg_t)
    a = jtr.particle_to_eulerian(st.particles, cfg_j.grid, sj, *flags)
    b = ttr.particle_to_eulerian(st_t.particles, cfg_t.grid, stt, *flags)
    for x, y in zip(a, b):
        assert rel_err(x, y) <= TOL


@pytest.mark.parametrize("model", ["ErgunWenYu", "SyamlalOBrien",
                                   "NoCorrection"])
def test_drag_laws(model):
    rng = np.random.RandomState(22)
    ur = np.abs(rng.randn(500)) * 0.5
    alpha = rng.rand(500) * 0.7
    d = 1e-3 * (0.5 + rng.rand(500))
    a = jdrag.jd(model, jnp.asarray(ur), jnp.asarray(alpha), jnp.asarray(d),
                 1e-6, 1000.0)
    b = tdrag.jd(model, torch.as_tensor(ur), torch.as_tensor(alpha),
                 torch.as_tensor(d), 1e-6, 1000.0)
    assert rel_err(a, b) <= TOL


@pytest.mark.parametrize("drag_smooth", [True, False])
def test_calc_asrc(case, drag_smooth):
    cfg_j, cfg_t, st, st_t = case
    sj, stt = _smooths(cfg_j, cfg_t)
    rng = np.random.RandomState(23)
    jd = 1e3 * (0.5 + rng.rand(st.particles.pos.shape[0]))
    a = jtr.calc_asrc(st.particles, jnp.asarray(jd), st.uf_smoothed,
                      st.fluid.alpha, cfg_j.grid, sj, drag_smooth)
    b = ttr.calc_asrc(st_t.particles, torch.as_tensor(jd), st_t.uf_smoothed,
                      st_t.fluid.alpha, cfg_t.grid, stt, drag_smooth)
    assert rel_err(a, b) <= TOL


def test_particle_forces_all_switches(case):
    cfg_j, cfg_t, st, st_t = case
    rng = np.random.RandomState(24)
    shp = cfg_j.grid.shape
    extra = [rng.randn(3, *shp) for _ in range(3)]   # grad p, curl, DDtUb
    switches = dict(particle_added_mass=True, particle_lift=True,
                    particle_history_force=True, lubrication_force=True,
                    inlet_force=(0.0, 0.05, 0.0),
                    inlet_box=(0.0, 0.008, 0.0, 0.004, 0.0, 0.016))
    cj = dataclasses.replace(cfg_j.cloud, **switches)
    ct = dataclasses.replace(cfg_t.cloud, **switches)
    pj = st.particles._replace(
        vel_fluid_old=st.particles.vel * 0.9,
        n0=jnp.asarray(rng.randint(0, 5, st.particles.n0.shape[0]) * 1.0))
    pt = bridge.particle_state_from_numpy(bridge.tree_to_numpy(pj))
    step = jnp.asarray(7, jnp.int32)
    a = jforces.particle_forces(
        pj, st.uf_smoothed, st.fluid.Ub, *(jnp.asarray(e) for e in extra),
        cfg_j.grid, cj, cfg_j.fluid, st.fluid.alpha, step)
    b = tforces.particle_forces(
        pt, st_t.uf_smoothed, st_t.fluid.Ub,
        *(torch.as_tensor(e) for e in extra), cfg_t.grid, ct, cfg_t.fluid,
        st_t.fluid.alpha, torch.tensor(7, dtype=torch.int32))
    assert rel_err(a[0], b[0]) <= TOL
    assert rel_err(a[1], b[1]) <= TOL
    assert_tree_close(bridge.tree_to_numpy(a[2]), bridge.tree_to_numpy(b[2]),
                      TOL)


def test_evolve(case):
    cfg_j, cfg_t, st, st_t = case
    clone = bridge.sim_state_from_numpy(bridge.sim_state_to_numpy(st))
    fj, pj, uj = jcloud.evolve(st.fluid, st.particles, st.uf_smoothed,
                               cfg_j.grid, cfg_j.bcs, cfg_j.cloud, cfg_j.dem,
                               cfg_j.fluid)
    ft, pt, ut = tcloud.evolve(clone.fluid, clone.particles,
                               clone.uf_smoothed, cfg_t.grid, cfg_t.bcs,
                               cfg_t.cloud, cfg_t.dem, cfg_t.fluid)
    assert rel_err(uj, ut) <= TOL
    assert_tree_close(bridge.tree_to_numpy(fj), bridge.tree_to_numpy(ft),
                      TOL)
    assert_tree_close(bridge.tree_to_numpy(pj), bridge.tree_to_numpy(pt),
                      TOL)


def test_delete_outside_scrubs_table(case):
    """A particle pushed out of the box is deactivated and its table
    slots are scrubbed, as in the reference."""
    cfg_j, cfg_t, st, st_t = case
    pos = np.asarray(st.particles.pos).copy()
    pos[5, 1] = -1e-3
    pj = st.particles._replace(pos=jnp.asarray(pos))
    pt = bridge.particle_state_from_numpy(bridge.tree_to_numpy(pj))
    a = jcloud._delete_outside(pj, cfg_j.grid, cfg_j.dem)
    b = tcloud._delete_outside(pt, cfg_t.grid, cfg_t.dem)
    assert not bool(b.active[5])
    np.testing.assert_array_equal(np.asarray(a.active), b.active.numpy())
    np.testing.assert_array_equal(np.asarray(a.nbr_idx), b.nbr_idx.numpy())


@pytest.mark.parametrize("Cl", [0.0, 0.3])
def test_lift_drag_coeffs(case, Cl):
    cfg_j, cfg_t, st, st_t = case
    fl_j = dataclasses.replace(cfg_j.fluid, Cl=Cl)
    fl_t = dataclasses.replace(cfg_t.fluid, Cl=Cl)
    a = jcloud.lift_drag_coeffs(st.fluid, st.particles, st.uf_smoothed,
                                cfg_j.grid, cfg_j.bcs, cfg_j.cloud, fl_j)
    b = tcloud.lift_drag_coeffs(st_t.fluid, st_t.particles, st_t.uf_smoothed,
                                cfg_t.grid, cfg_t.bcs, cfg_t.cloud, fl_t)
    for name in ("alpha", "Asrc", "drag_coef", "lift_coeff"):
        assert rel_err(getattr(a, name), getattr(b, name)) <= TOL, name
    assert bool(torch.any(b.Asrc != 0))


def test_unported_cloud_options_raise(case):
    _, cfg_t, _, st_t = case
    for bad in (dict(add_particle=1), dict(semi_implicit_drag=True)):
        cc = dataclasses.replace(cfg_t.cloud, **bad)
        with pytest.raises(NotImplementedError):
            if "semi_implicit_drag" in bad:
                tcloud.lift_drag_coeffs(st_t.fluid, st_t.particles,
                                        st_t.uf_smoothed, cfg_t.grid,
                                        cfg_t.bcs, cc, cfg_t.fluid)
            else:
                tcloud.evolve(st_t.fluid, st_t.particles, st_t.uf_smoothed,
                              cfg_t.grid, cfg_t.bcs, cc, cfg_t.dem,
                              cfg_t.fluid)
