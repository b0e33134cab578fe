"""Bin-sorted rebuilds (DEMConfig.sort_on_rebuild) in the port against
sedifoam_tpu, on the CPU.

- make_sort_order: the permutation equals the reference's exactly (both
  sorts are stable) on a state with inactive rows in the middle;
- permute_particle_state: every field equals the reference's exactly, on
  a filled binned table with shear history and on the dense backend's
  (3, N, N) history, and with rigid clumps;
- run_dem with the sort on, f64, in both packages: the whole state row
  by row to 1e-10 of each field's scale (the same bound as the unsorted
  tests/test_torch_dem.py::test_run_dem). The bed has one radius and no
  inactive row: the reference's substep takes its inverse masses before
  the rebuild and uses them after it, so where rows of different mass
  change places its sorted run is not its unsorted run. The port takes
  them again after a sorted rebuild;
- the port alone, on the bed of mixed radii with an inactive row: a
  sorted run equals the unsorted run by tag to 1e-10 of scale (the slot
  sums add in another order);
- the coupled step with the sort on: sorted = unsorted by tag, and the
  pre-step velocity (vel_fluid_old) follows its particle;
- the active window with the sort on: a windowed run equals the
  full-capacity run by tag (f32, 1e-6 absolute, as the unsorted test).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu.dem import integrate as jint  # noqa: E402
from sedifoam_tpu.dem import neighbor as jnb  # noqa: E402
from sedifoam_tpu.dem.state import make_particles as jmake  # noqa: E402
from sedifoam_tpu_torch import bench_case, bridge  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.dem import integrate as tint  # noqa: E402
from sedifoam_tpu_torch.dem import neighbor as tnb  # noqa: E402
from sedifoam_tpu_torch.runtime.runner import Simulation  # noqa: E402
from tagsort import by_tag  # noqa: E402
from test_torch_dem import BOX, R, _cfgs, _particles  # noqa: E402
from torch_port_cases import port_config, window_case  # noqa: E402
from torch_port_util import (assert_tree_close, few_threads,  # noqa: E402,F401
                             particles_to_torch, rel_err)

TOL = 1e-10


def _filled(periodic=(False, False, False)):
    """(jax cfg, torch cfg, jax state) after setup and 30 substeps: a
    filled table, shear history, and inactive rows 3 and 17."""
    jc, tc = _cfgs(periodic)
    st = _particles(jc, seed=4, vscale=2.0)
    st = st._replace(active=st.active.at[3].set(False).at[17].set(False))
    st = jint.run_dem(jint.setup_forces(st, jc), jc, 30)
    assert float(jnp.abs(st.shear).max()) > 0.0
    assert int(jnp.sum(st.nbr_idx < st.n_capacity)) > 100
    return jc, tc, st


def _orders(jc, st):
    args = (jc.domain_lo, jc.domain_hi, jc.cutoff)
    jo = jnb.make_sort_order(*args, periodic=jc.periodic)(st.pos, st.active)
    tst = particles_to_torch(st)
    to = tnb.make_sort_order(*args, periodic=jc.periodic)(tst.pos,
                                                          tst.active)
    return jo, to, tst


@pytest.mark.parametrize("periodic", [(False, False, False),
                                      (True, False, True)])
def test_make_sort_order_equal(periodic):
    jc, _, st = _filled(periodic)
    jo, to, _ = _orders(jc, st)
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    # inactive rows parked last, in their old order
    n = st.n_capacity
    dead = np.where(~np.asarray(st.active))[0]
    np.testing.assert_array_equal(to.numpy()[n - len(dead):], dead)
    assert len(dead) == 4


def test_sort_order_is_stable():
    """Many particles in one bin: ties keep the particle order, as the
    reference's stable argsort does."""
    pos = np.tile(np.array([[1e-3, 1e-3, 1e-3]]), (64, 1))
    pos[::2] += 4e-3                       # two bins, interleaved rows
    active = np.ones(64, bool)
    args = (BOX[0], BOX[1], 2 * R * 1.6)
    jo = jnb.make_sort_order(*args)(jnp.asarray(pos), jnp.asarray(active))
    to = tnb.make_sort_order(*args)(torch.as_tensor(pos),
                                    torch.as_tensor(active))
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    np.testing.assert_array_equal(
        to.numpy(), np.concatenate([np.arange(1, 64, 2),
                                    np.arange(0, 64, 2)]))


def test_permute_particle_state_binned_equal():
    jc, _, st = _filled()
    jo, to, tst = _orders(jc, st)
    ref = jnb.permute_particle_state(st, jo)
    got = tnb.permute_particle_state(tst, to)
    assert got.nbr_idx.dtype == torch.int32
    for name in ("shear", "wall_shear", "nbr_idx"):
        assert getattr(got, name).is_contiguous(), name
    assert_tree_close(bridge.tree_to_numpy(ref), bridge.tree_to_numpy(got),
                      0.0)
    # the sentinel stays the sentinel, partners keep their tags
    n = st.n_capacity
    assert int((got.nbr_idx == n).sum()) == int(jnp.sum(st.nbr_idx == n))
    old_tags = np.asarray(st.tag)
    for k in range(3):
        i = int(to[5])
        j_old = int(st.nbr_idx[k, i])
        j_new = int(got.nbr_idx[k, 5])
        if j_old < n:
            assert int(got.tag[j_new]) == old_tags[j_old]


def test_permute_particle_state_dense_equal():
    rng = np.random.RandomState(2)
    n = 24
    st = jmake(rng.rand(n, 3) * 4e-3, R, 2500.0, vel=rng.randn(n, 3),
               capacity=n + 3, n_walls=2, dtype=jnp.float64)
    st = st._replace(shear=jnp.asarray(rng.randn(3, n + 3, n + 3)),
                     wall_shear=jnp.asarray(rng.randn(3, 2, n + 3)),
                     force=jnp.asarray(rng.randn(n + 3, 3)))
    order = rng.permutation(n + 3)
    ref = jnb.permute_particle_state(st, jnp.asarray(order))
    got = tnb.permute_particle_state(particles_to_torch(st),
                                     torch.as_tensor(order))
    assert got.nbr_idx.shape == (0, n + 3)
    assert_tree_close(bridge.tree_to_numpy(ref), bridge.tree_to_numpy(got),
                      0.0)


def test_permute_particle_state_rigid_equal():
    """mol and displace move with their rows; the body SoA stays."""
    rng = np.random.RandomState(3)
    n = 18
    pos = rng.rand(n, 3) * 4e-3
    mol = np.repeat(np.arange(1, 7), 3)
    mol[-3:] = 0                           # three free spheres
    st = jmake(pos, R, 2500.0, capacity=n + 2, n_walls=1, neighbor_k=4,
               mol=mol, dtype=jnp.float64)
    order = rng.permutation(n + 2)
    ref = jnb.permute_particle_state(st, jnp.asarray(order))
    tst = particles_to_torch(st)
    got = tnb.permute_particle_state(tst, torch.as_tensor(order))
    assert_tree_close(bridge.tree_to_numpy(ref), bridge.tree_to_numpy(got),
                      0.0)
    assert got.rigid is tst.rigid
    np.testing.assert_array_equal(got.mol.numpy(),
                                  np.asarray(st.mol)[order])


def _uniform_bed(cfg, n=160, seed=9, vscale=4.0):
    """test_torch_dem's random bed with one radius and every row active."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(0.6 * R, np.asarray(BOX[1]) - 0.6 * R, size=(n, 3))
    return jmake(pos, R, 2500.0, vel=rng.randn(n, 3) * vscale,
                 omega=rng.randn(n, 3) * 20.0, capacity=n,
                 n_walls=len(cfg.walls), neighbor_k=cfg.nbr_k,
                 dtype=jnp.float64)


@pytest.mark.parametrize("fused_chain", [True, False])
def test_run_dem_sorted_matches_reference(fused_chain):
    """setup_forces + 50 substeps with rebuilds, the sort on in both."""
    jc, tc = _cfgs()
    jc = dataclasses.replace(jc, sort_on_rebuild=True)
    tc = dataclasses.replace(tc, sort_on_rebuild=True,
                             fused_chain=fused_chain)
    st = _uniform_bed(jc)
    tst = particles_to_torch(st)
    ref = jint.run_dem(jint.setup_forces(st, jc), jc, 50)
    got = tint.run_dem(tint.setup_forces(tst, tc), tc, 50)
    # rebuilt after the setup, and the rows really moved
    assert float(np.abs(by_tag(ref, "pos") - by_tag(st, "pos")).max()) \
        > 0.5 * jc.skin
    assert not np.array_equal(np.asarray(ref.tag), np.asarray(st.tag))
    worst = assert_tree_close(bridge.tree_to_numpy(ref),
                              bridge.tree_to_numpy(got), TOL)
    print(f"sorted run_dem, port vs reference: worst {worst:.3e}")


def test_run_dem_sorted_equals_unsorted_by_tag():
    _, tc = _cfgs()
    st = _particles(_cfgs()[0], seed=9, vscale=4.0)
    st = st._replace(active=st.active.at[3].set(False))
    runs = []
    for sort in (False, True):
        cfg = dataclasses.replace(tc, sort_on_rebuild=sort)
        p = particles_to_torch(st)
        runs.append(tint.run_dem(tint.setup_forces(p, cfg), cfg, 50))
    plain, srt = runs
    assert not torch.equal(plain.tag, srt.tag)
    assert int(plain.nbr_dropped) == int(srt.nbr_dropped)
    worst = 0.0
    def last_axis_by_tag(p, x):            # (3, W, N): N last
        act = p.active.numpy()
        o = np.argsort(p.tag.numpy()[act], kind="stable")
        return x.numpy()[..., act][..., o]

    for name in ("pos", "vel", "omega", "force", "torque", "wall_shear"):
        if name == "wall_shear":
            a = last_axis_by_tag(plain, plain.wall_shear)
            b = last_axis_by_tag(srt, srt.wall_shear)
        else:
            a, b = by_tag(plain, name), by_tag(srt, name)
        e = rel_err(a, b)
        assert e <= TOL, (name, e)
        worst = max(worst, e)
    print(f"sorted vs unsorted by tag: worst {worst:.3e}")


def test_coupled_step_sorted_equals_unsorted_by_tag():
    """Three coupled steps of the small binned bench case, f64: the
    sorted run equals the unsorted one by tag (1e-10 of scale; measured
    2.0e-13) and on the grid, and vel_fluid_old (the velocity before the
    step's substeps) follows its particle through the permutation."""
    small = dict(n_particles=256, nx=8, ny=16, nz=8)
    out = []
    for sort in (False, True):
        cfg = bench_case.build_config(**small, sort_on_rebuild=sort)
        fluid, particles = bench_case.build_state(
            cfg, small["n_particles"], torch.float64, "cpu")
        step = tsolver.CoupledStep(cfg, torch.float64, "cpu")
        state = step.initialize(fluid, particles)
        before = None
        for _ in range(3):
            before = state.particles
            state = step(state)
        out.append((before, state))
    (b0, s0), (b1, s1) = out
    assert not torch.equal(s0.particles.tag, s1.particles.tag)
    for name in ("pos", "vel", "omega", "force", "vel_fluid_old"):
        e = rel_err(by_tag(s0.particles, name), by_tag(s1.particles, name))
        assert e <= TOL, (name, e)
    for name in ("alpha", "Ub", "p", "Asrc"):
        e = rel_err(getattr(s0.fluid, name), getattr(s1.fluid, name))
        assert e <= TOL, (name, e)
    np.testing.assert_array_equal(by_tag(s1.particles, "vel_fluid_old"),
                                  by_tag(b1, "vel"))


def test_windowed_run_sorted_matches_full():
    """tests/test_window.py's injection column with the sort on: the
    active window relies on inactive rows staying last."""
    cfg_j, st = window_case()
    cfg = port_config(cfg_j)
    cfg = dataclasses.replace(cfg, dem=dataclasses.replace(
        cfg.dem, sort_on_rebuild=True))
    st = bridge.sim_state_from_numpy(bridge.sim_state_to_numpy(st))
    full = Simulation(cfg, st, steps_per_host_visit=5, active_window=False)
    full.run(20 * cfg.fluid.dt)
    win = Simulation(cfg, st, steps_per_host_visit=5, active_window=True)
    assert win.state.particles.n_capacity == 2048
    win.run(20 * cfg.fluid.dt)
    pf, pw = full.state.particles, win.state.particles
    tf, tw = by_tag(pf, "tag"), by_tag(pw, "tag")
    assert len(tf) > 2
    np.testing.assert_array_equal(tf, tw)
    # every active row still below the high-water mark of a prefix
    n_act = int(pw.active.sum())
    assert bool(pw.active[:n_act].all()) and not bool(pw.active[n_act:].any())
    for name in ("pos", "vel", "omega"):
        np.testing.assert_allclose(by_tag(pf, name), by_tag(pw, name),
                                   rtol=0, atol=1e-6, err_msg=name)
