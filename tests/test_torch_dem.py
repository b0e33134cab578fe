"""sedifoam_tpu_torch DEM modules against sedifoam_tpu, in f64 on the CPU.

Each test makes its inputs from a seed with numpy, runs the JAX function
and its port, and compares them. Tolerance: 1e-10 relative to each
field's scale (measured: at most 3e-16 per module, 2.3e-15 after
run_dem's 50 substeps with rebuilds). Neighbor tables are compared
exactly, slot by slot.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu import config as jcfg  # noqa: E402
from sedifoam_tpu.dem import forcelaws as jfl  # noqa: E402
from sedifoam_tpu.dem import integrate as jint  # noqa: E402
from sedifoam_tpu.dem import neighbor as jnb  # noqa: E402
from sedifoam_tpu.dem import walls as jwalls  # noqa: E402
from sedifoam_tpu.dem.state import make_particles as jmake  # noqa: E402
from sedifoam_tpu_torch import config as tcfg  # noqa: E402
from sedifoam_tpu_torch.dem import forcelaws as tfl  # noqa: E402
from sedifoam_tpu_torch.dem import integrate as tint  # noqa: E402
from sedifoam_tpu_torch.dem import neighbor as tnb  # noqa: E402
from sedifoam_tpu_torch.dem import walls as twalls  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import (particles_to_torch, rel_err,  # noqa: E402
                             assert_tree_close)
from sedifoam_tpu_torch import bridge  # noqa: E402

TOL = 1e-10
BOX = (0.0, 0.0, 0.0), (8e-3, 16e-3, 8e-3)
R = 5e-4


def _cfgs(periodic=(False, False, False), style="hertz_history"):
    """The same DEM config in both packages."""
    out = []
    for m in (jcfg, tcfg):
        pair = m.PairParams(style=style, kn=1e5, gamman=0.7, xmu=0.4)
        walls = tuple(m.WallSpec(style=s, lo=0.0, hi=h, params=pair)
                      for a, (s, h) in enumerate(
                          (("xplane", BOX[1][0]), ("yplane", BOX[1][1]),
                           ("zplane", BOX[1][2]))) if not periodic[a])
        out.append(m.DEMConfig(
            dt=1e-6, pair=pair, walls=walls, gravity=(0.0, -9.81, 0.0),
            backend="binned", nbr_k=16, max_per_bin=8,
            cutoff=2 * R * 1.6, skin=0.6 * R, periodic=periodic,
            audit_ring=2.6 * R, domain_lo=BOX[0], domain_hi=BOX[1]))
    return out


def _particles(cfg, n=160, seed=0, wall_gap=0.6, vscale=0.05):
    """A random bed (overlaps and wall contacts from the start)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(wall_gap * R, np.asarray(BOX[1]) - wall_gap * R,
                      size=(n, 3))
    vel = rng.randn(n, 3) * vscale
    omega = rng.randn(n, 3) * 20.0
    # two dead slots exercise the inactive paths
    st = jmake(pos, R * (1.0 + 0.1 * rng.rand(n)), 2500.0, vel=vel,
               omega=omega, capacity=n + 2, n_walls=len(cfg.walls),
               neighbor_k=cfg.nbr_k, dtype=jnp.float64)
    return st


def _vec(rng, shape):
    return tuple(rng.randn(*shape) for _ in range(3))


@pytest.mark.parametrize("style", ["hooke", "hooke_history",
                                   "hertz_history"])
@pytest.mark.parametrize("shearupdate", [True, False])
def test_contact_force_styles(style, shearupdate):
    rng = np.random.RandomState(1)
    shape = (4, 257)
    touch = rng.rand(*shape) < 0.7
    r = 1e-3 * (0.5 + rng.rand(*shape))
    overlap = 1e-5 * rng.rand(*shape)
    delta, vtr, shear = (_vec(rng, shape), _vec(rng, shape),
                         tuple(1e-6 * a for a in _vec(rng, shape)))
    shear[0][0, :5] = 0.0
    shear[1][0, :5] = 0.0
    shear[2][0, :5] = 0.0
    vnnr = rng.randn(*shape)
    meff = 1e-6 * (0.5 + rng.rand(*shape))
    poly = 1e-8 * rng.rand(*shape)
    args = (touch, overlap, r, 1.0 / r, 1.0 / r ** 2, delta, vnnr, vtr,
            shear, meff, poly)
    # a small xmu puts a share of the contacts over the Coulomb cap
    pj = jcfg.PairParams(style=style, kn=1e5, gamman=0.7, xmu=0.05)
    pt = tcfg.PairParams(style=style, kn=1e5, gamman=0.7, xmu=0.05)

    def conv(a, lib):
        if isinstance(a, tuple):
            return tuple(conv(x, lib) for x in a)
        return jnp.asarray(a) if lib == "jax" else torch.as_tensor(a)

    ref = jfl.contact_force(pj, 1e-6, *conv(args, "jax"),
                            shearupdate=shearupdate)
    got = tfl.contact_force(pt, 1e-6, *conv(args, "torch"),
                            shearupdate=shearupdate)
    for vr, vg in zip(ref, got):
        for a, b in zip(vr, vg):
            assert rel_err(a, b) <= TOL


def _moving_walls(m, pair):
    """The wall kinds the kernel does not take: a sheared cylinder, a
    wiggling plane and a sheared plane (torch wall_forces only)."""
    return (m.WallSpec(style="zcylinder", cylradius=4e-3, vshear=0.1,
                       shear_axis=0, params=pair),
            m.WallSpec(style="xplane", lo=0.0, hi=8e-3, wiggle=True,
                       wiggle_axis=0, amplitude=2e-4, period=1e-3,
                       params=pair),
            m.WallSpec(style="yplane", lo=0.0, hi=None, vshear=0.2,
                       shear_axis=0, params=pair))


@pytest.mark.parametrize("moving", [False, True])
def test_wall_forces(moving):
    jc, tc = _cfgs()
    jw = _moving_walls(jcfg, jc.pair) if moving else jc.walls
    tw = _moving_walls(tcfg, tc.pair) if moving else tc.walls
    st = _particles(jc, seed=2)
    # centred on the cylinder axis
    st = st._replace(pos=st.pos - jnp.asarray([4e-3, 8e-3, 0.0]),
                     wall_shear=jnp.asarray(
                         1e-6 * np.random.RandomState(3).randn(
                             *st.wall_shear.shape)))
    if not moving:
        st = st._replace(pos=st.pos + jnp.asarray([4e-3, 8e-3, 0.0]))
    for step_time in (0.0, 2.7e-4):
        ref = jwalls.wall_forces(st, jw, jc.dt, step_time, True)
        got = twalls.wall_forces(particles_to_torch(st), tw, tc.dt,
                                 step_time, True)
        assert np.any(np.asarray(ref[0]) != 0.0)    # wall contacts present
        for a, b in zip(ref, got):
            assert rel_err(a, b) <= TOL


@pytest.mark.parametrize("periodic", [(False, False, False),
                                      (True, False, True)])
def test_make_binner_tables_equal(periodic):
    jc, _ = _cfgs(periodic)
    st = _particles(jc, n=400, seed=4)
    args = (jc.domain_lo, jc.domain_hi, jc.cutoff, jc.nbr_k, jc.max_per_bin,
            periodic, jc.audit_ring)
    idx_j, drop_j = jnb.make_binner(*args)(st.pos, st.active)
    # K below the in-ring count so the audit has drops to count
    tight = args[:3] + (4,) + args[4:]
    idx_jt, drop_jt = jnb.make_binner(*tight)(st.pos, st.active)
    tst = particles_to_torch(st)
    idx_t, drop_t = tnb.make_binner(*args)(tst.pos, tst.active)
    idx_tt, drop_tt = tnb.make_binner(*tight)(tst.pos, tst.active)
    np.testing.assert_array_equal(np.asarray(idx_j), idx_t.numpy())
    np.testing.assert_array_equal(np.asarray(idx_jt), idx_tt.numpy())
    assert idx_t.dtype == torch.int32
    assert int(drop_j) == int(drop_t)
    assert int(drop_jt) == int(drop_tt) > 0


def test_carry_over_shear():
    rng = np.random.RandomState(5)
    n, ko, kn = 300, 8, 10
    old = rng.randint(0, n + 1, size=(ko, n)).astype(np.int32)
    new = rng.randint(0, n + 1, size=(kn, n)).astype(np.int32)
    new[:4] = old[:4]                       # matched partners carry over
    shear = rng.randn(3, ko, n)
    ref = jnb.carry_over_shear(jnp.asarray(old), jnp.asarray(new),
                               jnp.asarray(shear))
    got = tnb.carry_over_shear(torch.as_tensor(old), torch.as_tensor(new),
                               torch.as_tensor(shear))
    assert rel_err(ref, got) <= TOL


def test_scrub_dead_partners():
    rng = np.random.RandomState(6)
    n = 200
    idx = rng.randint(0, n + 1, size=(8, n)).astype(np.int32)
    active = rng.rand(n) < 0.8
    ref = jnb.scrub_dead_partners(jnp.asarray(idx), jnp.asarray(active))
    got = tnb.scrub_dead_partners(torch.as_tensor(idx),
                                  torch.as_tensor(active))
    np.testing.assert_array_equal(np.asarray(ref), got.numpy())


@pytest.mark.parametrize("periodic", [(False, False, False),
                                      (True, False, True)])
def test_pair_forces_binned(periodic):
    jc, tc = _cfgs(periodic)
    st = jint.setup_forces(_particles(jc, seed=7), jc)
    rng = np.random.RandomState(8)
    st = st._replace(shear=jnp.asarray(1e-6 * rng.randn(*st.shear.shape)))
    plen = jc.periodic_len()
    ref = jnb.pair_forces_binned(st, jc.pair, jc.dt, st.nbr_idx, True, plen)
    tst = particles_to_torch(st)
    got = tnb.pair_forces_binned(tst, tc.pair, tc.dt, tst.nbr_idx, True,
                                 plen)
    assert np.any(np.asarray(ref[0]) != 0.0)        # contacts present
    for a, b in zip(ref, got):
        assert rel_err(a, b) <= TOL


def test_compute_forces_frozen_types_and_carrier_rho():
    """The fix freeze and fix fdrag added-mass terms of compute_forces."""
    jc, tc = _cfgs()
    extra = dict(frozen_types=(2,), carrier_rho=1000.0)
    jc = dataclasses.replace(jc, **extra)
    tc = dataclasses.replace(tc, **extra)
    rng = np.random.RandomState(10)
    st = jint.setup_forces(_particles(jc, seed=10), jc)
    n = st.pos.shape[0]
    st = st._replace(ptype=jnp.asarray(rng.randint(1, 3, n), jnp.int32),
                     dudt=jnp.asarray(rng.randn(n, 3)),
                     v_old=st.vel + 1e-3 * jnp.asarray(rng.randn(n, 3)),
                     fdrag=jnp.asarray(1e-6 * rng.randn(n, 3)))
    ref = jint.compute_forces(st, jc, 0.0, True)
    got = tint.compute_forces(particles_to_torch(st), tc, 0.0, True)
    assert np.any(np.asarray(ref.force) == 0.0)     # frozen rows
    assert_tree_close(bridge.tree_to_numpy(ref), bridge.tree_to_numpy(got),
                      TOL)


@pytest.mark.parametrize("fused_chain", [True, False])
def test_run_dem(fused_chain):
    """setup_forces + 50 substeps (with Verlet rebuilds) in both."""
    jc, tc = _cfgs()
    tc = dataclasses.replace(tc, fused_chain=fused_chain)
    st = _particles(jc, seed=9, vscale=4.0)
    st = st._replace(active=st.active.at[3].set(False))
    tst = particles_to_torch(st)
    ref = jint.run_dem(jint.setup_forces(st, jc), jc, 50)
    got = tint.run_dem(tint.setup_forces(tst, tc), tc, 50)
    assert float(jnp.max(jnp.abs(ref.pos - st.pos))) > 0.5 * jc.skin  # rebuilt
    assert_tree_close(bridge.tree_to_numpy(ref), bridge.tree_to_numpy(got),
                      TOL)
