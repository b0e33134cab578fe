"""The port's dense (all-pairs) DEM backend against sedifoam_tpu, f64 on
the CPU.

- pair.pair_forces vs the reference for the three pair styles, open and
  periodic, with and without shear update: 1e-10 relative to each
  output's scale (measured: 1.4e-16 at worst);
- the port's dense backend vs its binned backend on one state: forces,
  torques and the shear history of every table slot, 1e-10 (measured:
  5.5e-17);
- 3 coupled steps of tests/test_deadterm_gating.py's dense small case
  (64 particles, 8x12x8 grid, 4 substeps), cast to f64: every state
  field 1e-8 relative to its scale (measured: 7.1e-12), with the dead-term
  contract's exact zeros (lift_coeff, dudt);
- 25 coupled steps of xiaocase3 (dense, one particle, 100 substeps)
  through the port's Simulation against the reference's step, with the
  reference test's bounds: every field 1e-8 (measured: 8.6e-13), except
  the solid-phase velocity Ua = smoothed(vol*U)/alpha and its fluxes,
  which divide by alpha ~ 1e-17 away from the particle and are compared
  as alpha*Ua (measured: 3e-16).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from sedifoam_tpu import config as jcfg  # noqa: E402
from sedifoam_tpu.dem import pair as jpair  # noqa: E402
from sedifoam_tpu.dem.state import make_particles as jmake  # noqa: E402
from sedifoam_tpu.solver import (initialize as jinit,  # noqa: E402
                                 make_step_fn as jstep_fn)
from sedifoam_tpu_torch import bench_case, bridge, cases  # noqa: E402
from sedifoam_tpu_torch import config as tcfg  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.dem import integrate as tint  # noqa: E402
from sedifoam_tpu_torch.dem import neighbor as tnb  # noqa: E402
from sedifoam_tpu_torch.dem import pair as tpair  # noqa: E402
from sedifoam_tpu_torch.dem.state import make_particles as tmake  # noqa: E402
from sedifoam_tpu_torch.runtime.runner import Simulation  # noqa: E402
from test_golden_xiaocase3 import make_xiaocase3  # noqa: E402
from torch_port_cases import f64  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import (  # noqa: E402
    assert_tree_close, particles_to_torch, rel_err)

TOL = 1e-10
BOX = (0.0, 0.0, 0.0), (6e-3, 8e-3, 6e-3)
R = 5e-4
# Ua and the solid fluxes built from it divide by alpha at round-off
# level where there are no particles: compared as alpha*Ua instead
ILL_CONDITIONED = ("Ua", "Ua_old", "phia", "phia_old")


def _bed(n=60, seed=0, dense=True, k=24):
    """A random f64 bed with overlaps, random velocities and spins, and
    two dead slots, in the reference's make_particles."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(R, np.asarray(BOX[1]) - R, size=(n, 3))
    return jmake(pos, R * (1.0 + 0.1 * rng.rand(n)), 2500.0,
                 vel=0.05 * rng.randn(n, 3), omega=20.0 * rng.randn(n, 3),
                 capacity=n + 2, n_walls=0,
                 neighbor_k=None if dense else k, dtype=jnp.float64)


@pytest.mark.parametrize("style", ["hooke", "hooke_history",
                                   "hertz_history"])
@pytest.mark.parametrize("periodic", [False, True])
@pytest.mark.parametrize("shearupdate", [True, False])
def test_pair_forces_match_reference(style, periodic, shearupdate):
    st = _bed(seed=3)
    n = st.pos.shape[0]
    rng = np.random.RandomState(4)
    shear = 1e-6 * rng.randn(3, n, n)
    st = st._replace(shear=jnp.asarray(shear - shear.transpose(0, 2, 1)))
    plen = (BOX[1][0], None, BOX[1][2]) if periodic else None
    # a small xmu puts a share of the contacts over the Coulomb cap
    pj = jcfg.PairParams(style=style, kn=1e5, gamman=0.7, xmu=0.05)
    pt = tcfg.PairParams(style=style, kn=1e5, gamman=0.7, xmu=0.05)
    ref = jpair.pair_forces(st, pj, 1e-6, shearupdate, periodic_len=plen)
    got = tpair.pair_forces(particles_to_torch(st), pt, 1e-6, shearupdate,
                            periodic_len=plen)
    assert np.any(np.asarray(ref[0]) != 0.0)            # contacts present
    for a, b in zip(ref, got):
        assert b.dtype == torch.float64
        assert rel_err(a, b) <= TOL


def test_make_particles_dense_shapes_match_reference():
    pos = np.random.RandomState(5).rand(7, 3) * 1e-3
    a = jmake(pos, R, 2500.0, capacity=9, n_walls=3)
    b = tmake(pos, R, 2500.0, capacity=9, n_walls=3)
    assert b.shear.shape == (3, 9, 9) and b.nbr_idx.shape == (0, 9)
    assert_tree_close(bridge.tree_to_numpy(a), bridge.tree_to_numpy(b), 0.0)


def test_dense_matches_binned_on_one_state():
    """The same bed through both port backends (shear history from
    zero, one shear update): equal forces and torques, and each table
    slot's shear equals the dense shear of its pair."""
    dense = particles_to_torch(_bed(seed=6))
    binned = particles_to_torch(_bed(seed=6, dense=False))
    cfg = tcfg.DEMConfig(
        dt=1e-6, pair=tcfg.PairParams(style="hertz_history", kn=1e5,
                                      gamman=0.7, xmu=0.3),
        backend="binned", nbr_k=24, max_per_bin=8, cutoff=2.2 * R * 1.6,
        skin=0.6 * R, audit_ring=2.2 * R + 0.6 * R, domain_lo=BOX[0],
        domain_hi=BOX[1])
    binned = tint.maybe_rebuild_neighbors(binned, cfg, force=True)
    assert int(binned.nbr_dropped) == 0
    fd, td, sd = tpair.pair_forces(dense, cfg.pair, cfg.dt, True)
    fb, tb, sb = tnb.pair_forces_binned(binned, cfg.pair, cfg.dt,
                                        binned.nbr_idx, True)
    assert bool(torch.any(fd != 0))
    assert rel_err(fd, fb) <= TOL and rel_err(td, tb) <= TOL
    idx = binned.nbr_idx.long()
    n = idx.shape[1]
    has = idx < n
    i = torch.arange(n).expand_as(idx)
    from_dense = sd[:, i, idx.clamp(max=n - 1)] * has
    assert bool(torch.any(sb != 0))
    assert rel_err(from_dense, sb) <= TOL


def test_lattice_backend_still_raises():
    """The lattice backend is ported, but cohesion and lubrication are
    not wired on it: compute_forces refuses them with the reference's
    message, as sedifoam_tpu's does."""
    from sedifoam_tpu.dem import integrate as jint
    from sedifoam_tpu.dem import lubrication as jlub
    from sedifoam_tpu_torch.dem import lubrication as tlub
    jst = _bed(seed=7)
    st = particles_to_torch(jst)
    for m, lub, integ, ps in ((jcfg, jlub, jint, jst),
                              (tcfg, tlub, tint, st)):
        for kw in ({"cohesion": m.CohesionParams(
                        ah=1e-19, lam=100e-9, smin=1e-9, smax=1e-4,
                        model=0)},
                   {"lubrication": lub.LubricationParams(mu=1e-3)}):
            cfg = m.DEMConfig(dt=1e-6, backend="lattice", **kw)
            with pytest.raises(NotImplementedError,
                               match="cohesion/lubrication are not wired "
                                     "for the lattice"):
                integ.compute_forces(ps, cfg)


def test_deadterm_dense_case_three_steps_match_reference():
    small = dict(n_particles=64, nx=8, ny=12, nz=8, sub_steps=4)
    cfg_j, state_j = bench.build_case(backend="dense", **small)
    state_j = f64(state_j)
    state_t = bridge.sim_state_from_numpy(bridge.sim_state_to_numpy(state_j))
    cfg_t = bench_case.build_config(backend="dense", **small)
    assert not tsolver.need_ddtu(cfg_t) and cfg_t.fluid.Cl == 0.0
    step_j = jstep_fn(cfg_j)
    for _ in range(3):
        state_j = step_j(state_j)
    state_t = tsolver.make_step_fn(cfg_t, n_sub=3, device="cpu")(state_t)
    ref = bridge.sim_state_to_numpy(state_j)
    got = bridge.sim_state_to_numpy(state_t)
    assert np.any(ref["particles"]["shear"] != 0.0)    # contacts carried
    assert_tree_close(ref, got, 1e-8)
    # the dead-term contract: the gated carriers are exact zeros
    assert not bool(torch.any(state_t.fluid.lift_coeff != 0))
    assert not bool(torch.any(state_t.particles.dudt != 0))


@pytest.fixture(scope="module")
def xiaocase3_reference():
    """25 coupled steps of the reference's xiaocase3."""
    cfg, fluid, particles = make_xiaocase3()
    state = jinit(fluid, particles, cfg)
    step = jstep_fn(cfg)
    for _ in range(25):
        state = step(state)
    return state


def test_xiaocase3_25_steps_match_reference(xiaocase3_reference):
    cfg, fluid, particles = cases.xiaocase3(device="cpu")
    state = tsolver.CoupledStep(cfg, device="cpu").initialize(fluid,
                                                              particles)
    sim = Simulation(cfg, state, device="cpu")
    sim.run(25 * cfg.fluid.dt)
    st = sim.state
    # the reference test's bounds (benchmark: v(5e-4 s) ~ 0.026 m/s)
    v = float(st.particles.vel[0, 1])
    assert 0.01 < v < 0.045
    assert bool(torch.isfinite(st.fluid.p).all())
    assert bool(torch.isfinite(st.fluid.Ub).all())
    assert abs(float(st.particles.pos[0, 1]) - 1.9e-3) < 5e-4
    ref = xiaocase3_reference
    assert int(st.fluid.step) == int(ref.fluid.step) == 25
    assert_tree_close(bridge.sim_state_to_numpy(ref),
                      bridge.sim_state_to_numpy(st), 1e-8,
                      skip=ILL_CONDITIONED)
    assert rel_err(np.asarray(ref.fluid.alpha)[None]
                   * np.asarray(ref.fluid.Ua),
                   st.fluid.alpha[None] * st.fluid.Ua) <= 1e-8


def test_xiaocase3_case_matches_reference_builder():
    cj, fj, pj = make_xiaocase3()
    ct, ft, pt = cases.xiaocase3(device="cpu")
    for part in ("fluid", "cloud", "dem"):
        assert dataclasses.asdict(getattr(cj, part)) == \
            dataclasses.asdict(getattr(ct, part)), part
    assert dataclasses.asdict(cj.grid) == dataclasses.asdict(ct.grid)
    assert_tree_close(bridge.tree_to_numpy(pj), bridge.tree_to_numpy(pt), 0.0)
    assert_tree_close(bridge.tree_to_numpy(fj), bridge.tree_to_numpy(ft), 0.0)
