"""The reference's DEM physics gates on sedifoam_tpu_torch alone: the
set-ups, step counts, assertions and tolerances of tests/test_dem.py
and tests/test_lubrication_walls.py, case for case, in f64, on the CPU
and (marked `cuda`) on the card.

The one addition: each contact set-up of tests/test_dem.py (head-on
momentum and bounce in both styles, the Hertz restitution, the oblique
spin, the wall bounce and rest, the Coulomb cap) also runs on the
binned backend with the contact chain fused (backend="binned",
fused_chain=True), under the dense case's assertions, so that the chain
carries the physics: on the card its hand-written kernel
(csrc/contact_chain.cu), whose launch count must grow across the case;
on the CPU its plain version. The binned set-ups:
- the two-sphere collisions (r = 5 mm): cutoff 12 mm (a diameter and
  the skin), skin 2 mm, nbr_k 8, max_per_bin 4, domain
  [-30, 30] x [-15, 15] x [-15, 15] mm (they part to about x = +-22 mm);
- the ball on the y = 0 floor (the wall fused into the chain): cutoff
  12 mm, skin 2 mm, nbr_k 8, max_per_bin 4, domain
  [-12, 12] x [0, 24] x [-12, 12] mm, and the wall's contact law as the
  pair law: the chain takes no pair style "none" (nor does the JAX
  package's), and a lone sphere has no partner for it to act on.

The long runs (120,000 substeps a collision, 200,000 for the wall
bounce) are `slow` on the CPU (1.2-2.2 ms a substep, so 149-175 s a
collision and 200-435 s a wall bounce) and on the card, where they
replay captured blocks of substeps (torch_port_util.dem_stepper; the
substeps and the gates are the same) and take 13-50 s a case.

Runs on the port alone: nothing here imports JAX or the JAX package, so the
file runs on the card under `python -m pytest --noconftest`.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sedifoam_tpu_torch.config import (PAIR_HERTZ_HISTORY,  # noqa: E402
                                       PAIR_HOOKE_HISTORY, DEMConfig,
                                       PairParams, WallSpec)
from sedifoam_tpu_torch.dem import integrate as _dem  # noqa: E402
from sedifoam_tpu_torch.dem.integrate import (run_dem,  # noqa: E402
                                              setup_forces)
from sedifoam_tpu_torch.dem.lubrication import (  # noqa: E402
    LubricationParams, lubrication_forces, lubrication_forces_binned,
    wall_bounded_volume)
from sedifoam_tpu_torch.dem.state import make_particles  # noqa: E402
from torch_port_util import (DEVICES, chain_kernel_ran,  # noqa: E402,F401
                             dem_stepper, devices, few_threads)

BACKENDS = ("dense", "binned")
# the binned set-ups of the module docstring
COLLIDE_BINNED = dict(backend="binned", fused_chain=True, nbr_k=8,
                      max_per_bin=4, cutoff=0.012, skin=0.002,
                      domain_lo=(-0.03, -0.015, -0.015),
                      domain_hi=(0.03, 0.015, 0.015))
FLOOR_BINNED = dict(backend="binned", fused_chain=True, nbr_k=8,
                    max_per_bin=4, cutoff=0.012, skin=0.002,
                    domain_lo=(-0.012, 0.0, -0.012),
                    domain_hi=(0.012, 0.024, 0.012))
# a collision or the wall bounce: slow on the CPU and on the card
LONG = devices(slow=True)


def _binned(cfg, backend, extra):
    if backend != "binned":
        return cfg
    if extra is FLOOR_BINNED:
        extra = dict(extra, pair=cfg.walls[0].params)
    return dataclasses.replace(cfg, **extra)


def _parts(cfg, device, **kw):
    k = cfg.nbr_k if cfg.backend == "binned" else None
    return make_particles(neighbor_k=k, device=device, **kw)


def _f(t):
    return float(t.detach().cpu())


# ---- tests/test_dem.py ------------------------------------------------------

@pytest.mark.parametrize("device", DEVICES)
def test_free_fall(device):
    st = make_particles(pos=[[0.0, 1.0, 0.0]], radius=0.01, density=2000.0,
                        n_walls=0, device=device)
    cfg = DEMConfig(dt=1e-4, gravity=(0.0, -9.81, 0.0))
    st = setup_forces(st, cfg)
    n = 100
    st = run_dem(st, cfg, n)
    t = n * cfg.dt
    # velocity-Verlet is exact for constant acceleration
    np.testing.assert_allclose(_f(st.vel[0, 1]), -9.81 * t, rtol=1e-12)
    np.testing.assert_allclose(_f(st.pos[0, 1]), 1.0 - 0.5 * 9.81 * t * t,
                               rtol=1e-10)


@pytest.mark.parametrize("device", DEVICES)
def test_inactive_particles_frozen(device):
    st = make_particles(pos=[[0.0, 0.0, 0.0], [1.0, 0.0, 0.0]], radius=0.01,
                        density=1000.0, capacity=4, n_walls=0, device=device)
    cfg = DEMConfig(dt=1e-4, gravity=(0.0, -9.81, 0.0))
    st = setup_forces(st, cfg)
    st = run_dem(st, cfg, 50)
    assert _f(torch.abs(st.pos[2:]).max()) == 0.0
    assert _f(torch.abs(st.vel[2:]).max()) == 0.0


def _collide(device, backend, style, kn=1e5, gamman=0.3, xmu=0.5,
             dampflag=1, offset=0.0):
    """Two equal spheres approaching head-on (optionally offset for
    obliquity)."""
    r = 0.005
    pair = PairParams(style=style, kn=kn, gamman=gamman, xmu=xmu,
                      dampflag=dampflag)
    cfg = _binned(DEMConfig(dt=2e-7, pair=pair), backend, COLLIDE_BINNED)
    st = _parts(cfg, device,
                pos=[[-2.5 * r, 0.0, 0.0], [2.5 * r, offset, 0.0]],
                vel=[[1.0, 0.0, 0.0], [-1.0, 0.0, 0.0]],
                radius=r, density=2500.0, n_walls=0)
    with chain_kernel_ran(device, backend == "binned"):
        st = setup_forces(st, cfg)
        st = dem_stepper(cfg).run(st, 120000)  # long enough to separate
    return st


@pytest.mark.parametrize("device", LONG)
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("style,gamman", [
    (PAIR_HOOKE_HISTORY, 50.0),
    (PAIR_HERTZ_HISTORY, 0.8),
])
def test_headon_collision_momentum_and_bounce(style, gamman, backend,
                                              device):
    st = _collide(device, backend, style, gamman=gamman)
    v = st.vel.cpu().numpy()
    # momentum conserved (equal masses -> velocities sum to zero)
    np.testing.assert_allclose(v[0] + v[1], 0.0, atol=1e-12)
    # they bounced apart and lost energy
    assert v[0, 0] < 0.0 and v[1, 0] > 0.0
    assert abs(v[0, 0]) <= 1.0 + 1e-12
    # no residual overlap / separated
    gap = _f(st.pos[1, 0] - st.pos[0, 0])
    assert gap > 2 * 0.005


@pytest.mark.parametrize("device", LONG)
@pytest.mark.parametrize("backend", BACKENDS)
def test_hertz_restitution_close_to_gamman(backend, device):
    """For the hertzFix damping design, gamman IS the restitution coeff."""
    e_target = 0.8
    st = _collide(device, backend, PAIR_HERTZ_HISTORY, kn=1e6,
                  gamman=e_target, xmu=0.0)
    e = abs(_f(st.vel[1, 0])) / 1.0
    assert abs(e - e_target) < 0.05


@pytest.mark.parametrize("device", LONG)
@pytest.mark.parametrize("backend", BACKENDS)
def test_oblique_collision_spins_particles(backend, device):
    st = _collide(device, backend, PAIR_HERTZ_HISTORY, gamman=0.8, xmu=0.5,
                  offset=0.004)
    w = st.omega.cpu().numpy()
    assert np.abs(w).max() > 1e-3  # friction torque spun them up
    # spin about z (impact plane is x-y)
    assert np.abs(w[:, 2]).max() > np.abs(w[:, 0]).max()


@pytest.mark.parametrize("device", LONG)
@pytest.mark.parametrize("backend", BACKENDS)
def test_wall_bounce_and_rest(backend, device):
    """Ball dropped on a y-floor: bounces, never penetrates deeply, and
    comes to rest at overlap where contact balances gravity."""
    r = 0.005
    # near-critical damping (2*sqrt(kn*m) ~ 7.2, meff*gamman = 3.9) so the
    # ball settles within the simulated window
    wall = WallSpec(style="yplane", lo=0.0, hi=None,
                    params=PairParams(style=PAIR_HOOKE_HISTORY, kn=1e4,
                                      gamman=3000.0, xmu=0.5))
    cfg = _binned(DEMConfig(dt=1e-6, walls=(wall,),
                            gravity=(0.0, -9.81, 0.0)), backend, FLOOR_BINNED)
    st = _parts(cfg, device, pos=[[0.0, 3 * r, 0.0]], radius=r,
                density=2500.0, n_walls=1)
    stepper = dem_stepper(cfg)
    with chain_kernel_ran(device, backend == "binned"):
        st = setup_forces(st, cfg)
        traj_min = 1e9
        for _ in range(10):
            st = stepper.run(st, 20000)
            traj_min = min(traj_min, _f(st.pos[0, 1]))
    # never penetrates more than ~20% of radius
    assert traj_min > r * 0.8
    # settled: tiny velocity, resting just below y=r (static overlap)
    assert abs(_f(st.vel[0, 1])) < 1e-3
    m = _f(st.mass[0])
    overlap_static = m * 9.81 / 1e4
    np.testing.assert_allclose(_f(st.pos[0, 1]), r - overlap_static,
                               rtol=0.05)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_tangential_coulomb_cap(backend, device):
    """Sliding particle on a frictional floor decelerates at mu*g."""
    r = 0.005
    mu = 0.3
    wall = WallSpec(style="yplane", lo=0.0, hi=None,
                    params=PairParams(style=PAIR_HOOKE_HISTORY, kn=1e5,
                                      gamman=100.0, xmu=mu))
    cfg = _binned(DEMConfig(dt=1e-6, walls=(wall,),
                            gravity=(0.0, -9.81, 0.0)), backend, FLOOR_BINNED)
    st = _parts(cfg, device, pos=[[0.0, r * 0.999, 0.0]],
                vel=[[0.5, 0.0, 0.0]], radius=r, density=2500.0, n_walls=1)
    with chain_kernel_ran(device, backend == "binned"):
        st = setup_forces(st, cfg)
        st = dem_stepper(cfg).run(st, 2000)
    t = 2000 * 1e-6
    vx = _f(st.vel[0, 0])
    # Coulomb-limited sliding: deceleration on the order of mu*g (the
    # normal force oscillates around m*g during the settling transient,
    # so allow a generous band around the rigid-plane value)
    assert 0.5 - 3.0 * mu * 9.81 * t < vx < 0.5 - 0.3 * mu * 9.81 * t
    # friction torque spins the particle toward rolling (omega_z < 0 for
    # +x sliding on a floor with normal +y)
    assert _f(st.omega[0, 2]) < 0.0


@pytest.mark.parametrize("device", DEVICES)
def test_lubrication_squeeze_resists_approach(device):
    """pair lubricate/poly: approaching spheres feel a squeeze force that
    diverges as the gap closes; the isotropic FLD term damps motion."""
    r1, r2 = 0.005, 0.0025  # polydisperse
    gap = 0.001
    st = make_particles(
        pos=[[0.0, 0.0, 0.0], [r1 + r2 + gap, 0.0, 0.0]],
        vel=[[0.1, 0.0, 0.0], [-0.1, 0.0, 0.0]],
        radius=[r1, r2], density=1000.0, n_walls=0, device=device)
    p = LubricationParams(mu=1e-3, flaglog=1, flagfld=1,
                          cut_inner=(r1 + r2) * 1.0001,
                          cut=(r1 + r2 + 3 * gap), box_volume=1e-3)
    f, tq = lubrication_forces(st, p)
    f = f.cpu().numpy()
    # squeeze opposes approach: particle 0 pushed -x, particle 1 +x
    assert f[0, 0] < 0 and f[1, 0] > 0
    # smaller gap -> larger force
    pos = st.pos.clone()
    pos[1, 0] = r1 + r2 + gap / 4
    f2, _ = lubrication_forces(st._replace(pos=pos), p)
    assert abs(_f(f2[0, 0])) > abs(f[0, 0])
    # isotropic drag on a lone moving particle
    active = st.active.clone()
    active[1] = False
    f3, _ = lubrication_forces(st._replace(active=active), p)
    assert f3[0, 0] < 0  # opposes +x motion


# ---- tests/test_lubrication_walls.py ----------------------------------------

PAIR = PairParams(style="hertz_history", kn=1e5, gamman=0.7, xmu=0.5)


def test_wall_bounded_volume_static_and_wiggle():
    lo, hi = (0.0, 0.0, 0.0), (1.0, 2.0, 3.0)
    # no walls: raw box
    assert wall_bounded_volume(lo, hi, ()) == pytest.approx(6.0)
    # y walls shrink the slab to [0.5, 1.5]
    walls = (WallSpec(style="yplane", lo=0.5, hi=1.5, params=PAIR),)
    assert wall_bounded_volume(lo, hi, walls) == pytest.approx(3.0)
    # one-sided wall (LAMMPS NULL side) only overrides its side
    walls = (WallSpec(style="xplane", lo=0.25, hi=None, params=PAIR),)
    assert wall_bounded_volume(lo, hi, walls) == pytest.approx(0.75 * 6.0)
    # wiggled wall along its own axis shifts both sides by
    # A*(1 - cos(2 pi t / T)) — at t = T/2 the offset is 2A
    walls = (WallSpec(style="zplane", lo=0.0, hi=2.0, params=PAIR,
                      wiggle=True, wiggle_axis=2, amplitude=0.1,
                      period=1.0),)
    v0 = wall_bounded_volume(lo, hi, walls, step_time=0.0)
    vh = wall_bounded_volume(lo, hi, walls, step_time=0.5)
    assert float(v0) == pytest.approx(1.0 * 2.0 * 2.0)
    assert float(vh) == pytest.approx(float(v0))  # both sides shift equally
    # wiggle transverse to the wall axis leaves the volume alone
    walls = (WallSpec(style="zplane", lo=0.0, hi=2.0, params=PAIR,
                      wiggle=True, wiggle_axis=0, amplitude=0.1,
                      period=1.0),)
    assert float(wall_bounded_volume(lo, hi, walls, 0.3)) == \
        pytest.approx(4.0)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_squeeze_film_matches_taylor_law(backend, device):
    """Leading-order squeeze force F = 6 pi mu a_eff^2 V / h."""
    mu = 1.3e-3
    r1, r2 = 5e-4, 3e-4
    h = 2e-5                       # gap << radii: asymptotic regime
    V = 0.04                       # approach speed of particle 0
    pos = [[0.0, 0.0, 0.0], [r1 + r2 + h, 0.0, 0.0]]
    vel = [[V, 0.0, 0.0], [0.0, 0.0, 0.0]]
    p = LubricationParams(mu=mu, flaglog=0, flagfld=0,
                          cut_inner=(r1 + r2) * 1.001,
                          cut=(r1 + r2) * 1.5, flag_hi=1)
    if backend == "dense":
        st = make_particles(pos=pos, radius=[r1, r2], density=1000.0,
                            vel=vel, n_walls=0, device=device)
        f, _ = lubrication_forces(st, p)
    else:
        cfg = DEMConfig(dt=1e-6, pair=PAIR, backend="binned", nbr_k=8,
                        max_per_bin=4, cutoff=2.0 * (r1 + r2), skin=2e-4,
                        domain_lo=(-2e-3, -2e-3, -2e-3),
                        domain_hi=(4e-3, 2e-3, 2e-3))
        st = make_particles(pos=pos, radius=[r1, r2], density=1000.0,
                            vel=vel, n_walls=0, neighbor_k=cfg.nbr_k,
                            device=device)
        st = _dem.maybe_rebuild_neighbors(st, cfg, force=True)
        f, _ = lubrication_forces_binned(st, p, st.nbr_idx)
    a_eff = r1 * r2 / (r1 + r2)
    f_taylor = 6.0 * math.pi * mu * a_eff ** 2 * V / h
    f = f.cpu().numpy()
    # particle 0 moves +x toward particle 1: film resists with -x force
    assert f[0, 0] < 0
    assert abs(-f[0, 0] - f_taylor) / f_taylor < 1e-6
    # reaction on particle 1
    assert abs(f[1, 0] - f_taylor) / f_taylor < 1e-6


@pytest.mark.parametrize("device", DEVICES)
def test_wall_volume_feeds_fld_drag(device):
    """compute_forces uses the wall-bounded V_T, not the raw box."""
    L = 8e-3
    r = 5e-4
    walls = (WallSpec(style="yplane", lo=0.0, hi=L / 2, params=PAIR),)
    lub = LubricationParams(mu=1e-3, flaglog=0, flagfld=1, flag_hi=0,
                            flag_vf=1, cut_inner=1.9 * r, cut=3 * r,
                            box_volume=L ** 3)
    cfg = DEMConfig(dt=1e-6, pair=PAIR, walls=walls, backend="dense",
                    gravity=(0.0, 0.0, 0.0), lubrication=lub,
                    domain_lo=(0.0, 0.0, 0.0), domain_hi=(L, L, L))
    st = make_particles(pos=[[L / 4, L / 4, L / 4]], radius=r,
                        density=1000.0, vel=[[0.1, 0.0, 0.0]],
                        n_walls=len(walls), device=device)
    st = _dem.setup_forces(st, cfg)
    vol_p = 4.0 / 3.0 * math.pi * r ** 3
    vf = vol_p / (L * L * (L / 2))          # wall-halved volume
    expect = -6 * math.pi * lub.mu * (1.0 + 2.16 * vf) * r * 0.1
    got = _f(st.force[0, 0])
    assert got == pytest.approx(expect, rel=1e-6)
    # and it differs from what the raw box volume would give
    vf_raw = vol_p / L ** 3
    raw = -6 * math.pi * lub.mu * (1.0 + 2.16 * vf_raw) * r * 0.1
    assert abs(got - raw) > 0.1 * abs(raw - expect)
