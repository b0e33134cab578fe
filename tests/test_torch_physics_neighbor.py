"""The reference's neighbor-table gates on sedifoam_tpu_torch alone:
tests/test_neighbor.py (all six), tests/test_periodic.py:46-115 (the
seam contact on both backends, dense = binned on a periodic packing,
the wrap, momentum through the seam, frozen types) and
tests/test_ghost_partner.py:54-80 and :120 (a deactivated partner
exerts no force on either backend, nor cohesion; the delete box's flag
and scrub), case for case: the same set-ups, step counts, assertions
and tolerances, in f64, on the CPU and (marked `cuda`) on the card.
The binned backend runs its contact chain fused (DEMConfig's default):
on the card each binned case asserts that the kernel's launch count
grew across it, and the 3,000-substep trajectories replay captured
blocks of substeps (torch_port_util.dem_stepper).

Held elsewhere: tests/test_ghost_partner.py:82 (the lattice's ghost
partner) and tests/test_lattice.py in tests/test_torch_lattice_physics.py;
tests/test_ghost_partner.py:97 (the outside-the-domain delete) in
tests/test_torch_coupling.py. The in.lammps parsing of
tests/test_periodic.py:117- is the case loader's, held against the JAX
package in tests/test_torch_case_io.py.

Runs on the port alone: nothing here imports JAX or the JAX package, so the
file runs on the card under `python -m pytest --noconftest`.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sedifoam_tpu_torch.config import (CloudConfig,  # noqa: E402
                                       CohesionParams, DEMConfig,
                                       PairParams, WallSpec)
from sedifoam_tpu_torch.dem import inject  # noqa: E402
from sedifoam_tpu_torch.dem import integrate as I  # noqa: E402
from sedifoam_tpu_torch.dem.integrate import (run_dem,  # noqa: E402
                                              setup_forces)
from sedifoam_tpu_torch.dem.neighbor import make_binner  # noqa: E402
from sedifoam_tpu_torch.dem.state import make_particles  # noqa: E402
from sedifoam_tpu_torch.grid import Grid  # noqa: E402
from torch_port_util import (DEVICES, by_tag,  # noqa: E402,F401
                             chain_kernel_ran, dem_stepper, few_threads)


def _t(a, device, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)


def _np(t):
    return t.detach().cpu().numpy()


# ---- tests/test_neighbor.py -------------------------------------------------

BOX = (0.0, 0.0, 0.0), (0.02, 0.02, 0.02)
R = 5e-4


def _random_packing(n=64, seed=0):
    rng = np.random.RandomState(seed)
    pos = rng.uniform(2 * R, 0.02 - 2 * R, size=(n, 3))
    vel = rng.randn(n, 3) * 0.05
    return pos, vel


def _configs(backend):
    pair = PairParams(style="hertz_history", kn=1e5, gamman=0.7, xmu=0.4)
    wall = WallSpec(style="yplane", lo=0.0, hi=0.02, params=pair)
    return DEMConfig(
        dt=1e-6, pair=pair, walls=(wall,), gravity=(0.0, -9.81, 0.0),
        backend=backend, nbr_k=32, max_per_bin=8,
        cutoff=2 * R * 1.6, skin=0.6 * R,
        domain_lo=BOX[0], domain_hi=BOX[1])


@pytest.mark.parametrize("device", DEVICES)
def test_binner_finds_all_contacts(device):
    pos, _ = _random_packing(128, seed=3)
    active = torch.ones(128, dtype=torch.bool, device=device)
    rebuild = make_binner(BOX[0], BOX[1], cutoff=2 * R * 1.6,
                          k_neighbors=32, max_per_bin=8)
    idx, _ = rebuild(_t(pos, device), active)
    idx = _np(idx)  # (K, N)
    # brute-force within-cutoff pairs must all appear in the table
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    np.fill_diagonal(d, 1e9)
    for i, j in zip(*np.where(d < 2 * R)):
        assert j in idx[:, i], f"missing contact {i}-{j}"


@pytest.mark.parametrize("device", DEVICES)
def test_binned_matches_dense_forces(device):
    pos, vel = _random_packing(64)
    st_d = make_particles(pos, R, 2500.0, vel=vel, n_walls=1, device=device)
    st_b = make_particles(pos, R, 2500.0, vel=vel, n_walls=1, neighbor_k=32,
                          device=device)
    cfg_d, cfg_b = _configs("dense"), _configs("binned")
    st_d = setup_forces(st_d, cfg_d)
    with chain_kernel_ran(device):
        st_b = setup_forces(st_b, cfg_b)
    fb, fd = by_tag(st_b, "force"), by_tag(st_d, "force")
    np.testing.assert_allclose(fb, fd,
                               rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(by_tag(st_b, "torque"),
                               by_tag(st_d, "torque"), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.parametrize("device", DEVICES)
def test_binned_matches_dense_trajectory(device):
    """A settling pile: both backends produce the same physics (shear
    history carried exactly across rebuilds)."""
    pos, vel = _random_packing(48, seed=7)
    st_d = make_particles(pos, R, 2500.0, vel=vel, n_walls=1, device=device)
    st_b = make_particles(pos, R, 2500.0, vel=vel, n_walls=1, neighbor_k=32,
                          device=device)
    cfg_d, cfg_b = _configs("dense"), _configs("binned")
    st_d = setup_forces(st_d, cfg_d)
    st_d = dem_stepper(cfg_d).run(st_d, 3000)
    with chain_kernel_ran(device):
        st_b = setup_forces(st_b, cfg_b)
        st_b = dem_stepper(cfg_b).run(st_b, 3000)
    np.testing.assert_allclose(by_tag(st_b, "pos"), by_tag(st_d, "pos"),
                               rtol=0, atol=1e-8)
    np.testing.assert_allclose(by_tag(st_b, "vel"), by_tag(st_d, "vel"),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("device", DEVICES)
def test_add_delete_particles(device):
    """Particle injection/deletion regions (softParticleCloud add/delete)."""
    grid = Grid(nx=8, ny=8, nz=1, dx=1e-3, dy=1e-3, dz=1e-3)
    ccfg = CloudConfig(
        add_particle=1, add_interval=0.1,
        add_box=(0.0, 8e-3, 6e-3, 8e-3, 0.0, 1e-3),
        add_info=(4e-4, 2000.0, 1), add_velocity=(0.0, -0.1, 0.0),
        random_perturb=1e-4, reduce_number_factor=1,
        delete_particle=1, delete_box=(0.0, 8e-3, 0.0, 1e-3, 0.0, 1e-3))
    sites = _t(inject.seed_positions(grid, ccfg.add_box, 1), device)
    assert sites.shape[0] == 16  # 8x2 cells in the top band

    st = make_particles([[4e-3, 4e-3, 5e-4]], 2e-4, 2000.0,
                        capacity=64, n_walls=0, device=device)
    # the reference's jax.random.PRNGKey(1): the uint32 pair (0, 1)
    st = st._replace(time_to_add=_t(0.0, device),
                     rng_key=_t([0, 1], device, torch.int64))

    st2, tta, key, _, _ = inject.maybe_add_delete(
        st, st.time_to_add, st.rng_key, sites, grid, ccfg, dt_fluid=1e-3)
    assert int(st2.active.sum()) == 17      # 1 + 16 injected
    assert float(tta) == 0.1                # countdown reset
    assert int(st2.tag.max()) == 17         # tags continue from max
    # injected velocity applied
    inj = _np(st2.active) & (_np(st2.tag) > 1)
    np.testing.assert_allclose(_np(st2.vel)[inj, 1], -0.1)

    # move a particle into the delete box -> removed on next call
    pos = st2.pos.clone()
    pos[0, 1] = 5e-4
    st3 = st2._replace(pos=pos)
    st4, _, _, _, deleted = inject.maybe_add_delete(
        st3, tta, key, sites, grid, ccfg, dt_fluid=1e-3)
    assert not bool(st4.active[0])
    assert bool(deleted)
    assert int(st4.active.sum()) == 16


@pytest.mark.parametrize("device", DEVICES)
def test_truncation_audit_counts_dropped_inring(device):
    """audit_ring arms the K-truncation audit (LAMMPS dangerous-builds
    analogue): a K too small for the packing reports exactly the number
    of in-ring partners the K-nearest selection discarded."""
    # 6 particles clustered within one ring of each other: each sees 5
    pos = np.asarray([[0.0, 0.0, 0.0]] * 6) + \
        np.asarray([[0.0, 0, 0], [1.05, 0, 0], [-1.05, 0, 0],
                    [0, 1.05, 0], [0, -1.05, 0], [0, 0, 1.05]]) * 2 * R
    pos += 0.01  # keep inside BOX
    active = torch.ones(6, dtype=torch.bool, device=device)
    ring = 2 * R * 1.3
    mk = lambda k: make_binner(BOX[0], BOX[1], cutoff=2 * R * 1.6,  # noqa
                               k_neighbors=k, max_per_bin=8,
                               audit_ring=ring)
    # count in-ring partners per particle by brute force
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    np.fill_diagonal(d, 1e9)
    inring = (d < ring).sum(axis=1)
    assert inring.max() >= 3  # the cluster is actually dense
    _, dropped_ok = mk(int(inring.max()))(_t(pos, device), active)
    assert int(dropped_ok) == 0
    k_small = 2
    _, dropped = mk(k_small)(_t(pos, device), active)
    assert int(dropped) == int(np.maximum(inring - k_small, 0).sum())
    # audit disarmed -> always 0
    mk0 = make_binner(BOX[0], BOX[1], cutoff=2 * R * 1.6,
                      k_neighbors=k_small, max_per_bin=8)
    _, d0 = mk0(_t(pos, device), active)
    assert int(d0) == 0


@pytest.mark.parametrize("device", DEVICES)
def test_density_sized_k8_matches_dense_on_benchlike_bed(device):
    """The headline bench runs K=8 (density-sized, audit-verified) on a
    just-touching jittered simple-cubic bed; prove the K=8 table gives
    the dense backend's forces exactly and the audit stays clean."""
    rng = np.random.RandomState(7)
    pitch = 2.02 * R
    nx = 6
    ii = np.arange(nx ** 3)
    pos = np.stack([2 * R + (ii % nx) * pitch,
                    2 * R + ((ii // nx) % nx) * pitch,
                    2 * R + (ii // nx ** 2) * pitch], axis=1)
    pos += rng.uniform(-0.05 * R, 0.05 * R, pos.shape)
    vel = rng.randn(len(pos), 3) * 0.02
    pair = PairParams(style="hertz_history", kn=1e5, gamman=0.7, xmu=0.4)
    common = dict(dt=1e-6, pair=pair, gravity=(0.0, -9.81, 0.0),
                  cutoff=2 * R * 1.6, skin=0.6 * R,
                  domain_lo=BOX[0], domain_hi=BOX[1])
    cfg_d = DEMConfig(backend="dense", **common)
    cfg_b = DEMConfig(backend="binned", nbr_k=8, max_per_bin=10,
                      audit_ring=2 * R + 0.6 * R, **common)
    st_d = make_particles(pos, R, 2500.0, vel=vel, n_walls=0, device=device)
    st_b = make_particles(pos, R, 2500.0, vel=vel, n_walls=0, neighbor_k=8,
                          device=device)
    st_d = run_dem(setup_forces(st_d, cfg_d), cfg_d, 50)
    with chain_kernel_ran(device):
        st_b = run_dem(setup_forces(st_b, cfg_b), cfg_b, 50)
    assert int(st_b.nbr_dropped) == 0
    fd = _np(st_d.force)
    np.testing.assert_allclose(_np(st_b.force), fd,
                               rtol=0, atol=1e-10 * float(
                                   np.abs(fd).max() + 1e-30))
    np.testing.assert_allclose(_np(st_b.pos), _np(st_d.pos))


# ---- tests/test_periodic.py:46-115 ------------------------------------------

PAIR = PairParams(style="hertz_history", kn=1e5, gamman=0.7, xmu=0.5)
L = 1.0e-2  # box length per axis


def _cfg(backend, periodic=(True, False, False), **kw):
    args = dict(dt=1e-6, pair=PAIR, gravity=(0.0, 0.0, 0.0),
                backend=backend, nbr_k=8, max_per_bin=6,
                cutoff=2.5e-3, skin=5e-4,
                domain_lo=(0.0, 0.0, 0.0), domain_hi=(L, L, L),
                periodic=periodic)
    args.update(kw)
    return DEMConfig(**args)


def _two_across_seam(backend, device):
    """Two particles overlapping only through the x seam."""
    r = 1e-3
    pos = np.array([[0.0005, 0.005, 0.005],     # near x=0
                    [L - 0.0006, 0.005, 0.005]])  # near x=L
    # moving toward each other THROUGH the seam
    vel = np.array([[-0.05, 0.0, 0.0], [0.05, 0.0, 0.0]])
    cfg = _cfg(backend)
    parts = make_particles(pos=pos, radius=r, density=2000.0, vel=vel,
                           n_walls=0,
                           neighbor_k=cfg.nbr_k if backend == "binned"
                           else None, device=device)
    return parts, cfg


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("backend", ["dense", "binned"])
def test_seam_contact_force(backend, device):
    parts, cfg = _two_across_seam(backend, device)
    with chain_kernel_ran(device, backend == "binned"):
        parts = I.setup_forces(parts, cfg)
    f = _np(parts.force)
    # gap through the seam = 0.0011 < 2r = 0.002: overlapping -> repulsion
    # pushes particle 0 in +x (away from the seam) and particle 1 in -x
    assert f[0, 0] > 0.0, f
    assert f[1, 0] < 0.0, f
    np.testing.assert_allclose(f[0], -f[1], rtol=1e-12)


@pytest.mark.parametrize("device", DEVICES)
def test_dense_binned_equivalence_periodic(device):
    """A random periodic packing: both backends produce identical forces."""
    rng = np.random.RandomState(3)
    n = 40
    pos = rng.uniform(0.0, L, size=(n, 3))
    vel = rng.uniform(-0.02, 0.02, size=(n, 3))
    out = {}
    for backend in ("dense", "binned"):
        cfg = _cfg(backend, periodic=(True, True, True))
        parts = make_particles(pos=pos, radius=8e-4, density=2500.0, vel=vel,
                               n_walls=0,
                               neighbor_k=cfg.nbr_k if backend == "binned"
                               else None, device=device)
        with chain_kernel_ran(device, backend == "binned"):
            parts = I.setup_forces(parts, cfg)
            parts = I.run_dem(parts, cfg, 20)
        out[backend] = tuple(by_tag(parts, "pos", "vel"))
    np.testing.assert_allclose(out["dense"][0], out["binned"][0],
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(out["dense"][1], out["binned"][1],
                               rtol=0, atol=1e-9)


@pytest.mark.parametrize("device", DEVICES)
def test_position_wrap(device):
    cfg = _cfg("dense", periodic=(True, False, False),
               pair=PairParams(style="none"))
    pos = np.array([[L - 1e-4, 0.005, 0.005]])
    parts = make_particles(pos=pos, radius=1e-3, density=2000.0,
                           vel=np.array([[1.0, 0.0, 0.0]]), n_walls=0,
                           device=device)
    parts = I.setup_forces(parts, cfg)
    parts = I.run_dem(parts, cfg, 300)  # travels 3e-4 m, crosses seam
    x = float(parts.pos[0, 0])
    assert 0.0 <= x < L
    assert abs(x - 2e-4) < 1e-8


@pytest.mark.parametrize("device", DEVICES)
def test_momentum_conserved_through_seam(device):
    parts, cfg = _two_across_seam("dense", device)
    parts = I.setup_forces(parts, cfg)
    p0 = _np(torch.sum(parts.vel * parts.mass[:, None], dim=0))
    parts = I.run_dem(parts, cfg, 200)
    p1 = _np(torch.sum(parts.vel * parts.mass[:, None], dim=0))
    np.testing.assert_allclose(p0, p1, atol=1e-14)


@pytest.mark.parametrize("device", DEVICES)
def test_frozen_types(device):
    cfg = _cfg("dense", periodic=(False, False, False),
               gravity=(0.0, -9.81, 0.0), frozen_types=(2,))
    pos = np.array([[0.005, 0.006, 0.005],   # type 1, falls
                    [0.005, 0.002, 0.005]])  # type 2, frozen
    parts = make_particles(pos=pos, radius=1e-3, density=2000.0,
                           ptype=[1, 2], n_walls=0, device=device)
    parts = I.setup_forces(parts, cfg)
    parts = I.run_dem(parts, cfg, 100)
    assert float(parts.vel[0, 1]) < 0.0          # falling
    np.testing.assert_allclose(_np(parts.pos[1]), pos[1], atol=0.0)
    np.testing.assert_allclose(_np(parts.vel[1]), 0.0, atol=0.0)


# ---- tests/test_ghost_partner.py:54-80, :120 --------------------------------

def _touching_pair(backend, device, k=8):
    pair = PairParams(style="hertz_history", kn=1e5, gamman=0.5, xmu=0.3)
    d = 1e-3
    cfg = DEMConfig(dt=1e-6, pair=pair, walls=(),
                    gravity=(0.0, 0.0, 0.0), backend=backend,
                    nbr_k=k, max_per_bin=8, cutoff=2.5 * d, skin=0.5 * d,
                    domain_lo=(0.0, 0.0, 0.0),
                    domain_hi=(16 * d, 16 * d, 16 * d))
    # overlapping pair in the middle + a far bystander
    pos = np.array([[8e-3, 8e-3, 8e-3],
                    [8e-3 + 0.9 * d, 8e-3, 8e-3],
                    [2e-3, 2e-3, 2e-3]])
    st = make_particles(pos=pos, radius=0.5 * d, density=2500.0,
                        capacity=4, n_walls=0,
                        neighbor_k=k if backend == "binned" else None,
                        dtype=torch.float64, device=device)
    return st, cfg


def _deactivate(st, cfg, i):
    """Flip one particle off the way the delete paths do: mask flip +
    table scrub (no rebuild)."""
    active = st.active.clone()
    active[i] = False
    return I.scrub_deactivated(st._replace(active=active), cfg)


@pytest.mark.parametrize("device", DEVICES)
@pytest.mark.parametrize("backend", ["binned", "dense"])
def test_deactivated_partner_exerts_no_force(backend, device):
    st, cfg = _touching_pair(backend, device)
    with chain_kernel_ran(device, backend == "binned"):
        st = I.setup_forces(st, cfg)
        f0 = _np(st.force)
        assert np.abs(f0[0]).max() > 0.0          # in contact

        # deactivate particle 1 WITHOUT a rebuild (stale table entry)
        st2 = _deactivate(st, cfg, 1)
        st2 = I.compute_forces(st2, cfg, shearupdate=True)
    f2 = _np(st2.force)
    assert np.abs(f2[0]).max() == 0.0, \
        f"ghost partner still pushes: {f2[0]}"
    assert np.abs(f2[1]).max() == 0.0          # inactive row zeroed


@pytest.mark.parametrize("device", DEVICES)
def test_deactivated_partner_no_cohesion_or_lubrication(device):
    st, cfg = _touching_pair("binned", device)
    cfg = dataclasses.replace(
        cfg, cohesion=CohesionParams(ah=1e-19, lam=100e-9,
                                     smin=1e-9, smax=1e-4, model=0))
    with chain_kernel_ran(device):
        st = I.setup_forces(st, cfg)
        assert np.abs(_np(st.force)[0]).max() > 0.0
        st2 = _deactivate(st, cfg, 1)
        st2 = I.compute_forces(st2, cfg, shearupdate=True)
    assert np.abs(_np(st2.force)[0]).max() == 0.0


@pytest.mark.parametrize("device", DEVICES)
def test_delete_box_scrubs_table(device):
    """The delete-region path (inject.maybe_add_delete) reports the
    deletion so the caller scrubs; the evolve wiring does this under
    graphs.cond — here we exercise the flag + scrub pair directly."""
    st, cfg = _touching_pair("binned", device)
    # the reference's jax.random.PRNGKey(0): the uint32 pair (0, 0)
    st = st._replace(time_to_add=_t(1e9, device),
                     rng_key=_t([0, 0], device, torch.int64))
    with chain_kernel_ran(device):
        st = I.setup_forces(st, cfg)
        assert np.abs(_np(st.force)[0]).max() > 0.0

        grid = Grid(nx=16, ny=16, nz=16, dx=1e-3, dy=1e-3, dz=1e-3)
        d = 1e-3
        ccfg = CloudConfig(delete_particle=1,
                           delete_box=(8e-3 + 0.5 * d, 16e-3,
                                       0.0, 16e-3, 0.0, 16e-3))
        st2, _, _, added, deleted = inject.maybe_add_delete(
            st, st.time_to_add, st.rng_key,
            torch.zeros((0, 3), dtype=torch.float64, device=device), grid,
            ccfg, dt_fluid=1e-4)
        assert bool(deleted) and not bool(added)
        assert not bool(st2.active[1])
        st2 = I.scrub_deactivated(st2, cfg)
        st2 = I.compute_forces(st2, cfg, shearupdate=True)
    assert np.abs(_np(st2.force)[0]).max() == 0.0
