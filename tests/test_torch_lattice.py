"""The lattice DEM backend of sedifoam_tpu_torch (dem/lattice.py and its
wiring) against sedifoam_tpu, in f64 on the CPU, from the same
numpy-seeded inputs:

- make_geom / geom_offsets on periodic axes of 1, 2 and n bins, and
  bin_slots (slot table and overflow count): exactly;
- _halo_exchange / _halo_fold / pack_fields / _halo_fields: exactly;
- lattice_pair_forces (force, torque, new shear): 1e-12 of each field's
  scale;
- carry_shear_lattice on a state with contacts across the periodic seam
  and on one whose |shear| ties at the top-k cut: 1e-12 of its scale;
- make_particles(lattice_geom=...), load_case(xiaocase3, "lattice") (M
  and the state), the scrub of a deactivated partner: exactly;
- three coupled steps of __graft_entry__._tiny_case(backend="lattice")
  and of its counterpart built here from the port's modules: 1e-12 of
  each field's scale;
- a lattice checkpoint saved by one package and loaded by the other:
  exactly;
- the lattice step under graphs.host_reads_forbidden, the CPU's
  stand-in for a capture.

tests/test_torch_lattice_physics.py runs the reference's lattice physics
on the port alone and the lattice through the bench and run_case.
"""

import dataclasses
import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu import config as jcfg  # noqa: E402
from sedifoam_tpu.dem import integrate as jint  # noqa: E402
from sedifoam_tpu.dem import lattice as jlat  # noqa: E402
from sedifoam_tpu.dem.state import make_particles as jmake  # noqa: E402
from sedifoam_tpu.io import case as jcase  # noqa: E402
from sedifoam_tpu.runtime import checkpoint as jckpt  # noqa: E402
from sedifoam_tpu.runtime import diagnostics as jdiag  # noqa: E402
from sedifoam_tpu.solver import coupled_step as jcoupled  # noqa: E402
from sedifoam_tpu_torch import bridge, cases, graphs  # noqa: E402
from sedifoam_tpu_torch import config as tcfg  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.dem import integrate as tint  # noqa: E402
from sedifoam_tpu_torch.dem import lattice as tlat  # noqa: E402
from sedifoam_tpu_torch.dem.state import make_particles as tmake  # noqa: E402
from sedifoam_tpu_torch.fluid.state import init_fluid  # noqa: E402
from sedifoam_tpu_torch.io import case as tcase  # noqa: E402
from sedifoam_tpu_torch.runtime import checkpoint as tckpt  # noqa: E402
from sedifoam_tpu_torch.runtime import diagnostics as tdiag  # noqa: E402
from torch_port_cases import port_config  # noqa: E402
from torch_port_util import (assert_tree_close, few_threads,  # noqa: E402,F401
                             rel_err)

TOL = 1e-12
L = 1.0e-2
R = 5e-4
PERIODICITIES = [(False, False, False), (True, False, True),
                 (True, True, True)]

_ge = importlib.import_module("__graft_entry__")
# the reference's coupled step, jitted once per config for the module
_J_STEPS = {}


def _jstep(cfg):
    if cfg not in _J_STEPS:
        _J_STEPS[cfg] = jax.jit(lambda s: jcoupled(s, cfg))
    return _J_STEPS[cfg]


def _cfgs(backend="lattice", periodic=(False, False, False), **kw):
    """tests/test_lattice.py's DEMConfig in both packages."""
    out = []
    for m in (jcfg, tcfg):
        args = dict(dt=1e-6,
                    pair=m.PairParams(style="hertz_history", kn=1e5,
                                      gamman=0.7, xmu=0.5),
                    gravity=(0.0, -9.81, 0.0), backend=backend, nbr_k=16,
                    max_per_bin=6, cutoff=1.7e-3, skin=4e-4,
                    domain_lo=(0.0, 0.0, 0.0), domain_hi=(L, L, L),
                    periodic=periodic)
        args.update({k: (v(m) if callable(v) else v) for k, v in kw.items()})
        out.append(m.DEMConfig(**args))
    return out


def _packing(n=60, seed=0, spread=0.9):
    rng = np.random.RandomState(seed)
    pos = rng.uniform((1 - spread) / 2 * L, (1 + spread) / 2 * L,
                      size=(n, 3))
    vel = rng.uniform(-0.05, 0.05, size=(n, 3))
    rad = rng.uniform(0.8 * R, 1.2 * R, size=n)
    return pos, vel, rad


def _tparts(cfg, pos, vel, rad, **kw):
    geom = tlat.make_geom(cfg) if cfg.backend == "lattice" else None
    return tmake(pos=pos, radius=rad, density=2500.0, vel=vel, n_walls=0,
                 lattice_geom=geom,
                 neighbor_k=cfg.nbr_k if cfg.backend == "binned" else None,
                 device="cpu", **kw)


def _jparts(cfg, pos, vel, rad, **kw):
    geom = jlat.make_geom(cfg) if cfg.backend == "lattice" else None
    return jmake(pos=pos, radius=rad, density=2500.0, vel=vel, n_walls=0,
                 lattice_geom=geom,
                 neighbor_k=cfg.nbr_k if cfg.backend == "binned" else None,
                 dtype=jnp.float64, **kw)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _eq(a, b):
    np.testing.assert_array_equal(_np(a), _np(b))


# -- geometry, slots, halos (exact) -----------------------------------------

@pytest.mark.parametrize("hi,periodic", [
    ((L, L, L), (False, False, False)),
    ((1.2 * 1.7e-3, 2.5 * 1.7e-3, L), (True, True, True)),
    ((1.2 * 1.7e-3, 2.5 * 1.7e-3, L), (True, False, True)),
    ((L, 2.5 * 1.7e-3, 1.2 * 1.7e-3), (False, True, True))])
def test_geom_and_offsets_match_reference(hi, periodic):
    """1-, 2- and n-bin periodic axes drop the duplicate images alike."""
    assert tlat.HALF_OFFSETS == jlat.HALF_OFFSETS and \
        tlat.NOFF == jlat.NOFF == 14
    jc, tc = _cfgs(periodic=periodic, domain_hi=hi)
    jg, tg = jlat.make_geom(jc), tlat.make_geom(tc)
    assert dataclasses.astuple(jg) == dataclasses.astuple(tg)
    assert jg.padded == tg.padded and jg.S == tg.S
    offs = tlat.geom_offsets(tg)
    assert offs == jlat.geom_offsets(jg)
    assert [tg.flat_delta(o) for o in offs] == \
        [jg.flat_delta(o) for o in offs]
    _eq(tlat.real_bin_mask(tg), jlat.real_bin_mask(jg))
    _eq(tlat._real_mask(tg, torch.device("cpu")), jlat.real_bin_mask(jg))
    n_small = [a for a in range(3) if periodic[a] and tg.nb[a] <= 2]
    assert len(offs) < 14 if n_small else len(offs) == 14


def test_bin_slots_match_reference_exactly():
    """A clustered bed with inactive rows and bins fuller than M: the
    slot table (stable order within a bin) and the overflow count."""
    rng = np.random.RandomState(3)
    pos = np.concatenate([rng.uniform(0.0, L, (50, 3)),
                          rng.uniform(0.3 * L, 0.36 * L, (30, 3)),
                          np.full((4, 3), 0.5 * L)])
    active = rng.rand(len(pos)) > 0.1
    for periodic in PERIODICITIES:
        jc, tc = _cfgs(periodic=periodic, max_per_bin=3)
        js, jo = jlat.bin_slots(jlat.make_geom(jc), jnp.asarray(pos),
                                jnp.asarray(active))
        ts, to = tlat.bin_slots(tlat.make_geom(tc), torch.as_tensor(pos),
                                torch.as_tensor(active))
        assert ts.dtype == torch.int32 and int(jo) > 0
        _eq(ts, js)
        assert int(to) == int(jo)


@pytest.mark.parametrize("hi,periodic", [
    ((L, L, L), (True, True, True)),
    ((1.2 * 1.7e-3, 2.5 * 1.7e-3, 3.5 * 1.7e-3), (True, True, True)),
    ((L, 1.2 * 1.7e-3, L), (True, True, False))])
def test_halos_and_packing_match_reference_exactly(hi, periodic):
    """_halo_exchange on int and float arrays with leading axes,
    _halo_fold including the single-real-layer case (3 padded bins),
    pack_fields and _halo_fields (the +-L wrap of ghost coordinates)."""
    jc, tc = _cfgs(periodic=periodic, domain_hi=hi, max_per_bin=4)
    jg, tg = jlat.make_geom(jc), tlat.make_geom(tc)
    rng = np.random.RandomState(5)
    ints = rng.randint(0, 99, size=(4, tg.S)).astype(np.int32)
    floats = rng.randn(3, 2, 4, tg.S)
    for a in (ints, floats):
        _eq(tlat._halo_exchange(torch.as_tensor(a), tg),
            jlat._halo_exchange(jnp.asarray(a), jg))
        _eq(tlat._halo_fold(torch.as_tensor(a), tg),
            jlat._halo_fold(jnp.asarray(a), jg))
    n = 40
    pos = rng.uniform(0.0, 1.0, (n, 3)) * np.asarray(hi)
    vel, rad = rng.randn(n, 3), rng.uniform(0.8 * R, 1.2 * R, n)
    jp, tp = _jparts(jc, pos, vel, rad), _tparts(tc, pos, vel, rad)
    js, _ = jlat.bin_slots(jg, jp.pos, jp.active)
    ts, _ = tlat.bin_slots(tg, tp.pos, tp.active)
    jf, jh = jlat._halo_fields(*jlat.pack_fields(jp, js, jg), jg)
    tf, th = tlat._halo_fields(*tlat.pack_fields(tp, ts, tg), tg)
    _eq(th, jh)
    assert set(tf) == set(jf)
    for k in jf:
        _eq(tf[k], jf[k])


# -- forces and the carry against the reference ----------------------------

def _slotted(jc, tc, pos, vel, rad, seed=0, shear_scale=1e-6):
    """Both packages' particles on the lattice, slotted, with the same
    random shear history on every key (non-contacts get it zeroed)."""
    jg, tg = jlat.make_geom(jc), tlat.make_geom(tc)
    jp = _jparts(jc, pos, vel, rad)
    tp = _tparts(tc, pos, vel, rad)
    jp = jp._replace(nbr_idx=jlat.bin_slots(jg, jp.pos, jp.active)[0])
    tp = tp._replace(nbr_idx=tlat.bin_slots(tg, tp.pos, tp.active)[0])
    sh = shear_scale * np.random.RandomState(seed).randn(*tp.shear.shape)
    return (jp._replace(shear=jnp.asarray(sh)),
            tp._replace(shear=torch.as_tensor(sh)), jg, tg)


@pytest.mark.parametrize("periodic", PERIODICITIES)
@pytest.mark.parametrize("shearupdate", [True, False])
def test_pair_forces_match_reference(periodic, shearupdate):
    pos, vel, rad = _packing(seed=1, spread=1.0 if any(periodic) else 0.9)
    jc, tc = _cfgs(periodic=periodic)
    jp, tp, jg, tg = _slotted(jc, tc, pos, vel, rad)
    jf, jt, js = jlat.lattice_pair_forces(jp, jc, jg, jp.nbr_idx, jp.shear,
                                          shearupdate)
    tf, tt, ts = tlat.lattice_pair_forces(tp, tc, tg, tp.nbr_idx, tp.shear,
                                          shearupdate)
    assert np.abs(np.asarray(jf)).max() > 0
    assert rel_err(jf, tf) <= TOL and rel_err(jt, tt) <= TOL
    assert rel_err(js, ts) <= TOL


def _seam_state(jc, tc):
    """A periodic bed packed against both x faces and stepped 20
    substeps in the port, so contacts across the seam carry history."""
    rng = np.random.RandomState(11)
    n = 70
    pos = rng.uniform(0.0, L, (n, 3))
    pos[:40, 0] = np.where(np.arange(40) % 2 == 0,
                           rng.uniform(0.0, 1.2e-3, 40),
                           rng.uniform(L - 1.2e-3, L, 40))
    vel = rng.uniform(-0.3, 0.3, (n, 3))
    rad = rng.uniform(0.8 * R, 1.2 * R, n)
    tp = tint.setup_forces(_tparts(tc, pos, vel, rad), tc)
    tp = tint.run_dem(tp, tc, 20)
    jp = jmake(pos=pos, radius=rad, density=2500.0, n_walls=0,
               lattice_geom=jlat.make_geom(jc), dtype=jnp.float64)
    jp = jp._replace(**{k: jnp.asarray(getattr(tp, k).numpy())
                        for k in ("pos", "vel", "omega", "shear",
                                  "nbr_idx")})
    return jp, tp


def test_carry_across_the_seam_matches_reference():
    jc, tc = _cfgs(periodic=(True, True, True))
    jg, tg = jlat.make_geom(jc), tlat.make_geom(tc)
    jp, tp = _seam_state(jc, tc)
    # a contact across the x seam holds history: partners in the first
    # and last real x layers
    slot = tp.nbr_idx.numpy()
    x_of_bin = np.unravel_index(np.arange(tg.S), tg.padded)[0]
    ok = (slot < tp.n_capacity)
    first = set(slot[ok & (x_of_bin[None] == 1)])
    last = set(slot[ok & (x_of_bin[None] == tg.nb[0])])
    pos = tp.pos.numpy()
    d = pos[:, None, :] - pos[None, :, :]
    d -= L * np.round(d / L)
    r = tp.radius.numpy()
    touch = np.linalg.norm(d, axis=-1) < r[:, None] + r[None, :]
    assert any(touch[i, j] for i in first for j in last)
    assert np.abs(tp.shear.numpy()).max() > 0
    # moved: every particle drifts by up to a bin
    shift = np.random.RandomState(2).uniform(-1.2e-3, 1.2e-3, pos.shape)
    new = np.mod(pos + shift, L)
    js, _ = jlat.bin_slots(jg, jnp.asarray(new), jp.active)
    ts, _ = tlat.bin_slots(tg, torch.as_tensor(new), tp.active)
    _eq(ts, js)
    for kc in (16, 4):
        ref = jlat.carry_shear_lattice(jp.nbr_idx, js, jp.shear, jg,
                                       jp.n_capacity, k_compact=kc)
        got = tlat.carry_shear_lattice(tp.nbr_idx, ts, tp.shear, tg,
                                       tp.n_capacity, k_compact=kc)
        assert np.abs(np.asarray(ref)).max() > 0
        assert rel_err(ref, got) <= TOL


def test_carry_with_tied_shear_matches_reference():
    """Every contact holds the same |shear|, and particles have more
    contacts than k_compact keeps: which ties survive the cut is the
    order of lax.top_k (lower index first), kept by the stable sort."""
    jc, tc = _cfgs(periodic=(True, False, True))
    jg, tg = jlat.make_geom(jc), tlat.make_geom(tc)
    rng = np.random.RandomState(4)
    g = np.stack(np.meshgrid(*[np.arange(6)] * 3, indexing="ij"),
                 -1).reshape(-1, 3)
    pos = 1.5e-3 + 0.95e-3 * g + rng.uniform(-2e-5, 2e-5, g.shape)
    rad = np.full(len(pos), R)
    vel = rng.uniform(-0.05, 0.05, pos.shape)
    jp, tp, _, _ = _slotted(jc, tc, pos, vel, rad)
    # contacts get the same shear vector, up to the Newton sign
    _, _, sh = tlat.lattice_pair_forces(tp, tc, tg, tp.nbr_idx,
                                        torch.zeros_like(tp.shear), True)
    touching = (sh != 0).any(dim=0, keepdim=True)
    tied = torch.where(touching, torch.tensor([1e-6, -2e-6, 3e-6],
                                              dtype=sh.dtype
                                              ).reshape(3, 1, 1, 1, 1),
                       torch.zeros_like(sh))
    assert int(touching.sum()) > len(pos)       # > 2 contacts a particle
    new = pos + rng.uniform(-3e-4, 3e-4, pos.shape)
    js, _ = jlat.bin_slots(jg, jnp.asarray(new), jp.active)
    ts, _ = tlat.bin_slots(tg, torch.as_tensor(new), tp.active)
    carried = {}
    for kc in (16, 3, 2):
        ref = jlat.carry_shear_lattice(jp.nbr_idx, js,
                                       jnp.asarray(tied.numpy()), jg,
                                       jp.n_capacity, k_compact=kc)
        got = tlat.carry_shear_lattice(tp.nbr_idx, ts, tied, tg,
                                       tp.n_capacity, k_compact=kc)
        assert rel_err(ref, got) <= TOL
        carried[kc] = int((np.asarray(ref) != 0).any(axis=0).sum())
    # the cuts at 3 and 2 dropped tied contacts that 16 keeps
    assert carried[2] < carried[3] < carried[16]


# -- the state, the loader, the step --------------------------------------

def test_make_particles_and_scrub_match_reference():
    jc, tc = _cfgs(periodic=(True, False, True))
    pos, vel, rad = _packing(n=30, seed=6)
    jp = _jparts(jc, pos, vel, rad, capacity=36)
    tp = _tparts(tc, pos, vel, rad, capacity=36)
    assert tuple(tp.shear.shape) == \
        (3, len(tlat.geom_offsets(tlat.make_geom(tc))), 6, 6,
         tlat.make_geom(tc).S)
    assert bool((tp.nbr_idx == 36).all()) and tp.nbr_idx.dtype == torch.int32
    assert_tree_close(bridge.tree_to_numpy(jp), bridge.tree_to_numpy(tp), 0.0)
    for make, kw, geom in ((jmake, {"dtype": jnp.float64},
                            jlat.make_geom(jc)),
                           (tmake, {"device": "cpu"}, tlat.make_geom(tc))):
        with pytest.raises(NotImplementedError, match="rigid clumps"):
            make(pos=pos, radius=rad, density=2500.0, n_walls=0,
                 mol=np.arange(30) // 3 + 1, lattice_geom=geom, **kw)
    # a deactivated particle leaves the slot table at the scrub
    jp = jint.maybe_rebuild_neighbors(jp, jc, force=True)
    tp = tint.maybe_rebuild_neighbors(tp, tc, force=True)
    jp = jint.scrub_deactivated(jp._replace(active=jp.active.at[4].set(
        False)), jc)
    act = tp.active.clone()
    act[4] = False
    tp = tint.scrub_deactivated(tp._replace(active=act), tc)
    _eq(tp.nbr_idx, jp.nbr_idx)
    assert not bool((tp.nbr_idx == 4).any())


def test_load_case_xiaocase3_lattice_matches_reference(tmp_path):
    path = cases.write_xiaocase3(str(tmp_path / "xiaocase3"))
    cj, fj, pj, _ = jcase.load_case(path, backend="lattice")
    ct, ft, pt, _ = tcase.load_case(path, backend="lattice", device="cpu")
    assert ct.dem.backend == "lattice"
    assert ct.dem.max_per_bin == cj.dem.max_per_bin == 4     # 1 + 2, >= 4
    assert ct == port_config(cj)
    assert_tree_close(bridge.tree_to_numpy(fj), bridge.tree_to_numpy(ft), 0.0)
    assert_tree_close(bridge.tree_to_numpy(pj), bridge.tree_to_numpy(pt), 0.0)


def _tiny_port(backend, cfg_j):
    """__graft_entry__._tiny_case built from the port's modules: the
    config rebuilt from the port's classes, the same seeded particles,
    the port's make_particles, init_fluid and initialize."""
    cfg = port_config(cfg_j)
    g = cfg.grid
    pos = np.random.RandomState(0).uniform(
        [1e-3, 1e-3, 1e-3], [g.nx * 1e-3 - 1e-3, g.ny * 5e-4,
                             g.nz * 1e-3 - 1e-3], size=(64, 3))
    parts = tmake(pos=pos, radius=2.5e-4, density=2500.0, capacity=64,
                  n_walls=len(cfg.dem.walls), device="cpu",
                  lattice_geom=tlat.make_geom(cfg.dem)
                  if backend == "lattice" else None,
                  neighbor_k=cfg.dem.nbr_k if backend == "binned" else None)
    Ub = np.zeros((3,) + g.shape)
    Ub[1] = 0.02
    fluid = init_fluid(g, Ub=Ub, dtype=torch.float64, device="cpu")
    return cfg, tsolver.initialize(fluid, parts, cfg)


@pytest.fixture(scope="module")
def tiny():
    cfg_j, st_j = _ge._tiny_case(nx=8, ny=8, nz=8, n_particles=64,
                                 sub_steps=2, backend="lattice",
                                 dtype=jnp.float64)
    cfg_t, st_t = _tiny_port("lattice", cfg_j)
    return cfg_j, st_j, cfg_t, st_t


def test_tiny_case_three_coupled_steps_match_reference(tiny):
    cfg_j, st_j, cfg_t, st_t = tiny
    assert_tree_close(bridge.sim_state_to_numpy(st_j),
                      bridge.sim_state_to_numpy(st_t), TOL)
    step_j = _jstep(cfg_j)
    step_t = tsolver.make_step_fn(cfg_t, n_sub=1, device="cpu")
    for _ in range(3):
        st_j, st_t = step_j(st_j), step_t(st_t)
    worst = assert_tree_close(bridge.sim_state_to_numpy(st_j),
                              bridge.sim_state_to_numpy(st_t), TOL)
    assert worst <= TOL
    dj = jdiag.compute(st_j, cfg_j.grid, cfg_j.fluid, cfg_j.dem)
    dt = tdiag.to_host(tdiag.compute(st_t, cfg_t.grid, cfg_t.fluid,
                                     cfg_t.dem))
    assert dt["lattice_unslotted"] == int(dj["lattice_unslotted"]) == 0


def test_lattice_checkpoint_crosses_both_ways(tiny, tmp_path):
    cfg_j, st_j, cfg_t, st_t = tiny
    path = str(tmp_path / "j.npz")
    jckpt.save(path, st_j)
    template = graphs.tree_map(torch.zeros_like, st_t)
    loaded = tckpt.load(path, template)
    assert tuple(loaded.particles.shear.shape) == \
        tuple(st_j.particles.shear.shape)
    assert_tree_close(bridge.sim_state_to_numpy(st_j),
                      bridge.sim_state_to_numpy(loaded), 0.0)
    path = str(tmp_path / "t.npz")
    tckpt.save(path, st_t)
    back = jckpt.load(path, st_j)
    assert_tree_close(bridge.sim_state_to_numpy(st_t),
                      bridge.sim_state_to_numpy(back), 0.0)


def test_lattice_step_runs_without_host_reads(tiny):
    """The coupled lattice step with a rebuild in every substep (skin
    0) under host_reads_forbidden: the rebuild's cond is the only
    decision, so the step would capture."""
    _, _, cfg_t, st_t = tiny
    cfg = dataclasses.replace(cfg_t, dem=dataclasses.replace(
        cfg_t.dem, skin=0.0))
    step = tsolver.CoupledStep(cfg, device="cpu")
    ref = step(st_t)
    with graphs.host_reads_forbidden():
        got = step(st_t)
    assert_tree_close(bridge.sim_state_to_numpy(ref),
                      bridge.sim_state_to_numpy(got), 0.0)


