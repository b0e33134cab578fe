"""The port's particle injection (dem/inject.py) against sedifoam_tpu, on
the CPU.

- threefry split/uniform: bit for bit against jax.random.split and
  jax.random.uniform (raw uint32 keys, jax's default partitionable
  threefry), f32 and f64;
- seed_positions: equal arrays;
- add_particles and maybe_add_delete on one f64 state (an add that fires,
  one that does not, the delete box, a capacity-limited add): every
  field equal to the reference's, bit for bit;
- evolve() with injection on the tests/test_window.py column: 1e-10
  relative to each field's scale (measured: 4.3e-16).
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu.coupling import cloud as jcloud  # noqa: E402
from sedifoam_tpu.dem import inject as jinj  # noqa: E402
from sedifoam_tpu_torch import bridge  # noqa: E402
from sedifoam_tpu_torch.coupling import cloud as tcloud  # noqa: E402
from sedifoam_tpu_torch.dem import inject as tinj  # noqa: E402
from torch_port_cases import f64, port_config, window_case  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import assert_tree_close, particles_to_torch  # noqa: E402

KEYS = [0, 1, 42, 2 ** 31 + 7, 2 ** 32 - 1]


def _keys(seed):
    kj = jax.random.PRNGKey(seed)
    return kj, torch.as_tensor(np.asarray(kj).astype(np.int64))


@pytest.mark.parametrize("seed", KEYS)
def test_threefry_split_bitwise(seed):
    kj, kt = _keys(seed)
    for num in (2, 3, 8):
        ref = np.asarray(jax.random.split(kj, num))
        got = tinj.split(kt, num).numpy()
        assert ref.dtype == np.uint32 and got.dtype == np.int64
        np.testing.assert_array_equal(ref.astype(np.int64), got)


@pytest.mark.parametrize("seed", KEYS)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_threefry_uniform_bitwise(seed, dtype):
    kj, kt = _keys(seed)
    for shape in ((1,), (5,), (7, 3), (1024, 3)):
        ref = np.asarray(jax.random.uniform(kj, shape, getattr(jnp, dtype)))
        got = tinj.uniform(kt, shape, getattr(torch, dtype)).numpy()
        assert ref.dtype == got.dtype and ref.shape == got.shape
        np.testing.assert_array_equal(ref.view(np.uint8), got.view(np.uint8))
    # the chain the injector runs: split, then draw from the first key
    ka, _ = jax.random.split(kj)
    np.testing.assert_array_equal(
        np.asarray(jax.random.uniform(ka, (9, 3), getattr(jnp, dtype))),
        tinj.uniform(tinj.split(kt)[0], (9, 3), getattr(torch, dtype)
                     ).numpy())


@pytest.mark.parametrize("box,factor", [
    ((0.0, 1.0, 0.0, 1.0, 0.0, 1.0), 1),
    ((2e-3, 9e-3, 1e-3, 5e-3, 0.0, 12e-3), 1),
    ((0.0, 12e-3, 0.0, 3e-3, 0.0, 12e-3), 2),
    ((0.0, 12e-3, 0.0, 3e-3, 0.0, 12e-3), 3),
    ((), 1)])
def test_seed_positions_equal(box, factor):
    cfg_j, _ = window_case()
    cfg_t = port_config(cfg_j)
    ref = jinj.seed_positions(cfg_j.grid, box, factor)
    got = tinj.seed_positions(cfg_t.grid, box, factor)
    np.testing.assert_array_equal(ref, got)


def _state(capacity=64):
    """The window column's state in f64, with a few particles spread
    through the box, one dead slot below the high-water mark, and a
    nonzero key."""
    cfg_j, st = window_case(capacity=capacity)
    st = f64(st)
    ps = st.particles
    rng = np.random.RandomState(3)
    L = np.asarray(cfg_j.grid.lengths)
    pos = np.asarray(ps.pos).copy()
    pos[:6] = rng.uniform(0.05, 0.95, (6, 3)) * L
    pos[4, 1] = 0.95 * L[1]                   # in the delete box
    active = np.zeros(capacity, bool)
    active[:6] = True
    active[2] = False
    tag = np.zeros(capacity, np.int32)
    tag[:6] = np.arange(1, 7)
    ps = ps._replace(pos=jnp.asarray(pos), active=jnp.asarray(active),
                     tag=jnp.asarray(tag),
                     rng_key=jax.random.split(jax.random.PRNGKey(9))[1])
    return cfg_j, ps


def _sites(cfg_j, ps):
    s = jinj.seed_positions(cfg_j.grid, cfg_j.cloud.add_box,
                            cfg_j.cloud.reduce_number_factor)
    return jnp.asarray(s), torch.as_tensor(s)


def _add(capacity):
    cfg_j, ps = _state(capacity)
    cc_j = dataclasses.replace(cfg_j.cloud, random_perturb=3e-4)
    cc_t = dataclasses.replace(port_config(cfg_j).cloud, random_perturb=3e-4)
    sj, st = _sites(cfg_j, ps)
    ref = jinj.add_particles(ps, sj, cc_j, ps.rng_key)
    tps = particles_to_torch(ps)
    got = tinj.add_particles(tps, st, cc_t, tps.rng_key)
    return len(st), ref, got


def test_add_particles_bitwise():
    """64 slots (5 taken) take every one of the 48 sites."""
    n_sites, ref, got = _add(64)
    assert n_sites == 48
    assert int(got.active.sum()) == 5 + 48
    assert_tree_close(bridge.tree_to_numpy(ref), bridge.tree_to_numpy(got),
                      0.0)


def test_add_particles_at_capacity_fills_every_free_slot():
    """20 slots (5 taken) for 48 sites: the port fills all 15 free slots.
    The reference clamps the 33 seeds beyond capacity onto slot 19 and
    writes its old row back there, so it loses the seed that took slot
    19 (14 added); every other slot agrees bit for bit."""
    _, ref, got = _add(20)
    assert int(got.active.sum()) == 20
    assert int(np.sum(np.asarray(ref.active))) == 19
    assert not bool(ref.active[19]) and bool(got.active[19])
    a, b = bridge.tree_to_numpy(ref), bridge.tree_to_numpy(got)
    for k, v in a.items():
        if isinstance(v, np.ndarray) and v.ndim and v.shape[0] == 20:
            np.testing.assert_array_equal(v[:19], b[k][:19], err_msg=k)


@pytest.mark.parametrize("time_to_add", [0.0, 1e-4])
@pytest.mark.parametrize("delete_before_add", [0, 1])
def test_maybe_add_delete_bitwise(time_to_add, delete_before_add):
    cfg_j, ps = _state()
    L = cfg_j.grid.lengths
    clear = (0.0, L[0], 0.0, 0.5 * L[1], 0.0, L[2])
    cc_j = dataclasses.replace(cfg_j.cloud, random_perturb=3e-4,
                               delete_before_add=delete_before_add,
                               clear_box=clear)
    cc_t = dataclasses.replace(port_config(cfg_j).cloud, random_perturb=3e-4,
                               delete_before_add=delete_before_add,
                               clear_box=clear)
    sj, st = _sites(cfg_j, ps)
    ref = jinj.maybe_add_delete(ps, jnp.asarray(time_to_add), ps.rng_key,
                                sj, cfg_j.grid, cc_j, cfg_j.fluid.dt)
    tps = particles_to_torch(ps)
    before = tinj.SYNCS
    got = tinj.maybe_add_delete(tps, torch.tensor(time_to_add,
                                                  dtype=torch.float64),
                                tps.rng_key, st, port_config(cfg_j).grid,
                                cc_t, cfg_j.fluid.dt)
    assert tinj.SYNCS == before + 1           # the due test's cond
    # whether an add fired and whether the box deleted anyone stay on
    # the device, for the caller's conds
    assert got[3].dtype == got[4].dtype == torch.bool
    assert bool(got[3]) == bool(ref[3]) and bool(got[4]) == bool(ref[4])
    assert bool(got[3]) == (time_to_add <= 0.0)
    assert bool(got[4])                       # particle 4 was in the box
    assert_tree_close(bridge.tree_to_numpy(ref[0]),
                      bridge.tree_to_numpy(got[0]), 0.0)
    assert float(ref[1]) == float(got[1])
    np.testing.assert_array_equal(np.asarray(ref[2]).astype(np.int64),
                                  got[2].numpy())


def test_evolve_with_injection_matches_reference():
    """Two evolve() calls of the window column from an f64 state whose
    countdown is due: an add (with the forced rebuild and setup forces),
    then a plain subcycle."""
    cfg_j, st = window_case(capacity=256)
    st = f64(st)
    st = st._replace(particles=st.particles._replace(
        time_to_add=jnp.asarray(0.0)))
    cfg_t = port_config(cfg_j)
    st_t = bridge.sim_state_from_numpy(bridge.sim_state_to_numpy(st))
    fj, pj = st.fluid, st.particles
    ft, pt = st_t.fluid, st_t.particles
    for _ in range(2):
        fj, pj, _ = jcloud.evolve(fj, pj, st.uf_smoothed, cfg_j.grid,
                                  cfg_j.bcs, cfg_j.cloud, cfg_j.dem,
                                  cfg_j.fluid)
        ft, pt, _ = tcloud.evolve(ft, pt, st_t.uf_smoothed, cfg_t.grid,
                                  cfg_t.bcs, cfg_t.cloud, cfg_t.dem,
                                  cfg_t.fluid)
    assert int(np.sum(np.asarray(pj.active))) > 1       # the add fired
    assert_tree_close(bridge.tree_to_numpy(pj), bridge.tree_to_numpy(pt),
                      1e-10)
    assert_tree_close(bridge.tree_to_numpy(fj), bridge.tree_to_numpy(ft),
                      1e-10, skip=("Ua", "Ua_old", "phia", "phia_old"))
