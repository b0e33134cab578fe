"""The port's runtime services against sedifoam_tpu, on the CPU.

- utils/accum: stable_sum/dot/mean, both policies, f32 and f64, with
  the error taken relative to sum |a|: 1e-6 in f32 (measured: 1.3e-8,
  block sums reduced in another order) and 1e-13 in f64 (measured:
  4.8e-17);
- diagnostics.compute on one f64 state of the bench case (small), after
  a reference step: every value 1e-10 relative (measured: 5.7e-16);
- probes: the same samples as the reference's Probes, and the sidecar
  crosses packages;
- checkpoints in the reference's format, both ways: a state saved by one
  package, loaded by the other and stepped 2 more times in both agrees
  to 1e-8 of each field's scale (measured: 8.4e-11);
- the runner on xiaocase3 built in code (tests/test_runtime.py's checks
  without the case loader): probes, diagnostics log, time directories,
  OpenFOAM export, resume bit for bit, the timing split;
- active-window stepping on tests/test_window.py's injection column:
  slice/grow, the port's windowed run against its full-capacity run
  (f32, 1e-6 absolute, as the reference's test), and the port's
  windowed run against the reference's (f64, 1e-8 of scale by tag;
  measured: 8.3e-11).
"""

import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from sedifoam_tpu.fluid import turbulence as jturb  # noqa: E402
from sedifoam_tpu.io import foamwrite as jfoam  # noqa: E402
from sedifoam_tpu.runtime import checkpoint as jckpt  # noqa: E402
from sedifoam_tpu.runtime import diagnostics as jdiag  # noqa: E402
from sedifoam_tpu.runtime.probes import Probes as JProbes  # noqa: E402
from sedifoam_tpu.runtime.runner import Simulation as JSimulation  # noqa: E402
from sedifoam_tpu.solver import make_step_fn as jstep_fn  # noqa: E402
from sedifoam_tpu.utils import accum as jaccum  # noqa: E402
from sedifoam_tpu_torch import bench_case, bridge, cases  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.fluid import turbulence as tturb  # noqa: E402
from sedifoam_tpu_torch.io import foamwrite as tfoam  # noqa: E402
from sedifoam_tpu_torch.runtime import checkpoint as tckpt  # noqa: E402
from sedifoam_tpu_torch.runtime import diagnostics as tdiag  # noqa: E402
from sedifoam_tpu_torch.runtime import window as twin  # noqa: E402
from sedifoam_tpu_torch.runtime.probes import Probes as TProbes  # noqa: E402
from sedifoam_tpu_torch.runtime.runner import Simulation  # noqa: E402
from torch_port_cases import f64, port_config, window_case  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import assert_tree_close, rel_err  # noqa: E402

SMALL = dict(n_particles=256, nx=8, ny=16, nz=8)
PROBE = [(2e-3, 2e-3, 2.5e-4)]


# -- utils/accum ------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("float64", 1e-13)])
@pytest.mark.parametrize("policy", ["compensated", "native"])
@pytest.mark.parametrize("n", [700, 5000, 70001])
def test_accum_matches_reference(dtype, tol, policy, n):
    rng = np.random.RandomState(n)
    # a wide magnitude spread with cancellation
    a = (rng.randn(n) * 10.0 ** rng.randint(-3, 4, n)).astype(dtype)
    b = rng.rand(n).astype(dtype)
    ta, tb = torch.as_tensor(a), torch.as_tensor(b)
    from sedifoam_tpu_torch.utils import accum as taccum
    for ref, got in (
            (jaccum.stable_sum(jnp.asarray(a), policy),
             taccum.stable_sum(ta, policy)),
            (jaccum.stable_dot(jnp.asarray(a), jnp.asarray(b), policy),
             taccum.stable_dot(ta, tb, policy)),
            (jaccum.stable_mean(jnp.asarray(a), jnp.asarray(b), policy),
             taccum.stable_mean(ta, tb, policy))):
        assert got.dtype == getattr(torch, dtype) and got.ndim == 0
        assert abs(float(ref) - float(got)) <= tol * np.abs(a).sum()


# -- diagnostics, probes, checkpoints --------------------------------------

@pytest.fixture(scope="module")
def stepped():
    """(cfg_j, cfg_t, state_j): the bench case (small, binned) in f64
    after one reference step (nonzero fluxes, Asrc and contacts)."""
    cfg_j, st = bench.build_case(backend="binned", **SMALL)
    st = jstep_fn(cfg_j)(f64(st))
    return cfg_j, bench_case.build_config(**SMALL), st


def _port_state(st_j):
    return bridge.sim_state_from_numpy(bridge.sim_state_to_numpy(st_j))


def test_diagnostics_match_reference(stepped):
    cfg_j, cfg_t, st = stepped
    ref = jdiag.compute(st, cfg_j.grid, cfg_j.fluid, cfg_j.dem)
    got = tdiag.compute(_port_state(st), cfg_t.grid, cfg_t.fluid, cfg_t.dem)
    assert set(ref) == set(got)
    for k in ref:
        assert isinstance(got[k], torch.Tensor) and got[k].ndim == 0, k
        if k == "audit_drift_asrc_y":
            # a ratio of round-off (plain vs compensated sum): 1e-16 in
            # both, absolute
            assert abs(float(ref[k]) - float(got[k])) <= 1e-12
        else:
            assert rel_err(ref[k], got[k]) <= 1e-10, k
    host = tdiag.to_host(got)
    assert host["n_particles"] == SMALL["n_particles"]
    assert all(isinstance(v, float) for v in host.values())


def test_probes_match_reference(stepped, tmp_path):
    cfg_j, cfg_t, st = stepped
    st_t = _port_state(st)
    L = cfg_j.grid.lengths
    locs = [(0.1 * L[0], 0.2 * L[1], 0.3 * L[2]), (L[0], L[1], L[2]),
            (0.5 * L[0], 0.05 * L[1], 0.9 * L[2])]
    pj, pt = JProbes(cfg_j.grid, locs), TProbes(cfg_t.grid, locs)
    np.testing.assert_array_equal(np.asarray(pj.cells), pt.cells)
    for t, (fj, ft) in enumerate(((st.fluid, st_t.fluid),) * 2):
        pj.sample(t * 1e-3, p=fj.p, Ub=fj.Ub, alpha=fj.alpha)
        pt.sample(t * 1e-3, p=ft.p, Ub=ft.Ub, alpha=ft.alpha)
    for name in ("p", "Ub", "alpha"):
        tj, vj = pj.series(name)
        tt, vt = pt.series(name)
        np.testing.assert_array_equal(tj, tt)
        assert vj.shape == vt.shape
        np.testing.assert_array_equal(vj, vt)
    # the sidecar crosses packages
    pj.save(str(tmp_path / "j.npz"))
    back = TProbes(cfg_t.grid, locs)
    back.load(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(back.series("Ub")[1], pt.series("Ub")[1])


def test_checkpoint_leaf_order_matches_reference(stepped):
    _, _, st = stepped
    leaves = jax.tree.leaves(st)
    flat = tckpt._flatten(_port_state(st))
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(t.shape) for _, t in flat]
    assert [n for n, _ in flat].count("rng_key") == 1


def _steps(cfg_t, st_t, n):
    return tsolver.make_step_fn(cfg_t, n_sub=n, device="cpu")(st_t)


def test_checkpoint_reference_to_port(stepped, tmp_path):
    """Saved by the reference, loaded and continued 2 steps by the port;
    the reference continues the same 2 steps."""
    cfg_j, cfg_t, st = stepped
    path = str(tmp_path / "j.npz")
    jckpt.save(path, st)
    template = _port_state(jax.tree_util.tree_map(jnp.zeros_like, st))
    loaded = tckpt.load(path, template)
    assert_tree_close(bridge.sim_state_to_numpy(st),
                      bridge.sim_state_to_numpy(loaded), 0.0)
    assert loaded.particles.rng_key.dtype == torch.int64
    step_j = jstep_fn(cfg_j)
    ref = step_j(step_j(st))
    got = _steps(cfg_t, loaded, 2)
    assert_tree_close(bridge.sim_state_to_numpy(ref),
                      bridge.sim_state_to_numpy(got), 1e-8)


def test_checkpoint_port_to_reference(stepped, tmp_path):
    """Stepped and saved by the port, loaded and continued 2 steps by
    the reference; the port continues the same 2 steps."""
    cfg_j, cfg_t, st = stepped
    st_t = _steps(cfg_t, _port_state(st), 1)
    st_t = st_t._replace(particles=st_t.particles._replace(
        rng_key=torch.tensor([7, 2 ** 32 - 3])))
    path = str(tmp_path / "t.npz")
    tckpt.save(path, st_t)
    with np.load(path) as d:
        assert d[f"leaf_{len(d.files) - 1}"].ndim == 4    # uf_smoothed_old
        keys = [d[k] for k in d.files if d[k].dtype == np.uint32]
    assert len(keys) == 2                                 # rng_key, dns_key
    loaded = jckpt.load(path, st)
    assert loaded.particles.rng_key.dtype == jnp.uint32
    assert int(loaded.particles.rng_key[1]) == 2 ** 32 - 3
    step_j = jstep_fn(cfg_j)
    ref = step_j(step_j(loaded))
    got = _steps(cfg_t, st_t, 2)
    assert_tree_close(bridge.sim_state_to_numpy(ref),
                      bridge.sim_state_to_numpy(got), 1e-8)


def test_reynolds_stress_and_foam_export_match_reference(stepped, tmp_path):
    cfg_j, cfg_t, st = stepped
    st_t = _port_state(st)
    ref = jturb.reynolds_stress(st.fluid, cfg_j.grid, cfg_j.bcs, cfg_j.fluid)
    got = tturb.reynolds_stress(st_t.fluid, cfg_t.grid, cfg_t.bcs,
                                cfg_t.fluid)
    assert got.shape == (6,) + cfg_t.grid.shape
    assert rel_err(ref, got) <= 1e-10
    fields = dict(p=np.asarray(st.fluid.p), Ub=np.asarray(st.fluid.Ub))
    jfoam.write_time_dir(str(tmp_path / "j"), "0.1", cfg_j.grid, **fields)
    tfoam.write_time_dir(str(tmp_path / "t"), "0.1", cfg_t.grid, **fields)
    for name in fields:
        a = (tmp_path / "j" / "0.1" / name).read_text()
        assert a == (tmp_path / "t" / "0.1" / name).read_text()


# -- the runner on xiaocase3 -----------------------------------------------

def _sim(**kw):
    cfg, fluid, particles = cases.xiaocase3(device="cpu")
    state = tsolver.CoupledStep(cfg, device="cpu").initialize(fluid,
                                                              particles)
    return Simulation(cfg, state, probe_locations=PROBE, device="cpu",
                      **kw), cfg.fluid.dt


def test_runner_probes_diagnostics(tmp_path):
    sim, dt = _sim()
    sim.foam_output = True
    sim.run(10 * dt, log_every=5, write_dir=str(tmp_path),
            write_interval=5 * dt)
    t, p = sim.probes.series("p")
    assert len(t) == 10 and np.isfinite(p).all()
    assert len(sim.log) == 2
    d = sim.log[-1]
    assert 0 <= d["alpha_max"] <= 0.7
    assert d["n_particles"] == 1
    assert d["courant"] < 1.0
    tdirs = sorted(x for x in os.listdir(tmp_path))
    assert len(tdirs) == 2
    files = set(os.listdir(os.path.join(tmp_path, tdirs[0])))
    assert {"fields.npz", "particles.npz", "checkpoint.npz",
            "diagnostics.jsonl", "p", "alpha", "Ub", "Ua", "k",
            "nut"} <= files
    with np.load(os.path.join(tmp_path, tdirs[-1], "fields.npz")) as f:
        assert f["B"].shape == (6, 10, 10, 1)
        np.testing.assert_array_equal(f["p"], sim.state.fluid.p.numpy())


def test_checkpoint_resume_bitwise(tmp_path):
    """Full-state resume (incl. contact history) reproduces the run bit
    for bit on the CPU."""
    sim, dt = _sim()
    sim.run(5 * dt)
    ckpt = str(tmp_path / "ck.npz")
    tckpt.save(ckpt, sim.state)
    sim.run(10 * dt)
    sim2, _ = _sim()
    sim2.resume(ckpt)
    assert abs(sim2.t - 5 * dt) < 1e-12
    sim2.run(10 * dt)
    assert_tree_close(bridge.sim_state_to_numpy(sim.state),
                      bridge.sim_state_to_numpy(sim2.state), 0.0)


def test_case_level_resume_probes_bitwise(tmp_path):
    """save_checkpoint carries the probe series in a sidecar; a fresh
    Simulation resumed from it reproduces the straight run's probe
    series and final state bit for bit."""
    sim, dt = _sim()
    sim.run(10 * dt, probe_every=2)
    t_a, p_a = sim.probes.series("p")
    sim2, _ = _sim()
    sim2.run(4 * dt, probe_every=2)
    ckpt = str(tmp_path / "case_ck.npz")
    sim2.save_checkpoint(ckpt)
    del sim2
    sim3, _ = _sim()
    sim3.resume(ckpt)
    assert len(sim3.probes.times) == 2
    sim3.run(10 * dt, probe_every=2)
    t_b, p_b = sim3.probes.series("p")
    np.testing.assert_array_equal(t_a, t_b)
    np.testing.assert_array_equal(p_a, p_b)
    np.testing.assert_array_equal(sim.state.particles.vel.numpy(),
                                  sim3.state.particles.vel.numpy())


def test_timing_split_and_from_case(tmp_path):
    sim, dt = _sim()
    sim.run(2 * dt)
    before = bridge.sim_state_to_numpy(sim.state)
    split = sim.timing_split(n=2)
    assert set(split) == {"fluid", "evolve", "coupling_source"}
    assert all(v > 0 for v in split.values())
    # the split leaves the simulation's state as it was
    assert_tree_close(before, bridge.sim_state_to_numpy(sim.state), 0.0)
    # from_case loads a case directory with the reference's defaults
    # (dense, f64) and its probes argument (3 steps against the built
    # case: tests/test_torch_channel.py)
    case = cases.write_xiaocase3(str(tmp_path / "xiaocase3"))
    loaded = Simulation.from_case(case, probe_locations=PROBE, device="cpu")
    assert loaded.cfg.dem.backend == "dense"
    assert loaded.state.fluid.p.dtype == torch.float64
    assert loaded.controls.write_interval == 1e-3
    assert loaded.probes is not None and loaded.t == 0.0


# -- active-window stepping ------------------------------------------------

def _port_window_case(capacity=8192, dtype=None):
    cfg_j, st = window_case(capacity=capacity)
    if dtype == "float64":
        st = f64(st)
    return cfg_j, port_config(cfg_j), st, _port_state(st)


def test_slice_grow_roundtrip_sentinels():
    _, _, _, st = _port_window_case()
    ps = st.particles
    w = 4096
    small = twin.window_slice(ps, w)
    assert small.pos.shape == (w, 3)
    assert small.nbr_idx.shape == (ps.nbr_idx.shape[0], w)
    assert small.shear.shape[-1] == w
    for name, t in small._asdict().items():
        if isinstance(t, torch.Tensor):
            assert t.is_contiguous(), name
            if t.ndim and t.numel() and w in (t.shape[0], t.shape[-1]):
                # sliced fields are copies, never views
                assert t.data_ptr() != getattr(ps, name).data_ptr(), name
    assert small.nbr_idx.dtype == torch.int32
    assert int(small.nbr_idx.max()) <= w
    assert bool(torch.all((small.nbr_idx == w) | (small.nbr_idx < w)))
    back = twin.window_grow(small, 8192)
    assert back.nbr_idx.dtype == torch.int32
    assert_tree_close(bridge.tree_to_numpy(ps), bridge.tree_to_numpy(back),
                      0.0)


def test_high_water_and_next_window():
    _, _, _, st = _port_window_case()
    assert int(twin.high_water(st.particles)) == 1
    assert twin.next_window(1, 0, 8192) == 2048
    assert twin.next_window(1500, 2048, 8192) == 4096
    assert twin.next_window(3000, 2048, 8192) == 8192
    assert twin.next_window(9000, 2048, 8192) == 8192


def _by_tag(ps):
    a = ps.active.numpy() if isinstance(ps.active, torch.Tensor) \
        else np.asarray(ps.active)
    tag = np.asarray(ps.tag)[a]
    order = np.argsort(tag)
    return tag[order], {name: np.asarray(getattr(ps, name))[a][order]
                        for name in ("pos", "vel", "omega")}


def test_windowed_run_matches_full(tmp_path):
    """20 coupled steps with injection + deletion: the windowed runner
    (table 2048) reproduces the full-capacity run (table 8192) on every
    active particle, matched by tag; its checkpoint is full-capacity."""
    _, cfg, _, st = _port_window_case()
    sim_full = Simulation(cfg, st, steps_per_host_visit=5,
                          active_window=False)
    sim_full.run(20 * cfg.fluid.dt)
    sim_win = Simulation(cfg, st, steps_per_host_visit=5,
                         active_window=True)
    assert sim_win.state.particles.n_capacity == 2048
    sim_win.run(20 * cfg.fluid.dt)
    tf, xf = _by_tag(sim_full.state.particles)
    tw, xw = _by_tag(sim_win.state.particles)
    assert len(tf) > 2                                  # injection fired
    np.testing.assert_array_equal(tf, tw)
    for name in xf:
        np.testing.assert_allclose(xf[name], xw[name], rtol=0, atol=1e-6,
                                   err_msg=name)
    ck = str(tmp_path / "w.npz")
    sim_win.save_checkpoint(ck)
    sim3 = Simulation(cfg, st, active_window=False)
    sim3.resume(ck)
    assert sim3.state.particles.n_capacity == 8192
    np.testing.assert_array_equal(_by_tag(sim3.state.particles)[0], tw)


def test_windowed_run_matches_reference():
    """The port's windowed run against the reference's, f64, by tag."""
    cfg_j, cfg_t, st_j, st_t = _port_window_case(dtype="float64")
    ref = JSimulation(cfg_j, st_j, steps_per_host_visit=5,
                      active_window=True)
    ref.run(20 * cfg_j.fluid.dt)
    sim = Simulation(cfg_t, st_t, steps_per_host_visit=5,
                     active_window=True)
    sim.run(20 * cfg_t.fluid.dt)
    assert sim.state.particles.n_capacity == \
        ref.state.particles.n_capacity == 2048
    tj, xj = _by_tag(ref.state.particles)
    tt, xt = _by_tag(sim.state.particles)
    assert len(tj) > 2
    np.testing.assert_array_equal(tj, tt)
    for name in xj:
        assert rel_err(xj[name], xt[name]) <= 1e-8, name
    np.testing.assert_array_equal(
        np.asarray(ref.state.particles.rng_key).astype(np.int64),
        sim.state.particles.rng_key.numpy())


def test_inject_column_window_grows_and_matches_full():
    """The injection column of chip_smoke.py's inject phase
    (sedifoam_tpu_torch/cases.py) at a small size: 64 sites per add, a
    4,096-slot capacity. 33 steps (16 adds, one every second step) grow
    the window from 2,048 to 4,096 after step 32; the windowed run equals
    the full-capacity run by tag."""
    cfg, fluid, particles = cases.inject_case(nx=8, ny=16, nz=8,
                                              capacity=4096, device="cpu")
    state = tsolver.CoupledStep(cfg, torch.float32, "cpu").initialize(
        fluid, particles)
    dt = cfg.fluid.dt
    win = Simulation(cfg, state)
    assert win.windowed and win.state.particles.n_capacity == 2048
    win.run(32.5 * dt)
    full = Simulation(cfg, state, active_window=False)
    full.run(32.5 * dt)
    assert win.state.particles.n_capacity == 4096
    tw, xw = _by_tag(win.state.particles)
    tf, xf = _by_tag(full.state.particles)
    assert len(tw) == 1 + 16 * 64
    np.testing.assert_array_equal(tw, tf)
    for name in xw:
        np.testing.assert_array_equal(xw[name], xf[name], err_msg=name)
    assert bool(torch.isfinite(win.state.particles.pos).all())


def test_stable_sum_scans_in_one_pass():
    """600,000 f32 elements (586 block partials) with a 1e8 magnitude
    spread and cancellation: the compensated sum is within 1e-7 of
    sum|a| of math.fsum (measured: 4.9e-10, the block sums' own
    round-off) and of the reference's stable_sum, is a handful of tensor
    operations whatever the number of partials (the scan over partials
    is one float64 sum, no Python loop of 0-d tensors), and takes well
    under a second (the best of three calls)."""
    import math
    import time

    from torch.utils._python_dispatch import TorchDispatchMode

    from sedifoam_tpu_torch.utils import accum as taccum

    rng = np.random.RandomState(5)
    n = 600_000
    a = (rng.randn(n) * 10.0 ** rng.uniform(-4, 4, n)).astype(np.float32)
    a[::2] = -a[1::2] * (1.0 + 1e-3 * rng.randn(n // 2)).astype(np.float32)
    ta = torch.as_tensor(a)
    exact = math.fsum(a.astype(np.float64))
    scale = float(np.abs(a.astype(np.float64)).sum())

    class Count(TorchDispatchMode):
        n_ops = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n_ops += 1
            return func(*args, **(kwargs or {}))

    with Count():
        got = taccum.stable_sum(ta)
    seconds = []                    # best of 3: the machine is shared
    for _ in range(3):
        t0 = time.perf_counter()
        taccum.stable_sum(ta)
        seconds.append(time.perf_counter() - t0)
    seconds = min(seconds)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert Count.n_ops <= 12, Count.n_ops
    assert seconds < 1.0
    ref = float(jaccum.stable_sum(jnp.asarray(a)))
    assert abs(float(got) - exact) <= 1e-7 * scale
    assert abs(float(got) - ref) <= 1e-7 * scale
    print(f"stable_sum: {abs(float(got) - exact) / scale:.2e} of sum|a| "
          f"from fsum, the reference {abs(ref - exact) / scale:.2e}, a "
          f"plain sum {abs(float(ta.sum()) - exact) / scale:.2e}; "
          f"{Count.n_ops} tensor operations, {seconds * 1e3:.1f} ms")
    # the weighted mean of the Ubar controller goes the same way
    w = torch.as_tensor(rng.rand(n).astype(np.float32))
    with Count():
        Count.n_ops = 0
        taccum.stable_mean(ta, w)
    assert Count.n_ops <= 30, Count.n_ops
