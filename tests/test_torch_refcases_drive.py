"""The port's expMueller, BL24-TH1 and multiParticlesCollide validators
(sedifoam_tpu_torch/validate/mueller.py, bl24.py, collide.py) against the
JAX package driven in-process on stand-in case directories
(tests/torch_port_refcases.py), on the CPU.

scripts/validate_expMueller.py and validate_bl24.py fix their case
root, so the JAX side is driven here as those scripts drive it
(load_case, initialize, Simulation, the same sampling and metrics);
tests/test_golden_collide.py's loop (make_step_fn, a frame every 0.01 s)
is the collision traces' JAX side.

- expMueller09: the seed-2 jitter of the port's `jittered` equals the
  script's draw applied to the JAX particles bit for bit; seed 1, 60
  spheres 4 mm up a (8, 12, 2) gas column, 100 steps (2 visits of 50,
  both averaged), f32: every lineY* profile of the time-mean Ua within
  1e-4 of its scale of the JAX drive's (measured 4.2e-5), the per-line
  RMS errors within 1e-4 relative and the correlations within 2e-4 of
  the profile's scale over its spread across the line (a nearly flat
  profile's correlation moves by a shift over that spread);
  run_seeds over seeds (0, 1): seed 0's keys bare, seed 1's prefixed,
  the seed-mean and per-seed metrics on lineY3-5 equal to those
  recomputed from the two seeds' torch_ profile files;
- BL24-TH1: 96 spheres (the bottom layer frozen) in a table of 512 on a
  3-block (8, 9, 2) channel, 4 steps of 4 substeps, f32: q and the bulk
  Ub_x per sample within 1e-4 of scale of the JAX drive's (measured
  7.9e-7), gradP within 1e-4 of the controller's first correction Ubar /
  deltaT (gradP is a bulk-velocity correction over deltaT: the forced
  bed's gradP falls from 1,670 to 0.05 in three steps, and f32 round-off
  of the velocity reaches it times 1 / deltaT; measured 5.9e-7), the bed
  heights within 1e-6 m, every gate and the result's keys as the
  script's (its full-run set with ubar_locked);
- multiParticlesCollideDia: 20 steps of 100 substeps (dense, f64): the
  port's recorded frames (pos, vel) within 1e-10 of scale of the JAX
  make_step_fn loop's (measured 9.0e-16), and the trace comparison's
  maxima equal to those computed from the repository's golden files
  over the frames both hold.
"""

import dataclasses
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_port_refcases as rc  # noqa: E402
from sedifoam_tpu.io.case import load_case as jload  # noqa: E402
from sedifoam_tpu.runtime.runner import Simulation as JSimulation  # noqa: E402
from sedifoam_tpu.solver import initialize as jinitialize  # noqa: E402
from sedifoam_tpu.solver import make_step_fn as jmake_step_fn  # noqa: E402
from sedifoam_tpu.utils.postprocess import TimeAverager as JAverager  # noqa: E402
from sedifoam_tpu.utils.postprocess import line_sample as jline_sample  # noqa: E402
from sedifoam_tpu_torch.io.case import load_case as tload  # noqa: E402
from sedifoam_tpu_torch.validate import bl24, collide, mueller  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401

MU_T = 0.0095           # 2 visits of 50 steps
BL_T = 3.5e-4           # 2 visits of 2 steps
BL_CAP = 512
BL24_KEYS = {
    "quick", "case", "grid", "n_particles", "t_end", "wall_time_s",
    "ub_bulk_late", "ubar_target", "ubar_rel_err", "gradP_late_mean",
    "q_star", "frozen_max_disp", "alpha_min", "alpha_max", "finite",
    "n_active", "timing_split_ms", "gates", "passed"}


def _rel(ref, got):
    ref, got = np.asarray(ref, float), np.asarray(got, float)
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-300))


def _jsemi(cfg):
    return dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=True))


# -- expMueller ---------------------------------------------------------------

@pytest.fixture(scope="module")
def mueller_case(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mueller")
    return tmp, rc.write_mueller(str(tmp / "expMueller09"), y0=0.004)


def _jax_particles(case, seed):
    """The script's load and draw (validate_expMueller.py:47-60)."""
    cfg, fluid, particles, _ = jload(case, backend="binned",
                                     dtype=jnp.float32)
    if seed:
        rng = np.random.RandomState(seed)
        rad = np.asarray(particles.radius)
        jit = rng.uniform(-0.02, 0.02, (rad.shape[0], 3)) * rad[:, None]
        particles = particles._replace(
            pos=particles.pos + jnp.asarray(jit, particles.pos.dtype))
    return cfg, fluid, particles


def test_mueller_jitter_is_the_scripts_draw(mueller_case):
    _, case = mueller_case
    _, _, jp = _jax_particles(case, 2)
    _, _, tp, _ = tload(case, backend="binned", dtype=torch.float32,
                        device="cpu")
    got = mueller.jittered(tp, 2).pos.numpy()
    np.testing.assert_array_equal(got, np.asarray(jp.pos))
    assert not np.array_equal(got, tp.pos.numpy())
    assert mueller.jittered(tp, 0) is tp


def test_mueller_profiles_match_the_jax_drive(mueller_case):
    _, case = mueller_case
    got, profiles = mueller.profiles_run(case, MU_T, 0.0, 1, "cpu",
                                         timing_reps=1)
    cfg, fluid, particles = _jax_particles(case, 1)
    sim = JSimulation(cfg, jinitialize(fluid, particles, cfg))
    sim.steps_per_visit = 50
    avg = JAverager()

    def on_sample(s):
        avg.add(Ua=np.asarray(s.state.fluid.Ua),
                alpha=np.asarray(s.state.fluid.alpha))

    sim.run(MU_T, on_sample=on_sample)
    assert avg.n == 2
    lines = mueller.sample_lines(case)
    assert list(lines) == [f"lineY{i}" for i in range(1, 6)]
    worst = 0.0
    for name, (start, end, npts) in lines.items():
        pts, vals = jline_sample(avg.mean("Ua"), cfg.grid, start, end, npts)
        err = _rel(vals, profiles[name][:, 1:])
        assert err <= 1e-4, (name, err)
        np.testing.assert_array_equal(pts[:, 0], profiles[name][:, 0])
        worst = max(worst, err)
        bench = np.loadtxt(os.path.join(case, "data", "sets_bench",
                                        f"{name}_UaMean.xy"))
        vy = np.interp(bench[:, 0], pts[:, 0], vals[:, 1])
        denom = max(np.abs(bench[:, 2]).max(), 1e-9)
        rms = float(np.sqrt(np.mean((vy - bench[:, 2]) ** 2)) / denom)
        assert abs(got[f"{name}_uy_rms_err"] - rms) <= 1e-4 * rms
        # a correlation moves by about (a shift of the profile) / (its
        # spread): its bound is the profiles' 1e-4 of scale over that
        spread = max(float(np.std(vy)), 1e-300)
        corr_tol = 2e-4 * float(np.abs(vals[:, 1]).max()) / spread
        assert abs(got[f"{name}_uy_corr"]
                   - np.corrcoef(vy, bench[:, 2])[0, 1]) <= corr_tol, (
            name, got[f"{name}_uy_corr"], corr_tol)
        if name in ("lineY1", "lineY2"):
            _, av = jline_sample(avg.mean("alpha"), cfg.grid, start, end,
                                 npts)
            ba = np.loadtxt(os.path.join(case, "data", "sets_bench",
                                         f"{name}_alphaMean.xy"))
            a = np.interp(ba[:, 0], pts[:, 0], av)
            arms = float(np.sqrt(np.mean((a - ba[:, 1]) ** 2))
                         / np.abs(ba[:, 1]).max())
            assert abs(got[f"{name}_alpha_rms_err"] - arms) <= 1e-4 * arms
        else:
            assert f"{name}_alpha_rms_err" not in got
    assert set(got) == ({"case", "t_end", "wall_time_s", "continuity_err",
                         "audit_drift_asrc_y", "alpha_min",
                         "timing_split_ms"}
                        | {f"lineY{i}_uy_{m}" for i in range(1, 6)
                           for m in ("rms_err", "corr")}
                        | {"lineY1_alpha_rms_err", "lineY2_alpha_rms_err"})
    assert got["case"] == "expMueller09"
    print(f"expMueller09 vs the JAX drive: UaMean profiles {worst:.2e} "
          "of scale")


def test_mueller_seed_mean(mueller_case, tmp_path):
    _, case = mueller_case
    said = []
    ok, data = mueller.run_seeds(case, (0, 1), MU_T, 0.0,
                                 out_dir=str(tmp_path), device="cpu",
                                 say=said.append, timing_reps=1)
    assert ok and data["seeds"] == [0, 1] and len(said) == 2
    assert "lineY3_uy_corr" in data and "seed1_lineY3_uy_corr" in data
    assert "case" not in data and "seed1_t_end" not in data
    profs = [np.load(tmp_path / f"torch_expMueller09_profiles_seed{s}.npz")
             for s in (0, 1)]
    for line in ("lineY3", "lineY4", "lineY5"):
        bench = np.loadtxt(os.path.join(case, "data", "sets_bench",
                                        f"{line}_UaMean.xy"))
        per = [np.interp(bench[:, 0], p[line][:, 0], p[line][:, 2])
               for p in profs]
        vy = np.mean(per, axis=0)
        denom = np.abs(bench[:, 2]).max()
        assert data[f"seedmean_{line}_uy_rms_err"] == float(
            np.sqrt(np.mean((vy - bench[:, 2]) ** 2)) / denom)
        assert data[f"seedmean_{line}_uy_corr"] == float(
            np.corrcoef(vy, bench[:, 2])[0, 1])
        assert len(data[f"per_seed_{line}_uy_rms_err"]) == 2
    assert "seedmean_lineY1_uy_rms_err" not in data


# -- BL24-TH1 -----------------------------------------------------------------

@pytest.fixture(scope="module")
def bl24_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bl24")
    case = rc.write_bl24(str(tmp / "BL24-TH1"), n=96, counts=(8, 9, 2))
    res = bl24.run(case, BL_T, 0.0, out=str(tmp / "bed.npz"), device="cpu",
                   capacity=BL_CAP, steps_per_host_visit=2, timing_reps=1)
    return tmp, case, res


def test_bl24_keys_and_gates(bl24_run):
    tmp, _, res = bl24_run
    assert set(res) == BL24_KEYS
    assert res["grid"] == [8, 9, 2] and res["n_particles"] == 96
    assert set(res["gates"]) == {"finite", "frozen_immobile", "no_escapes",
                                 "alpha_bounds", "ubar_locked"}
    assert res["passed"] == all(res["gates"].values())
    for gate in ("finite", "frozen_immobile", "no_escapes", "alpha_bounds"):
        assert res["gates"][gate], gate
    d = np.load(tmp / "torch_bed.npz")
    assert set(d.files) == {"t", "q", "ub", "gp", "bed_h", "x_bins"}
    assert d["bed_h"].shape == (16,) and len(d["t"]) == 2
    json.dumps(res)


def test_bl24_matches_the_jax_drive(bl24_run):
    tmp, case, res = bl24_run
    cfg, fluid, particles, _ = jload(case, backend="binned",
                                     dtype=jnp.float32, capacity=BL_CAP)
    cfg = _jsemi(cfg)
    state = jinitialize(fluid, particles, cfg)
    ps0 = state.particles
    frozen_mask = np.asarray(ps0.ptype == 2)
    frozen0 = np.asarray(ps0.pos)[frozen_mask]
    xf, zf = np.asarray(cfg.grid.axis_faces(0)), np.asarray(
        cfg.grid.axis_faces(2))
    lx, lz = float(xf[-1] - xf[0]), float(zf[-1] - zf[0])
    cell_v = np.asarray(cfg.grid.cell_volume)
    samples = {"q": [], "ub": [], "gp": []}

    def on_sample(sim):                  # validate_bl24.py's sampler
        ps, fs = sim.state.particles, sim.state.fluid
        mob = ps.active & (ps.ptype == 1)
        vp = (4.0 / 3.0) * np.pi * np.asarray(ps.radius) ** 3
        samples["q"].append(float(jnp.sum(jnp.where(mob, ps.vel[:, 0], 0.0)
                                          * jnp.asarray(vp))) / (lx * lz))
        beta = 1.0 - fs.alpha
        samples["ub"].append(float(jnp.sum(fs.Ub[0] * beta
                                           * jnp.asarray(cell_v))
                                   / jnp.sum(beta * jnp.asarray(cell_v))))
        samples["gp"].append(float(fs.grad_p_value))

    sim = JSimulation(cfg, state, steps_per_host_visit=2)
    sim.run(BL_T, on_sample=on_sample)
    d = np.load(tmp / "torch_bed.npz")
    worst = 0.0
    for key in ("q", "ub"):
        err = _rel(samples[key], d[key])
        assert err <= 1e-4, (key, err)
        worst = max(worst, err)
    # the Ubar controller's gradP is a bulk-velocity correction over
    # deltaT: the scale it is held to is its first, whole correction
    # Ubar / deltaT (f32 round-off of the bulk velocity reaches gradP
    # amplified by 1 / deltaT)
    kick = cfg.fluid.forcing.mag_ubar / cfg.fluid.dt
    gp_err = float(np.abs(np.subtract(samples["gp"], d["gp"])).max()) / kick
    assert gp_err <= 1e-4, gp_err
    ps, fs = sim.state.particles, sim.state.fluid
    act = np.asarray(ps.active)
    pos = np.asarray(ps.pos)[act]
    np.testing.assert_allclose(bl24.bed_heights(pos, float(xf[0]), lx),
                               d["bed_h"], atol=1e-6, rtol=0)
    assert float(np.abs(np.asarray(ps.pos)[frozen_mask] - frozen0).max()) \
        == res["frozen_max_disp"] == 0.0
    assert int(act.sum()) == res["n_active"]
    assert abs(float(jnp.max(fs.alpha)) - res["alpha_max"]) \
        <= 1e-4 * res["alpha_max"]
    ubar = cfg.fluid.forcing.mag_ubar
    assert ubar == res["ubar_target"]
    ub_late = float(np.mean(samples["ub"]))
    assert res["gates"]["ubar_locked"] == (abs(ub_late - ubar) / ubar < 0.05)
    print(f"BL24-TH1 vs the JAX drive: q, Ub {worst:.2e} of scale, gradP "
          f"{gp_err:.2e} of Ubar / deltaT")


# -- multiParticlesCollide ----------------------------------------------------

def test_collide_frames_match_the_jax_loop(tmp_path):
    case = rc.write_collide(str(tmp_path / "multiParticlesCollideDia"),
                            end_time=0.02)
    times, pos, vel, _ = collide.trace(case, device="cpu")
    cfg, fluid, particles, controls = jload(case)
    state = jinitialize(fluid, particles, cfg)
    step = jmake_step_fn(cfg)
    jpos, jvel = [np.asarray(state.particles.pos)], [
        np.asarray(state.particles.vel)]
    for i in range(int(round(controls.end_time / controls.dt))):
        state = step(state)
        if (i + 1) % int(round(0.01 / controls.dt)) == 0:
            jpos.append(np.asarray(state.particles.pos))
            jvel.append(np.asarray(state.particles.vel))
    np.testing.assert_allclose(times, [0.0, 0.01, 0.02], rtol=1e-12)
    assert pos.shape == (3, 4, 3)
    perr, verr = _rel(np.stack(jpos), pos), _rel(np.stack(jvel), vel)
    assert perr <= 1e-10 and verr <= 1e-10, (perr, verr)
    golden = os.path.join(collide.GOLDEN, "multiParticlesCollideDia")
    cmp = collide.compare(pos, vel, golden)
    assert cmp["frames_compared"] == 3
    for i in range(4):
        b = np.loadtxt(os.path.join(golden, f"p{i + 1}.dat"))[:3]
        assert cmp["y_max_dev"][i] == float(np.max(np.abs(pos[:, i, 1]
                                                          - b[:, 5])))
        assert cmp["vy_max_dev"][i] == float(np.max(np.abs(vel[:, i, 1]
                                                           - b[:, 8])))
    print(f"collide vs the JAX loop: pos {perr:.2e}, vel {verr:.2e} of "
          "scale")
