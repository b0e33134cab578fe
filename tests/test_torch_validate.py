"""The port's case validators (sedifoam_tpu_torch/validate/) on the CPU,
at shrunken sizes and a few steps.

- irregular: 30 trimer clumps over 648 frozen 2 mm floor spheres (738
  particles in a table of 1,024) on a (9, 8, 6) y-graded mesh, 3 steps:
  the result has the reference script's keys, every gate of a cut run
  holds, and `transporting` is listed as not evaluated; the same written
  directory loaded by the reference's load_case and driven the same way
  (semi-implicit drag, Simulation with the same steps per visit, f32)
  gives the same result numbers: the clumps' mean velocity to 1e-4 of
  its scale (f32 through 150 substeps; measured 1.2e-6), alpha_max to
  1e-4 (measured 0), the counts exactly;
- bedload: a (14, 13, 6) channel with 2 bed layers (2,024 particles in
  a table of 2,048), 2 settling steps and 4 forced steps: keys, gates,
  the settling phase's clock reset, one sample per visit; against the
  reference driven the same way: q, the forcing, the fluid volume per
  sample and Ub_bulk to 1e-4 of scale (measured 6.7e-6);
- a run stopped by its wall-time limit (validate.run_until) on a fake
  Simulation: the same steps in chunks, and a stop before the limit;
- member_gaps and same_body_slots (moved here from chip_smoke.py) on a
  hand-made state, also after a row permutation;
- battery.judge on hand-made result dicts (pass, fail, missing key,
  not_run), the .partial file that replaces the report only at
  completion, --only merging, and the refusal to write the reference's
  report.
"""

import dataclasses
import json
import os
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu.config import ChannelForcing as JChannelForcing  # noqa: E402
from sedifoam_tpu.io.case import load_case as jload  # noqa: E402
from sedifoam_tpu.runtime.runner import Simulation as JSimulation  # noqa: E402
from sedifoam_tpu.solver import initialize as jinitialize  # noqa: E402
from sedifoam_tpu_torch import cases, validate  # noqa: E402
from sedifoam_tpu_torch.dem import neighbor as tnb  # noqa: E402
from sedifoam_tpu_torch.dem.state import make_particles  # noqa: E402
from sedifoam_tpu_torch.validate import battery, bedload, irregular  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401

IRREGULAR_KEYS = {
    "quick", "case", "grid", "n_particles", "n_clumps", "t_end",
    "wall_time_s", "member_gap_max_dev", "frozen_max_disp", "clump_mean_vx",
    "clump_mean_vy", "alpha_min", "alpha_max", "finite", "n_active",
    "timing_split_ms", "gates", "passed"}
BEDLOAD_KEYS = {
    "quick", "grid", "n_particles", "t_end", "wall_time_s", "Ub_bulk",
    "gradP_mean", "tau_b", "shields_theta", "q_star", "q_star_mpm",
    "q_ratio_vs_mpm", "frozen_max_disp", "finite", "n_active",
    "timing_split_ms", "gates", "passed"}
DT = 1e-4


def _jsemi(cfg):
    return dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=True))


def _close(ref, got, tol, what):
    scale = max(abs(ref), 1e-300)
    assert abs(ref - got) <= tol * scale, (what, ref, got)
    return abs(ref - got) / scale


# -- irregular --------------------------------------------------------------

@pytest.fixture(scope="module")
def irregular_run(tmp_path_factory):
    case = str(tmp_path_factory.mktemp("irr") / "irregular")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # the loader's K cap
        res = irregular.run(t_end=2.5 * DT, clumps=30, coarsen=1,
                            quick=True, device="cpu", counts=(9, 8, 6),
                            floor_d=0.002, case_dir=case, capacity=1024,
                            steps_per_host_visit=3, timing_reps=1)
    return case, res


def test_irregular_keys_and_gates(irregular_run):
    _, res = irregular_run
    assert IRREGULAR_KEYS <= set(res)
    assert res["steps"] == 3 and res["grid"] == [9, 8, 6]
    assert abs(res["t_reached"] - 3 * DT) < 1e-9
    assert res["n_particles"] == res["n_active"] == 648 + 90
    assert set(res["gates"]) == {"finite", "rigid_members",
                                 "frozen_immobile", "no_escapes",
                                 "alpha_bounds"}
    assert res["not_evaluated"] == ["transporting"]
    assert all(res["gates"].values()) and res["passed"]
    assert res["member_gap_max_dev"] < 1e-7
    assert res["nbr_dropped"] == 0
    json.dumps(res)                            # one JSON line


def test_irregular_matches_reference(irregular_run):
    case, res = irregular_run
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        cfg, fluid, particles, _ = jload(case, backend="binned",
                                         dtype=jnp.float32, capacity=1024)
    cfg = _jsemi(cfg)
    state = jinitialize(fluid, particles, cfg)
    sim = JSimulation(cfg, state, steps_per_host_visit=3)
    sim.run(2.5 * DT)
    ps, fs = sim.state.particles, sim.state.fluid
    assert int(fs.step) == res["steps"]
    member = np.asarray(ps.mol > 0) & np.asarray(ps.active)
    mvel = np.asarray(ps.vel)[member]
    speed = float(np.abs(mvel).max())
    worst = 0.0
    for key, ref in (("clump_mean_vx", float(mvel[:, 0].mean())),
                     ("clump_mean_vy", float(mvel[:, 1].mean()))):
        assert abs(ref - res[key]) <= 1e-4 * speed, (key, ref, res[key])
        worst = max(worst, abs(ref - res[key]) / speed)
    amax = _close(float(jnp.max(fs.alpha)), res["alpha_max"], 1e-4,
                  "alpha_max")
    # alpha_min is round-off of the smoothing around 0 in both
    assert abs(float(jnp.min(fs.alpha)) - res["alpha_min"]) <= 1e-6
    assert int(np.asarray(ps.active).sum()) == res["n_active"]
    assert int(ps.nbr_dropped) == res["nbr_dropped"] == 0
    print(f"irregular vs reference: mean velocity {worst:.3e} of the "
          f"fastest member, alpha_max {amax:.3e}")


def test_irregular_quick_defaults(capsys):
    """--quick's settings, read from the parser without running; main
    prints the result as one JSON line and returns it."""
    captured = {}

    def fake_run(*a, **kw):
        captured["args"] = a
        return {"passed": True}

    real = irregular.run
    irregular.run = fake_run
    try:
        res = irregular.main(["--quick", "--device", "cpu"])
    finally:
        irregular.run = real
    t_end, clumps, coarsen, quick, out, device = captured["args"]
    assert (t_end, clumps, coarsen, quick, device) == (0.05, 150, 4, True,
                                                       "cpu")
    assert res == {"passed": True}
    assert json.loads(capsys.readouterr().out.strip()) == res


# -- bedload ----------------------------------------------------------------

@pytest.fixture(scope="module")
def bedload_run(tmp_path_factory):
    case = str(tmp_path_factory.mktemp("bed") / "bedload")
    res = bedload.run(t_end=3.5 * DT, t_settle=1.5 * DT, coarsen=1, layers=2,
                      quick=True, device="cpu", counts=(14, 13, 6),
                      case_dir=case, capacity=2048, steps_per_host_visit=2,
                      timing_reps=1)
    return case, res


def test_bedload_keys_and_gates(bedload_run):
    _, res = bedload_run
    assert BEDLOAD_KEYS <= set(res)
    assert res["grid"] == [14, 13, 6]
    # 2 settling steps, the clock set back, 4 forced steps
    assert res["steps"] == 6
    assert res["n_particles"] == res["n_active"] == 2 * 46 * 22
    assert set(res["gates"]) == {"finite", "frozen_immobile", "no_escapes"}
    assert res["not_evaluated"] == ["transporting", "mpm_band"]
    assert all(res["gates"].values()) and res["passed"]
    assert res["gradP_mean"] > 0.0 and res["Ub_bulk"] > 0.0
    json.dumps(res)


def test_bedload_matches_reference(bedload_run):
    case, res = bedload_run
    cfg, fluid, particles, _ = jload(case, backend="binned",
                                     dtype=jnp.float32, capacity=2048)
    cfg = _jsemi(cfg)
    state = jinitialize(fluid, particles, cfg)
    cfg_settle = dataclasses.replace(cfg, fluid=dataclasses.replace(
        cfg.fluid, forcing=JChannelForcing(mode="none")))
    sim0 = JSimulation(cfg_settle, state, steps_per_host_visit=2)
    sim0.run(1.5 * DT)
    state = sim0.state._replace(fluid=sim0.state.fluid._replace(
        time=jnp.zeros_like(sim0.state.fluid.time)))
    box = cases.CHANNEL_BOX
    area = (box[1] - box[0]) * (box[5] - box[4])
    cellV = np.asarray(cfg.grid.cell_volume)
    gp, q, vb = [], [], []

    def on_sample(sim):
        ps, fs = sim.state.particles, sim.state.fluid
        mob = ps.active & (ps.ptype == 1)
        vp = (4.0 / 3.0) * np.pi * np.asarray(ps.radius) ** 3
        q.append(float(jnp.sum(jnp.where(mob, ps.vel[:, 0], 0.0)
                               * jnp.asarray(vp))) / area)
        gp.append(float(fs.grad_p_value))
        vb.append(float(jnp.sum((1.0 - fs.alpha) * cellV)))

    sim = JSimulation(cfg, state, steps_per_host_visit=2)
    sim.run(3.5 * DT, on_sample=on_sample)
    fs = sim.state.fluid
    assert int(fs.step) == res["steps"] and len(gp) == 2
    worst = max(
        _close(float(np.mean(gp)), res["gradP_mean"], 1e-4, "gradP_mean"),
        _close(float(jnp.mean(fs.Ub[0])), res["Ub_bulk"], 1e-4, "Ub_bulk"))
    d, s = bedload.D, bedload.RHOA / cfg.fluid.rhob
    q_star = float(np.mean(q)) / np.sqrt((s - 1.0) * 9.81 * d ** 3)
    # q* and tau_b are rounded to 4 places in the result, as in the
    # reference script: half a unit of the last place on top
    assert abs(q_star - res["q_star"]) <= 1e-4 * abs(q_star) + 5e-5
    tau_b = cfg.fluid.rhob * float(np.mean(gp)) * float(np.mean(vb)) / area
    assert abs(tau_b - res["tau_b"]) <= 1e-4 * abs(tau_b) + 5e-5
    assert int(np.asarray(sim.state.particles.active).sum()) \
        == res["n_active"]
    print(f"bedload vs reference: worst {worst:.3e}")


def test_bedload_sampler_fetches_once(bedload_run):
    """One sample = one device-to-host fetch (a single .tolist())."""
    samples = {"t": [], "q": [], "gp": [], "Vb": []}
    cfg, state = validate.load(bedload_run[0], 1, "cpu", 2048)

    class Sim:
        pass

    sim = Sim()
    sim.state = state
    fetches = []
    real = torch.Tensor.tolist

    def counting(self):
        fetches.append(self.shape)
        return real(self)

    torch.Tensor.tolist = counting
    try:
        bedload.sampler(cfg, samples)(sim)
    finally:
        torch.Tensor.tolist = real
    assert fetches == [torch.Size([4])]
    assert samples["t"] == [0.0] and samples["q"] == [0.0]
    total = (cases.CHANNEL_BOX[1] * cases.CHANNEL_BOX[3]
             * cases.CHANNEL_BOX[5])
    assert 0.5 * total < samples["Vb"][0] < total


# -- a run stopped by its wall-time limit -------------------------------------

class _FakeSim:
    """Simulation's loop without the physics: 25 steps a visit, each
    step `cost` seconds of the clock that run_until reads."""

    def __init__(self, clock, cost):
        import types
        self.cfg = types.SimpleNamespace(fluid=types.SimpleNamespace(dt=DT))
        self.steps_per_visit = 25
        self.steps, self.calls = 0, []
        self.clock, self.cost = clock, cost

    @property
    def t(self):
        return float(np.float32(self.steps * DT))

    def run(self, t_end, **kw):
        self.calls.append(t_end)
        while self.t < t_end - 1e-12:
            self.steps += self.steps_per_visit
            self.clock[0] += self.steps_per_visit * self.cost


def test_run_until_stops_before_the_limit(monkeypatch):
    import time

    clock = [0.0]
    monkeypatch.setattr(time, "perf_counter", lambda: clock[0])
    # no limit: one call (the ends lie half a step short: f32 time)
    end = 0.06 - 0.5 * DT
    sim = _FakeSim(clock, 0.4)
    assert validate.run_until(sim, end) is True
    assert sim.calls == [end] and sim.steps == 600
    # a limit that is never reached: chunks of 250 steps, the same steps
    sim = _FakeSim(clock, 0.4)
    assert validate.run_until(sim, end, max_wall=1e9) is True
    assert sim.steps == 600 and len(sim.calls) == 3
    # 100 s a chunk, 350 s allowed: 3 chunks run (before a fourth the
    # clock reads 300 s, and 300 + 1.2 x 100 s is over the limit), and the
    # run says it was cut
    clock[0] = 0.0
    sim = _FakeSim(clock, 0.4)
    assert validate.run_until(sim, 10 * end, max_wall=350.0) is False
    assert sim.steps == 750 and clock[0] == pytest.approx(300.0)


# -- the helpers moved out of chip_smoke.py -----------------------------------

def _clump_state():
    rng = np.random.RandomState(0)
    base = rng.rand(4, 1, 3) * 5e-3
    offs = np.array([[-1e-3, 0, 0], [0, 0, 0], [1.5e-3, 0, 0]])[None]
    pos = np.concatenate([rng.rand(5, 3) * 5e-3,
                          (base + offs).reshape(-1, 3)])
    mol = np.concatenate([np.zeros(5, int), np.repeat(np.arange(1, 5), 3)])
    return make_particles(pos, 2e-4, 2650.0, mol=mol, capacity=20,
                          n_walls=1, neighbor_k=4, dtype=torch.float64,
                          device="cpu")


def test_member_gaps_follow_rows():
    p = _clump_state()
    gaps = irregular.member_gaps(p)
    assert gaps.shape == (4, 2)
    np.testing.assert_allclose(gaps.numpy(), np.tile([1e-3, 1.5e-3], (4, 1)),
                               rtol=1e-12)
    order = torch.as_tensor(np.random.RandomState(1).permutation(20))
    q = tnb.permute_particle_state(p, order)
    assert torch.equal(irregular.member_gaps(q), gaps)


def test_same_body_slots_counts():
    p = _clump_state()
    n = p.n_capacity
    idx = torch.full((4, n), n, dtype=torch.int32)
    idx[0, 5] = 6          # same body (rows 5, 6, 7 are body 1)
    idx[1, 5] = 8          # another body
    idx[0, 0] = 1          # two free spheres
    assert irregular.same_body_slots(p._replace(nbr_idx=idx)) == 1


# -- battery ------------------------------------------------------------------

@pytest.mark.parametrize("name,data,quick,expect", [
    ("irregular", {"passed": True}, False, True),
    ("irregular", {"passed": False}, False, False),
    ("irregular", {}, False, False),
    ("transport-bedload", {"passed": True}, True, True),
    ("transport-bedload", {"error": "boom"}, False, False),
    ("xiaocase3", {"finite": True, "curve_max_dev": 0.001, "v_end": 0.049,
                   "v_end_benchmark": 0.05}, False, True),
    ("xiaocase3", {"finite": True, "curve_max_dev": 0.005, "v_end": 0.049,
                   "v_end_benchmark": 0.05}, False, False),
    ("xiaocase3", {"finite": True, "curve_max_dev": 0.001, "v_end": 0.04,
                   "v_end_benchmark": 0.05}, False, False),
    ("xiaocase3", {"finite": True, "curve_max_dev": 0.001, "v_end": 0.04,
                   "v_end_benchmark": 0.05}, True, True),
    ("xiaocase3", {"finite": True, "v_end": 0.05}, False, False),
    ("xiaocase3", {"finite": True, "curve_max_dev": None, "v_end": 0.05,
                   "v_end_benchmark": 0.05}, False, False),
    ("jetFlow", {"not_run": "no files", "passed": True}, False, False),
    ("some-new-case", {"passed": True}, False, False),
])
def test_battery_judge(name, data, quick, expect):
    assert battery.judge(name, data, quick) is expect


def test_battery_partial_replaces_only_at_completion(tmp_path):
    report = str(tmp_path / "out" / "torch_report.json")
    seen = []

    def first():
        seen.append((os.path.exists(report),
                     os.path.exists(report + ".partial")))
        return {"passed": True}

    def second():
        with open(report + ".partial") as f:
            seen.append(json.load(f)["cases"]["irregular"]["passed"])
        return {"passed": False}

    rep = battery.run_battery({"irregular": first,
                               "transport-bedload": second}, report,
                              say=lambda m: None)
    assert seen == [(False, False), True]
    assert os.path.exists(report) and not os.path.exists(report + ".partial")
    with open(report) as f:
        assert json.load(f) == rep
    assert rep["cases"]["irregular"]["passed"] is True
    assert rep["cases"]["transport-bedload"]["passed"] is False
    # the cases the repository holds no files for are listed, not passed
    for name, why in battery.NOT_RUN.items():
        assert rep["cases"][name] == {"passed": False, "not_run": why}
    assert battery.summary(rep) == (1, 2, len(battery.NOT_RUN))

    # an interrupted full run leaves the complete report in place
    def boom():
        raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        battery.run_battery({"irregular": first, "transport-bedload": boom},
                            report, say=lambda m: None)
    with open(report) as f:
        assert json.load(f) == rep
    assert os.path.exists(report + ".partial")

    # --only merges one case into the report; a crash is a failed case
    def crash():
        raise ValueError("diverged")

    rep2 = battery.run_battery({"irregular": crash,
                                "transport-bedload": second}, report,
                               only=["irregular"], say=lambda m: None)
    assert rep2["cases"]["irregular"]["passed"] is False
    assert "diverged" in rep2["cases"]["irregular"]["error"]
    assert rep2["cases"]["transport-bedload"]["passed"] is False
    assert battery.summary(rep2)[:2] == (0, 2)


def test_battery_never_writes_the_reference_report(capsys):
    with pytest.raises(SystemExit):
        battery.main(["--report",
                      os.path.join(battery.RESULTS, "report.json"),
                      "--device", "cpu"])
    assert "reference battery's report" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        battery.main(["--only", "BL24-TH1", "--device", "cpu"])
