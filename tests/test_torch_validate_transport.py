"""The port's transport-suspended and transport-vortex-dune validators
(sedifoam_tpu_torch/validate/suspended.py, dune.py) and their case
writers on the CPU, against the reference scripts and the JAX package.

- the bed writers at the full box: cases.suspended_bed and
  cases.dune_bed give exactly the rows that scripts/validate_suspended.py
  `synth_bed` and scripts/validate_dune.py `synth_dune` write (34,046 and
  58,212 grains; the crest x0 = 0.062354 m);
- each validator on a shrunken case (the box cut in x and z): suspended
  1,045 grains in a table of 2,048 on an (8, 13, 5) mesh; the dune 582
  grains in 1,024 on an (8, 6, 4) two-block mesh coarsened 2x to (4, 3,
  2); 2 settling steps, the clock set back, 4 forced steps, a sample
  every step (the Ubar controller's kick lands in the first forced step:
  sampled, it sets the forcing's scale), f32: the result's keys, the
  gates of a cut run, `not_evaluated`; each sample one device-to-host
  fetch;
- the same written directory through the JAX package (its load_case at
  K = 8, the same coarsening, semi-implicit drag, its Simulation with
  the same steps per visit, the settle-then-force sequence, the samples
  by the reference scripts' formulas): every sample of q, gradP, the
  fluid volume, y_com and frac_hi (suspended), q and the hump's centre
  (dune), and Ub_bulk within 1e-4 of scale, counts and n_active exact.
  The dune runs with `subCycles 5`, so this holds the five-cycle step
  against the reference. Measured worst: suspended 1.8e-5 (y_com; q
  5.7e-6, gradP 7.2e-6, the fluid volume 5.9e-8, frac_hi 0, Ub_bulk
  2.7e-6), dune 6.9e-7 (q; the hump's centre equal to its last bit);
- the coarsened two-block dune grid has the JAX package's coarsen_faces
  faces at factors 2, 3 and 4 (the block joint kept only where the
  factor divides the lower block's cells);
- battery: both cases runnable, judged by `passed` (pass, fail, missing
  key, quick), no longer in NOT_RUN; --quick's settings of each main.

Serial wall time on this file: about 95 s with two threads (the two
reference runs, 28 s and 43 s, compile a JAX Simulation for the settling
and the forced configuration each).
"""

import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu.config import ChannelForcing as JChannelForcing  # noqa: E402
from sedifoam_tpu.fluid.state import init_fluid as jinit_fluid  # noqa: E402
from sedifoam_tpu.grid import Grid as JGrid  # noqa: E402
from sedifoam_tpu.io.case import load_case as jload  # noqa: E402
from sedifoam_tpu.runtime.runner import Simulation as JSimulation  # noqa: E402
from sedifoam_tpu.solver import initialize as jinitialize  # noqa: E402
from sedifoam_tpu.utils.postprocess import coarsen_faces as jcoarsen  # noqa: E402
from sedifoam_tpu_torch import cases, validate  # noqa: E402
from sedifoam_tpu_torch.validate import battery, dune, suspended  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401

DT = 1e-4
VISIT = 1                 # a sample every step: the forcing's kick is one
SUSP_BOX = (0.0, 0.02, 0.0, 0.04, 0.0, 0.012)
SUSP = dict(counts=(8, 13, 5), box=SUSP_BOX, capacity=2048, coarsen=1)
DUNE_BOX = (0.0, 0.02, 0.0, 0.0167, 0.0, 0.004)
DUNE = dict(counts=(8, 6, 4), bed_cells=2, box=DUNE_BOX, capacity=1024,
            coarsen=2)
COMMON_KEYS = {"quick", "grid", "n_particles", "t_end", "t_reached",
               "steps", "wall_time_s", "Ub_bulk", "q_star",
               "frozen_max_disp", "finite", "n_active", "nbr_dropped",
               "timing_split_ms", "gates", "not_evaluated", "passed"}
SUSP_KEYS = COMMON_KEYS | {"gradP_mean", "u_star", "w_s_ferguson_church",
                           "rouse_number", "y_com_initial", "y_com_late",
                           "frac_above_quarter_depth"}
DUNE_KEYS = COMMON_KEYS | {"x_crest_initial", "dune_migration_m",
                           "migration_celerity_mm_s"}
CUT_GATES = {"finite", "frozen_immobile", "no_escapes", "k_audit"}


def _rows_of(path):
    with open(path) as f:
        return f.read().split("Atoms\n\n")[1].strip().split("\n")


# -- the bed writers against the reference scripts ----------------------------

def test_suspended_bed_is_the_scripts_bed(tmp_path):
    from scripts import validate_suspended as ref
    n = ref.synth_bed(str(tmp_path / "bed.in"), cases.SAND_D, 2)
    rows = cases.suspended_bed()
    assert n == len(rows) == 34046
    assert rows == _rows_of(tmp_path / "bed.in")
    assert tuple(ref.BOX) == cases.SUSPENDED_BOX
    assert sum(r.split()[1] == "2" for r in rows) == 235 * 116


def test_dune_bed_is_the_scripts_bed(tmp_path):
    from scripts import validate_dune as ref
    n, x0 = ref.synth_dune(str(tmp_path / "dune.in"), cases.SAND_D, 6)
    rows, x0p = cases.dune_bed()
    assert n == len(rows) == 58212
    assert rows == _rows_of(tmp_path / "dune.in")
    assert x0p == x0 == pytest.approx(0.062354, abs=1e-12)
    assert tuple(ref.BOX) == cases.DUNE_BOX


# -- the validators on shrunken cases -----------------------------------------

def _run(module, tmp_path_factory, name, **kw):
    case = str(tmp_path_factory.mktemp(name) / name)
    out = str(tmp_path_factory.mktemp(name + "_out") / "samples.npz")
    res = module.run(t_end=3.5 * DT, t_settle=1.5 * DT, quick=True,
                     device="cpu", case_dir=case, out=out,
                     steps_per_host_visit=VISIT, timing_reps=1, **kw)
    return case, res, dict(np.load(out))


@pytest.fixture(scope="module")
def suspended_run(tmp_path_factory):
    return _run(suspended, tmp_path_factory, "suspended", **SUSP)


@pytest.fixture(scope="module")
def dune_run(tmp_path_factory):
    return _run(dune, tmp_path_factory, "dune", **DUNE)


@pytest.mark.parametrize("which", ["suspended", "dune"])
def test_keys_and_gates_of_a_cut_run(which, suspended_run, dune_run):
    _, res, samples = suspended_run if which == "suspended" else dune_run
    keys, module = (SUSP_KEYS, suspended) if which == "suspended" \
        else (DUNE_KEYS, dune)
    assert keys <= set(res)
    # 2 settling steps, the clock set back to 0, 4 forced steps (a
    # sample each)
    assert res["steps"] == 6
    assert abs(res["t_reached"] - 4 * DT) < 1e-9
    np.testing.assert_allclose(samples["t"], DT * np.arange(1, 5),
                               rtol=1e-6)
    assert set(res["gates"]) == CUT_GATES
    assert res["not_evaluated"] == list(module.FULL_GATES)
    assert all(res["gates"].values()) and res["passed"]
    assert res["n_particles"] == res["n_active"]
    assert res["nbr_dropped"] == 0 and res["frozen_max_disp"] == 0.0
    assert res["q_star"] > 0.0 and res["Ub_bulk"] > 0.0
    json.dumps(res)                            # one JSON line


def test_shrunken_cases_sizes(suspended_run, dune_run):
    assert suspended_run[1]["n_particles"] == 38 * 22 + 19 * 11
    assert suspended_run[1]["grid"] == [8, 13, 5]
    assert dune_run[1]["n_particles"] == len(cases.dune_bed(
        box=DUNE_BOX)[0]) == 582
    assert dune_run[1]["grid"] == [4, 3, 2]


def test_suspended_reports_the_scripts_formulas(suspended_run):
    _, res, samples = suspended_run
    s = suspended.RHOA / 1000.0
    w_s = suspended.settling_velocity_fc(cases.SAND_D, s=s)
    assert res["w_s_ferguson_church"] == round(w_s, 4)
    u_star = math.sqrt(1000.0 * res["gradP_mean"] * np.mean(samples["Vb"])
                       / (0.02 * 0.012) / 1000.0)
    assert res["u_star"] == pytest.approx(round(u_star, 4), abs=1e-12)
    assert res["rouse_number"] == pytest.approx(
        round(w_s / (0.41 * u_star), 3), abs=1e-12)


class _Sim:
    def __init__(self, state):
        self.state = state


def _count_fetches(fn):
    """(method, shape) of every device-to-host read made by fn() (numpy()
    is left out: it raises on a device tensor, and on a host tensor it
    reads no device)."""
    seen = []
    names = ("tolist", "cpu", "item", "__float__", "__int__", "__bool__")
    real = {n: getattr(torch.Tensor, n) for n in names}

    def counting(name):
        def method(self, *a, **kw):
            seen.append((name, tuple(self.shape)))
            return real[name](self, *a, **kw)
        return method

    for n in names:
        setattr(torch.Tensor, n, counting(n))
    try:
        fn()
    finally:
        for n in names:
            setattr(torch.Tensor, n, real[n])
    return seen


def test_suspended_sampler_fetches_once(suspended_run):
    cfg, state = validate.load(suspended_run[0], 1, "cpu", 2048, 8)
    samples = {k: [] for k in ("t", "q", "gp", "Vb", "ycom", "frac_hi")}
    on_sample = suspended.sampler(cfg, samples, SUSP_BOX)
    assert _count_fetches(lambda: on_sample(_Sim(state))) == [("tolist",
                                                                (6,))]
    assert samples["t"] == [0.0] and samples["q"] == [0.0]
    assert samples["frac_hi"] == [0.0]
    assert samples["ycom"][0] == pytest.approx(
        cases.SAND_D * (0.5 + 1.025), rel=1e-6)   # the second layer


def test_dune_sampler_fetches_once(dune_run):
    _, state = validate.load(dune_run[0], 2, "cpu", 1024, 8)
    samples = {"t": [], "q": [], "xcom": []}
    _, x0 = cases.dune_bed(box=DUNE_BOX)
    on_sample = dune.sampler(samples, DUNE_BOX, x0)
    assert _count_fetches(lambda: on_sample(_Sim(state))) == [("cpu",
                                                                (2 + 1024,))]
    assert samples["t"] == [0.0] and samples["q"] == [0.0]
    # the jittered lattice is symmetric about the crest but for the
    # jitter and the columns' rounding to whole layers
    assert abs(samples["xcom"][0] - x0) < 2.5e-4


def test_hump_center_takes_the_minimum_image():
    Lx = 0.1
    x = np.array([0.099, 0.001, 0.097, 0.003])     # a hump across x = Lx
    assert dune.hump_center(x, 0.0, Lx) == pytest.approx(0.0, abs=1e-15)
    assert dune.hump_center(x + 0.05, 0.05, Lx) == pytest.approx(0.05)


# -- the same written directories through the JAX package ---------------------

def _jax_case(case, capacity, coarsen):
    cfg, fluid, particles, _ = jload(case, backend="binned", neighbor_k=8,
                                     dtype=jnp.float32, capacity=capacity)
    cfg = dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=True))
    if coarsen > 1:
        g = cfg.grid
        grid = JGrid.from_faces(*(jcoarsen(np.asarray(g.axis_faces(a)),
                                           coarsen) for a in range(3)))
        cfg = dataclasses.replace(cfg, grid=grid)
        fluid = jinit_fluid(grid, dtype=jnp.float32)
    state = jinitialize(fluid, particles, cfg)
    cfg_settle = dataclasses.replace(cfg, fluid=dataclasses.replace(
        cfg.fluid, forcing=JChannelForcing(mode="none")))
    sim0 = JSimulation(cfg_settle, state, steps_per_host_visit=VISIT)
    sim0.run(1.5 * DT)
    state = sim0.state._replace(fluid=sim0.state.fluid._replace(
        time=jnp.zeros_like(sim0.state.fluid.time)))
    return cfg, state


def _close_series(ref, got, what):
    ref, got = np.asarray(ref, float), np.asarray(got, float)
    scale = max(float(np.abs(ref).max()), 1e-300)
    err = float(np.abs(ref - got).max()) / scale
    assert err <= 1e-4, (what, ref, got)
    return err


def test_suspended_matches_reference(suspended_run):
    case, res, got = suspended_run
    cfg, state = _jax_case(case, SUSP["capacity"], 1)
    H = SUSP_BOX[3]
    area = SUSP_BOX[1] * SUSP_BOX[5]
    cellV = np.asarray(cfg.grid.cell_volume)
    mob0 = np.asarray(state.particles.active
                      & (state.particles.ptype == 1))
    ref = {k: [] for k in ("q", "gp", "Vb", "ycom", "frac_hi")}

    def on_sample(sim):
        ps, fs = sim.state.particles, sim.state.fluid
        mob = np.asarray(ps.active) & (np.asarray(ps.ptype) == 1)
        pos = np.asarray(ps.pos)
        vp = (4.0 / 3.0) * np.pi * np.asarray(ps.radius) ** 3
        ref["q"].append(float((np.asarray(ps.vel)[mob, 0] * vp[mob]).sum())
                        / area)
        ref["gp"].append(float(fs.grad_p_value))
        ref["Vb"].append(float(jnp.sum((1.0 - fs.alpha) * cellV)))
        ref["ycom"].append(float(pos[mob, 1].mean()))
        ref["frac_hi"].append(float((pos[mob, 1] > 0.25 * H).mean()))

    y_com0 = float(np.asarray(state.particles.pos)[mob0, 1].mean())
    sim = JSimulation(cfg, state, steps_per_host_visit=VISIT)
    sim.run(3.5 * DT, on_sample=on_sample)
    fs, ps = sim.state.fluid, sim.state.particles
    assert int(fs.step) == res["steps"] and len(ref["q"]) == 4
    errs = {k: _close_series(ref[k], got[k], k) for k in ref}
    errs["Ub_bulk"] = _close_series([float(jnp.mean(fs.Ub[0]))],
                                    [res["Ub_bulk"]], "Ub_bulk")
    assert abs(y_com0 - res["y_com_initial"]) <= 1e-4 * y_com0 + 5e-6
    assert int(np.asarray(ps.active).sum()) == res["n_active"]
    assert int(ps.nbr_dropped) == res["nbr_dropped"] == 0
    assert cfg.dem.nbr_k == 23
    print("suspended vs reference: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()))


def test_dune_matches_reference(dune_run):
    case, res, got = dune_run
    cfg, state = _jax_case(case, DUNE["capacity"], DUNE["coarsen"])
    assert cfg.cloud.sub_cycles == 5 and cfg.cloud.sub_steps == 16
    _, x0 = cases.dune_bed(box=DUNE_BOX)
    Lx = DUNE_BOX[1]
    area = Lx * DUNE_BOX[5]
    ref = {"q": [], "xcom": []}

    def center(ps):
        mob = np.asarray(ps.active) & (np.asarray(ps.ptype) == 1)
        dx = np.asarray(ps.pos)[mob, 0].astype(np.float64) - x0
        dx -= Lx * np.round(dx / Lx)
        return x0 + float(dx.mean())

    def on_sample(sim):
        ps = sim.state.particles
        mob = np.asarray(ps.active) & (np.asarray(ps.ptype) == 1)
        vp = (4.0 / 3.0) * np.pi * np.asarray(ps.radius) ** 3
        ref["q"].append(float((np.asarray(ps.vel)[mob, 0] * vp[mob]).sum())
                        / area)
        ref["xcom"].append(center(ps))

    x_com0 = center(state.particles)
    sim = JSimulation(cfg, state, steps_per_host_visit=VISIT)
    sim.run(3.5 * DT, on_sample=on_sample)
    fs, ps = sim.state.fluid, sim.state.particles
    assert int(fs.step) == res["steps"] and len(ref["q"]) == 4
    worst = _close_series(ref["q"], got["q"], "q")
    # the centre moves by micrometres: held to its displacement's scale
    mig_ref = np.asarray(ref["xcom"]) - x_com0
    assert abs(x_com0 - res["x_crest_initial"]) <= 5e-6 + 1e-9
    x_err = float(np.abs(np.asarray(ref["xcom"]) - got["xcom"]).max())
    assert x_err <= 1e-4 * float(np.abs(mig_ref).max()), (ref, got)
    worst = max(worst, x_err / float(np.abs(mig_ref).max()),
                _close_series([float(jnp.mean(fs.Ub[0]))], [res["Ub_bulk"]],
                              "Ub_bulk"))
    assert int(np.asarray(ps.active).sum()) == res["n_active"]
    assert int(ps.nbr_dropped) == res["nbr_dropped"] == 0
    print(f"dune vs reference: worst {worst:.3e} "
          f"(x_com {x_err / x0:.3e} of x)")


def test_coarsened_two_block_grid_matches_reference(tmp_path):
    from sedifoam_tpu.io.case import read_block_mesh as jread
    from sedifoam_tpu_torch.io.case import read_block_mesh
    cases.write_dune_case(str(tmp_path / "dune"), crest_layers=1,
                          box=(0.0, 0.155885, 0.0, 0.0167, 0.0, 0.002))
    path = str(tmp_path / "dune" / "constant" / "polyMesh" / "blockMeshDict")
    grid, patches = read_block_mesh(path)
    jgrid, jpatches = jread(path)
    assert grid.shape == tuple(jgrid.shape) == (156, 26, 40)
    assert patches == jpatches
    y = np.asarray(grid.axis_faces(1))
    assert y[cases.DUNE_FULL["bed_cells"]] == pytest.approx(
        cases.DUNE_BED_TOP, abs=1e-15)

    @dataclasses.dataclass
    class Cfg:
        grid: object

    for factor in (2, 3, 4):
        coarse = validate.coarsened(Cfg(grid), factor).grid
        for a in range(3):
            ref = jcoarsen(np.asarray(jgrid.axis_faces(a)), factor)
            np.testing.assert_array_equal(
                np.asarray(coarse.axis_faces(a)), ref)
        joint_kept = bool(np.isclose(np.asarray(coarse.axis_faces(1)),
                                     cases.DUNE_BED_TOP, atol=1e-12).any())
        assert joint_kept is (cases.DUNE_FULL["bed_cells"] % factor == 0)


# -- battery ------------------------------------------------------------------

@pytest.mark.parametrize("name", ["transport-suspended",
                                  "transport-vortex-dune"])
@pytest.mark.parametrize("data,quick,expect", [
    ({"passed": True}, False, True),
    ({"passed": False}, False, False),
    ({}, False, False),
    ({"passed": True, "quick": True}, True, True),
])
def test_battery_judges_the_transport_cases(name, data, quick, expect):
    assert battery.judge(name, data, quick) is expect


def test_battery_runs_the_transport_cases():
    runners = battery.case_runners("cpu", quick=True)
    for name in ("transport-suspended", "transport-vortex-dune"):
        assert name in runners and name not in battery.NOT_RUN
    assert len(battery.NOT_RUN) == 6
    assert set(runners) == {"xiaocase3", "irregular", "transport-bedload",
                            "transport-suspended", "transport-vortex-dune",
                            "jetFlow"}


@pytest.mark.parametrize("module,names", [
    (suspended, ("t_end", "t_avg_start", "t_settle", "coarsen", "layers",
                 "quick", "out", "device")),
    (dune, ("t_end", "t_settle", "coarsen", "crest_layers", "quick", "out",
            "device")),
])
def test_quick_defaults(module, names, capsys, monkeypatch):
    """--quick's settings and the defaults, read from the parser without
    running; main prints the result as one JSON line and returns it."""
    captured = {}

    def fake_run(*a, **kw):
        captured["args"], captured["kw"] = a, kw
        return {"passed": True}

    monkeypatch.setattr(module, "run", fake_run)
    res = module.main(["--quick", "--device", "cpu"])
    got = dict(zip(names, captured["args"]))
    assert {k: got[k] for k in module.QUICK} == module.QUICK
    assert got["quick"] is True and got["device"] == "cpu"
    assert captured["kw"] == {"max_wall": None}
    assert res == {"passed": True}
    assert json.loads(capsys.readouterr().out.strip()) == res
    module.main(["--device", "cpu"])
    got = dict(zip(names, captured["args"]))
    assert got["t_end"] == 1.5 and got["t_settle"] == 0.2
    assert got["coarsen"] == 2 and got["quick"] is False
