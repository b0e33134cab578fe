"""jetFlow on the port: the written case (cases.write_jetflow_case) and
its validator (sedifoam_tpu_torch/validate/jetflow.py) on the CPU,
against the JAX package.

- the written blockMeshDict through both packages'
  read_block_mesh_embedded: every assertion of tests/test_jetflow.py's
  test_embedded_mesh_geometry (56 x 120 x 56, the box, the mirrored
  0.06 side grading, the uniform 4.4 mm column, the inlet disc region of
  radius 2.5 mm inside `bottom`, `top` and `outer`), and the two grids,
  patches and regions equal; the refusal without embed_ogrid;
- load_case(embed_ogrid=True) at the full mesh through both packages:
  the assertions of test_case_loads_with_region_bcs (the RegionPatchBC
  inlet, inletOutlet and fixedValue at the top, the slip floor, kEqn
  from the LES subdict, the frozen type 2, adding and deleting, the
  disc's covered area against pi r^2 to 2e-2), and the two configs
  equal field by field (the reference's rebuilt from the port's
  classes);
- test_embedded_case_steps on both packages: the mesh coarsened 4x, f64,
  dense DEM, 2 coupled steps (200 substeps each): finite, the inlet flux
  equal to 1.72 x the disc's covered area to 1e-8 in each, and the two
  states equal to 1e-10 of scale (the ill-conditioned solid velocity
  aside, as in test_torch_clumps.py);
- the validator on a shrunken case (the full tank and axial mesh, 12
  cells across with a 4-cell column, an add every 6 steps, a DEM step of
  1e-5 s: 20 substeps, the window's floor lowered to 64 rows in both
  packages), 20 steps at 2 a visit, a probe sample every second visit
  (the validator's), f32,
  against the JAX package's Simulation on the same written directory
  with the same visits and samples: two adds of 16 particles and one
  window regrowth (64 -> 128 rows) in both; every probe sample of Ub,
  q_in and the disc area within 1e-4 of scale; n_active and the window
  sizes exact. The JAX package's own f32 flux, summed as the script
  sums it (numpy over float32), meets the script's 1e-6 gate on this
  case; the port's, summed in float64, does too;
- the battery: jetFlow runnable, judged by `passed`, no longer in
  NOT_RUN; --quick's settings of the validator's main.

Measured worst deviations (this file's run on the CPU): the 2 coupled
f64 steps 2.9e-14 of scale; the shrunken validator run: the Ub probes
3.3e-6 of their scale, q_in 8.8e-8; the JAX package's f32
inlet_flux_rel_err 1.3e-7, the port's 4.7e-8.

Serial wall time on this file: about 55 s with two threads (the JAX
package compiles its step once for the 2 f64 steps and once per window
size for the validator's run: 27 s of it).
"""

import dataclasses
import functools
import json

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu import bc as jbc  # noqa: E402
from sedifoam_tpu.fluid.state import init_fluid as jinit_fluid  # noqa: E402
from sedifoam_tpu.grid import Grid as JGrid  # noqa: E402
from sedifoam_tpu.io import case as jcase  # noqa: E402
from sedifoam_tpu.runtime import window as jwin  # noqa: E402
from sedifoam_tpu.runtime.runner import Simulation as JSimulation  # noqa: E402
from sedifoam_tpu.solver import initialize as jinitialize  # noqa: E402
from sedifoam_tpu.solver import make_step_fn as jmake_step  # noqa: E402
from sedifoam_tpu.utils.postprocess import coarsen_faces as jcoarsen  # noqa: E402
from sedifoam_tpu_torch import bc as tbc  # noqa: E402
from sedifoam_tpu_torch import bridge, cases, validate  # noqa: E402
from sedifoam_tpu_torch.fluid.state import init_fluid  # noqa: E402
from sedifoam_tpu_torch.io import case as tcase  # noqa: E402
from sedifoam_tpu_torch.runtime import window as twin  # noqa: E402
from sedifoam_tpu_torch.solver import CoupledStep, initialize  # noqa: E402
from sedifoam_tpu_torch.validate import battery, jetflow  # noqa: E402
from torch_port_cases import port_config  # noqa: E402
from torch_port_util import assert_tree_close, few_threads  # noqa: E402,F401

DT = 2e-4
VISIT = 2
STEPS = 20
W_MIN = 64                 # the window's floor in both packages
SHRUNK = dict(counts=(12, 120, 12), column_cells=4, add_interval=1.2e-3,
              dem_dt=1e-5)
SHRUNK_CAPACITY = 1024
ILL_CONDITIONED = ("Ua", "Ua_old", "phia", "phia_old", "DDtUa")
READERS = {"port": tcase.read_block_mesh_embedded,
           "jax": jcase.read_block_mesh_embedded}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    return cases.write_jetflow_case(
        str(tmp_path_factory.mktemp("jet") / "jetFlow"))


def _mesh(case_dir):
    return f"{case_dir}/constant/polyMesh/blockMeshDict"


def _covered_area(region, grid):
    m = np.asarray(region.mask(grid))[0]
    xf = np.asarray(grid.axis_faces(0))
    zf = np.asarray(grid.axis_faces(2))
    return float((m * np.diff(xf)[:, None] * np.diff(zf)[None, :]).sum())


# -- the mesh -----------------------------------------------------------------

@pytest.mark.parametrize("which", ["port", "jax"])
def test_embedded_mesh_geometry(case, which):
    """tests/test_jetflow.py::test_embedded_mesh_geometry on the written
    blockMeshDict."""
    grid, patch_faces, regions = READERS[which](_mesh(case))
    # 24 (side, graded) + 8 (column) + 24 per cross axis; 120 axial
    assert tuple(grid.shape) == (56, 120, 56)
    xf = np.asarray(grid.axis_faces(0))
    np.testing.assert_allclose([xf[0], xf[-1]], [-0.05, 0.05], atol=1e-12)
    # grading 0.06 outer->inner: cells shrink toward the jet column
    w = np.diff(xf)
    assert w[0] > 5 * w[23]
    np.testing.assert_allclose(w[:24], w[::-1][:24])   # mirrored sides
    np.testing.assert_allclose(w[24:32], 0.0044 / 8)   # uniform column
    # bottom face carries the inlet disc region (arc radius 2.5 mm)
    assert set(regions) == {2}
    inner, outer, disc = regions[2]
    assert (inner, outer) == ("inlet", "bottom")
    assert disc.axis == 1 and disc.radius == pytest.approx(0.0025)
    assert patch_faces["top"] == [3]
    assert sorted(patch_faces["outer"]) == [0, 1, 4, 5]
    yf = np.asarray(grid.axis_faces(1))
    np.testing.assert_allclose([yf[0], yf[-1]], [0.0, 0.3], atol=1e-12)
    assert np.diff(yf)[-1] == pytest.approx(4.0 * np.diff(yf)[0])


def test_both_readers_give_one_grid(case):
    grid, patches, regions = READERS["port"](_mesh(case))
    jgrid, jpatches, jregions = READERS["jax"](_mesh(case))
    for a in range(3):
        np.testing.assert_array_equal(np.asarray(grid.axis_faces(a)),
                                      np.asarray(jgrid.axis_faces(a)))
    assert patches == jpatches
    assert {k: (i, o, dataclasses.astuple(d))
            for k, (i, o, d) in regions.items()} == \
        {k: (i, o, dataclasses.astuple(d))
         for k, (i, o, d) in jregions.items()}


@pytest.mark.parametrize("which", ["port", "jax"])
def test_refused_without_opt_in(case, which):
    if which == "port":
        with pytest.raises(tcase.UnsupportedMeshError, match="embed_ogrid"):
            tcase.load_case(case, device="cpu")
    else:
        with pytest.raises(jcase.UnsupportedMeshError, match="embed_ogrid"):
            jcase.load_case(case)


# -- the loaded case ----------------------------------------------------------

@pytest.fixture(scope="module")
def loaded(case):
    t = tcase.load_case(case, embed_ogrid=True, capacity=512, device="cpu")
    j = jcase.load_case(case, embed_ogrid=True, capacity=512)
    return t, j


@pytest.mark.parametrize("which", ["port", "jax"])
def test_case_loads_with_region_bcs(loaded, which):
    """tests/test_jetflow.py::test_case_loads_with_region_bcs on the
    written directory."""
    bc = tbc if which == "port" else jbc
    cfg = (loaded[0] if which == "port" else loaded[1])[0]
    ub_ym = cfg.bcs.Ub.ym
    assert isinstance(ub_ym, bc.RegionPatchBC)
    assert ub_ym.inside.kind == bc.FIXED_VALUE
    assert ub_ym.inside.value == (0.0, 1.72, 0.0)
    assert ub_ym.outside.kind == bc.SLIP
    assert cfg.bcs.Ub.yp.kind == bc.INLET_OUTLET
    assert cfg.bcs.p.yp.kind == bc.FIXED_VALUE
    # scalar slip collapses to zeroGradient; Ua inlet slip == bottom slip
    assert cfg.bcs.alpha.ym.kind == bc.ZERO_GRADIENT
    assert cfg.bcs.Ua.ym.kind == bc.SLIP
    # the LES subdict of turbulenceProperties selects kEqn; the stale
    # constant/LESProperties names Smagorinsky
    assert cfg.fluid.turbulence.model == "kEqn"
    # type-2 `bottom` group is excluded from fix nve/sphere -> frozen
    assert cfg.dem.frozen_types == (2,)
    # particle injection near the inlet, deletion near the outlet
    assert cfg.cloud.add_particle == 1 and cfg.cloud.delete_particle == 1
    assert cfg.cloud.add_velocity == (0.0, 1.72, 0.0)
    # inlet disc flux: coverage-weighted area matches pi r^2
    np.testing.assert_allclose(_covered_area(ub_ym.region, cfg.grid),
                               np.pi * 0.0025 ** 2, rtol=2e-2)
    # the run shape: 200 substeps of 1e-6 s, the loader's K = 16 over the
    # 0.8 mm cutoff, three wall planes on the box
    assert cfg.cloud.sub_steps == 200 and cfg.cloud.sub_cycles == 1
    assert cfg.dem.dt == pytest.approx(1e-6)
    assert cfg.dem.nbr_k == 16 and cfg.dem.cutoff == pytest.approx(8e-4)
    assert cfg.dem.skin == pytest.approx(1.5e-4)
    assert [w.style for w in cfg.dem.walls] == ["xplane", "yplane", "zplane"]


def test_both_packages_load_one_case(loaded):
    (cfg, fluid, particles, controls), (jcfg, jfluid, jparticles,
                                        jcontrols) = loaded
    assert port_config(jcfg) == cfg
    assert dataclasses.asdict(controls) == dataclasses.asdict(jcontrols)
    assert (controls.dt, controls.end_time) == (2e-4, 1.5)
    for k in ("pos", "radius", "density", "ptype", "active", "tag"):
        np.testing.assert_array_equal(
            getattr(particles, k).numpy(), np.asarray(getattr(jparticles, k)),
            err_msg=k)
    assert int(particles.active.sum()) == 6
    assert sorted(particles.ptype[particles.active].tolist()) == \
        [1, 1, 2, 2, 2, 2]


def test_add_sites_and_boxes(loaded):
    """36 sites on the full mesh (the column's middle 6 x 6 cells), 16
    on the 2x-coarsened one, all inside the inlet disc, in the first cell
    layer; the delete box is the top two layers."""
    from sedifoam_tpu_torch.dem.inject import seed_positions
    cfg = loaded[0][0]
    add, delete = cases.jetflow_boxes()
    assert cfg.cloud.add_box == pytest.approx(add, abs=1e-12)
    assert cfg.cloud.clear_box == cfg.cloud.add_box
    assert cfg.cloud.delete_box == pytest.approx(delete, abs=1e-12)
    yf = np.asarray(cfg.grid.axis_faces(1))
    assert delete[2] == pytest.approx(yf[-3])
    for coarsen, n in ((1, 36), (2, 16)):
        g = validate.coarsened(cfg, coarsen).grid
        sites = seed_positions(g, cfg.cloud.add_box, 1)
        assert len(sites) == n
        assert np.all(np.hypot(sites[:, 0], sites[:, 2]) < 0.0025)
        y0 = np.asarray(g.axis_faces(1))[:2].mean()
        np.testing.assert_allclose(sites[:, 1], y0)


# -- two coupled steps in f64 -------------------------------------------------

def _nan_free(d):
    """The particle fields of a nested numpy SimState with their NaNs
    (the 0/0 drag of the table's empty rows) set to 0; where they were
    goes under "nan_at"."""
    nan_at = {}
    for k, v in d["particles"].items():
        if isinstance(v, np.ndarray) and np.issubdtype(v.dtype, np.floating):
            nan_at[k] = np.isnan(v)
            d["particles"][k] = np.where(nan_at[k], 0.0, v)
    d["nan_at"] = nan_at
    return d


def test_embedded_case_steps(case):
    """tests/test_jetflow.py::test_embedded_case_steps on both packages:
    the mesh coarsened 4x, f64, 2 coupled steps."""
    jcfg, jfl, jps, _ = jcase.load_case(case, embed_ogrid=True, capacity=64)
    g = jcfg.grid
    grid = JGrid.from_faces(*(jcoarsen(np.asarray(g.axis_faces(a)), 4)
                              for a in range(3)))
    jcfg = dataclasses.replace(jcfg, grid=grid)
    js = jinitialize(jinit_fluid(grid, dtype=jnp.float64), jps, jcfg)
    step = jmake_step(jcfg)
    for _ in range(2):
        js = step(js)

    cfg, _, ps, _ = tcase.load_case(case, embed_ogrid=True, capacity=64,
                                    device="cpu")
    cfg = validate.coarsened(cfg, 4)
    coupled = CoupledStep(cfg, torch.float64, "cpu")
    ts = initialize(init_fluid(cfg.grid, dtype=torch.float64, device="cpu"),
                    ps, cfg, coupled.smoother)
    for _ in range(2):
        ts = coupled(ts)

    area = _covered_area(cfg.bcs.Ub.ym.region, cfg.grid)
    assert area == _covered_area(jcfg.bcs.Ub.ym.region, grid)
    for fl, ps_ in ((js.fluid, js.particles), (ts.fluid, ts.particles)):
        assert bool(np.isfinite(np.asarray(fl.p)).all())
        assert bool(np.isfinite(np.asarray(fl.Ub)).all())
        assert bool(np.isfinite(np.asarray(ps_.pos)).all())
        qin = float(np.sum(np.asarray(fl.phib.y[:, 0])))
        np.testing.assert_allclose(qin, 1.72 * area, rtol=1e-8)
    ref, got = (_nan_free(bridge.sim_state_to_numpy(s)) for s in (js, ts))
    nan_ref, nan_got = ref.pop("nan_at"), got.pop("nan_at")
    for k in nan_ref:
        np.testing.assert_array_equal(nan_ref[k], nan_got[k], err_msg=k)
    worst = assert_tree_close(ref, got, 1e-10, skip=ILL_CONDITIONED)
    print(f"jetFlow 2 f64 steps vs reference: worst {worst:.3e}")


# -- the validator on a shrunken case ------------------------------------------

def _window_floor(mp, mod):
    mp.setattr(mod, "next_window", functools.partial(mod.next_window,
                                                     w_min=W_MIN))


@pytest.fixture(scope="module")
def shrunk_run(tmp_path_factory):
    case_dir = cases.write_jetflow_case(
        str(tmp_path_factory.mktemp("shrunk") / "jetFlow"), **SHRUNK)
    out = str(tmp_path_factory.mktemp("shrunk_out") / "centreline.npz")
    sims = []
    run_until = validate.run_until

    def kept(sim, *a, **kw):
        sims.append(sim)
        return run_until(sim, *a, **kw)

    with pytest.MonkeyPatch.context() as mp:
        _window_floor(mp, twin)
        mp.setattr(jetflow, "HEARTBEAT_VISITS", 1)
        mp.setattr(validate, "run_until", kept)
        res = jetflow.run(t_end=(STEPS - 0.5) * DT, device="cpu",
                          capacity=SHRUNK_CAPACITY, case=case_dir,
                          steps_per_host_visit=VISIT, timing_reps=1,
                          out=out)
    (sim,) = sims
    return case_dir, res, dict(np.load(out)), sim.state.particles


def test_keys_and_gates_of_a_shrunken_run(shrunk_run):
    _, res, samples, _ = shrunk_run
    keys = {"t_end", "quick", "grid", "wall_time_s", "inlet_flux_rel_err",
            "disc_area_rel_err", "n_particles_active", "finite",
            "timing_split_ms", "continuity_err", "gates", "passed",
            "uc_mean_by_station", "decay_B_by_station", "t_reached",
            "steps", "windows", "captures", "capture_s", "capture_log",
            "progress", "not_evaluated", "nbr_k", "sub_steps",
            "chain_launches", "nbr_dropped"}
    assert keys == set(res)
    assert res["steps"] == STEPS and res["grid"] == [12, 120, 12]
    assert res["sub_steps"] == 20 and res["nbr_k"] == 16
    assert res["nbr_dropped"] == 0
    # a full run's gates are all evaluated; on 4 ms of jet the decay and
    # the population gates fail, as they must
    assert set(res["gates"]) == {"finite", "inlet_flux", "disc_area",
                                 "uc_monotone", "decay_band",
                                 "particles_flowing"}
    assert res["not_evaluated"] == []
    assert res["gates"]["finite"] and res["gates"]["inlet_flux"]
    assert res["gates"]["disc_area"]
    assert not res["gates"]["particles_flowing"] and not res["passed"]
    # 6 seeds and two adds of 16 sites; the window grew once
    assert res["n_particles_active"] == 6 + 2 * 16
    assert res["windows"] == [64, 128]
    assert [p["visit"] for p in res["progress"]] == list(
        range(1, STEPS // VISIT + 1))
    assert res["captures"] == 0 and res["capture_log"] == []
    assert res["chain_launches"] == {}        # no kernel on the CPU
    assert samples["uc"].shape == (STEPS // VISIT // jetflow.PROBE_EVERY,
                                   5)
    np.testing.assert_allclose(samples["stations"], jetflow.STATIONS)
    json.dumps(res)


def test_shrunken_run_matches_reference(shrunk_run):
    case_dir, res, samples, ports = shrunk_run
    cfg, fluid, particles, _ = jcase.load_case(
        case_dir, backend="binned", dtype=jnp.float32, embed_ogrid=True,
        capacity=SHRUNK_CAPACITY)
    state = jinitialize(fluid, particles, cfg)
    probes = [(0.0, s * cases.JET_D, 0.0) for s in jetflow.STATIONS]
    windows = []

    def on_sample(sim):
        w = sim.state.particles.n_capacity
        if not windows or windows[-1] != w:
            windows.append(w)

    with pytest.MonkeyPatch.context() as mp:
        _window_floor(mp, jwin)
        sim = JSimulation(cfg, state, probe_locations=probes,
                          steps_per_host_visit=VISIT)
        sim.run((STEPS - 0.5) * DT, probe_every=jetflow.PROBE_EVERY,
                on_sample=on_sample)
    times, Ub = sim.probes.series("Ub")
    fs, ps = sim.state.fluid, sim.state.particles
    assert int(fs.step) == res["steps"]
    np.testing.assert_allclose(samples["times"], times, rtol=1e-6)
    ub_ref = np.asarray(Ub[:, 1, :], np.float64)
    err_ub = float(np.abs(ub_ref - samples["uc"]).max()
                   / np.abs(ub_ref).max())
    assert err_ub <= 1e-4, (ub_ref, samples["uc"])
    assert windows == res["windows"]
    assert int(np.asarray(ps.active).sum()) == res["n_particles_active"]
    # the particle rows at the end: the same rows active, and the added
    # particles' positions and velocities
    active = np.asarray(ps.active)
    np.testing.assert_array_equal(ports.active.numpy(), active)
    err_rows = {}
    for name in ("pos", "vel"):
        ref = np.asarray(getattr(ps, name), np.float64)[active]
        got = getattr(ports, name).double().numpy()[active]
        err_rows[name] = float(np.abs(got - ref).max() / np.abs(ref).max())
        assert err_rows[name] <= 1e-4, (name, err_rows[name])
    # the script's flux: numpy's sum over the float32 faces
    m_area = _covered_area(cfg.bcs.Ub.ym.region, cfg.grid)
    q_disc = cases.JET_U * m_area
    q_ref = float(np.sum(np.asarray(fs.phib.y[:, 0])))
    jax_flux_err = abs(q_ref / q_disc - 1.0)
    assert jax_flux_err < 1e-6
    q_port = (1.0 + res["inlet_flux_rel_err"]) * q_disc
    err_q = abs(q_port - q_ref) / abs(q_ref)
    assert err_q <= 1e-4
    area_err = abs(m_area / (np.pi * 0.0025 ** 2) - 1.0)
    assert abs(area_err - res["disc_area_rel_err"]) <= 1e-4 * area_err
    print(f"jetFlow shrunken run vs reference: Ub probes {err_ub:.3e}, "
          f"q_in {err_q:.3e}, particle pos {err_rows['pos']:.3e}, vel "
          f"{err_rows['vel']:.3e}; JAX f32 inlet_flux_rel_err "
          f"{jax_flux_err:.3e}, port {res['inlet_flux_rel_err']:.3e}")


# -- battery -------------------------------------------------------------------

@pytest.mark.parametrize("data,quick,expect", [
    ({"passed": True}, False, True),
    ({"passed": False}, False, False),
    ({}, False, False),
    ({"passed": True, "quick": True}, True, True),
])
def test_battery_judges_jetflow(data, quick, expect):
    assert battery.judge("jetFlow", data, quick) is expect


def test_battery_runs_jetflow():
    runners = battery.case_runners("cpu", quick=True)
    assert "jetFlow" in runners and "jetFlow" not in battery.NOT_RUN
    assert "jetFlow" in battery.VALIDATED


def test_quick_defaults(capsys, monkeypatch):
    """--quick's settings and the defaults, read from the parser without
    running; main prints the result as one JSON line and returns it."""
    captured = {}

    def fake_run(*a, **kw):
        captured["args"], captured["kw"] = a, kw
        return {"passed": True}

    names = ("t_end", "quick", "out", "device", "capacity", "coarsen", "f64")
    monkeypatch.setattr(jetflow, "run", fake_run)
    res = jetflow.main(["--quick", "--device", "cpu"])
    got = dict(zip(names, captured["args"]))
    assert {k: got[k] for k in jetflow.QUICK} == jetflow.QUICK
    assert got["quick"] is True and got["device"] == "cpu"
    assert captured["kw"] == {"case": None, "max_wall": None}
    assert res == {"passed": True}
    assert json.loads(capsys.readouterr().out.strip()) == res
    jetflow.main(["--device", "cpu", "--case", "/some/case", "--max-wall",
                  "60"])
    got = dict(zip(names, captured["args"]))
    assert got["t_end"] == 1.5 and got["coarsen"] == 1
    assert got["capacity"] == 65536 and got["quick"] is False
    assert captured["kw"] == {"case": "/some/case", "max_wall": 60.0}
    # the script's rule: --quick shortens only a default t_end
    jetflow.main(["--quick", "--t-end", "0.1", "--device", "cpu"])
    got = dict(zip(names, captured["args"]))
    assert got["t_end"] == 0.1 and got["capacity"] == 8192
