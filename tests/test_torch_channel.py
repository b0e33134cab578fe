"""The channel-transport slice and the case entry points, against
sedifoam_tpu on the CPU.

- 3 coupled steps of the coarse transport-bedload channel (14 x 13 x 6
  cells, two bed layers pressed 2 um into each other, 2,024 particles:
  contacts with shear history in the first step, the layers apart again
  by the third) loaded from its directory by
  each package: binned DEM with K = 16, f64, kEqn LES (BiCGStab), Ubar
  forcing, the semi-implicit drag, periodic x/z, the frozen type-2 bed
  and fix fdrag's carrier density (DDtU on). Every field agrees to 1e-9
  of its scale (measured: 1.6e-11 at worst), except the solid-phase
  velocity Ua = smoothed(vol*U)/alpha and what is built from it (phia,
  DDtUa), which divide by alpha at round-off level in empty cells and are
  compared as alpha*Ua; the frozen rows do not move in either package.
- Simulation.from_case on the written xiaocase3 for 3 steps equals
  Simulation(cfg, state) of cases.xiaocase3() bit for bit.
- python -m sedifoam_tpu_torch.run_case prints scripts/run_case.py's
  JSON summary keys (a subprocess on the CPU).
- The three entry points and the builders run on the CUDA card unless
  asked for the CPU: with no card and no device they raise, naming the
  CPU's option.
"""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu.io.case import load_case as jload  # noqa: E402
from sedifoam_tpu.solver import coupled_step as jcoupled  # noqa: E402
from sedifoam_tpu.solver import initialize as jinit  # noqa: E402
from sedifoam_tpu_torch import bridge, cases, linsolve  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.dem import fused  # noqa: E402
from sedifoam_tpu_torch.io.case import load_case as tload  # noqa: E402
from sedifoam_tpu_torch.runtime.runner import Simulation  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import assert_tree_close, rel_err  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ILL_CONDITIONED = ("Ua", "Ua_old", "phia", "phia_old", "DDtUa")


def _semi(cfg):
    return dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=True))


def test_channel_three_steps_match_reference(tmp_path):
    case = cases.write_channel_case(str(tmp_path / "channel"),
                                    counts=(14, 13, 6), layers=2,
                                    overlap=2e-6)
    cj, fj, pj, _ = jload(case, backend="binned", dtype=jnp.float64)
    ct, ft, pt, _ = tload(case, backend="binned", device="cpu")
    cj, ct = _semi(cj), _semi(ct)
    assert tsolver.need_ddtu(ct) and ct.dem.nbr_k == 16
    frozen = pt.ptype == 2
    pos0 = pt.pos[frozen].clone()

    sj = jinit(fj, pj, cj)
    step_j = jax.jit(lambda s: jcoupled(s, cj))
    linsolve.reset_stats()
    launches = fused.LAUNCHES
    step_t = tsolver.CoupledStep(ct, device="cpu")
    st = step_t.initialize(ft, pt)
    for n in range(3):
        sj, st = step_j(sj), step_t(st)
        if n == 0:
            # contacts with shear history (the fluid is still at rest:
            # its fluxes are round-off, compared after step 3)
            ref = bridge.tree_to_numpy(sj.particles)
            assert np.any(ref["shear"] != 0.0)
            assert_tree_close(ref, bridge.tree_to_numpy(st.particles), 1e-9)
    ref = bridge.sim_state_to_numpy(sj)
    got = bridge.sim_state_to_numpy(st)
    assert_tree_close(ref, got, 1e-9, skip=ILL_CONDITIONED)
    assert fused.LAUNCHES == launches        # CPU: the plain chain
    assert linsolve.STATS["bicgstab"][0] == 3      # one kEqn solve a step
    assert int(ref["particles"]["nbr_dropped"]) == 0
    assert rel_err(np.asarray(sj.fluid.alpha)[None] * np.asarray(sj.fluid.Ua),
                   st.fluid.Uc) <= 1e-9
    # the frozen bed is exactly still; Ubar drives the stream
    assert torch.equal(st.particles.pos[frozen], pos0)
    np.testing.assert_array_equal(ref["particles"]["pos"][frozen.numpy()],
                                  pos0.numpy())
    assert float(st.fluid.grad_p_value) > 0.0
    assert bool(torch.any(st.fluid.drag_coef != 0))      # semi-implicit
    assert bool(torch.any(st.fluid.DDtUb != 0))
    assert int(st.particles.active.sum()) == 2024


def test_from_case_matches_built_xiaocase3(tmp_path):
    case = cases.write_xiaocase3(str(tmp_path / "xiaocase3"))
    sim = Simulation.from_case(case, device="cpu")
    assert sim.controls.dt == 2e-5 and sim.controls.end_time == 0.005
    assert sim.cfg.dem.backend == "dense"
    assert sim.state.fluid.p.dtype == torch.float64
    cfg, fluid, particles = cases.xiaocase3(device="cpu")
    built = Simulation(cfg, tsolver.initialize(fluid, particles, cfg),
                       device="cpu")
    for s in (sim, built):
        s.run(2.5 * cfg.fluid.dt)
    assert int(sim.state.fluid.step) == int(built.state.fluid.step) == 3
    assert_tree_close(bridge.sim_state_to_numpy(built.state),
                      bridge.sim_state_to_numpy(sim.state), 0.0)


def test_run_case_module_prints_summary(tmp_path):
    case = cases.write_xiaocase3(str(tmp_path / "xiaocase3"))
    out = tmp_path / "out"
    out.mkdir()
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-m", "sedifoam_tpu_torch.run_case", case, "--f64",
         "--backend", "dense", "--t-end", "6e-5", "--out-dir", str(out),
         "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert res.returncode == 0, res.stderr
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    # scripts/run_case.py's keys (final_diagnostics only once logged)
    assert set(summary) == {"case", "t_end", "n_particles", "wall_time_s",
                            "steps_per_s"}
    assert summary["case"] == "xiaocase3" and summary["n_particles"] == 1
    assert summary["t_end"] == 6e-5
    probes = np.load(out / "probes.npz")
    assert probes["p"].shape[0] == 1 and np.isfinite(probes["p"]).all()


def test_entry_points_need_the_card_unless_asked_for_the_cpu(
        tmp_path, monkeypatch, capsys):
    """load_case, Simulation.from_case and run_case, and the builders
    (CoupledStep, make_step_fn, bench_case.build_state, cases.xiaocase3,
    cases.inject_case), given no device use the CUDA card; where there is
    none they raise and name device="cpu" / --device cpu, and nothing
    runs on the CPU."""
    from sedifoam_tpu_torch import bench_case, run_case
    case = cases.write_xiaocase3(str(tmp_path / "xiaocase3"))
    cfg = cases.xiaocase3(device="cpu")[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda: tload(case), cases.xiaocase3,
                  lambda: cases.inject_case(nx=4, ny=8, nz=4, capacity=64),
                  lambda: bench_case.build_state(cfg, 1),
                  lambda: tsolver.CoupledStep(cfg),
                  lambda: tsolver.make_step_fn(cfg)):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            build()
    with pytest.raises(RuntimeError, match="--device cpu"):
        Simulation.from_case(case)
    with pytest.raises(SystemExit) as exit_:
        run_case.main([case, "--t-end", "6e-5"])
    assert exit_.value.code == 2
    assert "--device cpu" in capsys.readouterr().err
