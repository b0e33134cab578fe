"""Tests of the port that need a CUDA card (the contact-chain kernel has
its own file, tests/test_torch_contact_chain.py). They import no JAX, so
they run where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

- the xiaocase3 golden curve: the full 250-step run (endTime 0.005 s /
  deltaT 2e-5) of the port's xiaocase3 (dense DEM backend, f64) through
  Simulation, against tests/golden_data/xiaoCase3.dat with the reference
  test's bounds (tests/test_golden_xiaocase3.py): terminal velocity
  within 5% of the 0.05 m/s inflow, the curve within 0.004 m/s after the
  first 2e-4 s;
- the particle-to-grid scatter repeats bit for bit on the card;
- so does a run resumed from a checkpoint (the bench case, small, f32,
  through the kernel): the straight run and the resumed run end equal;
- replays of the captured step (solver.GraphedStep) equal the eager
  step bit for bit, with no host sync inside a replay.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sedifoam_tpu_torch import bench_case, cases  # noqa: E402
from sedifoam_tpu_torch.coupling import transfer  # noqa: E402
from sedifoam_tpu_torch.runtime.checkpoint import _flatten  # noqa: E402
from sedifoam_tpu_torch.runtime.runner import Simulation  # noqa: E402
from sedifoam_tpu_torch.solver import CoupledStep  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "golden_data")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_xiaocase3_settling_curve_on_card():
    dev = _card()
    cfg, fluid, particles = cases.xiaocase3(torch.float64, dev)
    state = CoupledStep(cfg, torch.float64, dev).initialize(fluid,
                                                            particles)
    sim = Simulation(cfg, state, device=dev)
    times, vels = [], []

    def record(s):
        times.append(s.t)
        vels.append(float(s.state.particles.vel[0, 1]))

    sim.run(250 * cfg.fluid.dt, on_sample=record)
    times, vels = np.asarray(times), np.asarray(vels)
    assert len(times) == 250

    bench = np.loadtxt(os.path.join(DATA, "xiaoCase3.dat"))
    vb = np.interp(times, bench[:, 0], bench[:, 1])
    assert abs(vels[-1] - vb[-1]) < 0.05 * 0.05
    mask = times > 2e-4
    err = np.max(np.abs(vels[mask] - vb[mask]))
    print(f"xiaocase3 on {torch.cuda.get_device_name(0)}: v_y(end) "
          f"{vels[-1]:.6f} m/s, max deviation {err:.6f} m/s, "
          f"{sim.wall_time:.2f} s")
    assert err < 0.004, f"max deviation {err:.4g} m/s vs benchmark"


@pytest.mark.cuda
def test_scatter_repeats_bitwise_on_card():
    """200k values into 512 cells (about 400 per cell): the sums come
    out the same every time, and match an f64 sum to f32 round-off."""
    dev = _card()
    g = torch.Generator(device="cpu").manual_seed(0)
    n, cells_n = 200_000, 512
    w = torch.randn(n, 4, generator=g).to(dev)
    cells = torch.randint(0, cells_n, (n,), generator=g).to(dev)
    first = transfer._segment_sum(w, cells, cells_n)
    for _ in range(5):
        assert torch.equal(transfer._segment_sum(w, cells, cells_n), first)
    ref = torch.zeros(cells_n, 4, dtype=torch.float64, device=dev
                      ).index_add_(0, cells, w.double())
    assert float((first.double() - ref).abs().max()) < 1e-4


@pytest.mark.cuda
def test_resume_bitwise_on_card(tmp_path):
    dev = _card()
    small = dict(n_particles=2048, nx=8, ny=16, nz=8)
    cfg = bench_case.build_config(**small)
    fluid, particles = bench_case.build_state(cfg, small["n_particles"],
                                              torch.float32, dev)
    state = CoupledStep(cfg, torch.float32, dev).initialize(fluid,
                                                            particles)
    dt = cfg.fluid.dt
    sim = Simulation(cfg, state, device=dev)
    sim.run(2.5 * dt)                                   # 3 steps
    ck = sim.save_checkpoint(str(tmp_path / "ck.npz"))
    sim.run(5.5 * dt)                                   # to step 6
    sim2 = Simulation(cfg, state, device=dev)
    sim2.resume(ck)
    sim2.run(5.5 * dt)
    assert int(sim.state.fluid.step) == int(sim2.state.fluid.step) == 6
    for (name, a), (_, b) in zip(_flatten(sim.state), _flatten(sim2.state)):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("sort", [False, True])
def test_graphed_step_replays_the_eager_step_on_card(sort):
    """The bench case, small, binned, f32: 6 replays of the captured step
    (rebuild conds and PCG while loops inside) equal 6 eager steps bit for
    bit, with the same solver iterations, no host sync inside a replay,
    and unrelated allocations between the replays."""
    import warnings

    from sedifoam_tpu_torch import graphs, linsolve
    from sedifoam_tpu_torch.solver import GraphedStep
    dev = _card()
    small = dict(n_particles=2048, nx=8, ny=16, nz=8)
    cfg = bench_case.build_config(**small, backend="binned",
                                  sort_on_rebuild=sort)
    fluid, particles = bench_case.build_state(cfg, small["n_particles"],
                                              torch.float32, dev)
    step = CoupledStep(cfg, torch.float32, dev)
    state = step.initialize(fluid, particles)
    eager = step(graphs.tree_map(torch.clone, state))
    linsolve.reset_stats()
    for _ in range(5):
        eager = step(eager)
    stats = dict(linsolve.STATS)
    graphed = GraphedStep(step)
    out = graphed(graphs.tree_map(torch.clone, state))   # capture + step 1
    linsolve.reset_stats()
    junk = []
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            for _ in range(5):
                junk.append(torch.full((1 << 18,), float("nan"), device=dev))
                out = graphed(out)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # (the mode's first use warns that it is a prototype: no sync)
    assert not [w for w in seen
                if "called a synchronizing CUDA operation" in str(w.message)]
    assert graphed.captures == 1 and graphed.graph.nodes["while"] > 0
    assert dict(linsolve.STATS) == stats and stats["pcg"][1] > 0
    for a, b in zip(graphs.flatten(eager), graphs.flatten(out)):
        assert torch.equal(a, b) or (a.is_floating_point() and torch.equal(
            a.nan_to_num(7.0), b.nan_to_num(7.0)))
