"""The port's telemetry (sedifoam_tpu_torch/telemetry.py) on the CPU: the
counter registry, the counters it keeps (linsolve.STATS, the contact
chain's launch counts, the rebuild counter), the phase clock's switch
and Simulation.run's spans. On the card (marked `cuda`): the clock's
slots against CUDA events over the same replays, and the bench bed
replayed with the clock on bit for bit against the clock off. Imports
nothing of JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_telemetry.py
"""

import collections

import pytest

torch = pytest.importorskip("torch")

from sedifoam_tpu_torch import bench_case, linsolve, telemetry  # noqa: E402
from sedifoam_tpu_torch.dem import fused, neighbor  # noqa: E402
from sedifoam_tpu_torch.dem.integrate import (run_dem,  # noqa: E402
                                              setup_forces)
from sedifoam_tpu_torch.dem.state import make_particles  # noqa: E402
from sedifoam_tpu_torch.graphs import flatten  # noqa: E402
from sedifoam_tpu_torch.runtime.runner import Simulation  # noqa: E402
from sedifoam_tpu_torch.solver import (CoupledStep, GraphedStep,  # noqa: E402
                                       initialize)
from torch_port_util import few_threads  # noqa: E402,F401

TINY = dict(n_particles=256, nx=8, ny=16, nz=8)


@pytest.fixture(autouse=True)
def telemetry_off():
    """Every test starts and ends with telemetry off and no span kept."""
    telemetry.enable(False)
    telemetry._SPANS.clear()
    yield
    telemetry.enable(False)
    telemetry._SPANS.clear()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _tiny_sim(device="cpu", **kw):
    cfg = bench_case.build_config(**TINY)
    fluid, particles = bench_case.build_state(cfg, TINY["n_particles"],
                                              device=device)
    return Simulation(cfg, initialize(fluid, particles, cfg), device=device,
                      **kw)


# ---- the registry --------------------------------------------------------

def test_registry_adds_in_place_reads_resets_and_restores():
    reg = telemetry.Registry()
    a = reg.counter("a", "cpu")
    b = reg.counter("b", "cpu", ("x", "y"))
    assert reg.counter("a", "cpu") is a
    a.add_(3)
    b[1].add_(5)
    assert reg.read() == {"a": 3, "b.x": 0, "b.y": 5}
    assert reg.value("b") == [0, 5] and reg.value("missing") == 0
    saved = reg.snapshot("b")
    b.add_(1)
    reg.counter("b2", "cpu").add_(7)
    reg.restore(saved, "b")
    # in place, and a counter made after the snapshot reads zero
    assert reg.counter("b", "cpu") is b
    assert reg.read() == {"a": 3, "b.x": 0, "b.y": 5, "b2": 0}
    reg.reset("a")
    assert reg.read("a") == {"a": 0} and reg.value("b") == [0, 5]
    reg.reset()
    assert set(reg.read().values()) == {0}


def test_capture_restores_all_but_the_chain_launches():
    """The families solver.GraphedStep restores around its capture: the
    solver counts, the rebuilds and the clock, not the chain's
    launches inside graphs."""
    dev = torch.device("cpu")
    telemetry.counter("fused.launches.8", dev)
    names = ("linsolve.pcg", "rebuilds", "fused.launches.8")
    before = {n: telemetry.REGISTRY.value(n) for n in names}
    saved = telemetry.snapshot(telemetry.CAPTURE_RESTORED)
    linsolve.STATS.add("pcg", torch.tensor(4))
    telemetry.count("rebuilds", dev)
    telemetry.count("fused.launches.8", dev)
    telemetry.restore(saved, telemetry.CAPTURE_RESTORED)
    assert linsolve.STATS["pcg"] == (before["linsolve.pcg"] or [0, 0])
    assert telemetry.REGISTRY.value("rebuilds") == before["rebuilds"]
    assert telemetry.REGISTRY.value("fused.launches.8") == \
        before["fused.launches.8"] + 1
    fused.reset_launches()


class _ParentStats:
    """linsolve._Stats as it kept its own storage before the registry:
    the yardstick of the counts."""

    def __init__(self):
        self.counters = {}

    def add(self, name, it):
        c = self.counters.setdefault(
            (name, it.device), torch.zeros(2, dtype=torch.int64,
                                           device=it.device))
        c[0].add_(1)
        c[1].add_(it)

    def read(self):
        out = {n: [0, 0] for n in linsolve._Stats.NAMES}
        for (n, _), c in self.counters.items():
            out[n] = [a + int(b) for a, b in zip(out[n], c.tolist())]
        return out


def test_stats_read_as_before_on_an_eager_run(monkeypatch):
    """linsolve.STATS over a short eager run of the tiny bed reads what
    the parent's own storage counts of the same solves."""
    parent = _ParentStats()
    add = linsolve.STATS.add

    def both(name, it):
        parent.add(name, it)
        add(name, it)

    monkeypatch.setattr(linsolve.STATS, "add", both)
    linsolve.reset_stats()
    sim = _tiny_sim()
    sim.run(sim.t + 3.5 * sim.cfg.fluid.dt)
    assert dict(linsolve.STATS) == parent.read()
    assert linsolve.STATS["pcg"][1] > 0
    saved = linsolve.STATS.snapshot()
    sim.run(sim.t + 1.5 * sim.cfg.fluid.dt)
    assert dict(linsolve.STATS) == parent.read()
    linsolve.STATS.restore(saved)
    assert linsolve.STATS["pcg"] != parent.read()["pcg"]
    linsolve.reset_stats()
    assert dict(linsolve.STATS) == {n: [0, 0] for n in linsolve.STATS}


def test_launch_counts_read_as_before():
    """The contact chain's counts, eager on the host and inside graphs
    on the device (here a CPU tensor stands in), read through
    launches(), launch_sizes() and graph_launches() as before, and
    launch_snapshot/launch_restore put them back."""
    dev = torch.device("cpu")
    fused.reset_launches()
    for n in (64, 64, 32):
        fused._count(n, dev)
    telemetry.counter("fused.launches.64", dev).add_(5)    # 5 replays
    assert fused.LAUNCHES == 3
    assert fused.launch_sizes() == collections.Counter({64: 7, 32: 1})
    assert fused.graph_launches() == 5 and fused.launches() == 8
    snap = fused.launch_snapshot()
    fused._count(16, dev)
    telemetry.counter("fused.launches.32", dev).add_(2)
    assert fused.launches() == 11
    fused.launch_restore(snap)
    assert fused.launch_sizes() == collections.Counter({64: 7, 32: 1})
    assert fused.LAUNCHES == 3 and fused.graph_launches() == 5
    fused.reset_launches()
    assert fused.launches() == 0 and fused.LAUNCHES == 0


# ---- the rebuild counter ---------------------------------------------------

def test_rebuilds_count_each_rebuild(monkeypatch):
    """A small binned bed of fast grains stepped eagerly past several
    skin rebuilds: the counter adds one for each rebuild that ran."""
    import numpy as np
    from sedifoam_tpu_torch.config import DEMConfig, PairParams, WallSpec
    r, box = 5e-4, 0.02
    rng = np.random.RandomState(3)
    pos = rng.uniform(2 * r, box - 2 * r, size=(48, 3))
    vel = rng.randn(48, 3) * 5.0
    pair = PairParams(style="hertz_history", kn=1e5, gamman=0.7, xmu=0.4)
    walls = tuple(WallSpec(style=s, lo=0.0, hi=box, params=pair)
                  for s in ("xplane", "yplane", "zplane"))
    cfg = DEMConfig(dt=1e-6, pair=pair, walls=walls,
                    gravity=(0.0, -9.81, 0.0), backend="binned", nbr_k=32,
                    max_per_bin=8, cutoff=2 * r * 1.6, skin=0.6 * r,
                    domain_lo=(0.0,) * 3, domain_hi=(box,) * 3)
    st = make_particles(pos, r, 2500.0, vel=vel, n_walls=3, neighbor_k=32,
                        dtype=torch.float64, device="cpu")
    ran = [0]
    carry = neighbor.carry_over_shear

    def spy(*a, **kw):
        ran[0] += 1                     # once in every rebuild body
        return carry(*a, **kw)

    monkeypatch.setattr(neighbor, "carry_over_shear", spy)
    before = telemetry.REGISTRY.value("rebuilds")
    st = setup_forces(st, cfg)
    st = run_dem(st, cfg, 300)
    assert ran[0] >= 5
    assert telemetry.REGISTRY.value("rebuilds") - before == ran[0]


# ---- the clock's switch and the spans -------------------------------------

def test_off_keeps_no_span_and_marks_nothing(monkeypatch):
    """With telemetry off a run keeps no span and a mark touches
    nothing, not even for a CUDA device; on, a mark on the CPU still
    makes nothing."""
    def refuse():
        raise AssertionError("the clock's kernel was built")

    monkeypatch.setattr(telemetry, "_library", refuse)
    sim = _tiny_sim(probe_locations=[(0.004, 0.004, 0.004)],
                    steps_per_host_visit=2)
    sim.run(sim.t + 3.5 * sim.cfg.fluid.dt, log_every=1)
    telemetry.mark("gap", torch.device("cuda"))
    assert telemetry.spans() == []
    assert not any(k.startswith("span.") for k in telemetry.read())
    telemetry.enable(True)
    telemetry.mark("fluid", torch.device("cpu"))
    assert (telemetry.CLOCK, torch.device("cpu")) not in \
        telemetry.REGISTRY.tensors


def test_run_spans_nest_and_add_self_time(tmp_path):
    """Simulation.run on a tiny CPU case with telemetry on: each visit is
    a run.visit span with its parts as children, and each name's self
    time is its durations less its children's."""
    telemetry.enable(True)
    sim = _tiny_sim(probe_locations=[(0.004, 0.004, 0.004)],
                    steps_per_host_visit=2)
    dt = sim.cfg.fluid.dt
    seen = []
    sim.run(sim.t + 5.5 * dt, probe_every=1, log_every=2,
            write_dir=str(tmp_path), write_interval=3.5 * dt,
            on_sample=lambda s: seen.append(s.t))
    recs = telemetry.spans()
    names = collections.Counter(s.name for s in recs)
    assert names == {"run.visit": 3, "run.replay": 3, "run.time_read": 3,
                     "run.probes": 3, "run.on_sample": 3,
                     "run.diagnostics": 1, "run.write": 1}
    visits = [s for s in recs if s.name == "run.visit"]
    assert all(s.parent is None for s in visits)
    own = collections.Counter()
    for s in recs:
        if s.name == "run.visit":
            continue
        assert s.parent == "run.visit"
        holder = [v for v in visits
                  if v.start_ns <= s.start_ns and s.end_ns <= v.end_ns]
        assert len(holder) == 1
        own[holder[0]] += s.end_ns - s.start_ns
        own[s.name] += s.end_ns - s.start_ns
    tot = telemetry.read()
    assert tot["span.run.visit.count"] == 3
    assert tot["span.run.visit.total_ns"] == sum(
        v.end_ns - v.start_ns for v in visits)
    assert tot["span.run.visit.self_ns"] == sum(
        v.end_ns - v.start_ns - own[v] for v in visits)
    for name in names:
        if name != "run.visit":
            assert tot[f"span.{name}.self_ns"] == \
                tot[f"span.{name}.total_ns"] == own[name]
    assert len(seen) == 3


# ---- on the card -----------------------------------------------------------

def _bench(dev, sizes):
    cfg = bench_case.build_config(**sizes)
    fluid, particles = bench_case.build_state(cfg, sizes["n_particles"],
                                              device=dev)
    return cfg, initialize(fluid, particles, cfg)


def _replays(cfg, state, dev, n):
    """(the GraphedStep, the state after n replays of it, a copy)."""
    step = GraphedStep(CoupledStep(cfg, torch.float32, dev))
    ps = state.particles
    s = state._replace(particles=ps._replace(
        shear=ps.shear.clone(), wall_shear=ps.wall_shear.clone()))
    for _ in range(n):
        s = step(s)
    return step, [t.clone() for t in flatten(s)]


@pytest.mark.cuda
def test_phase_slots_sum_to_event_time_on_card():
    """The four slots over replays 2..n of the bench bed sum to the CUDA
    events' time around them within 1%; the steps slot counts them."""
    dev = _card()
    cfg, state = _bench(dev, bench_case.FULL)
    telemetry.enable(True)
    step = GraphedStep(CoupledStep(cfg, torch.float32, dev))
    s = step(state)
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    acc = telemetry.counter(telemetry.CLOCK, dev, telemetry.CLOCK_FIELDS)
    n = 20
    s = step(s)
    start = acc.clone()               # on the stream: no sync
    e0.record()
    for _ in range(n - 1):
        s = step(s)
    e1.record()
    e1.synchronize()
    got = (acc - start).tolist()
    phases_ms = sum(got[:len(telemetry.SLOTS)]) / 1e6
    event_ms = e0.elapsed_time(e1)
    assert got[-1] == n - 1
    assert all(v > 0 for v in got[:len(telemetry.SLOTS)]), got
    assert abs(phases_ms - event_ms) <= 0.01 * event_ms, (phases_ms,
                                                           event_ms)


@pytest.mark.cuda
def test_clock_on_is_bitwise_clock_off_on_card():
    """20 replays of the bench bed with the clock captured into the
    graph give the state of 20 replays without it, bit for bit."""
    dev = _card()
    cfg, state = _bench(dev, bench_case.FULL)
    _, off = _replays(cfg, state, dev, 20)
    telemetry.enable(True)
    step, on = _replays(cfg, state, dev, 20)
    assert telemetry.REGISTRY.value(telemetry.CLOCK)[-1] >= 19
    for a, b in zip(off, on):
        assert torch.equal(a, b)
