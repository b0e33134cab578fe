"""One run of one cell: set-up, the measured window, the traced span,
the comparison with the reference, and the result line.

Set-up makes the configuration's inputs from the seed, loads them into
the program, `initialize`s the state, builds a
`runtime.runner.Simulation` (on the card it captures
`solver.GraphedStep` at its first step) and runs the warm-up visits
through `Simulation.run`. The window is one `Simulation.run` call,
closed at the first host visit that ends after `seconds`: every visit
replays `steps_per_host_visit` steps, reads the simulated time, samples
the probes every `probe_every` visits and logs diagnostics every
`log_every` visits, as `run_case` drives a case. The harness's hook at
each visit marks a visit whose state turned non-finite or whose neighbor
audit counter rose (on the device, no sync); around the workload's
`check_visit`-th visit it copies the state on the device, before and
after, so that the reference can follow that visit. The window runs on
past `seconds` until that visit is done.
"""

from __future__ import annotations

import gc
import importlib
import math
import shutil
import sys
import tempfile
import time
from types import SimpleNamespace

import torch

from pbench import check, spec, trace
from pbench.tree import copy_into, leaves, to_host, tree_map

PORT = "sedifoam_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "sedifoam_tpu")
MAX_VISITS = 1 << 16


class _WindowClosed(Exception):
    pass


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the benchmark must not
    load, compared whole (the program's name begins with one of them)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _unhealthy(state, dropped0):
    """0-d bool on the device: a non-finite fluid or particle field, or
    the neighbor table's audit counter above its value at the window's
    start."""
    fs, ps = state.fluid, state.particles
    act = ps.active[:, None]
    bad = ~torch.isfinite(fs.p).all() | ~torch.isfinite(fs.Ub).all()
    for t in (ps.pos, ps.vel, ps.omega):
        bad |= ~torch.isfinite(torch.where(act, t, 0.0)).all()
    return bad | (ps.nbr_dropped > dropped0)


def _labelled(fn, label):
    def call(*a, **kw):
        with torch.profiler.record_function(label):
            return fn(*a, **kw)
    return call


def _spanned(cls):
    """cls with its simulated-time read in a labelled host range."""
    class Spanned(cls):
        @property
        def t(self):
            with torch.profiler.record_function("pb.time_read"):
                return cls.t.fget(self)
    return Spanned


def _counters():
    lin = importlib.import_module(f"{PORT}.linsolve")
    fused = importlib.import_module(f"{PORT}.dem.fused")
    return {"pcg_iters": lin.STATS["pcg"][1], "chain": fused.launches()}


def _visits(sim, n, **kw):
    """sim.run over n host visits. The loop tests the simulated time,
    which a broken step may never advance: the run then stops after n
    visits all the same."""
    t_end = sim.t + (n * sim.steps_per_visit - 0.5) * sim.cfg.fluid.dt
    seen = [0]

    def guard(s):
        seen[0] += 1
        if seen[0] == n and s.t < t_end - 1e-12:
            raise _WindowClosed

    try:
        sim.run(t_end, on_sample=guard, **kw)
    except _WindowClosed:
        pass


def setup(cell, seed, device, workdir, traced, t_start):
    """Everything before the first timed step: (sim, record) where the
    record holds the set-up's host copies and times."""
    runner = importlib.import_module(f"{PORT}.runtime.runner")
    solver = importlib.import_module(f"{PORT}.solver")
    wl, cfg_spec, b = cell.workload, cell.config, cell.case
    spv = wl["steps_per_host_visit"]
    t0 = time.perf_counter()
    inp = b.inputs(cfg_spec, seed, workdir)
    cfg, fluid, particles = b.load(PORT, cfg_spec, inp, device)
    _sync(device)
    load_s = time.perf_counter() - t0
    marks = [("load", t0), ("initialize", t0 + load_s)]
    state0 = solver.initialize(fluid, particles, cfg)
    start_host = to_host(state0)
    marks.append(("Simulation", time.perf_counter()))
    cls = _spanned(runner.Simulation) if traced else runner.Simulation
    sim = cls(cfg, state0,
              probe_locations=b.probe_locations(cfg_spec, inp) or None,
              steps_per_host_visit=spv, device=device)
    graphed = sim.advance
    if traced:
        sim.advance = _labelled(sim.advance, "pb.replay")
        if sim.probes is not None:
            sim.probes.sample = _labelled(sim.probes.sample, "pb.probes")
        sim.diag_fn = _labelled(sim.diag_fn, "pb.diagnostics")
    # the first visit captures the step; its state is checked against
    # the reference's from its own start
    marks.append(("first visit", time.perf_counter()))
    _visits(sim, 1, probe_every=1)
    first_host = to_host(sim.state)
    marks.append(("warm-up", time.perf_counter()))
    more = wl["warmup_visits"] - 1
    if more > 0:
        _visits(sim, more, probe_every=wl["probe_every"], log_every=more)
    sim.log.clear()
    _sync(device)
    marks.append(("", time.perf_counter()))
    parts = ", ".join(f"{a} {t1 - t:.3f}"
                      for (a, t), (_, t1) in zip(marks, marks[1:]))
    return sim, {"inputs": inp, "cfg": cfg, "load_s": load_s,
                 "parts": f"before load {t0 - t_start:.3f}, {parts}",
                 "capture_s": getattr(graphed, "capture_seconds", None),
                 "start_host": start_host, "first_host": first_host}


def harness_buffers(sim):
    """The device buffers the window's hook writes: (snap, flags,
    dropped0). snap = (before, after) receives the state around the
    checked visit, flags marks unhealthy visits, dropped0 is the audit
    counter at the window's start."""
    snap = (tree_map(torch.clone, sim.state),
            tree_map(torch.clone, sim.state))
    flags = torch.zeros(MAX_VISITS, dtype=torch.bool, device=sim.device)
    return snap, flags, sim.state.particles.nbr_dropped.clone()


def window(sim, cell, seconds, buffers, tracer=None):
    """The measured window: {wall_s, visits, stamps, failed_visits};
    `buffers` are harness_buffers(sim)."""
    wl = cell.workload
    device = sim.device
    check_visit = wl["check_visit"]
    snap, flags, dropped0 = buffers
    stamps = []
    if check_visit == 1:
        copy_into(snap[0], sim.state)

    def hook(s):
        with torch.profiler.record_function("pb.hook"):
            v = len(stamps)
            stamps.append(time.perf_counter())
            flags[v % MAX_VISITS] = _unhealthy(s.state, dropped0)
            if v + 2 == check_visit:
                copy_into(snap[0], s.state)
            elif v + 1 == check_visit:
                copy_into(snap[1], s.state)
            if tracer is not None:
                tracer.on_visit(s)
            if (stamps[-1] >= deadline and v + 1 >= check_visit
                    and (tracer is None or tracer.done)):
                raise _WindowClosed

    t_open = time.perf_counter()
    deadline = t_open + seconds
    try:
        sim.run(math.inf, probe_every=wl["probe_every"],
                log_every=wl["log_every"], on_sample=hook)
    except _WindowClosed:
        pass
    finally:
        if tracer is not None and not tracer.done:
            tracer.close()
    _sync(device)
    wall = time.perf_counter() - t_open
    n = len(stamps)
    return {"wall_s": wall, "visits": n, "t_open": t_open,
            "stamps": stamps,
            "failed_visits": int(flags[:min(n, MAX_VISITS)].sum())}


def thirds_ms(win, spv):
    """Host ms per step over the window's first and last thirds of
    visits."""
    st = [win["t_open"]] + win["stamps"]
    n = len(st) - 1
    k = max(n // 3, 1)
    return ((st[k] - st[0]) * 1e3 / (k * spv),
            (st[n] - st[n - k]) * 1e3 / (k * spv))


def cards_used(sim) -> int:
    """The number of CUDA cards that hold the program's state."""
    return len({t.device for _, t in leaves(sim.state)
                if t.device.type == "cuda"})


def _stderr(msg):
    print(msg, file=sys.stderr, flush=True)


def measure(cell, seed, seconds, traced, device, t_start,
            bench_dir=spec.HERE, log=_stderr) -> SimpleNamespace:
    """Set-up, the window and (traced) the span's reading: what the
    program did, on the host. `got` holds the program's (start, first
    visit, the window's checked visit) states, `before_check` the state
    the checked visit started from. The program's device memory is freed before
    this returns."""
    on_card = device.type == "cuda"
    if traced and not on_card:
        raise ValueError("the traced span needs the CUDA card")
    spv = cell.workload["steps_per_host_visit"]
    mem = torch.cuda.max_memory_allocated
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    workdir = tempfile.mkdtemp(prefix="port_bench_")
    try:
        sim, rec = setup(cell, seed, device, workdir, traced, t_start)
        # the peak leaves out the harness's own buffers: the set-up's
        # peak, then the window's less the buffers it holds throughout
        peak_setup = mem(device) if on_card else None
        base = torch.cuda.memory_allocated(device) if on_card else 0
        buffers = harness_buffers(sim)
        _sync(device)
        if on_card:
            own = torch.cuda.memory_allocated(device) - base
            torch.cuda.reset_peak_memory_stats(device)
        setup_s = time.perf_counter() - t_start
        tracer = None
        if traced:
            tracer = trace.Tracer(
                time.perf_counter() + trace.START * seconds, _counters,
                lambda s: to_host(s.state.particles))
        win = window(sim, cell, seconds, buffers, tracer)
        peak = max(peak_setup, mem(device) - own) if on_card else None
        before_check = to_host(buffers[0][0])
        after_check = to_host(buffers[0][1])
        dropped = int(sim.state.particles.nbr_dropped)
        steps = win["visits"] * spv
        first3, last3 = thirds_ms(win, spv)
        log(f"window: {win['visits']} visits, {steps} steps in "
            f"{win['wall_s']:.3f} s; ms/step first third {first3:.4f}, "
            f"last third {last3:.4f}; setup_s {setup_s:.3f} ({rec['parts']}),"
            f" capture_s {rec['capture_s']}")
        mrec = {"on_card": on_card, "setup_s": setup_s,
                "wall_s": win["wall_s"], "steps": steps,
                "peak_bytes": peak, "load_s": rec["load_s"],
                "capture_s": rec["capture_s"], "cfg": rec["cfg"]}
        red = None
        if traced:
            red = _read_trace(tracer, mrec, spv)
            untraced = tracer.rec.get("untraced_device_s")
            mrec["untraced_device_s"] = untraced
            per = 1e3 / mrec["span_steps"]
            log(f"traced span: {red['window_s'] * per:.4f} ms/step, device "
                f"busy {red['busy_s'] * per:.4f} ms/step; the untraced "
                f"visits before it {(untraced or math.nan) * per:.4f} "
                f"ms/step on the device clock")
        metrics = _metrics(cell.per_layer if traced else cell.end_to_end,
                           mrec, bench_dir)
        dev = {"platform": "gpu" if on_card else "cpu",
               "kind": (torch.cuda.get_device_name(device) if on_card
                        else "cpu"),
               "count": cards_used(sim), "memory_peak_bytes": peak}
        if traced:
            dev["busy_s"] = red["busy_s"]
            dev["window_s"] = red["window_s"]
        del sim, tracer, buffers, mrec
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        # inputs made in the work directory are read by the reference
        # too: the directory goes when the run's result is made
        return SimpleNamespace(
            workdir=workdir, inputs=rec["inputs"], metrics=metrics,
            device=dev, breakdown=red["breakdown"] if traced else None,
            steps=steps, failed=win["failed_visits"] * spv,
            dropped=dropped, before_check=before_check,
            got=(rec["start_host"], rec["first_host"], after_check),
            step_ms_thirds=(first3, last3))
    except BaseException:
        shutil.rmtree(workdir, ignore_errors=True)
        raise


def judge(cell, m, device, log=_stderr) -> tuple:
    """(correct, checks): the reference's three checks on what `measure`
    returned, each number with its limit."""
    spv = cell.workload["steps_per_host_visit"]
    ref = check.Reference(cell.case, cell.config, m.inputs, device)
    checks = check.run_checks(
        m.got, check.reference_states(ref, spv, m.before_check),
        m.before_check)
    for where, c in checks.items():
        log(f"check {where}: " + ", ".join(
            f"{k} {v[check.NUMBERS[k]][0]:.3e} ({v[check.NUMBERS[k]][1]})"
            for k, v in c.items()))
    norms = {k: check.NUMBERS[k] for k in cell.limits}
    compared = {k: {"value": v, "limit": cell.limits[k]["limit"]}
                for k, v in check.numbers(checks, norms).items()}
    compared["failed"] = {"value": m.failed, "limit": 0}
    compared["dropped"] = {"value": m.dropped, "limit": 0}
    return (all(c["value"] <= c["limit"] for c in compared.values()),
            compared)


def run(name, seed, seconds, traced, device, root, t_start,
        bench_dir=spec.HERE, log=_stderr):
    """One run of cell `name`; returns the result dict (the line's keys,
    `checks` last)."""
    device = torch.device(device)
    cell = spec.find_cell(name, root, bench_dir)
    m = measure(cell, seed, seconds, traced, device, t_start, bench_dir,
                log)
    try:
        correct, compared = judge(cell, m, device, log)
    finally:
        shutil.rmtree(m.workdir, ignore_errors=True)
    result = {"correct": correct, "attempted": m.steps, "failed": m.failed,
              "metrics": m.metrics, "device": m.device}
    if traced:
        result["breakdown"] = m.breakdown
    result["checks"] = compared
    return result


def _read_trace(tracer, mrec, spv):
    dev_ops, host = trace.events(tracer.prof)
    red = trace.reduce(dev_ops, host)
    before, after = tracer.rec["before"], tracer.rec["after"]
    launched = after["chain"] - before["chain"]
    seen = sum("chain_kernel" in n for n, _, _ in red["ops"])
    if seen < launched:
        raise RuntimeError(f"the profiler saw {seen} contact-chain kernels "
                           f"of the {launched} the span launched")
    mrec.update(ops=red["ops"], busy_s=red["busy_s"],
                window_s=red["window_s"],
                span_steps=tracer.span * spv,
                syncs=tracer.rec["syncs"],
                pcg_iters=after["pcg_iters"] - before["pcg_iters"],
                chain_launches=launched,
                particles=tracer.rec["at_close"])
    return red


def _metrics(entries, mrec, bench_dir):
    """{name: {value, unit}} of the metrics whose reader found something
    to read; off the card, a metric of the host clock or the device
    trace is marked not measured."""
    out = {}
    for m in entries:
        if not mrec["on_card"] and m["source"] in ("host_clock",
                                                   "device_trace"):
            out[m["name"]] = {"value": None, "unit": m["unit"],
                              "note": "not measured"}
            continue
        v = spec.metric_reader(m["name"], bench_dir)(mrec)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out
