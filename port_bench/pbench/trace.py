"""The traced span of a window: torch.profiler over a few host visits in
its middle, the host's spans around each part of a visit, and the
reduction of the profile to device operations, busy time and idle gaps.

A profile may lose the records of its first launches (a few kernel
records, more the older the process), so the profiler starts `lead`
visits before the span that is read; the span's kernels are those that
start inside the host's "pb.span" range, which begins and ends on a
synchronized device. The run fails where the profile holds fewer
contact-chain kernels than the program's own counter says the span
launched.

Under the profiler a replayed graph runs several times slower (the gaps
between its kernels grow; the kernels do not), so the span's own length
is not a step's. The device's time for SPAN_VISITS untraced visits is
read on the device clock instead: CUDA events recorded on the stream at
the last visits before the profiler starts, adjacent to the span.
"""

from __future__ import annotations

import time
import warnings
from collections import deque
from contextlib import ExitStack

import torch

SPAN = "pb.span"
# the profiler starts at this share of the window, runs LEAD visits
# whose first records it may lose, then reads SPAN_VISITS visits
START, LEAD, SPAN_VISITS = 0.4, 1, 2
SYNC_WARNING = "called a synchronizing CUDA operation"
# the host's labelled parts of a visit (Simulation.run's loop and the
# harness's hook); device idle time is attributed to the innermost one
LABELS = ("pb.replay", "pb.time_read", "pb.probes", "pb.diagnostics",
          "pb.hook")
UNLABELLED = "pb.run_loop"


def _ns(e, what):
    f = getattr(e, f"{what}_ns", None)
    return f() if f is not None else 1e3 * getattr(e, f"{what}_us")()


def events(prof):
    """(device ops [(name, start_us, end_us)], host ranges [(label,
    start_us, end_us)]) of a finished profile, on the profiler's one
    timeline."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = _ns(e, "start") / 1e3
        end = start + _ns(e, "duration") / 1e3
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not name.startswith("pb."):     # the annotations' echo
                dev.append((name, start, end))
        elif name.startswith("pb."):
            host.append((name, start, end))
    return dev, host


def union(intervals):
    """Merged (start, end) intervals of a list of (start, end)."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(dev, host, top=10):
    """The span's device ops, busy seconds, window seconds and the
    breakdown: the ops that took most device time, and the device's idle
    time by what the host was doing."""
    spans = [(a, b) for n, a, b in host if n == SPAN]
    if len(spans) != 1:
        raise RuntimeError(f"expected one {SPAN} range, found {len(spans)}")
    s0, s1 = spans[0]
    ops = [(n, a, b) for n, a, b in dev if s0 <= a < s1]
    busy = union([(max(a, s0), min(b, s1)) for _, a, b in ops])
    busy_us = sum(b - a for a, b in busy)
    by_name = {}
    for n, a, b in ops:
        by_name[n] = by_name.get(n, 0.0) + (b - a) / 1e6
    # idle gaps inside the span, each attributed to the innermost host
    # label that holds its midpoint
    edges = [s0] + [x for ab in busy for x in ab] + [s1]
    labelled = sorted(((a, b, n) for n, a, b in host if n in LABELS),
                      key=lambda r: r[1] - r[0])
    idle = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        label = next((n for x, y, n in labelled if x <= mid < y),
                     UNLABELLED)
        idle[label] = idle.get(label, 0.0) + (b - a) / 1e6
    return {
        "ops": ops,
        "busy_s": busy_us / 1e6,
        "window_s": (s1 - s0) / 1e6,
        "breakdown": {
            "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                 key=lambda x: -x[1])[:top],
            "idle_gaps": sorted(([n, s] for n, s in idle.items()),
                                key=lambda x: -x[1])[:top],
        },
    }


class Tracer:
    """The traced span of one window, stepped once per host visit from
    the window's hook: the profiler starts at `start_at` (host clock),
    LEAD visits later the span opens on a synchronized device, and
    SPAN_VISITS visits after that it closes. `counters()` reads the
    program's device counters (at a synchronized point); `at_close(sim)`
    keeps what the metrics read of the state at the span's end."""

    def __init__(self, start_at, counters, at_close):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.start_at, self.lead, self.span = start_at, LEAD, SPAN_VISITS
        self.counters, self.at_close = counters, at_close
        self.phase, self.left = "wait", 0
        self.visits = 0
        self.stack = None
        self.events = deque(maxlen=SPAN_VISITS + 1)
        self.rec = {}

    @property
    def done(self) -> bool:
        return self.phase == "done"

    def on_visit(self, sim) -> None:
        dev = sim.device
        self.visits += 1
        if self.phase == "wait":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.events.append(ev)
            if (time.perf_counter() >= self.start_at
                    and len(self.events) == self.events.maxlen):
                # device seconds of the last SPAN_VISITS untraced visits
                ev.synchronize()
                self.rec["untraced_device_s"] = \
                    self.events[0].elapsed_time(ev) / 1e3
                self.events.clear()
                self.prof.start()
                self.phase, self.left = "lead", self.lead
        elif self.phase == "lead":
            self.left -= 1
            if self.left == 0:
                torch.cuda.synchronize(dev)
                self.rec["before"] = self.counters()
                self.stack = ExitStack()
                self.stack.enter_context(
                    torch.profiler.record_function(SPAN))
                self.seen = self.stack.enter_context(
                    warnings.catch_warnings(record=True))
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                self.t0 = time.perf_counter()
                self.phase, self.left = "span", self.span
        elif self.phase == "span":
            self.left -= 1
            if self.left == 0:
                torch.cuda.set_sync_debug_mode("default")
                torch.cuda.synchronize(dev)
                self.rec["host_span_s"] = time.perf_counter() - self.t0
                self.rec["syncs"] = sum(SYNC_WARNING in str(w.message)
                                        for w in self.seen)
                self.stack.close()
                self.rec["after"] = self.counters()
                self.prof.stop()
                self.rec["at_close"] = self.at_close(sim)
                self.phase = "done"

    def close(self) -> None:
        """Stop what is still open (a window that ended early)."""
        if self.phase == "span":
            torch.cuda.set_sync_debug_mode("default")
            self.stack.close()
        if self.phase in ("lead", "span"):
            self.prof.stop()
