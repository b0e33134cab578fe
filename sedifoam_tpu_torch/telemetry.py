"""The port's telemetry: device counters in one registry, a phase clock on
the device's own timer inside the coupled step, and the runner's host
spans.

- **Counters.** Each is an int64 tensor per (name, device), written in
  place by the code that counts, so a captured graph adds to the same
  tensor at every replay; the host turns them into numbers only when
  asked (`read`, a host sync). Kept here: linsolve.STATS
  (``linsolve.<solver>``: solves, iterations), the contact chain's
  launches inside graphs (``fused.launches.<N>``, dem/fused.py) and
  ``rebuilds``, the neighbor-table rebuilds: one add in each rebuild
  body (dem/integrate.py), so it counts where the branch runs, inside a
  graph and eagerly alike. A warm-up's throwaway branches count too
  (graphs.warming); solver.GraphedStep restores every counter but the
  chain's launches around its capture (`CAPTURE_RESTORED`).
- **The phase clock.** `mark(slot, device)` launches one thread
  (csrc/phase_clock.cu) that reads %globaltimer and adds the time since
  the device's last mark into the slot: the work between two marks goes
  to the slot the second one names. solver.coupled_step and
  coupling/cloud.evolve mark five times a step: at entry ``gap`` (the
  time since the previous step's last mark, which counts the step,
  ``clock.steps``), after the fluid step ``fluid``, before the DEM
  substeps ``coupling``, after them ``dem``, after liftDragCoeffs
  ``coupling``. Off (the default), and always on the CPU, a mark does
  nothing; a captured graph holds the marks only when the clock was on
  at its capture, and builds the kernel only then.
- **Spans.** `span(name)` around a part of the runner's loop
  (runtime/runner.Simulation.run: ``run.visit`` and its children
  ``run.replay``, ``run.time_read``, ``run.window``, ``run.probes``,
  ``run.on_sample``, ``run.diagnostics``, ``run.write``). When on, each
  keeps (name, parent, start, end) on the host's perf_counter_ns in a
  bounded ring (`spans`) and adds to its name's totals: count, total and
  self time (its duration less its children's). Under a running
  torch.profiler a span is also a record_function range of its name,
  on the profiler's timeline with the device's work. Off, a span tests
  one flag.

`enable(True)` turns the clock and the spans on together. `read()`
returns every counter, clock slot and span total as one flat dict of
ints; `delta(a, b)` is what was added between two reads.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import time

import torch

from sedifoam_tpu_torch import graphs

SLOTS = ("gap", "fluid", "coupling", "dem")
CLOCK = "clock"
CLOCK_FIELDS = tuple(f"{s}_ns" for s in SLOTS) + ("steps",)
_SLOT = {s: i for i, s in enumerate(SLOTS)}
_STEPS = len(SLOTS)
# the families a capture's warm-up step must not leave counted
CAPTURE_RESTORED = ("linsolve.", "rebuilds", CLOCK)
RING = 1 << 16          # span records kept

_ON = False


def enable(on: bool = True) -> None:
    """Turn the phase clock and the spans on (or off). The clock is in a
    captured step only where it was on at the capture."""
    global _ON
    _ON = bool(on)


# ---- the registry of device counters -------------------------------------

class Registry:
    """Named int64 counters, one tensor per (name, device), each a scalar
    or a vector of named fields."""

    def __init__(self):
        self.tensors = {}               # (name, device) -> tensor
        self.fields = {}                # name -> field names, () a scalar

    def counter(self, name: str, device, fields=()) -> torch.Tensor:
        """The counter's tensor on `device`, made (zeroed) at first use,
        which must come before any capture that adds to it."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (name, device)
        t = self.tensors.get(key)
        if t is None:
            if graphs.capturing():
                raise RuntimeError(f"telemetry: counter {name!r} first used "
                                   "under a capture: run the step once "
                                   "before capturing it")
            t = torch.zeros(len(fields) if fields else (),
                            dtype=torch.int64, device=device)
            self.tensors[key] = t
            self.fields[name] = tuple(fields)
        return t

    def names(self, prefix=""):
        return sorted({n for n, _ in self.tensors if n.startswith(prefix)})

    def value(self, name: str):
        """The counter summed over devices: an int, or a list of ints by
        field (a host read)."""
        fields = self.fields.get(name, ())
        out = [0] * len(fields) if fields else 0
        for (n, _), t in self.tensors.items():
            if n != name:
                continue
            if fields:
                out = [a + b for a, b in zip(out, t.tolist())]
            else:
                out += int(t)
        return out

    def read(self, prefix="") -> dict:
        """{name or name.field: int} of every counter whose name starts
        with `prefix` (a str or a tuple of them)."""
        out = {}
        for name in self.names(prefix):
            v = self.value(name)
            if self.fields[name]:
                out.update((f"{name}.{f}", x)
                           for f, x in zip(self.fields[name], v))
            else:
                out[name] = v
        return out

    def _matching(self, prefix):
        return [(k, t) for k, t in self.tensors.items()
                if k[0].startswith(prefix)]

    def reset(self, prefix="") -> None:
        """Zero the counters in place (a captured graph keeps adding to
        the same tensors)."""
        for _, t in self._matching(prefix):
            t.zero_()

    def snapshot(self, prefix="") -> dict:
        return {k: t.clone() for k, t in self._matching(prefix)}

    def restore(self, saved: dict, prefix="") -> None:
        """Put the counts of snapshot(prefix) back, in place; a counter
        made since reads zero."""
        for k, t in self._matching(prefix):
            if k in saved:
                t.copy_(saved[k])
            else:
                t.zero_()


REGISTRY = Registry()
counter = REGISTRY.counter
snapshot = REGISTRY.snapshot
restore = REGISTRY.restore


def count(name: str, device) -> None:
    """Add one to the scalar counter `name` on `device`, in place."""
    REGISTRY.counter(name, device).add_(1)


# ---- the phase clock -----------------------------------------------------

_LAST = {}              # device -> int64[1], the last mark's time (ns)


@functools.lru_cache(maxsize=None)
def _library():
    """Build (at first use) and bind csrc/phase_clock.cu."""
    from sedifoam_tpu_torch import _build
    lib = _build.load("phase_clock")
    ptr = ctypes.c_void_p
    lib.phase_clock_mark.argtypes = [ptr, ptr, ptr, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
    lib.phase_clock_ticks.argtypes = [ptr, ptr, ctypes.c_int]
    for fn in (lib.phase_clock_mark, lib.phase_clock_ticks):
        fn.restype = ctypes.c_int
    lib.phase_clock_error_string.argtypes = [ctypes.c_int]
    lib.phase_clock_error_string.restype = ctypes.c_char_p
    return lib


def _check(err, what):
    if err:
        msg = _library().phase_clock_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} (cudaError {err})")


def mark(slot: str, device) -> None:
    """Close phase `slot` on `device` (see the module's note): a no-op
    while the clock is off and on the CPU."""
    if not _ON or device.type != "cuda":
        return
    acc = REGISTRY.counter(CLOCK, device, CLOCK_FIELDS)
    last = _LAST.get(acc.device)
    if last is None:
        if graphs.capturing():
            raise RuntimeError("telemetry: the phase clock's first mark "
                               "under a capture: run the step once before "
                               "capturing it")
        last = _LAST[acc.device] = torch.zeros(1, dtype=torch.int64,
                                               device=device)
    i = _SLOT[slot]
    stream = torch.cuda.current_stream(device).cuda_stream
    _check(_library().phase_clock_mark(stream, last.data_ptr(),
                                       acc.data_ptr(), i, _STEPS,
                                       int(i == 0)), "phase_clock_mark")


def clock_ticks(device, n: int = 4096) -> dict:
    """The device timer's resolution: the smallest and largest change of
    %globaltimer over n changes read in a loop, and their mean (ns)."""
    out = torch.zeros(3, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    _check(_library().phase_clock_ticks(stream, out.data_ptr(), n),
           "phase_clock_ticks")
    lo, hi, spent = out.tolist()
    return {"min_ns": lo, "max_ns": hi, "mean_ns": spent / n}


# ---- spans ---------------------------------------------------------------

Span = collections.namedtuple("Span", "name parent start_ns end_ns")


class _Spans:
    def __init__(self):
        self.ring = collections.deque(maxlen=RING)
        self.totals = {}        # name -> [count, total_ns, self_ns]
        self.stack = []         # [name, start_ns, children_ns, range]

    def clear(self):
        self.ring.clear()
        self.totals.clear()


_SPANS = _Spans()
_OFF = contextlib.nullcontext()


class _Open:
    __slots__ = ("name",)

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(self.name)
            rf.__enter__()
        _SPANS.stack.append([self.name, time.perf_counter_ns(), 0, rf])
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        name, start, children, rf = _SPANS.stack.pop()
        if rf is not None:
            rf.__exit__(*exc)
        took = end - start
        parent = _SPANS.stack[-1] if _SPANS.stack else None
        if parent is not None:
            parent[2] += took
        _SPANS.ring.append(Span(name, parent[0] if parent else None,
                                start, end))
        tot = _SPANS.totals.setdefault(name, [0, 0, 0])
        tot[0] += 1
        tot[1] += took
        tot[2] += took - children
        return False


def span(name: str):
    """A context manager timing one part of the host's work (see the
    module's note); a shared no-op while telemetry is off."""
    return _Open(name) if _ON else _OFF


def spans() -> list:
    """The kept span records, oldest first: Span(name, parent, start_ns,
    end_ns)."""
    return list(_SPANS.ring)


# ---- reading -------------------------------------------------------------

def read() -> dict:
    """Every device counter and clock slot (a host read) and every span's
    totals (``span.<name>.count``, ``.total_ns``, ``.self_ns``), as one
    flat dict of ints."""
    out = REGISTRY.read()
    for name, (n, total, own) in _SPANS.totals.items():
        out[f"span.{name}.count"] = n
        out[f"span.{name}.total_ns"] = total
        out[f"span.{name}.self_ns"] = own
    return out


def delta(before: dict, after: dict) -> dict:
    """What was added between two reads (a key new in `after` counts from
    zero)."""
    return {k: v - before.get(k, 0) for k, v in after.items()}
