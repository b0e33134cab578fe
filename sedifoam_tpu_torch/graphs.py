"""The reference's compiled control flow on the card: ``lax.while_loop``,
``lax.cond`` and ``jax.jit`` as CUDA-graph conditional nodes.

The reference runs the coupled step as one XLA program: the PCG and
BiCGStab loops are ``lax.while_loop``s (``sedifoam_tpu/linsolve.py``),
the Verlet rebuild and the injection and deletion branches ``lax.cond``s
(``sedifoam_tpu/dem/integrate.py``, ``dem/inject.py``,
``coupling/cloud.py``), the whole step ``jax.jit`` (``solver.py``).
Here:

- ``while_loop(cond_fn, body_fn, carry)`` and ``cond(pred, true_fn,
  carry)`` run in Python when the current stream is not capturing (the
  CPU, or the eager step on the card): the predicate is read with
  ``bool()``, one host sync per decision. Under capture each adds a
  conditional node (WHILE or IF, ``csrc/graph_cond.cu``) to the graph:
  the predicate is read on the device and nothing comes back to the
  host. The body is captured by PyTorch on a side stream into a memory
  pool of the graph's (one for all its bodies), so its temporaries
  belong to the graph, and becomes the node's body. A replayed body
  must land in the same addresses every time: a WHILE node's body
  updates a copy of the carry in place (``copy_``); an IF node's body
  writes the tensors it changes into new buffers, which hold copies of
  the old values when the branch is not taken. Both forms leave the
  caller's tensors as they were, as the eager ones do.
- ``StepGraph`` captures ``fn(state) -> state`` once (after an eager
  warm-up that runs every branch, see ``warming``) and replays it with
  one graph launch. The output is written back into the graph's input
  buffers inside the graph, so a replayed step reads its own result and
  the host copies nothing between steps. One StepGraph holds one shape
  of the state; a new particle capacity needs a new StepGraph, as
  ``jax.jit`` retraces per shape.

There is no fallback: a capture that fails raises with the op that
broke it. ``host_reads_forbidden()`` is the CPU's stand-in for a
capture: it raises on every host read of a tensor outside these
functions' own decisions, so the tests show on the CPU that a step
would capture.

The conditional nodes come from ``csrc/graph_cond.cu`` and not from
PyTorch: torch 2.11's ``CUDAGraph`` has no conditional-node API, and the
``begin_capture_to_if_node`` of later versions has no WHILE node.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading
import time

import torch
from torch.overrides import TorchFunctionMode

_STATE = threading.local()


def _stack(name):
    s = getattr(_STATE, name, None)
    if s is None:
        s = []
        setattr(_STATE, name, s)
    return s


# ---- pytrees of tensors (NamedTuples, tuples, None, static values) ------

def flatten(tree):
    """The tensors of a tree of NamedTuples/tuples, in field order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for v in tree for t in flatten(v)]
    return []


def unflatten(like, leaves):
    """`like` with its tensors replaced, in order, by `leaves`."""
    it = iter(leaves)

    def go(t):
        if isinstance(t, torch.Tensor):
            return next(it)
        if isinstance(t, tuple):
            vals = [go(v) for v in t]
            return type(t)(*vals) if hasattr(t, "_fields") else type(t)(vals)
        return t
    return go(like)


def tree_map(fn, tree):
    return unflatten(tree, [fn(t) for t in flatten(tree)])


def _key(t):
    return t.untyped_storage().data_ptr()


def assign(dst, src):
    """dst[i].copy_(src[i]) for the leaves of two trees of one structure,
    safe against a source that is another destination: such sources are
    copied first."""
    d, s = flatten(dst), flatten(src)
    if len(d) != len(s):
        raise ValueError(f"carry has {len(d)} tensors, the body returned "
                         f"{len(s)}")
    owners = {_key(x): i for i, x in enumerate(d)}
    s = [x.clone() if owners.get(_key(x), i) != i else x
         for i, x in enumerate(s)]
    for x, y in zip(d, s):
        if x.shape != y.shape:
            raise ValueError(f"the body changed a carried shape: "
                             f"{tuple(x.shape)} -> {tuple(y.shape)}")
        if x is not y:
            x.copy_(y)


# ---- the conditional-node library ---------------------------------------

@functools.lru_cache(maxsize=None)
def _library():
    """Build (at first use) and bind csrc/graph_cond.cu."""
    from sedifoam_tpu_torch import _build
    lib = _build.load("graph_cond")
    ptr = ctypes.c_void_p
    lib.graph_cond_handle.argtypes = [ptr,
                                      ctypes.POINTER(ctypes.c_ulonglong)]
    lib.graph_cond_set.argtypes = [ptr, ptr, ctypes.c_ulonglong]
    lib.graph_cond_node.argtypes = [ptr, ctypes.c_ulonglong, ctypes.c_int,
                                    ptr]
    for fn in (lib.graph_cond_handle, lib.graph_cond_set,
               lib.graph_cond_node, lib.graph_cond_runtime_version):
        fn.restype = ctypes.c_int
    lib.graph_cond_error_string.argtypes = [ctypes.c_int]
    lib.graph_cond_error_string.restype = ctypes.c_char_p
    return lib


def _check(err, what):
    if err:
        msg = _library().graph_cond_error_string(err).decode()
        raise RuntimeError(f"{what} failed: {msg} (cudaError {err})")


# ---- capture state ------------------------------------------------------

def capturing() -> bool:
    """Whether the current CUDA stream is being captured into a graph."""
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


_STREAMS = {}


def _streams(device):
    """(capture stream, body stream) of a device, made once per process.
    PyTorch hands out its streams round-robin from a pool of 32, so two
    made at different times may be one stream: these two are checked to
    differ, and every capture uses the same pair (a body captured on the
    stream the step is being captured on could not be captured)."""
    key = torch.device(device).index
    if key not in _STREAMS:
        a = torch.cuda.Stream(device)
        b = torch.cuda.Stream(device)
        while b.cuda_stream == a.cuda_stream:
            b = torch.cuda.Stream(device)
        _STREAMS[key] = (a, b)
    return _STREAMS[key]


def _predicate(p):
    if not isinstance(p, torch.Tensor):
        raise TypeError("a conditional node needs its predicate as a "
                        "tensor on the device")
    return p.reshape(()).to(torch.bool).contiguous()


class _Capture:
    """The StepGraph whose capture is underway: the memory pool of its
    bodies, the side stream they are captured on and the body graphs it
    must keep alive. PyTorch records one capture into a pool at a time,
    so the bodies, captured while the step's own capture records into the
    step's pool, share a second one: one body after another, in the order
    the step runs them."""

    def __init__(self, device):
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = _streams(device)[1]
        self.bodies = []
        self.in_body = False
        self.nodes = {"while": 0, "if": 0}


def _conditional(kind, pred_fn, body, before=None):
    """Add a conditional node of `kind` ("if", "while") to the graph the
    current stream is capturing. body(parent stream) is captured first,
    by PyTorch on a side stream into the bodies' pool (a "while" body returns
    its next predicate, which a setter kernel at its end hands to the
    node); then, on the current stream, before() (copies the node's
    results start from), the setter of pred_fn()'s predicate and the
    node, whose body is the captured graph."""
    caps = _stack("capture")
    if not caps:
        raise RuntimeError("graphs.cond/while_loop under a capture that "
                           "StepGraph did not start: capture with StepGraph")
    cap = caps[-1]
    if cap.in_body:
        raise NotImplementedError("a cond or while_loop inside the body of "
                                  "another one")
    lib = _library()
    parent = torch.cuda.current_stream()
    handle = ctypes.c_ulonglong()
    _check(lib.graph_cond_handle(parent.cuda_stream, ctypes.byref(handle)),
           f"creating a {kind} node's handle")
    side = cap.stream
    g = torch.cuda.CUDAGraph(keep_graph=True)
    cap.in_body = True
    try:
        with torch.cuda.stream(side):
            g.capture_begin(pool=cap.pool, capture_error_mode="thread_local")
            try:
                nxt = body(parent)
                if kind == "while":
                    _check(lib.graph_cond_set(side.cuda_stream,
                                              nxt.data_ptr(), handle.value),
                           "setting a while node's predicate")
                del nxt
            finally:
                g.capture_end()
    finally:
        cap.in_body = False
    if before is not None:
        before()
    pred = _predicate(pred_fn())
    _check(lib.graph_cond_set(parent.cuda_stream, pred.data_ptr(),
                              handle.value),
           f"setting a {kind} node's predicate")
    _check(lib.graph_cond_node(parent.cuda_stream, handle.value,
                               int(kind == "while"),
                               ctypes.c_void_p(g.raw_cuda_graph())),
           f"adding a {kind} node")
    cap.bodies.append(g)
    cap.nodes[kind] += 1


def _captured_while(cond_fn, body_fn, carry):
    # the loop runs on copies, so the caller's tensors stay as they are
    carry = tree_map(torch.clone, carry)

    def body(parent):
        assign(carry, body_fn(carry))
        return _predicate(cond_fn(carry))
    _conditional("while", lambda: cond_fn(carry), body)
    return carry


def _captured_cond(pred, true_fn, carry):
    leaves = flatten(carry)
    outs = {}

    def body(parent):
        new = flatten(true_fn(carry))
        if len(new) != len(leaves):
            raise ValueError(f"cond: carry has {len(leaves)} tensors, the "
                             f"branch returned {len(new)}")
        for i, (a, b) in enumerate(zip(leaves, new)):
            if a is b:
                continue
            if a.shape != b.shape or a.dtype != b.dtype:
                raise ValueError(f"cond: the branch changed a carried "
                                 f"tensor's shape or dtype: {a.shape} "
                                 f"{a.dtype} -> {b.shape} {b.dtype}")
            with torch.cuda.stream(parent):      # lives on in the parent
                outs[i] = torch.empty_like(a)
            outs[i].copy_(b)

    def before():
        for i, o in outs.items():
            o.copy_(leaves[i])
    _conditional("if", lambda: pred, body, before)
    return unflatten(carry, [outs.get(i, x) for i, x in enumerate(leaves)])


# ---- the forms of lax.while_loop and lax.cond ---------------------------

def _emulating() -> bool:
    return bool(_stack("forbid"))


@contextlib.contextmanager
def _host_reads_allowed():
    stack = _stack("forbid")
    if not stack:
        yield
        return
    stack[-1].allowed += 1
    try:
        yield
    finally:
        stack[-1].allowed -= 1


def _read(pred) -> bool:
    with _host_reads_allowed():
        return bool(pred)


def while_loop(cond_fn, body_fn, carry):
    """lax.while_loop: carry = body_fn(carry) while cond_fn(carry). Under
    capture one WHILE node, whose body is body_fn then cond_fn, on a copy
    of the carry that the body updates in place."""
    if capturing():
        return _captured_while(cond_fn, body_fn, carry)
    read = _read if _emulating() else bool
    while read(cond_fn(carry)):                         # host sync
        carry = body_fn(carry)
    return carry


def cond(pred, true_fn, carry):
    """lax.cond(pred, true_fn, identity, carry). Under capture one IF
    node whose body is true_fn, writing the tensors it changes into new
    buffers (copies of the carry's before the node). In a warm-up (see
    `warming`) the branch not taken runs too, on a copy, and is thrown
    away."""
    if capturing():
        return _captured_cond(pred, true_fn, carry)
    read = _read if _emulating() else bool
    if read(pred):                                      # host sync
        return true_fn(carry)
    if _stack("warm"):
        true_fn(tree_map(torch.clone, carry))
    return carry


@contextlib.contextmanager
def warming():
    """An eager run in which every cond also runs its branch not taken
    (on a copy): caches that a branch fills at first use (Grid.const,
    device_vector, cuFFT plans, the kernels' launch parameters) are full
    before a capture, where a host-to-device copy is illegal."""
    stack = _stack("warm")
    stack.append(True)
    try:
        yield
    finally:
        stack.pop()


# ---- the CPU's stand-in for a capture -----------------------------------

class HostRead(RuntimeError):
    """A tensor was read on the host where a capture allows none."""


_READS = {torch.Tensor.__bool__, torch.Tensor.item, torch.Tensor.tolist,
          torch.Tensor.__int__, torch.Tensor.__float__,
          torch.Tensor.__index__, torch.Tensor.numpy,
          torch.Tensor.nonzero, torch.nonzero, torch.unique,
          torch.Tensor.unique, torch.bincount, torch.Tensor.bincount,
          torch.masked_select, torch.Tensor.masked_select,
          torch.tensor, torch.as_tensor}
_INDEXERS = {torch.Tensor.__getitem__, torch.Tensor.__setitem__,
             torch.Tensor.index_put_, torch.Tensor.index_put}


def _bool_index(args):
    for a in args:
        if isinstance(a, torch.Tensor) and a.dtype == torch.bool:
            return True
        if isinstance(a, (tuple, list)) and _bool_index(a):
            return True
    return False


class _ForbidHostReads(TorchFunctionMode):
    def __init__(self):
        super().__init__()
        self.allowed = 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not self.allowed:
            bad = func in _READS
            if func in (torch.tensor, torch.as_tensor) and args and \
                    isinstance(args[0], torch.Tensor):
                bad = False          # a tensor re-typed, not host data
            if func is torch.Tensor.__index__:
                bad = True
            if func in _INDEXERS and _bool_index(args[1:2]):
                bad = True
            if func is torch.repeat_interleave and "output_size" not in kwargs:
                bad = True
            if bad:
                name = getattr(func, "__qualname__", repr(func))
                raise HostRead(f"{name}: a host read or host-to-device copy "
                               "inside a step that must capture")
        return func(*args, **kwargs)


@contextlib.contextmanager
def host_reads_forbidden():
    """Run code as a capture would see it, on any device: the decisions
    of cond and while_loop are the only host reads allowed, and any other
    host read of a tensor, a boolean-mask index or a tensor made from
    host data raises HostRead."""
    mode = _ForbidHostReads()
    stack = _stack("forbid")
    stack.append(mode)
    try:
        with mode:
            yield
    finally:
        stack.pop()


# ---- the captured step --------------------------------------------------

class StepGraph:
    """fn(state) -> state (a tree of tensors of one structure and shape)
    captured once as a CUDA graph and replayed with one launch.

    capture(state): an eager warm-up of fn on a copy of `state` with
    every branch run (`warming`), then the capture on the input buffers
    (copies of `state`), with fn's output written back into them at the
    end of the graph. replay(state) copies `state` into the buffers
    unless it is the buffers already (the last replay's result), launches
    the graph and returns the buffers: the state after the step, valid
    until the next replay."""

    def __init__(self, fn):
        self.fn = fn
        self.graph = None
        self.buffers = None
        self.capture_seconds = None
        self.nodes = None

    def capture(self, state):
        dev = flatten(state)[0].device
        if dev.type != "cuda":
            raise ValueError(f"StepGraph captures on a CUDA device, not "
                             f"{dev}")
        _library()
        t0 = time.perf_counter()
        capture_stream, side = _streams(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side), warming():
            self.fn(tree_map(torch.clone, state))
        torch.cuda.current_stream(dev).wait_stream(side)
        self.buffers = tree_map(torch.clone, state)
        graph = torch.cuda.CUDAGraph()
        cap = _Capture(dev)
        caps = _stack("capture")
        with torch.cuda.graph(graph, stream=capture_stream):
            caps.append(cap)
            try:
                assign(self.buffers, self.fn(self.buffers))
            finally:
                caps.pop()
        torch.cuda.synchronize(dev)
        self.graph, self.bodies = graph, cap.bodies
        self.nodes = dict(cap.nodes)
        self.capture_seconds = time.perf_counter() - t0
        return self

    def replay(self, state):
        if state is not self.buffers:
            src = flatten(state)
            dst = flatten(self.buffers)
            if [t.shape for t in src] != [t.shape for t in dst]:
                raise ValueError("StepGraph.replay: the state's shapes "
                                 "differ from the captured ones")
            for d, s in zip(dst, src):
                if d is not s:
                    d.copy_(s)
        self.graph.replay()
        return self.buffers
