"""The binned contact chain as one hand-written CUDA kernel for Hopper.

Port of ``sedifoam_tpu/dem/fused.py`` (the TPU kernel ``_kernel``,
launched by ``chain_forces``, and its caller
``pair_forces_binned_fused``). The kernel (``csrc/contact_chain.cu``)
gathers each particle's K table partners itself, runs the
Hertz/Hooke-history law per slot, sums force and torque over the slots
in k order (no atomics: two launches on one input agree bit for bit),
and runs the static plane walls in the same pass. Shear and wall shear
are updated in place. The source's note gives its bound and its design.

``contact_chain`` is the wrapper: on a CUDA tensor it launches the
kernel (or raises); on a CPU tensor, and only there, it runs
``contact_chain_reference``, the plain PyTorch version of the same
function (``neighbor.pair_forces_binned`` + ``walls.wall_forces``).
Both take ``rows=(row0, n_rows)``: the rows [row0, row0 + n_rows) of the
state's row arrays (pos, vel, omega, radius, mass, active: all N rows)
are computed, against partners anywhere in them, and the table, the
histories and the outputs are those rows' alone ((K, n_rows), (3, K,
n_rows), (3, W, n_rows), (n_rows, 3)). That is one rank's block of a
state split over ranks (``parallel/``); ``rows=None`` is all N rows.
``LAUNCHES`` counts kernel launches, so a run can show that its main
path went through the kernel; ``LAUNCH_SIZES`` counts them by the rows
a launch computes (N, or n_rows of a row range; the runner's active
window launches it at several N). A launch
inside a captured CUDA graph (graphs.StepGraph) happens at every replay
of the graph, not where the wrapper runs: there the wrapper captures one
more kernel, which adds one to a counter on the device beside the
launch. ``launches()`` and ``launch_sizes()`` add those counters to the
eager counts (a host read).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import functools

import torch

from sedifoam_tpu_torch import _build, graphs, telemetry
from sedifoam_tpu_torch.config import (PAIR_HERTZ_HISTORY, PAIR_HOOKE,
                                       PAIR_HOOKE_HISTORY, WALL_ZCYLINDER,
                                       PairParams)
from sedifoam_tpu_torch.dem.forcelaws import _SQRT56, hertz_beta
from sedifoam_tpu_torch.dem.neighbor import pair_forces_binned
from sedifoam_tpu_torch.dem.pair import own
from sedifoam_tpu_torch.dem.state import ParticleState
from sedifoam_tpu_torch.dem.walls import wall_forces

# kernel launches in this process (incremented once per launch), in all
# and by N, outside CUDA graphs; inside them, one int64 counter per
# (device, N) on the device in the telemetry registry
# (``fused.launches.<N>``), made at the first eager launch
LAUNCHES = 0
LAUNCH_SIZES = collections.Counter()
_GRAPH = "fused.launches."
# launches captured into graphs, by N (each runs at every replay that
# reaches it)
CAPTURED = collections.Counter()


def _graph_counts() -> collections.Counter:
    return collections.Counter({int(name[len(_GRAPH):]):
                                telemetry.REGISTRY.value(name)
                                for name in telemetry.REGISTRY.names(_GRAPH)})


def launch_sizes() -> collections.Counter:
    """Launches by N, eager and inside replayed graphs (a host read)."""
    return +(LAUNCH_SIZES + _graph_counts())


def launches() -> int:
    """All launches, eager and inside replayed graphs (a host read)."""
    return sum(launch_sizes().values())


def graph_launches() -> int:
    """Launches inside replayed graphs (a host read)."""
    return sum(_graph_counts().values())


def reset_launches() -> None:
    """Zero every count, the device counters in place (a captured graph
    keeps adding to the same ones)."""
    global LAUNCHES
    LAUNCHES = 0
    LAUNCH_SIZES.clear()
    telemetry.REGISTRY.reset(_GRAPH)


def launch_snapshot():
    """The launch counts, eager and on the device (copies), for
    launch_restore: launches made to compare or time the kernel then do
    not count."""
    return LAUNCHES, LAUNCH_SIZES.copy(), telemetry.snapshot(_GRAPH)


def launch_restore(snap) -> None:
    global LAUNCHES
    LAUNCHES = snap[0]
    LAUNCH_SIZES.clear()
    LAUNCH_SIZES.update(snap[1])
    telemetry.restore(snap[2], _GRAPH)


def _count(n, device):
    global LAUNCHES
    name = f"{_GRAPH}{n}"
    if graphs.capturing():
        if (name, device) not in telemetry.REGISTRY.tensors:
            raise RuntimeError(f"contact_chain: first launch at N={n} under "
                               "a capture: warm up the step first")
        telemetry.count(name, device)
        CAPTURED[n] += 1
        return
    telemetry.counter(name, device)
    LAUNCHES += 1
    LAUNCH_SIZES[n] += 1

MAX_WALLS = 6
_BIG = 1e30
_STYLES = {PAIR_HOOKE: 0, PAIR_HOOKE_HISTORY: 1, PAIR_HERTZ_HISTORY: 2}


class _Law(ctypes.Structure):
    _fields_ = [("style", ctypes.c_int64), ("kn", ctypes.c_double),
                ("kt", ctypes.c_double), ("gamman", ctypes.c_double),
                ("gammat", ctypes.c_double), ("xmu", ctypes.c_double),
                ("c_damp", ctypes.c_double), ("kt_safe", ctypes.c_double)]


class _Wall(ctypes.Structure):
    _fields_ = [("axis", ctypes.c_int64), ("lo", ctypes.c_double),
                ("hi", ctypes.c_double), ("law", _Law)]


class _Chain(ctypes.Structure):
    _fields_ = [("n", ctypes.c_int64), ("K", ctypes.c_int64),
                ("W", ctypes.c_int64), ("shearupdate", ctypes.c_int64),
                ("row0", ctypes.c_int64), ("n_rows", ctypes.c_int64),
                ("periodic", ctypes.c_int64 * 3),
                ("plen", ctypes.c_double * 3), ("dt", ctypes.c_double),
                ("pair", _Law), ("walls", _Wall * MAX_WALLS)]


def walls_fusible(walls) -> bool:
    """Static plane walls only — wiggle/shear/cylinder walls take the
    torch wall_forces path beside the kernel."""
    return all(w.style != WALL_ZCYLINDER and not w.wiggle
               and w.vshear == 0.0 for w in walls)


def own_rows(state: ParticleState, rows) -> ParticleState:
    """The state with its row arrays (pos, vel, omega, radius, mass,
    active) cut to rows=(row0, n_rows); the rest as it is."""
    return state._replace(**{k: own(getattr(state, k), rows) for k in (
        "pos", "vel", "omega", "radius", "mass", "active")})


def contact_chain_reference(state: ParticleState, params: PairParams,
                            dt: float, idx, shearupdate: bool = True,
                            periodic_len=None, walls=(), rows=None):
    """Plain PyTorch version of the kernel: the binned pair chain plus,
    when `walls` is non-empty, the plane-wall pass.

    Returns (force (N,3), torque (N,3), new_shear (3,K,N), new_wall_shear
    (3,W,N) or None when `walls` is empty), as the reference's
    pair_forces_binned_fused does; with rows=(row0, n_rows), those rows'
    alone (n_rows in place of N; see the module's docstring).
    """
    force, torque, shear = pair_forces_binned(state, params, dt, idx,
                                              shearupdate, periodic_len,
                                              rows=rows)
    wall_shear = None
    if walls:
        fw, tw, wall_shear = wall_forces(own_rows(state, rows), walls, dt,
                                         0.0, shearupdate)
        force = force + fw
        torque = torque + tw
    return force, torque, shear, wall_shear


def contact_chain(state: ParticleState, params: PairParams, dt: float, idx,
                  shearupdate: bool = True, periodic_len=None, walls=(),
                  rows=None):
    """The contact chain: the kernel for CUDA tensors, the plain version
    for CPU tensors. Same signature and returns as
    contact_chain_reference. On CUDA, state.shear and (with walls)
    state.wall_shear are updated in place and returned."""
    dev = state.pos.device.type
    if dev == "cpu":
        return contact_chain_reference(state, params, dt, idx, shearupdate,
                                       periodic_len, walls, rows)
    if dev != "cuda":
        raise ValueError(f"contact_chain: unsupported device {dev!r}")
    return _launch(state, params, dt, idx, shearupdate, periodic_len, walls,
                   rows)


def _law(p: PairParams) -> _Law:
    p = p.resolved()
    if p.style not in _STYLES:
        raise ValueError(f"unknown pair style {p.style}")
    c_damp = (2.0 * _SQRT56 * hertz_beta(p.gamman)
              if p.style == PAIR_HERTZ_HISTORY else 0.0)
    return _Law(_STYLES[p.style], p.kn, p.kt, p.gamman, p.gammat, p.xmu,
                c_damp, max(p.kt, 1e-300))


def _params(n, K, dt, shearupdate, periodic_len, params, walls,
            rows=None) -> _Chain:
    if len(walls) > MAX_WALLS:
        raise ValueError(f"at most {MAX_WALLS} fused walls, got {len(walls)}")
    if not walls_fusible(walls):
        raise ValueError("only static plane walls fuse into the kernel")
    plen = tuple(periodic_len) if periodic_len is not None \
        else (None, None, None)
    row0, n_rows = row_range(n, rows)
    cp = _Chain(n=n, K=K, W=len(walls), shearupdate=int(bool(shearupdate)),
                row0=row0, n_rows=n_rows, dt=dt, pair=_law(params))
    for a in range(3):
        cp.periodic[a] = int(plen[a] is not None)
        cp.plen[a] = float(plen[a]) if plen[a] is not None else 0.0
    for wi, w in enumerate(walls):
        cp.walls[wi] = _Wall(w.axis,
                             float(w.lo) if w.lo is not None else -_BIG,
                             float(w.hi) if w.hi is not None else _BIG,
                             _law(w.params))
    return cp


# the parameter block of each (n, K, dt, shearupdate, periodic_len,
# params, walls, rows) seen, built once: all are numbers, tuples or frozen
# dataclasses. The kernel reads the block only during its launch.
_chain_params = functools.lru_cache(maxsize=256)(_params)


def _check(name, t, shape, dtype, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _library():
    """Build (at first use) and bind the kernel's library, once per
    process; check that its parameter block matches this module's."""
    lib = _build.load("contact_chain")
    ptr = ctypes.c_void_p
    lib.contact_chain_params_size.argtypes = []
    lib.contact_chain_params_size.restype = ctypes.c_size_t
    for fn in (lib.contact_chain_f32, lib.contact_chain_f64):
        fn.argtypes = [ptr] * 13
        fn.restype = ctypes.c_int
    lib.contact_chain_slot_warps.argtypes = [ctypes.c_int64, ctypes.c_int]
    lib.contact_chain_slot_warps.restype = ctypes.c_int
    lib.contact_chain_empty.argtypes = [ptr]
    lib.contact_chain_empty.restype = ctypes.c_int
    lib.contact_chain_error_string.argtypes = [ctypes.c_int]
    lib.contact_chain_error_string.restype = ctypes.c_char_p
    size = lib.contact_chain_params_size()
    if size != ctypes.sizeof(_Chain):
        raise RuntimeError(f"ChainParams is {size} bytes in CUDA, "
                           f"{ctypes.sizeof(_Chain)} in ctypes")
    return lib


def row_range(n, rows):
    """rows=(row0, n_rows) as two ints inside [0, n); None: all n rows."""
    if rows is None:
        return 0, n
    row0, n_rows = (int(r) for r in rows)
    if row0 < 0 or n_rows < 0 or row0 + n_rows > n:
        raise ValueError(f"contact_chain: rows [{row0}, {row0 + n_rows}) "
                         f"outside the {n} rows of the state")
    return row0, n_rows


def check_inputs(state, idx, n_walls, rows=None):
    """Raise unless the kernel can take these tensors: one float dtype
    (f32 or f64) on one device, the state's shapes, contiguous. The row
    arrays have all N rows; the table and the histories the own rows'
    (rows=(row0, n_rows); N of them when None)."""
    x = state.pos
    dtype, device = x.dtype, x.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"contact_chain: no kernel for dtype {dtype}")
    n = state.n_capacity
    nr = row_range(n, rows)[1]
    K = idx.shape[0]
    for name in ("pos", "vel", "omega"):
        _check(name, getattr(state, name), (n, 3), dtype, device)
    for name in ("radius", "mass"):
        _check(name, getattr(state, name), (n,), dtype, device)
    _check("active", state.active, (n,), torch.bool, device)
    _check("nbr_idx", idx, (K, nr), torch.int32, device)
    _check("shear", state.shear, (3, K, nr), dtype, device)
    if n_walls:
        _check("wall_shear", state.wall_shear, (3, n_walls, nr), dtype,
               device)


def _launch(state, params, dt, idx, shearupdate, periodic_len, walls,
            rows=None):
    """Launch the kernel on the current stream."""
    W = len(walls)
    check_inputs(state, idx, W, rows)
    x = state.pos
    dtype, device = x.dtype, x.device
    n, K = state.n_capacity, idx.shape[0]
    rows = row_range(n, rows)
    nr = rows[1]
    cp = _chain_params(n, K, float(dt), bool(shearupdate),
                       None if periodic_len is None else tuple(periodic_len),
                       params, tuple(walls), rows)

    lib = _library()
    fn = lib.contact_chain_f32 if dtype == torch.float32 \
        else lib.contact_chain_f64
    force = torch.empty((nr, 3), dtype=dtype, device=device)
    torque = torch.empty((nr, 3), dtype=dtype, device=device)
    shear = state.shear
    wall_shear = state.wall_shear if W else None
    # entering the device costs host time: only when it is not current
    here = device.index is None or device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if here else torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.addressof(cp), x.data_ptr(), state.vel.data_ptr(),
                 state.omega.data_ptr(), state.radius.data_ptr(),
                 state.mass.data_ptr(), state.active.data_ptr(),
                 idx.data_ptr(), shear.data_ptr(),
                 wall_shear.data_ptr() if W else None,
                 force.data_ptr(), torque.data_ptr(), stream)
    if err != 0:
        msg = lib.contact_chain_error_string(err).decode()
        raise RuntimeError(f"contact_chain kernel launch failed: {msg}")
    _count(nr, device)
    return force, torque, shear, wall_shear
