"""The binned contact chain as one hand-written CUDA kernel for Hopper.

Port of ``sedifoam_tpu/dem/fused.py`` (the TPU kernel ``_kernel``,
launched by ``chain_forces``, and its caller
``pair_forces_binned_fused``). For each particle the kernel
(``csrc/contact_chain.cu``) gathers its K table partners itself, runs the
Hertz/Hooke-history law per slot, sums force and torque, and runs the
static plane walls in the same pass. Shear and wall shear are updated in
place.

``contact_chain`` is the wrapper: on a CUDA tensor it launches the
kernel (or raises); on a CPU tensor, and only there, it runs
``contact_chain_reference``, the plain PyTorch version of the same
function (``neighbor.pair_forces_binned`` + ``walls.wall_forces``).
``LAUNCHES`` counts kernel launches, so a run can show that its main
path went through the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from sedifoam_tpu_torch import _build
from sedifoam_tpu_torch.config import (PAIR_HERTZ_HISTORY, PAIR_HOOKE,
                                       PAIR_HOOKE_HISTORY, WALL_ZCYLINDER,
                                       PairParams)
from sedifoam_tpu_torch.dem.forcelaws import _SQRT56, hertz_beta
from sedifoam_tpu_torch.dem.neighbor import pair_forces_binned
from sedifoam_tpu_torch.dem.state import ParticleState
from sedifoam_tpu_torch.dem.walls import wall_forces

# kernel launches in this process (incremented once per launch)
LAUNCHES = 0

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
                ("periodic", ctypes.c_int64 * 3),
                ("plen", ctypes.c_double * 3), ("dt", ctypes.c_double),
                ("pair", _Law), ("walls", _Wall * MAX_WALLS)]


def walls_fusible(walls) -> bool:
    """Static plane walls only — wiggle/shear/cylinder walls take the
    torch wall_forces path beside the kernel."""
    return all(w.style != WALL_ZCYLINDER and not w.wiggle
               and w.vshear == 0.0 for w in walls)


def contact_chain_reference(state: ParticleState, params: PairParams,
                            dt: float, idx, shearupdate: bool = True,
                            periodic_len=None, walls=()):
    """Plain PyTorch version of the kernel: the binned pair chain plus,
    when `walls` is non-empty, the plane-wall pass.

    Returns (force (N,3), torque (N,3), new_shear (3,K,N), new_wall_shear
    (3,W,N) or None when `walls` is empty), as the reference's
    pair_forces_binned_fused does.
    """
    force, torque, shear = pair_forces_binned(state, params, dt, idx,
                                              shearupdate, periodic_len)
    wall_shear = None
    if walls:
        fw, tw, wall_shear = wall_forces(state, walls, dt, 0.0, shearupdate)
        force = force + fw
        torque = torque + tw
    return force, torque, shear, wall_shear


def contact_chain(state: ParticleState, params: PairParams, dt: float, idx,
                  shearupdate: bool = True, periodic_len=None, walls=()):
    """The contact chain: the kernel for CUDA tensors, the plain version
    for CPU tensors. Same signature and returns as
    contact_chain_reference. On CUDA, state.shear and (with walls)
    state.wall_shear are updated in place and returned."""
    dev = state.pos.device.type
    if dev == "cpu":
        return contact_chain_reference(state, params, dt, idx, shearupdate,
                                       periodic_len, walls)
    if dev != "cuda":
        raise ValueError(f"contact_chain: unsupported device {dev!r}")
    return _launch(state, params, dt, idx, shearupdate, periodic_len, walls)


def _law(p: PairParams) -> _Law:
    p = p.resolved()
    if p.style not in _STYLES:
        raise ValueError(f"unknown pair style {p.style}")
    c_damp = (2.0 * _SQRT56 * hertz_beta(p.gamman)
              if p.style == PAIR_HERTZ_HISTORY else 0.0)
    return _Law(_STYLES[p.style], p.kn, p.kt, p.gamman, p.gammat, p.xmu,
                c_damp, max(p.kt, 1e-300))


def _params(n, K, dt, shearupdate, periodic_len, params, walls) -> _Chain:
    if len(walls) > MAX_WALLS:
        raise ValueError(f"at most {MAX_WALLS} fused walls, got {len(walls)}")
    if not walls_fusible(walls):
        raise ValueError("only static plane walls fuse into the kernel")
    plen = tuple(periodic_len) if periodic_len is not None \
        else (None, None, None)
    cp = _Chain(n=n, K=K, W=len(walls), shearupdate=int(bool(shearupdate)),
                dt=dt, pair=_law(params))
    for a in range(3):
        cp.periodic[a] = int(plen[a] is not None)
        cp.plen[a] = float(plen[a]) if plen[a] is not None else 0.0
    for wi, w in enumerate(walls):
        cp.walls[wi] = _Wall(w.axis,
                             float(w.lo) if w.lo is not None else -_BIG,
                             float(w.hi) if w.hi is not None else _BIG,
                             _law(w.params))
    return cp


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
    process."""
    lib = _build.load("contact_chain")
    ptr = ctypes.c_void_p
    lib.contact_chain_params_size.argtypes = []
    lib.contact_chain_params_size.restype = ctypes.c_size_t
    for fn in (lib.contact_chain_f32, lib.contact_chain_f64):
        fn.argtypes = [ptr] * 13
        fn.restype = ctypes.c_int
    lib.contact_chain_error_string.argtypes = [ctypes.c_int]
    lib.contact_chain_error_string.restype = ctypes.c_char_p
    size = lib.contact_chain_params_size()
    if size != ctypes.sizeof(_Chain):
        raise RuntimeError(f"ChainParams is {size} bytes in CUDA, "
                           f"{ctypes.sizeof(_Chain)} in ctypes")
    return lib


def check_inputs(state, idx, n_walls):
    """Raise unless the kernel can take these tensors: one float dtype
    (f32 or f64) on one device, the state's shapes, contiguous."""
    x = state.pos
    dtype, device = x.dtype, x.device
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"contact_chain: no kernel for dtype {dtype}")
    n = state.n_capacity
    K = idx.shape[0]
    for name in ("pos", "vel", "omega"):
        _check(name, getattr(state, name), (n, 3), dtype, device)
    for name in ("radius", "mass"):
        _check(name, getattr(state, name), (n,), dtype, device)
    _check("active", state.active, (n,), torch.bool, device)
    _check("nbr_idx", idx, (K, n), torch.int32, device)
    _check("shear", state.shear, (3, K, n), dtype, device)
    if n_walls:
        _check("wall_shear", state.wall_shear, (3, n_walls, n), dtype,
               device)


def _launch(state, params, dt, idx, shearupdate, periodic_len, walls):
    global LAUNCHES
    W = len(walls)
    check_inputs(state, idx, W)
    x = state.pos
    dtype, device = x.dtype, x.device
    n, K = state.n_capacity, idx.shape[0]
    cp = _params(n, K, dt, shearupdate, periodic_len, params, walls)

    lib = _library()
    fn = lib.contact_chain_f32 if dtype == torch.float32 \
        else lib.contact_chain_f64
    force = torch.empty((n, 3), dtype=dtype, device=device)
    torque = torch.empty((n, 3), dtype=dtype, device=device)
    shear = state.shear
    wall_shear = state.wall_shear if W else None
    with torch.cuda.device(device):
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
    LAUNCHES += 1
    return force, torque, shear, wall_shear
