"""Particle trajectory dumps (LAMMPS `dump custom` analogue); port of
``sedifoam_tpu/io/dump.py``.

Host file IO. The hot path is the repo's native async writer
(native/dump_writer.cpp, built on first use by `make -C native` and
loaded via ctypes): frames are handed to a worker thread so the step
loop never blocks on disk. Without a compiler a pure-Python synchronous
writer writes the same text.

Frame layout matches the reference's dump (xiaocase1/in.lammps:31):
id type diameter mass x y z vx vy vz — so the reference's postprocessing
scripts can read our output directly.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "build", "libsedifoam_io.so")

_lib = None
_lib_tried = False


def _load_native():
    global _lib, _lib_tried
    if _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not os.path.exists(_LIB_PATH):
            subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                           capture_output=True)
        lib = ctypes.CDLL(_LIB_PATH)
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.dump_open.restype = ctypes.c_void_p
    lib.dump_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_double)]
    lib.dump_write.restype = ctypes.c_int
    lib.dump_write.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)]
    lib.dump_pending.restype = ctypes.c_longlong
    lib.dump_pending.argtypes = [ctypes.c_void_p]
    lib.dump_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def _host(t, dtype):
    return np.asarray(t.detach().cpu().numpy(), dtype)


class DumpWriter:
    """Async (native) or sync (fallback) LAMMPS-style dump writer."""

    def __init__(self, path: str, box=None, binary: bool = False):
        self.path = path
        self.box = np.zeros(6) if box is None else np.asarray(box, float)
        self.binary = binary
        lib = _load_native()
        self._handle = None
        self._file = None
        if lib is not None:
            box_p = self.box.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
            self._handle = lib.dump_open(path.encode(), int(binary), box_p)
            self._lib = lib
        if self._handle is None:
            self._file = open(path, "wb" if binary else "w")

    @property
    def native(self) -> bool:
        return self._handle is not None

    def write(self, step: int, state) -> None:
        """Write the active particles of a ParticleState (one copy of
        each field to the host)."""
        active = state.active.detach().cpu().numpy()
        ids = _host(state.tag, np.int32)[active]
        types = _host(state.ptype, np.int32)[active]
        pos = _host(state.pos, np.float64)[active]
        vel = _host(state.vel, np.float64)[active]
        d = _host(state.radius, np.float64)[active] * 2.0
        m = _host(state.mass, np.float64)[active]
        data = np.ascontiguousarray(
            np.column_stack([d, m, pos, vel]))  # diameter mass x y z vx..
        n = len(ids)
        if self._handle is not None:
            ids = np.ascontiguousarray(ids)
            types = np.ascontiguousarray(types)
            self._lib.dump_write(
                self._handle, step, n, data.shape[1],
                ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                data.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        else:
            f = self._file
            f.write(f"ITEM: TIMESTEP\n{step}\n")
            f.write(f"ITEM: NUMBER OF ATOMS\n{n}\n")
            f.write("ITEM: BOX BOUNDS ff ff ff\n")
            for a in range(3):
                f.write(f"{self.box[2*a]:.9g} {self.box[2*a+1]:.9g}\n")
            f.write("ITEM: ATOMS id type diameter mass x y z vx vy vz\n")
            for i in range(n):
                row = " ".join(f"{v:.9g}" for v in data[i])
                f.write(f"{ids[i]} {types[i]} {row}\n")
            f.flush()

    def pending(self) -> int:
        if self._handle is not None:
            return int(self._lib.dump_pending(self._handle))
        return 0

    def close(self) -> None:
        if self._handle is not None:
            self._lib.dump_close(self._handle)
            self._handle = None
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
