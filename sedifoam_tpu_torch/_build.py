"""Build the package's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (sm_90a) into a
shared library with a plain C interface, loaded with ctypes. The library
goes to ``build/kernels/`` at the repository root, keyed by a hash of the
source and the flags, so an edited source builds anew and an unchanged one
is reused. Nothing here runs at import time; a build failure raises with
the compiler's output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"

# --fmad=false: no contraction of a*b+c into FMA, so a kernel's f32
# rounding follows its plain PyTorch version op for op (measured on an
# H100 for the contact chain: 4e-8 of scale apart without FMA, 6e-5 with
# it, on a state where both are 2e-4 from f64 through force cancellation)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def nvcc() -> str:
    """The CUDA compiler: $CUDA_HOME/bin/nvcc, else nvcc on PATH, else the
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    cands = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(Path(found))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{key[:16]}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its library is already built. The
    compiler's report (registers, spills) is kept beside it as .log."""
    out = library_path(name)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{' '.join(cmd)}\n"
                           f"{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu."""
    return ctypes.CDLL(str(build(name)))
