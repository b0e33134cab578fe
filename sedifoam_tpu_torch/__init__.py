"""sedifoam_tpu_torch — the coupled CFD-DEM step in PyTorch, for CUDA.

A port of ``sedifoam_tpu`` (JAX) that keeps its module layout, function
names and state field names, so each module has a counterpart there
(``sedifoam_tpu_torch/dem/neighbor.py`` <-> ``sedifoam_tpu/dem/neighbor.py``).
The JAX package is the reference the tests hold this one against.

Plain code is PyTorch on tensors of an explicit device and dtype. The
binned DEM contact chain is a hand-written CUDA kernel
(``csrc/contact_chain.cu``), built with nvcc at first use into
``build/kernels/``; on CPU tensors its plain PyTorch version runs.
This package never imports JAX.
"""

import functools

import torch

from sedifoam_tpu_torch.grid import Grid  # noqa: F401

__version__ = "0.1.0"


def default_device(device=None) -> torch.device:
    """`device` as a torch.device; with none given, the CUDA card. The
    entry points (io.case.load_case, Simulation.from_case, run_case) and
    the builders (CoupledStep, make_step_fn, bench_case.build_state,
    cases.xiaocase3, cases.inject_case) run on the card unless asked for
    the CPU: with no card this raises rather than carrying on there."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" (run_case: '
                           '--device cpu) to run on the CPU')
    return torch.device("cuda")


@functools.lru_cache(maxsize=256)
def device_vector(values: tuple, dtype, device) -> torch.Tensor:
    """A tuple of numbers from a config (gravity, a flow direction, a box
    corner) as a 1-D tensor, copied to the device once per (values, dtype,
    device) rather than at every step. Never written in place."""
    return torch.tensor(values, dtype=dtype, device=device)


def full_f32_precision():
    """Turn TF32 off, process-wide, for matmuls and cuDNN. The shear
    carry-over (dem/neighbor.carry_over_shear) and the FastDiag transforms
    (fastsolve.py) need full f32: TF32 keeps about three digits, which
    rounds the carried contact history and breaks the smoothing's maximum
    principle. CoupledStep calls this when it is built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
