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

import torch

from sedifoam_tpu_torch.grid import Grid  # noqa: F401

__version__ = "0.1.0"


def full_f32_precision():
    """Turn TF32 off, process-wide, for matmuls and cuDNN. The shear
    carry-over (dem/neighbor.carry_over_shear) and the FastDiag transforms
    (fastsolve.py) need full f32: TF32 keeps about three digits, which
    rounds the carried contact history and breaks the smoothing's maximum
    principle. CoupledStep calls this when it is built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
