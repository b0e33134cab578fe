"""Optional body-force subsystems (port of
``sedifoam_tpu/fluid/bodyforce.py``).

- IBM relaxation zone (createIBMForce.H, UEqns.H:38-41): an indicator
  field marks cells where the fluid velocity is implicitly relaxed to
  zero with time scale ibmRelaxTime, used to emulate internal walls.
- DNS spectral forcing (createTurbulence.H:29-49, calcDNSForce.H): a
  UO-process random force in Fourier space, projected solenoidal with
  K x f / |K|, driving box turbulence.

The spectral state is the reference's real (2, 3, nx, ny, nz) (re, im)
tensor, so a checkpoint crosses packages. The random stream is the
reference's too: jax.random's threefry `split` and `normal`
(dem/inject.py), a pure function of the state's key. The inverse
transform is `torch.fft.ifftn` on the complex view: the reference's
per-axis DFT matrix products exist there because its device has no
complex type; here the FFT does the same sum in O(n log n), needs no
DFT matrices on the device and is not subject to TF32 matmul rounding.
The wavevector constants are built once per (grid, dtype, device).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sedifoam_tpu_torch import device_vector
from sedifoam_tpu_torch.dem import inject as _rng
from sedifoam_tpu_torch.grid import Grid


class UOForcingState(NamedTuple):
    """Spectral force modes (re, im) + RNG key (carried in FluidState)."""

    f_hat: torch.Tensor   # (2, 3, nx, ny, nz) real
    key: torch.Tensor     # (2,) int64 holding the reference's uint32


def init_uo_state(grid: Grid, key=None, dtype=torch.float32,
                  device=None) -> UOForcingState:
    """Zero modes; the default key is jax.random.PRNGKey(7) = (0, 7)."""
    if key is None:
        key = torch.tensor([0, 7], dtype=torch.int64, device=device)
    return UOForcingState(
        f_hat=torch.zeros((2, 3) + grid.shape, dtype=dtype, device=device),
        key=key,
    )


def _wavevectors(grid: Grid, dtype, device):
    """(K (3,nx,ny,nz), |K|, K/(|K|+eps)) on the device, made once per
    Grid object, dtype and device (Grid.memo)."""
    def make():
        ks = [2.0 * np.pi * np.fft.fftfreq(n, d)
              for n, d in zip(grid.shape, grid.spacing)]
        KX, KY, KZ = np.meshgrid(*ks, indexing="ij")
        K = torch.as_tensor(np.stack([KX, KY, KZ]), dtype=dtype,
                            device=device)
        k_mag = torch.sqrt(torch.sum(K * K, dim=0))
        # solenoidal projection direction (calcDNSForce.H:31-37)
        return K, k_mag, K / (k_mag + 1e-6)[None]

    return grid.memo(("wavevectors", dtype, torch.device(device)), make)


def _ifftn_real(re, im):
    """Real part of ifftn over the 3 trailing axes."""
    return torch.fft.ifftn(torch.complex(re, im), dim=(-3, -2, -1)).real


def uo_forcing_step(state: UOForcingState, grid: Grid, dt: float,
                    alpha: float, sigma: float, k_upper: float,
                    k_lower: float = 0.0):
    """Advance the UO process and return (new_state, force (3,nx,ny,nz)).

    f_hat' = (1 - alpha dt) f_hat + sigma sqrt(dt) xi, restricted to the
    [k_lower, k_upper] shell; physical force = Re(ifft(K x f_hat / |K|)).
    """
    keys = _rng.split(state.key)
    key, sub = keys[0], keys[1]
    dtype = state.f_hat.dtype
    xi = _rng.normal(sub, state.f_hat.shape, dtype)
    sqrt_dt = torch.sqrt(device_vector((dt,), dtype,
                                       state.f_hat.device).reshape(()))
    f_hat = (1.0 - alpha * dt) * state.f_hat + sigma * sqrt_dt * xi

    _, k_mag, kn = _wavevectors(grid, dtype, state.f_hat.device)
    shell = ((k_mag <= k_upper) & (k_mag >= k_lower))[None, None]
    f_hat = torch.where(shell, f_hat, torch.zeros_like(f_hat))

    def cross(f):
        return torch.stack([
            kn[1] * f[2] - kn[2] * f[1],
            kn[2] * f[0] - kn[0] * f[2],
            kn[0] * f[1] - kn[1] * f[0],
        ])

    force = _ifftn_real(cross(f_hat[0]), cross(f_hat[1]))
    return UOForcingState(f_hat, key), force


def ibm_relaxation_diag(indicator, relax_time: float):
    """UbEqn -= Sp(-indicator/ibmRelaxTime, Ub): implicit damping
    coefficient field for the momentum diagonal."""
    return indicator / relax_time
