"""Active-window DEM stepping for injection-driven cases (port of
``sedifoam_tpu/runtime/window.py``).

Injection cases allocate a fixed particle capacity sized for the
end-of-run population, but every per-substep cost of the binned DEM
backend (partner gather, rebuild, integrate) scales with the table size
N, not the live population. The runner therefore steps on a prefix
window of the SoA sized to the live population and regrows it
(power-of-two) when the population nears the window; the kernel runs at
each window size N.

Soundness: active particles always live in a prefix of the SoA —
make_particles fills slots [0, n), injection takes the lowest-index
inactive slots (inject.add_particles: a stable argsort of `active`),
deletion flips bits inside the prefix. Callers grow before saturation
(next_window keeps >= 50% headroom).

The slices are contiguous copies, never views: the contact-chain kernel
takes only contiguous tensors and updates shear in place, and a
`[..., :w]` slice of the (3, K, cap) shear or the (K, cap) table is a
non-contiguous view of the full-capacity state. The neighbor-table
empty-slot sentinel is the table size itself (idx == N), so slicing and
growing remap it, keeping int32.
"""

from __future__ import annotations

import torch

from sedifoam_tpu_torch.dem.state import ParticleState


def _map(fn, ps: ParticleState) -> ParticleState:
    return type(ps)(*(fn(x) if isinstance(x, torch.Tensor) else x
                      for x in ps))


def high_water(particles: ParticleState) -> torch.Tensor:
    """Highest active slot index + 1 (0 if none active), a 0-d tensor."""
    n = particles.active.shape[0]
    idx = torch.where(particles.active,
                      torch.arange(n, device=particles.active.device),
                      torch.full((n,), -1, device=particles.active.device))
    return torch.max(idx) + 1


def window_slice(ps: ParticleState, w: int) -> ParticleState:
    """Restrict the SoA to its first `w` slots (binned backend only).

    Caller must guarantee every active particle lives below `w`
    (high_water(ps) <= w). Every sliced field is a contiguous copy;
    neighbor-table sentinels remap to `w`."""
    cap = ps.n_capacity
    if w >= cap:
        return ps
    if ps.rigid is not None:
        raise NotImplementedError("active-window stepping does not "
                                  "support rigid clumps")
    if ps.nbr_idx.shape[0] == 0 or ps.shear.shape[-1] != cap:
        raise NotImplementedError("active-window stepping requires the "
                                  "binned backend's (K, N) table")

    def m(x):
        if x.ndim == 0:
            return x
        if x.shape[0] == cap:
            return x[:w].clone()
        if x.ndim >= 2 and x.shape[-1] == cap:
            return x[..., :w].clone(memory_format=torch.contiguous_format)
        return x

    out = _map(m, ps)
    nbr = torch.where(out.nbr_idx >= w,
                      torch.full_like(out.nbr_idx, w), out.nbr_idx)
    return out._replace(nbr_idx=nbr.to(torch.int32))


def window_grow(ps: ParticleState, w_new: int) -> ParticleState:
    """Extend a windowed SoA to `w_new` slots (inactive defaults)."""
    w_old = ps.n_capacity
    if w_new <= w_old:
        return ps

    def m(x):
        if x.ndim == 0:
            return x
        if x.shape[0] == w_old:
            pad = torch.zeros((w_new - w_old,) + tuple(x.shape[1:]),
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, pad], dim=0)
        if x.ndim >= 2 and x.shape[-1] == w_old:
            pad = torch.zeros(tuple(x.shape[:-1]) + (w_new - w_old,),
                              dtype=x.dtype, device=x.device)
            return torch.cat([x, pad], dim=-1)
        return x

    out = _map(m, ps)
    # zero-padding a (K, w) int table would point every new slot at
    # particle 0: remap old sentinels and fill the new columns with the
    # new sentinel instead
    k = ps.nbr_idx.shape[0]
    nbr_old = torch.where(ps.nbr_idx >= w_old,
                          torch.full_like(ps.nbr_idx, w_new), ps.nbr_idx)
    nbr_pad = torch.full((k, w_new - w_old), w_new, dtype=torch.int32,
                         device=ps.nbr_idx.device)
    nbr = torch.cat([nbr_old, nbr_pad], dim=-1).to(torch.int32)
    return out._replace(nbr_idx=nbr)


def next_window(n_active_hi: int, w_cur: int, capacity: int,
                w_min: int = 2048) -> int:
    """Power-of-two window with >= 50% headroom over the high-water mark
    (injection bursts between host visits must never saturate it)."""
    w = max(w_min, w_cur)
    while w < capacity and n_active_hi * 2 > w:
        w *= 2
    return min(w, capacity)
