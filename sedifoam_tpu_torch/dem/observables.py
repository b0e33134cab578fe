"""Contact-network observables (compute gran/local, compute cohe/local);
port of ``sedifoam_tpu/dem/observables.py``.

Reference: interfaceToLammps/compute_gran_local.cpp:43-121 and
compute_cohe_local.cpp:43-121: per-contact local arrays (distance,
normal-force magnitude, force components, pair tags) for contact-network
analysis.

Fixed-shape versions: the dense backend returns (N, N) pair tables, the
binned backend (K, N) neighbor-slot tables, both masked by `touching`;
callers filter host-side (``.cpu().numpy()`` + boolean mask) when
writing dumps.
"""

from __future__ import annotations

from typing import Dict

import torch

from sedifoam_tpu_torch.config import DEMConfig
from sedifoam_tpu_torch.dem.forcelaws import contact_force
from sedifoam_tpu_torch.dem.state import ParticleState


def _require_table_backend(cfg: DEMConfig, what: str):
    if cfg.backend not in ("dense", "binned"):
        raise NotImplementedError(
            f"{what} supports dense/binned, not {cfg.backend!r}")


def _tags(state: ParticleState, cfg: DEMConfig, has=None):
    """(tag_i, tag_j) in the backend's table layout."""
    n = state.n_capacity
    if cfg.backend == "dense":
        return (state.tag[:, None].expand(n, n),
                state.tag[None, :].expand(n, n))
    idx = state.nbr_idx
    jcl = idx.clamp(0, n - 1).long()
    return (state.tag[None, :].expand(idx.shape),
            torch.where(has, state.tag[jcl], torch.zeros_like(idx)))


def contact_table(state: ParticleState, cfg: DEMConfig
                  ) -> Dict[str, torch.Tensor]:
    """Per-contact quantities for all touching pairs.

    Dense backend: dict of (N, N) tensors. Binned backend: dict of (K, N)
    tensors over the neighbor table. Keys: touching, dist, fn (normal
    force magnitude), fx/fy/fz, tag_i, tag_j. The contacts are those the
    force evaluation sees (pair.pair_kinematics, neighbor.slot_kinematics).
    """
    _require_table_backend(cfg, "contact_table")
    plen = cfg.periodic_len()
    if cfg.backend == "dense":
        from sedifoam_tpu_torch.dem.pair import pair_kinematics
        kin = pair_kinematics(state, plen)
        has = None
    else:
        from sedifoam_tpu_torch.dem.neighbor import slot_kinematics
        has, *kin = slot_kinematics(state, state.nbr_idx, plen)
    touch, overlap, r, rinv, rsqinv, delta, vnnr, vtr, meff, poly = kin
    tag_i, tag_j = _tags(state, cfg, has)

    shear = (state.shear[0], state.shear[1], state.shear[2])
    f, fs, _ = contact_force(cfg.pair, 0.0, touch, overlap, r, rinv,
                             rsqinv, delta, vnnr, vtr, shear, meff,
                             poly, shearupdate=False)
    fn_mag = torch.sqrt(sum((f[c] - fs[c]) ** 2 for c in range(3)))
    return {
        "touching": touch,
        "dist": torch.where(touch, r, torch.zeros_like(r)),
        "fn": fn_mag,
        "fx": f[0], "fy": f[1], "fz": f[2],
        "tag_i": tag_i,
        "tag_j": tag_j,
    }


def cohesion_table(state: ParticleState, cfg: DEMConfig
                   ) -> Dict[str, torch.Tensor]:
    """compute cohe/local (interfaceToLammps/compute_cohe_local.cpp:43-121):
    per cohesive pair within the smax ring: dist, force magnitude,
    fx/fy/fz, tag1/tag2. Dense -> (N, N) tables, binned -> (K, N)."""
    params = cfg.cohesion
    assert params is not None, "cohesion_table requires fix cohesive"
    _require_table_backend(cfg, "cohesion_table")
    from sedifoam_tpu_torch.dem.cohesion import cohesion_ccel

    x, rad = state.pos, state.radius
    n = state.n_capacity
    plen = cfg.periodic_len()

    if cfg.backend == "dense":
        from sedifoam_tpu_torch.dem.pair import min_image
        delta = min_image(
            tuple(x[:, None, c] - x[None, :, c] for c in range(3)), plen)
        rsq = delta[0] ** 2 + delta[1] ** 2 + delta[2] ** 2
        radsum = rad[:, None] + rad[None, :]
        valid = state.active[:, None] & state.active[None, :]
        valid &= ~torch.eye(n, dtype=torch.bool, device=x.device)
        has = None
    else:
        from sedifoam_tpu_torch.dem.neighbor import gather_partners
        has, pg, delta, rsq = gather_partners(state, state.nbr_idx, plen)
        radsum = rad[None, :] + pg[..., 9]
        valid = has & state.active[None, :]
    tag_i, tag_j = _tags(state, cfg, has)

    cut = radsum + params.smax
    within = valid & (rsq < cut * cut)
    r = torch.sqrt(torch.where(within, rsq, torch.ones_like(rsq)))
    ccel = cohesion_ccel(r, radsum, within, params)
    rinv = 1.0 / r
    f = tuple(delta[c] * ccel * rinv for c in range(3))
    return {
        "touching": within,
        "dist": torch.where(within, r, torch.zeros_like(r)),
        "force": torch.abs(ccel),
        "fx": f[0], "fy": f[1], "fz": f[2],
        "tag_i": tag_i,
        "tag_j": tag_j,
    }
