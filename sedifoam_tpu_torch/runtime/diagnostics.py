"""Runtime physics audits (port of ``sedifoam_tpu/runtime/diagnostics.py``).

Mirrors the reference's built-in per-step assertions/printouts:
- momentum-conservation totals Ftotal/Utotal (enhancedCloud.C:395-435,
  932-976)
- dispersed-phase fraction stats (alphaEqn.H:53-57)
- Courant numbers (CourantNo.H, alphaEqn.H relative-flux print)
- average particle velocity (enhancedCloud::averageInfo, :1341-1370)
- on the lattice DEM backend, the active particles no bin slot holds
  (`lattice_unslotted`, 0 in a healthy run)

`compute` returns a dict of 0-d tensors on the state's device and never
syncs; the runner copies them to the host in one transfer per log.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from sedifoam_tpu_torch import ops
from sedifoam_tpu_torch.config import FluidConfig
from sedifoam_tpu_torch.grid import Grid
from sedifoam_tpu_torch.utils.accum import stable_dot, stable_sum


def compute(state, grid: Grid, cfg: FluidConfig, dem_cfg=None
            ) -> Dict[str, torch.Tensor]:
    fs, ps = state.fluid, state.particles
    pol = getattr(cfg, "dtype_policy", "compensated")
    dtype, device = fs.alpha.dtype, fs.alpha.device
    V = grid.cell_volume_like(fs.alpha)
    dt = cfg.dt

    # Courant number: max over faces of |phi|/A * dt / d (facewise so
    # graded axes use their local spacing)
    co = torch.zeros((), dtype=dtype, device=device)
    co_r = torch.zeros((), dtype=dtype, device=device)
    area = grid.face_area
    for a in range(3):
        if grid.uniform:
            inv_ad = 1.0 / (area[a] * grid.spacing[a])
        else:
            def make(a=a):
                d = grid.axis_dists(a)
                shape = [1, 1, 1]
                shape[a] = len(d)
                return 1.0 / (area[a] * d.reshape(shape))

            inv_ad = grid.const(("inv_area_dist", a), make, dtype, device)
        co = torch.maximum(co, torch.max(torch.abs(fs.phib[a]) * inv_ad)
                           * dt)
        rel = torch.abs(fs.phia[a] - fs.phib[a])
        co_r = torch.maximum(co_r, torch.max(rel * inv_ad) * dt)

    # particle->fluid momentum source total (Ftotal2 analogue) —
    # compensated accumulation (enhancedCloud.C does these in f64)
    one_minus = 1.0 - fs.alpha
    f_total = torch.stack([stable_dot(fs.Asrc[c] * V, one_minus, pol)
                           for c in range(3)])

    # dispersed-phase stats
    alpha_mean = stable_dot(fs.alpha, V, pol) / grid.total_volume

    # solid momentum total (Utotal2 analogue)
    u_solid = torch.stack([stable_dot(fs.Ua[c] * V, fs.alpha, pol)
                           for c in range(3)])

    # average particle velocity (averageInfo)
    vol = ps.volume * ps.active
    total_vol = stable_sum(vol, pol)
    avg_vel = torch.stack([stable_dot(ps.vel[:, c], vol, pol)
                           for c in range(3)]) / (total_vol + 1e-30)

    # audit drift: how much the plain tree-sum differs from the
    # compensated accumulator on the largest-cancellation total,
    # normalized by the absolute-value mass of the sum (the signed total
    # legitimately crosses zero at a fluidization plateau)
    terms = fs.Asrc[1] * V * one_minus
    asrc_y_plain = torch.sum(terms)
    audit_drift = torch.abs(asrc_y_plain - f_total[1]) / (
        stable_sum(torch.abs(terms), pol) + 1e-30)

    out = {
        "courant": co,
        "courant_rel": co_r,
        "alpha_mean": alpha_mean,
        "alpha_min": torch.min(fs.alpha),
        "alpha_max": torch.max(fs.alpha),
        "asrc_total_x": f_total[0],
        "asrc_total_y": f_total[1],
        "asrc_total_z": f_total[2],
        "solid_momentum_y": u_solid[1],
        "n_particles": torch.sum(ps.active),
        "avg_particle_vel_y": avg_vel[1],
        "max_particle_speed": torch.max(
            torch.sqrt(torch.sum(ps.vel ** 2, dim=-1)) * ps.active),
        "continuity_err": torch.max(torch.abs(ops.div_flux(fs.phi, grid))),
        "audit_drift_asrc_y": audit_drift,
    }
    if dem_cfg is not None and dem_cfg.backend == "lattice":
        # lattice bins silently drop overflow particles from contacts;
        # surface any unslotted actives (must stay 0 in a healthy run)
        slotted = torch.sum(ps.nbr_idx < ps.n_capacity)
        out["lattice_unslotted"] = torch.sum(ps.active) - slotted
    return out


def to_host(diag: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The dict as Python floats, in one device-to-host transfer."""
    names = list(diag)
    vals = torch.stack([diag[k].to(torch.float64) for k in names]).cpu()
    return dict(zip(names, np.asarray(vals).tolist()))
