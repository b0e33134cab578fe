"""Per-particle fluid force sum (enhancedCloud::updateDragOnParticles,
enhancedCloud.C:112-312); port of ``sedifoam_tpu/coupling/forces.py``.

Drag, pressure gradient, buoyancy, added mass (clipped), Saffman-like
lift, Basset-history reduced-order model, wall lubrication and the inlet
forcing region — each behind its cloudProperties switch. Returns the
constant-over-subcycle force pushed into the DEM fdrag fix, plus the
updated history-force state.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from pbref import device_vector
from pbref.config import CloudConfig, FluidConfig
from pbref.coupling import drag as _drag
from pbref.coupling.transfer import gather_fields, particle_cells
from pbref.dem.state import ParticleState
from pbref.grid import Grid

ROOTVSMALL = 1e-18


def g1n(delta_n):
    """History kernel g1n (enhancedCloud.C:1372-1384):
    n < 1 -> 0.9279; else 0.9279*(2n-1)/n * n^(-n/(2n-1)) + 0.001531."""
    n = torch.clamp(delta_n, min=1.0)
    g = 0.9279 * (2.0 * n - 1.0) / n * n ** (-n / (2.0 * n - 1.0)) + 0.001531
    return torch.where(delta_n < 1.0, torch.full_like(g, 0.9279), g)


def particle_forces(
    state: ParticleState,
    uf_smoothed,       # (3,...) smoothed fluid velocity
    uf_smoothed_old,   # (3,...) previous-step smoothed fluid velocity
    grad_p,            # (3,...) pressure gradient
    curl_u,            # (3,...) curl of fluid velocity
    ddt_uf,            # (3,...) DDtUb material derivative
    grid: Grid,
    ccfg: CloudConfig,
    fcfg: FluidConfig,
    alpha_field,
    step_index,
    need_dudt: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, ParticleState]:
    """Returns (p_drag (N,3), p_dudt (N,3), state with history updated).

    need_dudt=False skips gathering DDtUb (p_dudt is exact zeros); it
    feeds only the added-mass term and fix fdrag's carrier_rho term.
    """
    cells = particle_cells(state, grid)
    vol = state.volume
    d = torch.clamp(2.0 * state.radius, min=1e-300)
    dt = fcfg.dt
    rhob, nub = fcfg.rhob, fcfg.nub

    need_dudt = need_dudt or ccfg.particle_added_mass

    # every grid field this force sum needs, in ONE packed row gather
    fields = [uf_smoothed, alpha_field]
    if need_dudt:
        fields.append(ddt_uf)
    if ccfg.particle_pressure_grad:
        fields.append(grad_p)
    if ccfg.particle_lift:
        fields.append(curl_u)
    if ccfg.particle_history_force:
        fields.append(uf_smoothed_old)
    gathered = gather_fields(cells, *fields, grid=grid)
    uf_p, p_alpha = gathered[:2]
    rest = list(gathered[2:])
    dudt_p = rest.pop(0) if need_dudt else torch.zeros_like(state.vel)
    gp = rest.pop(0) if ccfg.particle_pressure_grad else None
    cu = rest.pop(0) if ccfg.particle_lift else None
    uf_old_p = rest.pop(0) if ccfg.particle_history_force else None

    uri = uf_p - state.vel
    mag_uri = torch.sqrt(torch.sum(uri * uri, dim=-1))

    jd_vals = _drag.jd(ccfg.drag_model, mag_uri, p_alpha, d, nub, rhob)

    p_drag = torch.zeros_like(state.vel)

    if ccfg.particle_drag:
        p_drag = p_drag + (jd_vals * (1.0 - p_alpha) * vol)[:, None] * uri
    if ccfg.particle_pressure_grad:
        p_drag = p_drag - gp * vol[:, None]
    if ccfg.particle_buoyancy:
        g = device_vector(tuple(fcfg.gravity), p_drag.dtype, p_drag.device)
        p_drag = p_drag - g[None, :] * (rhob * vol)[:, None]
    if ccfg.particle_added_mass:
        dupdt = (state.vel - state.vel_fluid_old) / dt
        acc = dudt_p - dupdt
        mag_acc = torch.sqrt(torch.sum(acc * acc, dim=-1))
        acc = torch.where((mag_acc > 10.0)[:, None],
                          acc / (mag_acc + ROOTVSMALL)[:, None] * 10.0, acc)
        p_drag = p_drag + 0.5 * rhob * vol[:, None] * acc
    if ccfg.particle_lift:
        mag_cu = torch.sqrt(torch.sum(cu * cu, dim=-1))
        lift = (1.6 * rhob * math.sqrt(nub)) * (d ** 2)[:, None] * \
            torch.linalg.cross(uri, cu, dim=-1) / \
            torch.sqrt(mag_cu + ROOTVSMALL)[:, None]
        p_drag = p_drag + lift

    n0, sum_fb = state.n0, state.sum_delta_fb
    if ccfg.particle_history_force:
        # reduced-order Basset history (enhancedCloud.C:197-234)
        tau_d = d ** 2 / nub
        uri_old = uf_old_p - state.vel_fluid_old
        rep = mag_uri * d / nub
        rep_old = torch.sqrt(torch.sum(uri_old * uri_old, dim=-1)) * d / nub
        tau_h = tau_d * (0.632 / (rep + ROOTVSMALL) + 0.087) ** 2
        tau_h_old = tau_d * (0.632 / (rep_old + ROOTVSMALL) + 0.087) ** 2
        cb = -1.5 * d ** 2 * rhob * math.sqrt(math.pi * nub)
        n_total = step_index.to(p_drag.dtype)
        tau_t = dt * (n_total - n0)
        dupdt = (state.vel - state.vel_fluid_old) / dt
        delta_fb = cb[:, None] * dupdt / math.sqrt(dt)

        young = tau_t < tau_h  # still within the history window
        # branch 1: accumulate
        sum1 = sum_fb + delta_fb
        dnh1 = n_total - n0
        fh1 = g1n(dnh1)[:, None] * sum1
        n0_1 = n0
        # branch 2: rescale the window
        sum2 = (tau_h / torch.clamp(tau_h_old, min=ROOTVSMALL))[:, None] \
            * sum_fb
        dnh2 = tau_h / dt
        sum2 = ((dnh2 - 1.0) / torch.clamp(dnh2, min=ROOTVSMALL))[:, None] \
            * sum2
        n0_2 = n_total - dnh2
        sum2 = sum2 + delta_fb
        fh2 = g1n(dnh2)[:, None] * sum2

        sum_fb = torch.where(young[:, None], sum1, sum2)
        n0 = torch.where(young, n0_1, n0_2)
        fh = torch.where(young[:, None], fh1, fh2)
        p_drag = p_drag + fh * dt
    if ccfg.lubrication_force:
        # hardcoded y-wall lubrication (enhancedCloud.C:235-248)
        dist_min = 1e-4 * d
        dist_max = 0.1 * d
        dist_wall = state.pos[:, 1] - 0.5 * d
        pvel = state.vel[:, 1]
        in_range = (dist_wall < dist_max) & (dist_wall > dist_min)
        f_lub = (6.0 * math.pi * nub * rhob * (-pvel)
                 / torch.where(in_range, dist_wall,
                               torch.ones_like(dist_wall)) * d ** 2 / 4.0)
        p_drag = p_drag.clone()
        p_drag[:, 1] += torch.where(in_range, f_lub, torch.zeros_like(f_lub))
    if any(abs(v) > 0 for v in ccfg.inlet_force) and len(ccfg.inlet_box) == 6:
        box = ccfg.inlet_box
        inside = torch.ones_like(state.active)
        for a in range(3):
            inside &= (state.pos[:, a] >= box[2 * a]) & \
                      (state.pos[:, a] <= box[2 * a + 1])
        target = device_vector(tuple(ccfg.inlet_force), p_drag.dtype,
                               p_drag.device)
        f_inlet = state.mass[:, None] * (target[None, :] - state.vel) / dt
        p_drag = torch.where(inside[:, None], f_inlet, p_drag)

    state = state._replace(n0=n0, sum_delta_fb=sum_fb)
    return p_drag, dudt_p, state
