"""Hydrodynamic lubrication for polydisperse spheres (pair lubricate/poly);
port of ``sedifoam_tpu/dem/lubrication.py``.

Reference: interfaceToLammps/pair_lubricate_poly.cpp:65-430 — FLD
(fast lubrication dynamics) isotropic drag plus pairwise squeeze/shear/
pump resistances between unequal spheres:

- isotropic (flagfld): F -= R0*a*v, T -= RT0*a^3*w, with optional
  volume-fraction corrections to R0/RT0 (flagVF branch at :175-186);
- pairwise (flagHI): scalar resistances a_sq (squeeze), a_sh (shear),
  a_pu (pump) from the scaled gap h = (r - a_i - a_j)/a_i and the radius
  ratio beta0 = a_j/a_i, including the log terms when flaglog is set
  (:306-330); gaps below cut_inner are regularized exactly as the
  reference does (:294-296, including its 100*(a_i+a_j) quirk).

Box shearing (fix deform coupling) is not supported — the reference's
cohesive-suspension configs don't use it with sediFoam.

Dense ordered-pair evaluation with component-tuple layout (see pair.py).
Both passes take rows=(row0, n_rows) as the contact chain does: the
forces of those rows alone against partners in all rows; the volume
fraction sums the volume of all rows.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from pbref.config import WALL_ZCYLINDER
from pbref.dem.state import ParticleState


def _pairwise_lub(p, mu, delta, r, within, radi, radj, vi, vj, wi, wj, xl):
    """Shared squeeze/shear/pump math for any pair-enumeration layout.

    All inputs are broadcast pair arrays; vi/vj are surface velocities at
    the closest-approach point, xl the contact offset from particle i.
    Returns (fpair (3-tuple), torque contributions (3-tuple) or None).
    """
    h_sep = r - radi - radj
    h_sep = torch.where(r < p.cut_inner, 100.0 * radi + 100.0 * radj, h_sep)
    h = torch.clamp(h_sep / radi, min=1e-12)

    beta0 = radj / radi
    beta1 = 1.0 + beta0
    logih = torch.log(1.0 / h)

    a_sq = beta0 ** 2 / beta1 ** 2 / h
    if p.flaglog:
        a_sq = a_sq + (1.0 + 7.0 * beta0 + beta0 ** 2) / 5.0 / beta1 ** 3 \
            * logih
        a_sq = a_sq + (1.0 + 18.0 * beta0 - 29.0 * beta0 ** 2
                       + 18.0 * beta0 ** 3 + beta0 ** 4) / 21.0 \
            / beta1 ** 4 * h * logih
    a_sq = 6.0 * math.pi * mu * radi * a_sq

    if p.flaglog:
        a_sh = (4.0 * beta0 * (2.0 + beta0 + 2.0 * beta0 ** 2)
                / 15.0 / beta1 ** 3 * logih)
        a_sh = a_sh + (4.0 * (16.0 - 45.0 * beta0 + 58.0 * beta0 ** 2
                              - 45.0 * beta0 ** 3 + 16.0 * beta0 ** 4)
                       / 375.0 / beta1 ** 4 * h * logih)
        a_sh = 6.0 * math.pi * mu * radi * a_sh
        a_pu = beta0 * (4.0 + beta0) / 10.0 / beta1 ** 2 * logih
        a_pu = a_pu + ((32.0 - 33.0 * beta0 + 83.0 * beta0 ** 2
                        + 43.0 * beta0 ** 3) / 250.0 / beta1 ** 3 * h * logih)
        a_pu = 8.0 * math.pi * mu * radi ** 3 * a_pu

    vr = tuple(vi[c] - vj[c] for c in range(3))
    vnnr = sum(vr[c] * delta[c] for c in range(3)) / r
    vn = tuple(vnnr * delta[c] / r for c in range(3))
    vt = tuple(vr[c] - vn[c] for c in range(3))

    fpair = tuple(a_sq * vn[c] for c in range(3))
    if p.flaglog:
        fpair = tuple(fpair[c] + a_sh * vt[c] for c in range(3))
    zero = torch.zeros_like(r)
    fpair = tuple(torch.where(within, fpair[c], zero) for c in range(3))

    tq = wt = None
    if p.flaglog:
        tq = (xl[1] * fpair[2] - xl[2] * fpair[1],
              xl[2] * fpair[0] - xl[0] * fpair[2],
              xl[0] * fpair[1] - xl[1] * fpair[0])
        dw = tuple(wi[c] - wj[c] for c in range(3))
        wdotn = sum(dw[c] * delta[c] for c in range(3)) / r
        wt = tuple(torch.where(within, a_pu * (dw[c] - wdotn * delta[c] / r),
                               zero) for c in range(3))
        tq = tuple(torch.where(within, tq[c], zero) for c in range(3))
    return fpair, tq, wt


def wall_bounded_volume(box_lo, box_hi, walls, step_time=0.0):
    """Effective V_T for the volume-fraction correction when plane walls
    bound the suspension (pair_lubricate_poly.cpp:514-539: each fix-wall
    side overrides the domain extent on its axis; moving walls trigger a
    per-step recompute, :152-177). Wiggled walls shift both sides by the
    same offset walls.py applies; step_time is the substep loop's Python
    float. Returns a Python float."""
    lo = list(box_lo)
    hi = list(box_hi)
    for w in walls:
        if w.style == WALL_ZCYLINDER:
            continue      # reference's wall volume logic is plane-only
        a = w.axis
        wlo, whi = w.lo, w.hi
        if w.wiggle and w.wiggle_axis == a and w.period > 0.0:
            arg = 2.0 * math.pi / w.period * step_time
            off = w.amplitude - w.amplitude * math.cos(arg)
            wlo = None if wlo is None else wlo + off
            whi = None if whi is None else whi + off
        if wlo is not None:
            lo[a] = wlo
        if whi is not None:
            hi[a] = whi
    return (hi[0] - lo[0]) * (hi[1] - lo[1]) * (hi[2] - lo[2])


@dataclasses.dataclass(frozen=True)
class LubricationParams:
    """pair_style lubricate/poly mu flaglog flagfld cutinner cutoff
    [flagHI] [flagVF]."""

    mu: float = 1e-3          # dynamic viscosity
    flaglog: int = 0          # include log terms (and shear/pump)
    flagfld: int = 0          # isotropic FLD drag
    cut_inner: float = 0.0    # inner gap regularization cutoff (distance)
    cut: float = 0.0          # outer cutoff (distance)
    flag_hi: int = 1          # pairwise hydrodynamic interactions
    flag_vf: int = 1          # volume-fraction corrections
    box_volume: float = 1.0   # V_T for the volume-fraction correction


def lubrication_forces(state: ParticleState, p: LubricationParams,
                       periodic_len=None, vol_T=None, rows=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (force (N,3), torque (N,3)). vol_T overrides p.box_volume
    (wall-bounded volume, see wall_bounded_volume). rows: the module
    docstring (force and torque (n_rows, 3))."""
    from pbref.dem.pair import min_image, own
    mu = p.mu
    n = state.n_capacity
    x, v, w = own(state.pos, rows), own(state.vel, rows), \
        own(state.omega, rows)
    rad = own(state.radius, rows)
    active = own(state.active, rows)

    force = torch.zeros_like(v)
    torque = torch.zeros_like(v)

    # ---- isotropic FLD terms (with volume-fraction correction) --------
    if p.flagfld:
        vol_p = torch.sum(state.volume * state.active)
        vol = p.box_volume if vol_T is None else vol_T
        vf = vol_p / vol if p.flag_vf else 0.0
        if p.flaglog:
            R0 = 6 * math.pi * mu * (1.0 + 2.725 * vf - 6.583 * vf * vf)
            RT0 = 8 * math.pi * mu * (1.0 + 0.749 * vf - 2.469 * vf * vf)
        else:
            R0 = 6 * math.pi * mu * (1.0 + 2.16 * vf)
            RT0 = 8 * math.pi * mu * (1.0 + 0.0 * vf)
        force = force - R0 * rad[:, None] * v * active[:, None]
        torque = torque - RT0 * (rad ** 3)[:, None] * w * active[:, None]

    if not p.flag_hi:
        return force, torque

    # ---- pairwise squeeze/shear/pump -----------------------------------
    xa, va, wa = state.pos, state.vel, state.omega    # the partners: all
    delta = min_image(tuple(x[:, None, c] - xa[None, :, c]
                            for c in range(3)), periodic_len)
    rsq = delta[0] ** 2 + delta[1] ** 2 + delta[2] ** 2
    ii = torch.arange(n, device=x.device)
    within = active[:, None] & state.active[None, :] & \
        (own(ii, rows)[:, None] != ii[None, :])
    within &= rsq < p.cut ** 2
    r = torch.sqrt(torch.where(within, rsq, torch.ones_like(rsq)))

    radi = rad[:, None]
    radj = state.radius[None, :]

    # closest-approach points (from centers, along -delta for i)
    xl = tuple(-delta[c] / r * radi for c in range(3))
    jl = tuple(-delta[c] / r * radj for c in range(3))

    wi = tuple(w[:, None, c] + torch.zeros_like(r) for c in range(3))
    wj = tuple(wa[None, :, c] + torch.zeros_like(r) for c in range(3))

    # surface velocities at closest approach (no background shear field)
    vi = (v[:, None, 0] + (wi[1] * xl[2] - wi[2] * xl[1]),
          v[:, None, 1] + (wi[2] * xl[0] - wi[0] * xl[2]),
          v[:, None, 2] + (wi[0] * xl[1] - wi[1] * xl[0]))
    vj = (va[None, :, 0] - (wj[1] * jl[2] - wj[2] * jl[1]),
          va[None, :, 1] - (wj[2] * jl[0] - wj[0] * jl[2]),
          va[None, :, 2] - (wj[0] * jl[1] - wj[1] * jl[0]))

    fpair, tq, wt = _pairwise_lub(p, mu, delta, r, within, radi, radj,
                                  vi, vj, wi, wj, xl)
    force = force - torch.stack([torch.sum(fpair[c], dim=1)
                                 for c in range(3)], dim=-1)
    if p.flaglog:
        torque = torque - torch.stack([
            torch.sum(tq[c] + wt[c], dim=1) for c in range(3)], dim=-1)

    return force, torque


def lubrication_forces_binned(state: ParticleState, p: LubricationParams,
                              idx, periodic_len=None, vol_T=None, rows=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pair lubricate/poly over the (K, N) neighbor table (binner cutoff
    and K must cover p.cut's ring; enforced by the case loader). rows:
    as neighbor.gather_partners."""
    from pbref.dem.neighbor import gather_partners
    from pbref.dem.pair import own

    mu = p.mu
    v, w = own(state.vel, rows), own(state.omega, rows)
    rad, active = own(state.radius, rows), own(state.active, rows)

    force = torch.zeros_like(v)
    torque = torch.zeros_like(v)

    if p.flagfld:
        vol_p = torch.sum(state.volume * state.active)
        vol = p.box_volume if vol_T is None else vol_T
        vf = vol_p / vol if p.flag_vf else 0.0
        if p.flaglog:
            R0 = 6 * math.pi * mu * (1.0 + 2.725 * vf - 6.583 * vf * vf)
            RT0 = 8 * math.pi * mu * (1.0 + 0.749 * vf - 2.469 * vf * vf)
        else:
            R0 = 6 * math.pi * mu * (1.0 + 2.16 * vf)
            RT0 = 8 * math.pi * mu * (1.0 + 0.0 * vf)
        force = force - R0 * rad[:, None] * v * active[:, None]
        torque = torque - RT0 * (rad ** 3)[:, None] * w * active[:, None]

    if not p.flag_hi:
        return force, torque

    has, pg, delta, rsq = gather_partners(state, idx, periodic_len, rows)
    within = has & active[None, :] & (rsq < p.cut ** 2)
    r = torch.sqrt(torch.where(within, rsq, torch.ones_like(rsq)))

    radi = rad[None, :]          # particle i broadcast over slots
    radj = pg[..., 9]

    xl = tuple(-delta[c] / r * radi for c in range(3))
    jl = tuple(-delta[c] / r * radj for c in range(3))
    wi = tuple(w[:, c][None, :] + torch.zeros_like(r) for c in range(3))
    wj = tuple(pg[..., 6 + c] for c in range(3))
    vi = (v[:, 0][None, :] + (wi[1] * xl[2] - wi[2] * xl[1]),
          v[:, 1][None, :] + (wi[2] * xl[0] - wi[0] * xl[2]),
          v[:, 2][None, :] + (wi[0] * xl[1] - wi[1] * xl[0]))
    vj = (pg[..., 3] - (wj[1] * jl[2] - wj[2] * jl[1]),
          pg[..., 4] - (wj[2] * jl[0] - wj[0] * jl[2]),
          pg[..., 5] - (wj[0] * jl[1] - wj[1] * jl[0]))

    fpair, tq, wt = _pairwise_lub(p, mu, delta, r, within, radi, radj,
                                  vi, vj, wi, wj, xl)
    force = force - torch.stack([torch.sum(fpair[c], dim=0)
                                 for c in range(3)], dim=-1)
    if p.flaglog:
        torque = torque - torch.stack([
            torch.sum(tq[c] + wt[c], dim=0) for c in range(3)], dim=-1)
    return force, torque
