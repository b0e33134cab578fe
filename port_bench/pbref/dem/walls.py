"""Granular wall forces (fix wall/gran); port of ``sedifoam_tpu/dem/walls.py``.

Mirrors interfaceToLammps/fix_wall_granFix.cpp: plane walls on any axis
(with optional lo/hi sides), a z-axis cylinder, optional wiggle
(oscillating wall) and shear (moving wall) velocity, and per-wall shear
history with the same force laws as the pair styles. Wall shear is
stored (3, W, N).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from pbref.config import WALL_ZCYLINDER, WallSpec
from pbref.dem.forcelaws import contact_force, vcross
from pbref.dem.state import ParticleState

_BIG = 1e30


def _wall_geometry(spec: WallSpec, x, rad, step_time: float):
    """Signed distance components (3x (N,)) from the wall contact point
    and wall velocity components (3x (N,))."""
    zero = torch.zeros_like(rad)
    vwall = [zero, zero, zero]
    wlo = spec.lo if spec.lo is not None else -_BIG
    whi = spec.hi if spec.hi is not None else _BIG

    if spec.wiggle:
        arg = 2.0 * math.pi / spec.period * step_time
        if spec.wiggle_axis == spec.axis:
            wlo = wlo + spec.amplitude - spec.amplitude * math.cos(arg)
            whi = whi + spec.amplitude - spec.amplitude * math.cos(arg)
        vw = spec.amplitude * 2.0 * math.pi / spec.period * math.sin(arg)
        vwall[spec.wiggle_axis] = torch.full_like(rad, vw)
    elif spec.vshear != 0.0 and spec.shear_axis >= 0:
        vwall[spec.shear_axis] = torch.full_like(rad, spec.vshear)

    delta = [zero, zero, zero]
    if spec.style == WALL_ZCYLINDER:
        delxy = torch.sqrt(x[:, 0] ** 2 + x[:, 1] ** 2)
        delr = spec.cylradius - delxy
        inside = delr <= rad
        safe = torch.where(delxy == 0.0, torch.ones_like(delxy), delxy)
        delta[0] = torch.where(inside, -delr / safe * x[:, 0], zero)
        delta[1] = torch.where(inside, -delr / safe * x[:, 1], zero)
        delta[2] = torch.where(inside, zero, zero + spec.cylradius)
        if spec.vshear != 0.0 and spec.shear_axis != 2:
            vwall = [torch.where(inside, spec.vshear * x[:, 1] / safe, zero),
                     torch.where(inside, -spec.vshear * x[:, 0] / safe, zero),
                     zero]
    else:
        a = spec.axis
        del1 = x[:, a] - wlo
        del2 = whi - x[:, a]
        delta[a] = torch.where(del1 < del2, del1, -del2)

    return tuple(delta), tuple(vwall)


def wall_forces(state: ParticleState, walls: Tuple[WallSpec, ...], dt: float,
                step_time: float = 0.0, shearupdate: bool = True):
    """Sum wall contact forces over all wall fixes.

    Returns (force (N,3), torque (N,3), new_wall_shear (3,W,N)).
    """
    force = torch.zeros_like(state.vel)
    torque = torch.zeros_like(state.vel)
    if not walls:
        return force, torque, state.wall_shear

    new_shear_cols = []
    x, v, w = state.pos, state.vel, state.omega
    rad, m = state.radius, state.mass
    one = torch.ones_like(rad)

    for wi, spec in enumerate(walls):
        delta, vwall = _wall_geometry(spec, x, rad, step_time)
        rsq = delta[0] ** 2 + delta[1] ** 2 + delta[2] ** 2
        touch = state.active & (rsq <= rad * rad) & (rsq > 0.0)

        rsq_safe = torch.where(touch, rsq, one)
        r = torch.sqrt(rsq_safe)
        rinv = 1.0 / r
        rsqinv = 1.0 / rsq_safe

        vr = tuple(v[:, c] - vwall[c] for c in range(3))
        vnnr = sum(vr[c] * delta[c] for c in range(3))
        vn = tuple(delta[c] * vnnr * rsqinv for c in range(3))
        vt = tuple(vr[c] - vn[c] for c in range(3))
        wr = tuple(rad * w[:, c] * rinv for c in range(3))
        vtr = (vt[0] - (delta[2] * wr[1] - delta[1] * wr[2]),
               vt[1] - (delta[0] * wr[2] - delta[2] * wr[0]),
               vt[2] - (delta[1] * wr[0] - delta[0] * wr[1]))

        overlap = rad - r
        poly_arg = overlap * rad  # (radius - r) * radius for walls
        shear_w = (state.wall_shear[0, wi], state.wall_shear[1, wi],
                   state.wall_shear[2, wi])

        f_w, fs_vec, new_shear = contact_force(
            spec.params, dt, touch, overlap, r, rinv, rsqinv, delta,
            vnnr, vtr, shear_w, m, poly_arg, shearupdate)

        force = force + torch.stack(f_w, dim=-1)
        tor = vcross(delta, fs_vec)
        torque = torque - torch.stack(
            [rad * tor[c] * rinv for c in range(3)], dim=-1)
        new_shear_cols.append(torch.stack(new_shear))  # (3, N)

    # (3, W, N)
    return force, torque, torch.stack(new_shear_cols, dim=1)
