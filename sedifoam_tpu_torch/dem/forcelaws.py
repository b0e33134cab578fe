"""Granular contact force laws, shared by the pair and wall paths (port of
``sedifoam_tpu/dem/forcelaws.py``).

Implements the exact math of the reference's DEM styles:
- gran/hooke & gran/hooke/history (stock LAMMPS, mirrored in
  interfaceToLammps/fix_wall_granFix.cpp:356-556)
- gran/hertzFix/history (interfaceToLammps/pair_gran_hertzFix_history.cpp:
  191-255), including the corrected stiffness normalisation constants
  2/1.82, 4/5.46, 8/8.84 and the damping ratio
  beta = -ln(gamman)/sqrt(ln^2(gamman)+pi^2).

Vectors are 3-tuples of component tensors, as in the reference, so the
(K, N) slot layout of the binned table carries through unchanged.
`touch` masks non-contacts; non-contacts see guarded, finite values.
csrc/contact_chain.cu holds the same law, per contact, for the kernel.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from sedifoam_tpu_torch.config import (PAIR_HERTZ_HISTORY, PAIR_HOOKE,
                                       PAIR_HOOKE_HISTORY, PairParams)

_SQRT56 = math.sqrt(5.0 / 6.0)

Vec3 = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _safe_div(a, b):
    return a / torch.where(b == 0.0, torch.ones_like(b), b)


def vdot(a: Vec3, b: Vec3):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def vmag(a: Vec3):
    return torch.sqrt(vdot(a, a))


def vcross(a: Vec3, b: Vec3) -> Vec3:
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def vscale(s, a: Vec3) -> Vec3:
    return (s * a[0], s * a[1], s * a[2])


def vadd(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def vsub(a: Vec3, b: Vec3) -> Vec3:
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def vwhere(cond, a: Vec3, b: Vec3) -> Vec3:
    return tuple(torch.where(cond, x, y) for x, y in zip(a, b))


def hertz_beta(gamman: float) -> float:
    """Damping ratio from the 'restitution-style' gamman of hertzFix."""
    ln = math.log(gamman)
    return -ln / math.sqrt(ln * ln + math.pi * math.pi)


def contact_force(
    params: PairParams,
    dt: float,
    touch,            # (...,) bool
    overlap,          # (...,) radsum - r (pair) or radius - r (wall)
    r, rinv, rsqinv,  # (...,) contact distance and inverses (guarded)
    delta: Vec3,      # x_i - x_j (or signed wall distance vector)
    vnnr,             # (...,) vr . delta
    vtr: Vec3,        # relative tangential surface velocity
    shear: Vec3,      # accumulated shear history (pre-update)
    meff,             # (...,) effective mass
    poly_arg,         # (...,) (radsum-r)*ri*rj/radsum  or (radius-r)*radius
    shearupdate: bool = True,
) -> Tuple[Vec3, Vec3, Vec3]:
    """Returns (force, tangential force fs, new_shear) as component tuples.

    force includes the normal component delta*ccel + fs. Torque is computed
    by callers as -rad * cross(delta, fs) * rinv.
    """
    p = params.resolved()
    zero = torch.zeros_like(vnnr)
    zero3 = (zero, zero, zero)

    if p.style == PAIR_HOOKE:
        damp = meff * p.gamman * vnnr * rsqinv
        ccel = p.kn * overlap * rinv - damp
        vrel = vmag(vtr)
        fn = p.xmu * torch.abs(ccel * r)
        fs = meff * p.gammat * vrel
        ft = torch.where(vrel != 0.0,
                         torch.minimum(fn, fs) / torch.where(
                             vrel == 0, torch.ones_like(vrel), vrel),
                         zero)
        fs_vec = vscale(-ft * touch, vtr)
        force = vadd(vscale(ccel * touch, delta), fs_vec)
        return force, fs_vec, zero3

    # --- history styles: update & rotate shear -------------------------
    if shearupdate:
        shear = vadd(shear, vscale(dt, vtr))
    shrmag = vmag(shear)
    rsht = vdot(shear, delta) * rsqinv
    if shearupdate:
        shear = vsub(shear, vscale(rsht, delta))

    if p.style == PAIR_HOOKE_HISTORY:
        damp = meff * p.gamman * vnnr * rsqinv
        ccel = p.kn * overlap * rinv - damp
        tdamp = meff * p.gammat
        fs_vec = vsub(vscale(-p.kt, shear), vscale(tdamp, vtr))
        fs = vmag(fs_vec)
        fn = p.xmu * torch.abs(ccel * r)
        over = fs > fn
        scale = _safe_div(fn, fs)
        damp_t = vscale(tdamp / max(p.kt, 1e-300), vtr)
        shear_rescaled = vsub(vscale(scale, vadd(shear, damp_t)), damp_t)
        shear = vwhere(over & (shrmag != 0.0), shear_rescaled, shear)
        fs_capped = vwhere(shrmag != 0.0, vscale(scale, fs_vec), zero3)
        fs_vec = vwhere(over, fs_capped, fs_vec)

    elif p.style == PAIR_HERTZ_HISTORY:
        beta = hertz_beta(p.gamman)
        sqrt_poly = torch.sqrt(torch.clamp(poly_arg, min=0.0))
        sn = (2.0 / 1.82) * p.kn * sqrt_poly
        st = (8.0 / 8.84) * p.kn * sqrt_poly
        damp = 2.0 * _SQRT56 * beta * vnnr * rsqinv
        polyhertz = sqrt_poly
        ccel = (polyhertz * (4.0 / 5.46) * p.kn * overlap * rinv
                - torch.sqrt(sn * meff) * damp)
        tdamp_coef = torch.sqrt(st * meff) * (2.0 * _SQRT56 * beta)
        fs_vec = vsub(vscale(-(polyhertz * (8.0 / 8.84) * p.kt), shear),
                      vscale(tdamp_coef, vtr))
        fs = vmag(fs_vec)
        fn = p.xmu * torch.abs(ccel * r)
        over = fs > fn
        scale = _safe_div(fn, fs)
        # the reference's rescale constant: sqrt(st*meff)*2*sqrt(5/6)*beta
        # * vtr / 8.84 * 8.0 / kt
        damp_t = vscale(tdamp_coef / 8.84 * 8.0 / max(p.kt, 1e-300), vtr)
        shear_rescaled = vsub(vscale(scale, vadd(shear, damp_t)), damp_t)
        shear = vwhere(over & (shrmag != 0.0), shear_rescaled, shear)
        fs_capped = vwhere(shrmag != 0.0, vscale(scale, fs_vec), zero3)
        fs_vec = vwhere(over, fs_capped, fs_vec)

    else:
        raise ValueError(f"unknown pair style {p.style}")

    # zero everything on non-contacts (incl. the shear history)
    shear = vwhere(touch, shear, zero3)
    fs_vec = vwhere(touch, fs_vec, zero3)
    force = vwhere(touch, vadd(vscale(ccel, delta), fs_vec), zero3)
    return force, fs_vec, shear
