"""Van der Waals cohesion between spheres (fix cohesive); port of
``sedifoam_tpu/dem/cohesion.py``.

The ordered-pair laws of interfaceToLammps/fix_cohesive.cpp:138-260:
model 0 is the retarded 3-branch piecewise law (Hamaker constant `ah`,
London wavelength `lam`, separation cutoffs smin/smax), model 1 the
unretarded law. Attractive: ccel < 0 pulls particles together along the
center line.

Both passes take rows=(row0, n_rows) as the contact chain does: the
forces of those rows of the state alone, against partners in all its
rows (one rank's own rows in a step split over ranks, parallel/).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from pbref.config import CohesionParams
from pbref.dem.state import ParticleState

_PINV = 0.25 / math.atan(1.0)  # 1/pi


def cohesion_ccel(r, radsum, within, params: CohesionParams):
    """Central cohesive force magnitude (negative = attraction) for any
    pair-enumeration layout; the exact piecewise laws of
    fix_cohesive.cpp:183-244. The 1e-300 guards round to 0 in f32, as in
    the reference; the branches they feed are masked out there."""
    sep = r - radsum  # surface separation (can be negative in contact)
    ah, lam, smin = params.ah, params.lam, params.smin
    if params.model == 0:
        d_far = torch.clamp(sep, min=1e-300)
        ccel_far = -ah * radsum * lam * (
            6.4988e-3 - 4.5316e-4 * lam / d_far
            + 1.1326e-5 * lam * lam / (d_far * d_far)) / d_far ** 3

        def _mid(d):
            return (-ah * (lam + 22.242 * d) * radsum * lam / 24.0
                    / (lam + 11.121 * d) ** 2 / (d * d))

        ccel_mid = _mid(torch.clamp(sep, min=1e-300))
        ccel_min = _mid(torch.full_like(sep, smin))
        ccel = torch.where(sep > lam * _PINV, ccel_far,
                           torch.where(sep > smin, ccel_mid, ccel_min))
    else:
        d = torch.clamp(sep, min=1e-300)
        ccel_out = -ah * radsum ** 6 / 6.0 / (d * d) / (r + radsum) ** 2 \
            / r ** 3
        ccel_in = (-ah * radsum ** 6 / 6.0 / (smin * smin)
                   / (smin + 2.0 * radsum) ** 2 / (smin + radsum) ** 3)
        ccel = torch.where(sep > smin, ccel_out, ccel_in)
    return torch.where(within, ccel, torch.zeros_like(ccel))


def cohesion_forces(state: ParticleState, params: Optional[CohesionParams],
                    periodic_len=None, rows=None):
    """Dense all-pairs cohesion."""
    from pbref.dem.pair import min_image, own
    if params is None or params.ah == 0.0:
        return torch.zeros_like(own(state.vel, rows))

    x, rad = state.pos, state.radius
    n = state.n_capacity
    xi = own(x, rows)
    delta = min_image(tuple(xi[:, None, c] - x[None, :, c] for c in range(3)),
                      periodic_len)
    rsq = delta[0] ** 2 + delta[1] ** 2 + delta[2] ** 2
    radsum = own(rad, rows)[:, None] + rad[None, :]

    valid = own(state.active, rows)[:, None] & state.active[None, :]
    ii = torch.arange(n, device=x.device)
    valid &= own(ii, rows)[:, None] != ii[None, :]
    cut = radsum + params.smax
    within = valid & (rsq < cut * cut)

    r = torch.sqrt(torch.where(within, rsq, torch.ones_like(rsq)))
    ccel = cohesion_ccel(r, radsum, within, params)
    rinv = 1.0 / r
    return torch.stack([torch.sum(delta[c] * ccel * rinv, dim=1)
                        for c in range(3)], dim=-1)


def cohesion_forces_binned(state: ParticleState,
                           params: Optional[CohesionParams], idx,
                           periodic_len=None, rows=None):
    """Cohesion over the (K, N) neighbor table (fix_cohesive.cpp has its
    own neighbor-list request, fix_cohesive.cpp:92-96; here the table is
    shared: the binner's cutoff must cover d_max + smax, enforced by the
    case loader). rows: as neighbor.gather_partners."""
    from pbref.dem.pair import own
    if params is None or params.ah == 0.0:
        return torch.zeros_like(own(state.vel, rows))
    from pbref.dem.neighbor import gather_partners

    has, pg, delta, rsq = gather_partners(state, idx, periodic_len, rows)
    rad = own(state.radius, rows)
    radsum = rad[None, :] + pg[..., 9]
    cut = radsum + params.smax
    within = has & own(state.active, rows)[None, :] & (rsq < cut * cut)
    r = torch.sqrt(torch.where(within, rsq, torch.ones_like(rsq)))
    ccel = cohesion_ccel(r, radsum, within, params)
    rinv = 1.0 / r
    return torch.stack([torch.sum(delta[c] * ccel * rinv, dim=0)
                        for c in range(3)], dim=-1)
