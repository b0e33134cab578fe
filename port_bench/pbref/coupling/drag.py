"""Per-particle drag correlations Jd(|Ur|) [kg/(m^3 s)] (port of
``sedifoam_tpu/coupling/drag.py``).

Matches lammpsFoam/dragModels/: ErgunWenYu (ErgunWenYu.C:86-145),
SyamlalOBrien (SyamlalOBrien.C:86-145), NoCorrection
(NoCorrection.C:86-146). The drag force on a particle is then
Jd * (1-alpha) * Vol * Ur (enhancedCloud.C:159-162).
"""

from __future__ import annotations

import torch

ROOTVSMALL = 1e-18

DRAG_MODELS = ("ErgunWenYu", "SyamlalOBrien", "NoCorrection")


def ergun_wen_yu(ur_mag, alpha, d, nuf: float, rhof: float):
    beta = torch.clamp(1.0 - alpha, min=ROOTVSMALL)
    bp = beta ** (-2.65)
    Re = torch.clamp(beta * ur_mag * d / nuf, min=ROOTVSMALL)
    Cds = torch.where(Re > 1000.0, torch.full_like(Re, 0.44),
                      24.0 * (1.0 + 0.15 * Re ** 0.687) / Re)
    k_wen_yu = 0.75 * Cds * rhof * ur_mag * bp / d
    k_ergun = (150.0 * alpha * nuf * rhof / (beta * d) ** 2
               + 1.75 * rhof * ur_mag / (beta * d))
    return torch.where(beta <= 0.8, k_ergun, k_wen_yu)


def _vr(ur_mag, alpha, d, nuf: float, beta_floor: float, re_floor: float):
    beta = torch.clamp(1.0 - alpha, min=beta_floor)
    Ai = beta ** 4.14
    Bi = torch.where(beta > 0.85, beta ** 2.65, 0.8 * beta ** 1.28)
    Re = torch.clamp(ur_mag * d / nuf, min=re_floor)
    Vr = 0.5 * (Ai - 0.06 * Re + torch.sqrt(
        (0.06 * Re) ** 2 + 0.12 * Re * (2.0 * Bi - Ai) + Ai ** 2))
    return Re, Vr


def syamlal_obrien(ur_mag, alpha, d, nuf: float, rhof: float):
    Re, Vr = _vr(ur_mag, alpha, d, nuf, ROOTVSMALL, ROOTVSMALL)
    Cds = (0.63 + 4.8 * torch.sqrt(Vr / Re)) ** 2
    return 0.75 * Cds * rhof * ur_mag / (d * Vr ** 2)


def no_correction(ur_mag, alpha, d, nuf: float, rhof: float):
    # NoCorrection.C uses floors 1e-6 (beta) and 1e-3 (Re)
    Re, Vr = _vr(ur_mag, alpha, d, nuf, 1e-6, 1e-3)
    Cds = 24.0 / Re + 4.0 * Re ** (-0.5) + 0.4
    return 0.75 * Cds * rhof * ur_mag / (d * Vr ** 2)


_TABLE = {
    "ErgunWenYu": ergun_wen_yu,
    "SyamlalOBrien": syamlal_obrien,
    "NoCorrection": no_correction,
}


def jd(model: str, ur_mag, alpha, d, nuf: float, rhof: float):
    """Runtime-selectable drag model (dragModel::New analogue)."""
    if model not in _TABLE:
        raise ValueError(
            f"unknown dragModel '{model}'; valid: {sorted(_TABLE)}")
    return _TABLE[model](ur_mag, alpha, d, nuf, rhof)
