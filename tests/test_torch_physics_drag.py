"""The reference's drag-correlation gates on sedifoam_tpu_torch alone:
tests/test_drag_models.py (all seven: the Stokes limit, the Newton cap,
the Ergun branch, the Syamlal-O'Brien and no-correction formulas,
monotonicity in |Ur|, the unknown model's error), case for case: the
same inputs, assertions and tolerances, in f64, on the CPU and (marked
`cuda`) on the card.

Runs on the port alone: nothing here imports JAX or the JAX package, so the
file runs on the card under `python -m pytest --noconftest`.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sedifoam_tpu_torch.coupling import drag  # noqa: E402
from torch_port_util import DEVICES, few_threads  # noqa: E402,F401

NUF, RHOF = 1e-6, 1000.0


def _jd(model, ur, alpha, d, device):
    def t(v):
        return torch.tensor([v], dtype=torch.float64, device=device)
    return float(drag.jd(model, t(ur), t(alpha), t(d), NUF, RHOF)[0])


@pytest.mark.parametrize("device", DEVICES)
def test_wen_yu_stokes_limit(device):
    """Dilute, low Re: Jd*Vol*Ur -> 3*pi*mu*d*Ur (Stokes drag)."""
    d, ur = 1e-4, 1e-4
    alpha = 0.0
    jd = _jd("ErgunWenYu", ur, alpha, d, device)
    vol = np.pi / 6 * d ** 3
    f = jd * (1 - alpha) * vol * ur
    stokes = 3 * np.pi * (NUF * RHOF) * d * ur
    np.testing.assert_allclose(f, stokes, rtol=0.02)  # Re ~ 0.01


@pytest.mark.parametrize("device", DEVICES)
def test_wen_yu_newton_regime_cap(device):
    """Re > 1000: Cds = 0.44 exactly."""
    d, ur, alpha = 1e-3, 2.0, 0.1
    beta = 1 - alpha
    Re = beta * ur * d / NUF
    assert Re > 1000
    jd = _jd("ErgunWenYu", ur, alpha, d, device)
    expect = 0.75 * 0.44 * RHOF * ur * beta ** (-2.65) / d
    np.testing.assert_allclose(jd, expect, rtol=1e-12)


@pytest.mark.parametrize("device", DEVICES)
def test_ergun_branch_dense(device):
    """beta <= 0.8 switches to the Ergun packed-bed correlation."""
    d, ur, alpha = 1e-3, 0.1, 0.5
    beta = 1 - alpha
    jd = _jd("ErgunWenYu", ur, alpha, d, device)
    expect = (150.0 * alpha * NUF * RHOF / (beta * d) ** 2
              + 1.75 * RHOF * ur / (beta * d))
    np.testing.assert_allclose(jd, expect, rtol=1e-12)


@pytest.mark.parametrize("device", DEVICES)
def test_syamlal_obrien_dilute_terminal_velocity(device):
    """At alpha->0 the Syamlal-O'Brien Vr -> 1 and Cds -> (0.63+4.8/sqrt(Re))^2."""
    d, ur, alpha = 1e-4, 0.01, 0.0
    Re = ur * d / NUF
    jd = _jd("SyamlalOBrien", ur, alpha, d, device)
    cds = (0.63 + 4.8 / np.sqrt(Re)) ** 2
    np.testing.assert_allclose(jd, 0.75 * cds * RHOF * ur / d, rtol=1e-6)


@pytest.mark.parametrize("device", DEVICES)
def test_no_correction_formula(device):
    d, ur, alpha = 1e-4, 0.01, 0.0
    Re = ur * d / NUF
    jd = _jd("NoCorrection", ur, alpha, d, device)
    cds = 24.0 / Re + 4.0 * Re ** -0.5 + 0.4
    np.testing.assert_allclose(jd, 0.75 * cds * RHOF * ur / d, rtol=1e-6)


@pytest.mark.parametrize("device", DEVICES)
def test_all_models_monotone_in_ur(device):
    for model in drag.DRAG_MODELS:
        j1 = _jd(model, 0.01, 0.2, 1e-3, device)
        j2 = _jd(model, 0.1, 0.2, 1e-3, device)
        assert j2 > j1 > 0, model


@pytest.mark.parametrize("device", DEVICES)
def test_unknown_model_raises(device):
    def z(v):
        return torch.full((1,), v, dtype=torch.float64, device=device)
    with pytest.raises(ValueError):
        drag.jd("Gidaspow", z(0.0), z(0.0), z(1.0), NUF, RHOF)
