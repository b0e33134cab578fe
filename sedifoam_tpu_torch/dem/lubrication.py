"""The `pair_style lubricate/poly` parameters (the class of
``sedifoam_tpu/dem/lubrication.py``, copied field for field).

Only the parameters are ported, so that the case loader can parse a
script that sets them; the lubrication forces are not, and
``dem/integrate`` refuses a DEMConfig whose ``lubrication`` is set.
"""

from __future__ import annotations

import dataclasses


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
