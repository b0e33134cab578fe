"""One fluid timestep — the fluid half of the coupled loop
(lammpsFoam.C:74-107); port of ``sedifoam_tpu/fluid/step.py``."""

from __future__ import annotations

from sedifoam_tpu_torch.config import FluidConfig
from sedifoam_tpu_torch.fluid import piso as _piso
from sedifoam_tpu_torch.fluid import turbulence as _turb
from sedifoam_tpu_torch.fluid.state import FluidBCs, FluidState
from sedifoam_tpu_torch.grid import Grid


def advance_time(fs: FluidState, cfg: FluidConfig) -> FluidState:
    """runTime++: rotate old-time fields."""
    return fs._replace(
        alpha_old=fs.alpha,
        Ua_old=fs.Ua,
        Ub_old=fs.Ub,
        phia_old=fs.phia,
        phib_old=fs.phib,
        time=fs.time + cfg.dt,
        step=fs.step + 1,
    )


def fluid_step(fs: FluidState, grid: Grid, bcs: FluidBCs, cfg: FluidConfig,
               advance: bool = True, need_ddtu: bool = False,
               pprecond=None) -> FluidState:
    """need_ddtu=True asks for DDtU.H, which is not ported and raises (the
    reference defaults to True; its solver passes solver.need_ddtu(cfg),
    False on the ported path). `pprecond` is the prebuilt pressure
    preconditioner (built here when None)."""
    if need_ddtu:
        _piso.ddtu(fs, grid, bcs, cfg)
    if cfg.add_dns_force:
        raise NotImplementedError("FluidConfig.add_dns_force is not ported")
    if advance:
        fs = advance_time(fs, cfg)

    nu = _turb.nu_eff(fs, grid, cfg)

    # alphaEqn.H: alpha is imposed from the particle averaging; only
    # beta = 1 - alpha is refreshed (derived property here).

    eqn = _piso.assemble_ub_eqn(fs, grid, bcs, cfg, nu)
    fs = _piso.piso(fs, eqn, grid, bcs, cfg, pprecond)

    rUbA = fs.beta / eqn.A(grid)
    fs = _piso.adjust_channel_forcing(fs, rUbA, grid, cfg)

    return _turb.correct(fs, grid, bcs, cfg)
