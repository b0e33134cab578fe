"""One fluid timestep — the fluid half of the coupled loop
(lammpsFoam.C:74-107); port of ``sedifoam_tpu/fluid/step.py``.

On a slab of a fluid split along grid-x (grid.SlabGrid) the DNS forcing
needs every kx plane of its spectral state for the inverse transform:
each rank gathers the planes, advances the whole state from the same
key and takes the whole transform, alike on every rank, then keeps its
slab's planes of the state and of the force."""

from __future__ import annotations

from pbref.config import FluidConfig
from pbref.fluid import piso as _piso
from pbref.fluid import turbulence as _turb
from pbref.fluid.state import FluidBCs, FluidState
from pbref.grid import Grid


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
    """need_ddtu=False skips DDtU.H: the material derivatives feed only
    the Cvm virtual-mass RHS (piso.assemble_ub_eqn) and the particle
    added-mass / fix-fdrag carrier_rho terms (coupling/forces.py,
    dem/integrate.py), all gated off on the same config switches; the
    solver derives the flag from the SimConfig (solver.need_ddtu).
    `pprecond` is the prebuilt pressure preconditioner (built here when
    None)."""
    if advance:
        fs = advance_time(fs, cfg)

    nu = _turb.nu_eff(fs, grid, cfg)

    if cfg.add_dns_force:
        from pbref.fluid import bodyforce as _bf
        uo = _bf.UOForcingState(grid.join(fs.dns_f_hat), fs.dns_key)
        uo, force = _bf.uo_forcing_step(
            uo, grid.domain, cfg.dt, cfg.dns_alpha, cfg.dns_sigma,
            cfg.dns_k_upper, cfg.dns_k_lower)
        fs = fs._replace(dns_f_hat=grid.cut(uo.f_hat), dns_key=uo.key,
                         turbulence_force=grid.cut(force))

    # alphaEqn.H: alpha is imposed from the particle averaging; only
    # beta = 1 - alpha is refreshed (derived property here).

    eqn = _piso.assemble_ub_eqn(fs, grid, bcs, cfg, nu)
    fs = _piso.piso(fs, eqn, grid, bcs, cfg, pprecond)

    rUbA = fs.beta / eqn.A(grid)
    fs = _piso.adjust_channel_forcing(fs, rUbA, grid, cfg)

    fs = _turb.correct(fs, grid, bcs, cfg)
    if need_ddtu:
        fs = _piso.ddtu(fs, grid, bcs, cfg)
    return fs
