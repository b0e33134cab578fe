"""The binned contact chain in plain PyTorch: the pair chain
(neighbor.pair_forces_binned) plus the plane-wall pass (walls.wall_forces)
on every device. The program's kernel computes the same function; here
it never runs."""

from __future__ import annotations

from pbref.config import WALL_ZCYLINDER, PairParams
from pbref.dem.neighbor import pair_forces_binned
from pbref.dem.pair import own
from pbref.dem.state import ParticleState
from pbref.dem.walls import wall_forces


def walls_fusible(walls) -> bool:
    """Static plane walls only — wiggle/shear/cylinder walls take the
    torch wall_forces path beside the kernel."""
    return all(w.style != WALL_ZCYLINDER and not w.wiggle
               and w.vshear == 0.0 for w in walls)


def own_rows(state: ParticleState, rows) -> ParticleState:
    """The state with its row arrays (pos, vel, omega, radius, mass,
    active) cut to rows=(row0, n_rows); the rest as it is."""
    return state._replace(**{k: own(getattr(state, k), rows) for k in (
        "pos", "vel", "omega", "radius", "mass", "active")})


def contact_chain_reference(state: ParticleState, params: PairParams,
                            dt: float, idx, shearupdate: bool = True,
                            periodic_len=None, walls=(), rows=None):
    """Plain PyTorch version of the kernel: the binned pair chain plus,
    when `walls` is non-empty, the plane-wall pass.

    Returns (force (N,3), torque (N,3), new_shear (3,K,N), new_wall_shear
    (3,W,N) or None when `walls` is empty), as the reference's
    pair_forces_binned_fused does; with rows=(row0, n_rows), those rows'
    alone (n_rows in place of N; see the module's docstring).
    """
    force, torque, shear = pair_forces_binned(state, params, dt, idx,
                                              shearupdate, periodic_len,
                                              rows=rows)
    wall_shear = None
    if walls:
        fw, tw, wall_shear = wall_forces(own_rows(state, rows), walls, dt,
                                         0.0, shearupdate)
        force = force + fw
        torque = torque + tw
    return force, torque, shear, wall_shear


contact_chain = contact_chain_reference
