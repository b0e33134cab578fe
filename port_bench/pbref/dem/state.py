"""Fixed-capacity struct-of-arrays particle state (port of
``sedifoam_tpu/dem/state.py``).

One NamedTuple of tensors owns everything; adding/deleting particles flips
`active` mask bits. Field names, shapes and meanings are the reference's,
so the bridge (``bridge.py``) maps the two packages' states by name.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch


class ParticleState(NamedTuple):
    pos: torch.Tensor        # (N, 3)
    vel: torch.Tensor        # (N, 3)
    omega: torch.Tensor      # (N, 3) angular velocity
    radius: torch.Tensor     # (N,)
    mass: torch.Tensor       # (N,)
    density: torch.Tensor    # (N,)
    ptype: torch.Tensor      # (N,) int32
    tag: torch.Tensor        # (N,) int32, 1-based like LAMMPS; 0 = empty slot
    active: torch.Tensor     # (N,) bool
    force: torch.Tensor      # (N, 3) current total force (velocity-Verlet carry)
    torque: torch.Tensor     # (N, 3)
    # contact shear history: dense backend (3, N, N) per ordered pair,
    # binned backend (3, K, N) per neighbor slot, lattice backend
    # (3, NOFF, M, M, S) per (half offset, slot, partner slot, bin)
    shear: torch.Tensor
    wall_shear: torch.Tensor  # (3, W, N); W = number of wall fixes
    # (K, N) int32, == N empty; (0, N) when dense; the lattice's (M, S)
    # slot table when lattice
    nbr_idx: torch.Tensor
    pos_at_build: torch.Tensor  # (N, 3) positions at last rebuild
    # fix fdrag state (fix_fluid_drag.cpp): constant fluid force over a
    # subcycle + per-substep added-mass bookkeeping
    fdrag: torch.Tensor      # (N, 3)
    dudt: torch.Tensor       # (N, 3) fluid DDtU at the particle
    v_old: torch.Tensor      # (N, 3) velocity at previous substep
    # history-force (Basset) reduced-order state (enhancedCloud.C:197-234)
    n0: torch.Tensor         # (N,)
    sum_delta_fb: torch.Tensor  # (N, 3)
    # velocity at the start of the fluid step (p.UOld())
    vel_fluid_old: torch.Tensor  # (N, 3)
    # particle injection state (dem/inject.py)
    time_to_add: torch.Tensor    # scalar countdown
    rng_key: torch.Tensor        # (2,) int64 holding the reference's uint32
    # worst count of in-ring partners dropped by the K-nearest truncation
    # at any rebuild so far (LAMMPS "dangerous builds" analogue)
    nbr_dropped: torch.Tensor    # scalar int32
    # multisphere rigid clumps (fix rigid/small molecule; dem/rigid.py):
    # mol = compacted 1-based body id (0 = free sphere); displace = the
    # member's offset in its body's principal-axis frame; rigid = the
    # body SoA, or None when the case has no clumps (the integrator
    # branches on it, there is no config flag)
    mol: torch.Tensor = None         # (N,) int32
    displace: torch.Tensor = None    # (N, 3)
    rigid: object = None             # Optional[dem.rigid.RigidBodies]

    @property
    def n_capacity(self):
        return self.pos.shape[0]

    @property
    def n_active(self):
        return torch.sum(self.active)

    @property
    def volume(self):
        return (4.0 / 3.0) * math.pi * self.radius ** 3

    @property
    def inertia(self):
        """Moment of inertia of a solid sphere: 0.4*m*r^2 (LAMMPS INERTIA)."""
        return 0.4 * self.mass * self.radius ** 2


def make_particles(pos, radius, density, vel=None, omega=None, ptype=None,
                   tag=None, capacity: Optional[int] = None, n_walls: int = 6,
                   neighbor_k: Optional[int] = None, lattice_geom=None,
                   mol=None, dtype=torch.float64,
                   device=None) -> ParticleState:
    """Build a ParticleState from numpy inputs, padded to capacity.

    neighbor_k: K of the binned (K, N) table; lattice_geom: the lattice
    backend's dem.lattice.LatticeGeom, whose shapes shear and the slot
    table then take; neither gives the dense backend's shapes ((3, N, N)
    shear, an empty (0, N) table).

    mol: per-particle molecule ids (any positive labels; 0/None = free
    sphere). Any id > 0 groups particles into rigid clumps (dem/rigid.py),
    on the dense and binned backends only.
    """
    pos = np.asarray(pos, dtype=np.float64).reshape(-1, 3)
    n = pos.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} particles")

    def t(a, dt=None):
        return torch.as_tensor(a, dtype=dt or dtype, device=device)

    def pad2(a, fill=0.0):
        out = np.full((capacity, 3), fill, dtype=np.float64)
        out[:n] = a
        return t(out)

    def pad1(a, fill=0.0, dt=None):
        out = np.full((capacity,), fill, dtype=np.float64)
        out[:n] = a
        return t(out, dt)

    radius = np.broadcast_to(np.asarray(radius, np.float64), (n,))
    density = np.broadcast_to(np.asarray(density, np.float64), (n,))
    mass = density * (4.0 / 3.0) * np.pi * radius ** 3
    vel = np.zeros((n, 3)) if vel is None else np.asarray(vel).reshape(-1, 3)
    omega = np.zeros((n, 3)) if omega is None else np.asarray(omega).reshape(-1, 3)
    ptype = np.ones(n) if ptype is None else np.asarray(ptype)
    tag = np.arange(1, n + 1) if tag is None else np.asarray(tag)

    active = np.zeros(capacity, bool)
    active[:n] = True

    rigid = None
    mol_arr = np.zeros(n, np.int64) if mol is None else \
        np.asarray(mol, np.int64).ravel()
    displace = np.zeros((n, 3))
    if (mol_arr > 0).any():
        if lattice_geom is not None:
            raise NotImplementedError(
                "rigid clumps (mol ids) are supported on the dense and "
                "binned backends only")
        from pbref.dem.rigid import make_rigid_bodies
        rigid, mol_arr, displace = make_rigid_bodies(
            pos, mass, radius, mol_arr, vel=vel, omega=omega, dtype=dtype,
            device=device)

    def zeros(*shape, dt=None):
        return torch.zeros(shape, dtype=dt or dtype, device=device)

    if lattice_geom is not None:
        from pbref.dem.lattice import geom_offsets
        g = lattice_geom
        shear = zeros(3, len(geom_offsets(g)), g.M, g.M, g.S)
        table = (g.M, g.S)
    else:
        shear = zeros(3, capacity if neighbor_k is None else neighbor_k,
                      capacity)
        table = (neighbor_k or 0, capacity)

    return ParticleState(
        pos=pad2(pos),
        vel=pad2(vel),
        omega=pad2(omega),
        radius=pad1(radius),
        mass=pad1(mass),
        density=pad1(density),
        ptype=pad1(ptype, 0, torch.int32),
        tag=pad1(tag, 0, torch.int32),
        active=torch.as_tensor(active, device=device),
        force=zeros(capacity, 3),
        torque=zeros(capacity, 3),
        shear=shear,
        wall_shear=zeros(3, n_walls, capacity),
        nbr_idx=torch.full(table, capacity, dtype=torch.int32,
                           device=device),
        pos_at_build=pad2(pos),
        fdrag=zeros(capacity, 3),
        dudt=zeros(capacity, 3),
        v_old=pad2(vel),
        n0=pad1(np.zeros(n)),
        sum_delta_fb=zeros(capacity, 3),
        vel_fluid_old=pad2(vel),
        time_to_add=torch.tensor(1e30, dtype=dtype, device=device),
        rng_key=zeros(2, dt=torch.int64),
        nbr_dropped=zeros(dt=torch.int32),
        mol=pad1(mol_arr, 0, torch.int32),
        displace=pad2(displace),
        rigid=rigid,
    )
