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
    # binned backend: contact shear history (3, K, N) per neighbor slot
    shear: torch.Tensor
    wall_shear: torch.Tensor  # (3, W, N); W = number of wall fixes
    nbr_idx: torch.Tensor       # (K, N) int32; == N means empty slot
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
    # particle injection state (not ported: kept for the field mapping)
    time_to_add: torch.Tensor    # scalar countdown
    rng_key: torch.Tensor        # (2,) int64 (uint32 in the reference)
    # worst count of in-ring partners dropped by the K-nearest truncation
    # at any rebuild so far (LAMMPS "dangerous builds" analogue)
    nbr_dropped: torch.Tensor    # scalar int32
    # rigid clumps are not ported: mol stays 0 and rigid None
    mol: torch.Tensor = None         # (N,) int32
    displace: torch.Tensor = None    # (N, 3)
    rigid: object = None

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
                   neighbor_k: Optional[int] = None, mol=None,
                   dtype=torch.float64, device=None) -> ParticleState:
    """Build a ParticleState from numpy inputs, padded to capacity.

    neighbor_k: K of the binned (K, N) table. The dense and lattice
    backends (neighbor_k None) and rigid clumps (mol > 0) are not ported.
    """
    if neighbor_k is None:
        raise NotImplementedError(
            "DEMConfig.backend: only the binned backend is ported; pass "
            "neighbor_k")
    pos = np.asarray(pos, dtype=np.float64).reshape(-1, 3)
    n = pos.shape[0]
    capacity = capacity or n
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} particles")
    if mol is not None and (np.asarray(mol) > 0).any():
        raise NotImplementedError("rigid clumps (mol ids) are not ported")

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

    def zeros(*shape, dt=None):
        return torch.zeros(shape, dtype=dt or dtype, device=device)

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
        shear=zeros(3, neighbor_k, capacity),
        wall_shear=zeros(3, n_walls, capacity),
        nbr_idx=torch.full((neighbor_k, capacity), capacity,
                           dtype=torch.int32, device=device),
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
        mol=zeros(capacity, dt=torch.int32),
        displace=zeros(capacity, 3),
        rigid=None,
    )
