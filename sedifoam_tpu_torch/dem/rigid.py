"""Multisphere rigid-clump DEM (LAMMPS `fix rigid/small molecule`); port
of ``sedifoam_tpu/dem/rigid.py``.

The reference's `irregular` example-case drives non-spherical sediment
grains as rigid clumps of bonded spheres (cases/example-cases/irregular/
in.lammps:13 `read_data In_initial.in fix molprop NULL Molecules`,
in.lammps:36 `fix 5 big rigid/small molecule`; physics per Sun & Xiao
arXiv:1608.01049).

Bodies are a second fixed-capacity SoA (B bodies). Member spheres carry
the contacts exactly as free spheres do: the pair kernels never see
bodies. Each DEM substep:

  accumulate   fcm_b  = segment_sum(f_i,  mol_i)
               tcm_b  = segment_sum(r_i x f_i + tq_i, mol_i)
  integrate    velocity-Verlet on body DOFs: vcm/xcm, angular momentum
               L += dt/2 * tcm, omega = R I^-1 R^T L (quaternion rotate),
               quaternion advanced by the exponential map
  set members  x_i = xcm + R d_i ; v_i = vcm + omega x (R d_i) ;
               omega_i = omega   (finite-size spheres spin with the body)

This mirrors FixRigidSmall's initial/final_integrate split (LAMMPS
fix_rigid_small.cpp); the quaternion update uses the exponential map
instead of LAMMPS's Richardson iteration: same O(dt^2) accuracy, no
inner loop.

Intra-body contacts are EXCLUDED (slot-table scrub at rebuild /
same-mol mask in the dense pair evaluation): members at fixed overlap
have zero relative surface velocity, so their granular forces are
central, equal-opposite and cancel in both fcm and tcm. Dropping them
changes no physics and keeps the K-slot table free for real neighbors;
the contact-chain kernel therefore never sees an intra-body contact.

Member offsets `displace` live in the BODY frame (computed once at
setup against the principal axes); world offsets are recomputed from
the quaternion every substep, so bodies crossing periodic boundaries
never see wrap artifacts.

The body sums are `index_put_(accumulate=True)`, which adds duplicates
in a fixed order on CUDA (indices sorted first). `index_add_` adds with
float atomics in a varying order there; the sums feed member positions,
so with it a run and its resume from a checkpoint would not repeat (as
coupling/transfer.py found for the particle-to-grid sums).

In a step split over ranks (`shard`, parallel/mesh.Shard) the bodies are
whole on every rank and each rank holds a block of the member rows: the
body sums gather the members' force and torque rows of all ranks in row
order and add them with the same sorted scatter on every rank, so the
bodies stay the same on every rank, and one process's, bit for bit; each
rank then places its own members.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class RigidBodies(NamedTuple):
    """Fixed-capacity body SoA. Padding rows have valid=False, mass=1."""
    xcm: torch.Tensor      # (B, 3) center of mass (world)
    vcm: torch.Tensor      # (B, 3)
    angmom: torch.Tensor   # (B, 3) angular momentum (world frame)
    quat: torch.Tensor     # (B, 4) body->world rotation, (w, x, y, z)
    inertia: torch.Tensor  # (B, 3) principal moments (body frame)
    mass: torch.Tensor     # (B,)
    valid: torch.Tensor    # (B,) bool

    @property
    def n_capacity(self):
        return self.xcm.shape[0]


# ---------------------------------------------------------------------------
# quaternion algebra (w, x, y, z) — batched over the leading axis


def _cross(a, b):
    # the last axis, whatever the leading shape: torch.cross without dim
    # takes the first axis of size 3
    return torch.linalg.cross(a, b, dim=-1)


def quat_mul(a, b):
    aw, av = a[..., :1], a[..., 1:]
    bw, bv = b[..., :1], b[..., 1:]
    w = aw * bw - torch.sum(av * bv, dim=-1, keepdim=True)
    v = aw * bv + bw * av + _cross(av, bv)
    return torch.cat([w, v], dim=-1)


def quat_rotate(q, v):
    """Rotate vectors v (.., 3) by quaternions q (.., 4): body->world."""
    qw, qv = q[..., :1], q[..., 1:]
    t = 2.0 * _cross(qv, v)
    return v + qw * t + _cross(qv, t)


def quat_rotate_inv(q, v):
    """World->body: rotate by the conjugate."""
    qw, qv = q[..., :1], q[..., 1:]
    t = 2.0 * _cross(-qv, v)
    return v + qw * t + _cross(-qv, t)


def quat_advance(q, omega, dt):
    """q(t+dt) = exp(dt/2 * omega) (x) q, renormalized.

    omega is the world-frame angular velocity; the guard keeps the
    quotient finite at omega = 0.
    """
    wmag = torch.sqrt(torch.sum(omega * omega, dim=-1, keepdim=True))
    half = 0.5 * dt * wmag
    # sin(x)/x, safe at 0
    sinc = torch.where(wmag > 1e-30,
                       torch.sin(half) / torch.clamp(wmag, min=1e-30),
                       torch.full_like(wmag, 0.5 * dt))
    dq = torch.cat([torch.cos(half), omega * sinc], dim=-1)
    out = quat_mul(dq, q)
    return out / torch.linalg.norm(out, dim=-1, keepdim=True)


def omega_from_angmom(rb: RigidBodies):
    """World angular velocity: omega = R diag(1/I) R^T L."""
    l_body = quat_rotate_inv(rb.quat, rb.angmom)
    # 1e-300 rounds to 0 in f32, as in the reference: the where masks it
    iinv = torch.where(rb.inertia > 0.0,
                       1.0 / torch.clamp(rb.inertia, min=1e-300),
                       torch.zeros_like(rb.inertia))
    return quat_rotate(rb.quat, l_body * iinv)


# ---------------------------------------------------------------------------
# setup (host-side, numpy): bodies from per-particle molecule ids


def make_rigid_bodies(pos, mass, radius, mol, vel=None, omega=None,
                      capacity_bodies=None, dtype=torch.float64, device=None
                      ) -> Tuple[RigidBodies, np.ndarray, np.ndarray]:
    """Group particles by 1-based molecule id into rigid bodies.

    Returns (bodies, mol_compact (n,), displace (n, 3)): mol ids are
    compacted to 1..B (0 = free sphere); displace holds each member's
    offset in its body's PRINCIPAL-AXIS frame. Body inertia includes the
    spheres' own 2/5 m r^2 plus the parallel-axis term, matching LAMMPS
    rigid with finite-size (omega-carrying) sphere members. Body vcm and
    angular momentum come from the member velocities/spins (the rigid
    projection of whatever motion the IC carries, as FixRigid's setup
    computes them from atom v/omega).
    """
    pos = np.asarray(pos, np.float64).reshape(-1, 3)
    n = pos.shape[0]
    mass = np.broadcast_to(np.asarray(mass, np.float64), (n,))
    radius = np.broadcast_to(np.asarray(radius, np.float64), (n,))
    vel = np.zeros((n, 3)) if vel is None else \
        np.asarray(vel, np.float64).reshape(-1, 3)
    omega = np.zeros((n, 3)) if omega is None else \
        np.asarray(omega, np.float64).reshape(-1, 3)
    mol = np.asarray(mol, np.int64).ravel()
    ids = np.unique(mol[mol > 0])
    B = capacity_bodies or max(len(ids), 1)
    assert B >= len(ids)

    xcm = np.zeros((B, 3))
    vcm = np.zeros((B, 3))
    angmom = np.zeros((B, 3))
    quat = np.tile(np.array([1.0, 0.0, 0.0, 0.0]), (B, 1))
    inertia = np.zeros((B, 3))
    mtot = np.ones(B)
    valid = np.zeros(B, bool)
    mol_compact = np.zeros(len(mol), np.int32)
    displace = np.zeros_like(pos)

    for b, mid in enumerate(ids):
        sel = mol == mid
        mol_compact[sel] = b + 1
        m = mass[sel]
        x = pos[sel]
        r = radius[sel]
        M = m.sum()
        com = (m[:, None] * x).sum(axis=0) / M
        d = x - com
        # inertia tensor about com: sphere self term + parallel axis
        eye = np.eye(3)
        I = np.zeros((3, 3))
        for mi, di, ri in zip(m, d, r):
            I += 0.4 * mi * ri * ri * eye
            I += mi * ((di @ di) * eye - np.outer(di, di))
        w, R = np.linalg.eigh(I)          # columns of R = principal axes
        if np.linalg.det(R) < 0:          # keep it a rotation, not a flip
            R[:, 2] = -R[:, 2]
        xcm[b] = com
        vcm[b] = (m[:, None] * vel[sel]).sum(axis=0) / M
        angmom[b] = (np.cross(d, m[:, None] * vel[sel])
                     + (0.4 * m * r * r)[:, None] * omega[sel]).sum(axis=0)
        inertia[b] = w
        mtot[b] = M
        valid[b] = True
        quat[b] = _quat_from_matrix(R)
        displace[sel] = d @ R             # R^T d, row-wise

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    bodies = RigidBodies(
        xcm=t(xcm), vcm=t(vcm), angmom=t(angmom), quat=t(quat),
        inertia=t(inertia), mass=t(mtot),
        valid=torch.as_tensor(valid, device=device),
    )
    return bodies, mol_compact, displace


def _quat_from_matrix(R: np.ndarray) -> np.ndarray:
    """Rotation matrix (body->world, columns = body axes) to (w,x,y,z)."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        return np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                         (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 0.0)) * 2
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q / np.linalg.norm(q)


# ---------------------------------------------------------------------------
# per-substep integration


def _body_of(mol, member, B):
    """Body row of each particle (0 for free spheres), as int64."""
    mol = mol.long()
    return torch.where(member, mol - 1, torch.zeros_like(mol)).clamp(0, B - 1)


def _wrap(x, domain_lo, domain_hi, periodic):
    """Periodic wrap of the columns of x (.., 3) on the periodic axes."""
    if not any(periodic):
        return x
    cols = []
    for a in range(3):
        xa = x[:, a]
        if periodic[a]:
            lo, L = domain_lo[a], domain_hi[a] - domain_lo[a]
            xa = lo + torch.remainder(xa - lo, L)
        cols.append(xa)
    return torch.stack(cols, dim=-1)


def _segments(mol, B):
    """The body row each particle adds into: a free sphere into a row of
    its own past the bodies, which is dropped (one shared drop row would
    make every free sphere a duplicate of one index, and the fixed-order
    scatter adds duplicates one after the other)."""
    n = mol.shape[0]
    mol = mol.long()
    return torch.where(mol > 0, mol - 1,
                       B + torch.arange(n, device=mol.device))


def _accumulate(ps, shard=None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sum member forces/torques into body frame counts.

    Returns (fcm (B,3), tcm (B,3), rw (N,3) member world offsets). The
    member offset comes from the quaternion + body-frame displace, never
    from wrapped positions, so periodic images do not matter. With a
    shard, rw of the own rows and the sums over the rows of all ranks
    (the module docstring).
    """
    rb = ps.rigid
    B = rb.n_capacity
    member = ps.mol > 0
    seg = _segments(ps.mol, B)
    rw = quat_rotate(rb.quat[seg.clamp(0, B - 1)], ps.displace)
    rw = torch.where(member[:, None], rw, torch.zeros_like(rw))
    tq = _cross(rw, ps.force) + ps.torque
    rows = torch.cat([ps.force, tq], dim=1)
    if shard is not None:
        rows = shard.comm.all_gather_rows(rows)
        seg = _segments(shard.full["mol"], B)
    # both sums in one fixed-order scatter (module docstring)
    sums = torch.zeros((B + rows.shape[0], 6), dtype=ps.force.dtype,
                       device=ps.force.device)
    sums.index_put_((seg,), rows, accumulate=True)
    return sums[:B, :3], sums[:B, 3:], rw


def _set_members(ps, rw, domain_lo=None, domain_hi=None, periodic=None):
    """Write body motion into member pos/vel/omega."""
    rb = ps.rigid
    B = rb.n_capacity
    member = ps.mol > 0
    b = _body_of(ps.mol, member, B)
    omega_b = omega_from_angmom(rb)
    pos = rb.xcm[b] + rw
    if periodic is not None:
        pos = _wrap(pos, domain_lo, domain_hi, periodic)
    vel = rb.vcm[b] + _cross(omega_b[b], rw)
    mm = member[:, None]
    return ps._replace(
        pos=torch.where(mm, pos, ps.pos),
        vel=torch.where(mm, vel, ps.vel),
        omega=torch.where(mm, omega_b[b], ps.omega),
    )


def initial_integrate(ps, dt, domain_lo, domain_hi, periodic, shard=None):
    """Body half-kick + drift + member placement (before forces)."""
    rb = ps.rigid
    dtf = 0.5 * dt
    fcm, tcm, _ = _accumulate(ps, shard)
    minv = torch.where(rb.valid, 1.0 / rb.mass,
                       torch.zeros_like(rb.mass))[:, None]
    vcm = rb.vcm + dtf * fcm * minv
    xcm = rb.xcm + dt * vcm * rb.valid[:, None]
    xcm = _wrap(xcm, domain_lo, domain_hi, periodic)
    angmom = rb.angmom + dtf * tcm * rb.valid[:, None]
    rb = rb._replace(vcm=vcm, xcm=xcm, angmom=angmom)
    omega_b = omega_from_angmom(rb)
    rb = rb._replace(quat=quat_advance(rb.quat, omega_b, dt))
    ps = ps._replace(rigid=rb)
    # fresh world offsets from the advanced quaternion
    B = rb.n_capacity
    member = ps.mol > 0
    b = _body_of(ps.mol, member, B)
    rw = quat_rotate(rb.quat[b], ps.displace)
    rw = torch.where(member[:, None], rw, torch.zeros_like(rw))
    return _set_members(ps, rw, domain_lo, domain_hi, periodic)


def final_integrate(ps, dt, shard=None):
    """Body half-kick from the new forces + member velocity update."""
    rb = ps.rigid
    dtf = 0.5 * dt
    fcm, tcm, rw = _accumulate(ps, shard)
    minv = torch.where(rb.valid, 1.0 / rb.mass,
                       torch.zeros_like(rb.mass))[:, None]
    rb = rb._replace(vcm=rb.vcm + dtf * fcm * minv,
                     angmom=rb.angmom + dtf * tcm * rb.valid[:, None])
    ps = ps._replace(rigid=rb)
    return _set_members(ps, rw)   # positions unchanged: rw from same quat


def scrub_same_mol(idx: torch.Tensor, mol: torch.Tensor) -> torch.Tensor:
    """Rewrite table slots pointing at same-body partners to the empty
    sentinel (rebuild-time only: the per-substep gathers stay 11-column
    and the contact chain needs no mol argument)."""
    n = mol.shape[0]
    j = idx.clamp(0, n - 1).long()
    col_mol = mol[None, :] if idx.ndim == 2 else mol
    same = (mol[j] == col_mol) & (col_mol > 0) & (idx < n)
    return torch.where(same, torch.full_like(idx, n), idx)
