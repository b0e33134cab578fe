"""sedifoam_tpu_torch's rigid clumps (dem/rigid.py and its hooks) against
sedifoam_tpu, on the CPU.

Inputs come from a numpy seed or from tests/test_rigid.py's set-ups (the
dimers and the tilted clump moved into contact, so that 20 substeps see
the collision) and go through both packages. Tolerance: 1e-12 of each
field's scale in f64 (measured: 0 for the quaternion functions and
make_rigid_bodies, at most 2.8e-15 after 20 substeps of the collision
and 8.8e-15 of the clump on the wall, contact history included); 1e-5
in f32 against JAX f32 for the quaternion functions (measured 6.2e-8),
including the `sinc` guard at omega = 0 and the `1e-300` guard of
omega_from_angmom, which flushes to 0 in f32 in both packages.
"""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu import config as jcfg  # noqa: E402
from sedifoam_tpu.dem import integrate as jint  # noqa: E402
from sedifoam_tpu.dem import rigid as jrig  # noqa: E402
from sedifoam_tpu.dem.state import make_particles as jmake  # noqa: E402
from sedifoam_tpu_torch import bridge  # noqa: E402
from sedifoam_tpu_torch import config as tcfg  # noqa: E402
from sedifoam_tpu_torch.dem import integrate as tint  # noqa: E402
from sedifoam_tpu_torch.dem import rigid as trig  # noqa: E402
from sedifoam_tpu_torch.dem.state import make_particles as tmake  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import (assert_tree_close,  # noqa: E402
                             particles_to_torch, rel_err)

TOL = {"f64": 1e-12, "f32": 1e-5}
JDT = {"f64": jnp.float64, "f32": jnp.float32}
TDT = {"f64": torch.float64, "f32": torch.float32}


def _bodies(prec, n=7, seed=3):
    """Random bodies in both packages; row 0 is at rest (the guards), the
    last row is padding (valid=False, mass=1, zero inertia)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    f = dict(xcm=rng.normal(size=(n, 3)), vcm=rng.normal(size=(n, 3)),
             angmom=1e-7 * rng.normal(size=(n, 3)), quat=q,
             inertia=1e-9 * (0.5 + rng.random(size=(n, 3))),
             mass=1e-4 * (0.5 + rng.random(size=n)))
    f["angmom"][0] = 0.0
    f["inertia"][-1] = 0.0
    f["mass"][-1] = 1.0
    valid = np.ones(n, bool)
    valid[-1] = False
    rj = jrig.RigidBodies(valid=jnp.asarray(valid), **{
        k: jnp.asarray(v, JDT[prec]) for k, v in f.items()})
    rt = trig.RigidBodies(valid=torch.as_tensor(valid), **{
        k: torch.as_tensor(v, dtype=TDT[prec]) for k, v in f.items()})
    return rj, rt, rng


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_quaternion_functions(prec):
    rj, rt, rng = _bodies(prec)
    n = rj.n_capacity
    v = rng.normal(size=(n, 3))
    q2 = rng.normal(size=(n, 4))
    om = 50.0 * rng.normal(size=(n, 3))
    om[0] = 0.0                       # the sinc guard
    om[1] = 1e-35                     # below the guard's threshold
    vj, q2j, omj = (jnp.asarray(a, JDT[prec]) for a in (v, q2, om))
    vt, q2t, omt = (torch.as_tensor(a, dtype=TDT[prec]) for a in (v, q2, om))
    pairs = {
        "quat_mul": (jrig.quat_mul(rj.quat, q2j), trig.quat_mul(rt.quat, q2t)),
        "quat_rotate": (jrig.quat_rotate(rj.quat, vj),
                        trig.quat_rotate(rt.quat, vt)),
        "quat_rotate_inv": (jrig.quat_rotate_inv(rj.quat, vj),
                            trig.quat_rotate_inv(rt.quat, vt)),
        "quat_advance": (jrig.quat_advance(rj.quat, omj, 1e-3),
                         trig.quat_advance(rt.quat, omt, 1e-3)),
        "omega_from_angmom": (jrig.omega_from_angmom(rj),
                              trig.omega_from_angmom(rt)),
    }
    for name, (ref, got) in pairs.items():
        assert got.dtype == TDT[prec], name
        assert torch.all(torch.isfinite(got)), name
        assert rel_err(ref, got) <= TOL[prec], name
    # zero omega leaves the quaternion as it is; a padding body (zero
    # inertia) has zero angular velocity
    assert rel_err(rt.quat[:2], pairs["quat_advance"][1][:2]) <= TOL[prec]
    assert torch.all(pairs["omega_from_angmom"][1][-1] == 0.0)
    # (B, 3) with B = 3: the cross product is over the last axis
    a, b = rng.normal(size=(3, 3)), rng.normal(size=(3, 3))
    np.testing.assert_allclose(
        trig._cross(torch.as_tensor(a), torch.as_tensor(b)).numpy(),
        np.cross(a, b), atol=1e-15)


def test_make_rigid_bodies():
    """Trimers, an L-shaped clump and free spheres, with member velocities
    and spins: bodies, compacted ids and body-frame offsets."""
    rng = np.random.default_rng(11)
    r = 2e-4
    pos, mol = [], []
    for b in range(5):
        org = rng.uniform(1e-3, 9e-3, 3)
        axis = rng.normal(size=3)
        axis /= np.linalg.norm(axis)
        for k in (-1, 0, 1):
            pos.append(org + k * 0.8 * 2 * r * axis)
            mol.append(10 * (b + 1))              # any positive labels
    pos += [[0.0, 0.0, 0.0], [2 * r, 0.0, 0.0], [0.0, 2 * r, 0.0]]
    mol += [7, 7, 7]
    pos += list(rng.uniform(1e-3, 9e-3, (4, 3)))  # free spheres
    mol += [0, 0, 0, 0]
    n = len(pos)
    rad = r * (0.8 + 0.4 * rng.random(n))
    mass = 2650.0 * (4 / 3) * np.pi * rad ** 3
    vel, omega = rng.normal(size=(n, 3)), 10 * rng.normal(size=(n, 3))
    bj, mj, dj = jrig.make_rigid_bodies(pos, mass, rad, mol, vel=vel,
                                        omega=omega, capacity_bodies=8)
    bt, mt, dt = trig.make_rigid_bodies(pos, mass, rad, mol, vel=vel,
                                        omega=omega, capacity_bodies=8)
    np.testing.assert_array_equal(mj, mt)
    assert mt.dtype == np.int32 and mt.max() == 6
    np.testing.assert_allclose(dt, dj, rtol=0, atol=1e-12 * np.abs(dj).max())
    worst = assert_tree_close(bridge.tree_to_numpy(bj),
                              bridge.tree_to_numpy(bt), TOL["f64"])
    assert worst <= TOL["f64"]
    assert bt.valid.dtype == torch.bool and int(bt.valid.sum()) == 6
    # the same through make_particles, which pads mol and displace
    sj = jmake(pos, rad, 2650.0, vel=vel, omega=omega, mol=mol,
               capacity=n + 3, n_walls=0)
    st = tmake(pos, rad, 2650.0, vel=vel, omega=omega, mol=mol,
               capacity=n + 3, n_walls=0, device="cpu")
    assert st.mol.dtype == torch.int32
    assert_tree_close(bridge.tree_to_numpy(sj), bridge.tree_to_numpy(st),
                      TOL["f64"])


def _cfgs(backend, r, dt, kn, gamman, walls=False, gravity=(0.0, 0.0, 0.0),
          periodic=(False, False, False)):
    out = []
    for m in (jcfg, tcfg):
        pair = m.PairParams(style="hertz_history", kn=kn, gamman=gamman,
                            xmu=0.3)
        w = (m.WallSpec(style="yplane", lo=0.0, hi=None, params=pair),) \
            if walls else ()
        out.append(m.DEMConfig(
            dt=dt, pair=pair, walls=w, gravity=gravity, backend=backend,
            nbr_k=8, max_per_bin=8, cutoff=3 * r, skin=r, periodic=periodic,
            domain_lo=(-0.06, -0.06, -0.06), domain_hi=(0.06, 0.06, 0.06)))
    return out


def _dimers_in_contact():
    """test_rigid.py's two dimers on an offset lane, moved together until
    the leading spheres overlap by 2% of r."""
    r, v0 = 0.005, 0.2
    gap = np.sqrt((2 * r * 0.99) ** 2 - 0.004 ** 2)
    pos = [[-2 * r, 0.0, 0.0], [0.0, 0.0, 0.0],
           [gap, 0.004, 0.0], [gap + 2 * r, 0.004, 0.0]]
    vel = [[v0, 0.0, 0.0]] * 2 + [[-v0, 0.0, 0.0]] * 2
    return r, pos, vel, [1, 1, 2, 2]


@pytest.mark.parametrize("backend", ["dense", "binned"])
def test_dimer_collision(backend):
    r, pos, vel, mol = _dimers_in_contact()
    cj, ct = _cfgs(backend, r, dt=2e-7, kn=1e7, gamman=1.0)
    sj = jmake(pos=pos, vel=vel, radius=r, density=2500.0, mol=mol,
               n_walls=0, capacity=6,
               neighbor_k=8 if backend == "binned" else None)
    st = particles_to_torch(sj)
    assert st.rigid is not None and st.rigid.valid.dtype == torch.bool
    sj = jint.run_dem(jint.setup_forces(sj, cj), cj, 20)
    st = tint.run_dem(tint.setup_forces(st, ct), ct, 20)
    assert float(jnp.abs(sj.rigid.angmom[:2, 2]).min()) > 0.0   # it hit
    assert_tree_close(bridge.tree_to_numpy(sj), bridge.tree_to_numpy(st),
                      TOL["f64"])
    # rigidity: member distances as they were
    d = torch.linalg.norm(st.pos[1] - st.pos[0])
    assert abs(float(d) - 2 * r) <= 1e-12 * r


@pytest.mark.parametrize("backend", ["dense", "binned"])
def test_clump_settles_onto_wall(backend):
    """test_rigid.py's tilted dimer, lowered until one member presses on
    the y wall, under gravity, in a box periodic in x."""
    r = 0.005
    cj, ct = _cfgs(backend, r, dt=2e-6, kn=1e7, gamman=0.3, walls=True,
                   gravity=(0.0, -9.81, 0.0), periodic=(True, False, False))
    pos = [[0.0595, 0.99 * r, 0.0],
           [0.0595 + 2 * r * 0.995, 0.99 * r + 0.001, 0.0]]   # spans the wrap
    sj = jmake(pos=pos, radius=r, density=2000.0, mol=[1, 1], n_walls=1,
               capacity=3, neighbor_k=8 if backend == "binned" else None)
    st = particles_to_torch(sj)
    sj = jint.run_dem(jint.setup_forces(sj, cj), cj, 20)
    st = tint.run_dem(tint.setup_forces(st, ct), ct, 20)
    assert float(jnp.abs(sj.wall_shear).max()) > 0.0
    assert_tree_close(bridge.tree_to_numpy(sj), bridge.tree_to_numpy(st),
                      TOL["f64"])
    # momentum audit: member momentum == body momentum
    p = (st.vel[:2] * st.mass[:2, None]).sum(dim=0)
    assert rel_err(st.rigid.vcm[0] * st.rigid.mass[0], p) <= 1e-12


def test_padding_bodies_and_free_spheres():
    """A padding body row (valid=False, mass=1) stays still, free spheres
    beside a clump move as free spheres, and intra-body overlap exerts no
    force."""
    r = 0.005
    cj, ct = _cfgs("binned", r, dt=1e-6, kn=1e6, gamman=0.5,
                   gravity=(0.0, -9.81, 0.0))
    pos = [[0.0, 0.0, 0.0], [1.2 * r, 0.0, 0.0],      # deep fixed overlap
           [0.02, 0.0, 0.0], [0.02, 1.9 * r, 0.0]]    # free, touching
    mol = [1, 1, 0, 0]
    vel = [[0.0] * 3] * 3 + [[0.01, 0.0, 0.02]]       # sliding contact
    sj = jmake(pos=pos, vel=vel, radius=r, density=2000.0, mol=mol,
               n_walls=0, capacity=6, neighbor_k=8)
    # pad the bodies by one row, in both packages
    bj, _, _ = jrig.make_rigid_bodies(pos, np.asarray(sj.mass[:4]), r, mol,
                                      capacity_bodies=2)
    sj = sj._replace(rigid=bj)
    st = particles_to_torch(sj)
    assert not bool(st.rigid.valid[1])
    sj = jint.run_dem(jint.setup_forces(sj, cj), cj, 20)
    st = tint.run_dem(tint.setup_forces(st, ct), ct, 20)
    assert_tree_close(bridge.tree_to_numpy(sj), bridge.tree_to_numpy(st),
                      TOL["f64"])
    pad = st.rigid
    assert torch.all(pad.xcm[1] == 0) and torch.all(pad.vcm[1] == 0)
    assert torch.all(pad.angmom[1] == 0)
    assert torch.equal(pad.quat[1], torch.tensor([1.0, 0, 0, 0],
                                                 dtype=torch.float64))
    # the clump fell as one point mass: no contact force between members
    assert rel_err(torch.tensor(-9.81 * 20 * 1e-6, dtype=torch.float64),
                   st.rigid.vcm[0, 1]) <= 1e-12
    assert float(st.vel[0, 0]) == 0.0 and float(st.vel[1, 0]) == 0.0


def test_scrub_same_mol():
    rng = np.random.RandomState(2)
    n, k = 40, 6
    mol = rng.randint(0, 5, size=n).astype(np.int32)
    idx = rng.randint(0, n + 1, size=(k, n)).astype(np.int32)   # n = empty
    ref = np.asarray(jrig.scrub_same_mol(jnp.asarray(idx), jnp.asarray(mol)))
    got = trig.scrub_same_mol(torch.as_tensor(idx), torch.as_tensor(mol))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(ref, got.numpy())
    assert (got.numpy() != idx).any()
    # a rebuild leaves no same-body partner in the table
    r, pos, vel, mols = _dimers_in_contact()
    _, ct = _cfgs("binned", r, dt=2e-7, kn=1e7, gamman=1.0)
    st = tmake(pos=pos, vel=vel, radius=r, density=2500.0, mol=mols,
               n_walls=0, neighbor_k=8, device="cpu")
    st = tint.maybe_rebuild_neighbors(st, ct, force=True)
    j = st.nbr_idx.clamp(0, 3).long()
    same = (st.mol[j] == st.mol[None, :]) & (st.nbr_idx < 4)
    assert not bool(same.any()) and bool((st.nbr_idx < 4).any())
