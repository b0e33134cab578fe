"""The irregular-grain slice as a whole, and a coupled step with a region
patch, against sedifoam_tpu on the CPU in f64.

- 3 coupled steps of the irregular case at a small size (20 trimer
  clumps pressed 30 um into a floor of 648 frozen 2 mm spheres, 708
  particles, a 9 x 8 x 6 y-graded mesh) written by
  cases.write_irregular_case and loaded from its directory by each
  package's load_case: binned DEM at the loader's K = 160 (its cap: the
  ring of the 2 mm floor over the 0.35 mm grains asks for more), rigid
  bodies, kEqn LES, Ubar 0.5, the semi-implicit drag,
  periodic x/z. Every field, `rigid` included, agrees to 1e-9 of its
  scale (measured: 1.6e-10 at worst, the pressure), except the
  solid-phase velocity Ua = smoothed(vol*U)/alpha and what is built from
  it, which divide by alpha at round-off level in empty cells and are
  compared as alpha*Ua. The table's slots are compared by partner: the
  floor is an exact lattice with neighbours at equal distances.
- A checkpoint of that run written by either package loads in the other,
  `rigid` included, leaf for leaf, and continues there.
- One coupled step with tests/test_region_bc.py's disc inlet in a slip
  bottom (a RegionPatchBC on Ub, a particle column over the jet) through
  solver.coupled_step in both packages: 1e-10 of each field's scale
  (measured: 2.1e-14): no difference from the reference.
"""

import dataclasses
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu import bc as jbc  # noqa: E402
from sedifoam_tpu import config as jcfg  # noqa: E402
from sedifoam_tpu import grid as jgrid  # noqa: E402
from sedifoam_tpu import solver as jsolver  # noqa: E402
from sedifoam_tpu.dem.state import make_particles as jmake  # noqa: E402
from sedifoam_tpu.fluid import state as jfstate  # noqa: E402
from sedifoam_tpu.io.case import load_case as jload  # noqa: E402
from sedifoam_tpu.runtime import checkpoint as jckpt  # noqa: E402
from sedifoam_tpu_torch import bc as tbc  # noqa: E402
from sedifoam_tpu_torch import bridge, cases  # noqa: E402
from sedifoam_tpu_torch import config as tcfg  # noqa: E402
from sedifoam_tpu_torch import grid as tgrid  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.fluid import state as tfstate  # noqa: E402
from sedifoam_tpu_torch.io.case import load_case as tload  # noqa: E402
from sedifoam_tpu_torch.runtime import checkpoint as tckpt  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import assert_tree_close, rel_err  # noqa: E402

ILL_CONDITIONED = ("Ua", "Ua_old", "phia", "phia_old", "DDtUa")
# the fluid-phase fluxes: the stream runs along x, and the z flux is five
# orders below the x flux, at the level of the pressure solve's residual.
# Their three components are compared on the flux's common scale.
FLUXES = ("phib", "phi", "phib_old")
SMALL = dict(n_clumps=20, counts=(9, 8, 6), floor_d=0.002, press=3e-5)


def _by_partner(particles):
    """A particle dict with each column's table slots ordered by partner
    index, the shear rows with them. The floor is an exact lattice: its
    spheres have neighbours at equal distances, and which of two ties
    comes first in the K-nearest order hangs on the last bit of d^2,
    which XLA and PyTorch round differently."""
    d = dict(particles)
    order = np.argsort(d["nbr_idx"], axis=0, kind="stable")
    d["nbr_idx"] = np.take_along_axis(d["nbr_idx"], order, axis=0)
    d["shear"] = np.take_along_axis(d["shear"], order[None], axis=1)
    return d


def _sim_by_partner(state):
    d = bridge.sim_state_to_numpy(state)
    d["particles"] = _by_partner(d["particles"])
    return d


def _assert_sim_close(ref, got, tol):
    """Both _sim_by_partner dicts, field by field; returns the worst."""
    worst = assert_tree_close(ref, got, tol, skip=ILL_CONDITIONED + FLUXES)
    for name in FLUXES:
        a, b = ref["fluid"][name], got["fluid"][name]
        scale = max(np.abs(a[c]).max() for c in "xyz")
        err = max(np.abs(a[c] - b[c]).max() for c in "xyz") / scale
        assert err <= tol, (name, err)
        worst = max(worst, err)
    return worst


def _semi(cfg):
    return dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=True))


@pytest.fixture(scope="module")
def irregular(tmp_path_factory):
    """The small case loaded and stepped 3 times by both packages:
    (cj, ct, JAX state, port state, port state after step 1)."""
    case = cases.write_irregular_case(
        str(tmp_path_factory.mktemp("irregular")), **SMALL)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # the K = 160 cap's warning
        cj, fj, pj, _ = jload(case, backend="binned", dtype=jnp.float64)
        ct, ft, pt, _ = tload(case, backend="binned", device="cpu")
    cj, ct = _semi(cj), _semi(ct)
    sj = jsolver.initialize(fj, pj, cj)
    step_j = jax.jit(lambda s: jsolver.coupled_step(s, cj))
    step_t = tsolver.CoupledStep(ct, device="cpu")
    st = step_t.initialize(ft, pt)
    first = None
    for n in range(3):
        sj, st = step_j(sj), step_t(st)
        if n == 0:
            first = (_by_partner(bridge.tree_to_numpy(sj.particles)),
                     _by_partner(bridge.tree_to_numpy(st.particles)))
    return cj, ct, sj, st, first, step_j, step_t, pt


def test_irregular_loads_alike(irregular):
    cj, ct, _, st, _, _, _, pt = irregular
    assert ct.dem.nbr_k == cj.dem.nbr_k == 160
    assert ct.dem.frozen_types == (2,) and ct.dem.periodic == cj.dem.periodic
    assert pt.rigid is not None and int(pt.rigid.valid.sum()) == 20
    assert int(pt.mol.max()) == 20 and int((pt.mol > 0).sum()) == 60
    assert int(pt.active.sum()) == 708
    assert ct.fluid.forcing.mag_ubar == 0.5
    assert ct.fluid.max_possible_alpha == 0.8
    assert ct.cloud.sub_steps == 50


def test_irregular_three_steps_match_reference(irregular):
    _, ct, sj, st, first, _, _, pt = irregular
    # step 1: the pressed members have bounced off the floor (a contact
    # lasts 19 of the step's 50 substeps), the others fall
    ref1, got1 = first
    assert np.any(ref1["vel"][ref1["mol"] > 0, 1] > 0.0)
    assert np.any(ref1["rigid"]["angmom"] != 0.0)
    assert_tree_close(ref1, got1, 1e-9)
    ref, got = _sim_by_partner(sj), _sim_by_partner(st)
    assert _assert_sim_close(ref, got, 1e-9) <= 1e-9
    assert ref["particles"]["rigid"] is not None
    assert rel_err(np.asarray(sj.fluid.alpha)[None] * np.asarray(sj.fluid.Ua),
                   st.fluid.Uc) <= 1e-9
    assert int(ref["particles"]["nbr_dropped"]) == 0
    # the validator's gates: members rigid, the floor exactly still
    ps = st.particles

    def gaps(p):
        members = p.pos[p.mol > 0].reshape(-1, 3, 3)
        return torch.linalg.norm(members[:, 1:] - members[:, :-1], dim=-1)

    assert float(torch.abs(gaps(ps) - gaps(pt)).max()) < 1e-12
    # (the data file rounds positions to 1e-8 m)
    assert float(torch.abs(gaps(pt) - cases.IRREGULAR_D).max()) < 2e-8
    floor = ps.ptype == 2
    assert torch.equal(ps.pos[floor], pt.pos[floor])
    assert bool(torch.any(ps.vel[ps.mol > 0] != 0))
    # no same-body partner in the table
    n = ps.n_capacity
    j = ps.nbr_idx.clamp(0, n - 1).long()
    same = (ps.mol[j] == ps.mol[None, :]) & (ps.mol[None, :] > 0) \
        & (ps.nbr_idx < n)
    assert not bool(same.any())


def test_checkpoint_leaf_order_with_rigid(irregular):
    """mol, displace, then RigidBodies' seven fields (valid as bool), in
    jax.tree.flatten's order."""
    _, _, sj, st, *_ = irregular
    leaves = jax.tree.leaves(sj)
    flat = tckpt._flatten(st)
    assert [tuple(x.shape) for x in leaves] == \
        [tuple(t.shape) for _, t in flat]
    names = [n for n, _ in flat]
    i = names.index("mol")
    assert names[i:i + 9] == ["mol", "displace", "xcm", "vcm", "angmom",
                              "quat", "inertia", "mass", "valid"]
    assert flat[i + 8][1].dtype == torch.bool
    assert np.asarray(leaves[names.index("valid")]).dtype == np.bool_


def test_checkpoint_crosses_packages_with_rigid(irregular, tmp_path):
    _, _, sj, st, _, step_j, step_t, _ = irregular
    # reference -> port
    pj = str(tmp_path / "j.npz")
    jckpt.save(pj, sj)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, sj)
    template = bridge.sim_state_from_numpy(bridge.sim_state_to_numpy(zeros))
    loaded = tckpt.load(pj, template)
    assert loaded.particles.rigid.valid.dtype == torch.bool
    assert_tree_close(bridge.sim_state_to_numpy(sj),
                      bridge.sim_state_to_numpy(loaded), 0.0)
    # port -> reference, and on from there
    pt = str(tmp_path / "t.npz")
    tckpt.save(pt, st)
    back = jckpt.load(pt, zeros)
    assert back.particles.rigid.valid.dtype == jnp.bool_
    assert_tree_close(bridge.sim_state_to_numpy(st),
                      bridge.sim_state_to_numpy(back), 0.0)
    ref, got = _sim_by_partner(step_j(back)), _sim_by_partner(step_t(loaded))
    _assert_sim_close(ref, got, 1e-9)


def _jet(m, gridm, fstate, make):
    """tests/test_region_bc.py's disc inlet in a slip bottom, with a
    particle column over the jet."""
    n = 8
    grid = gridm.Grid(nx=n, ny=12, nz=n, dx=1.0 / n, dy=1.5 / 12, dz=1.0 / n)
    vin = 0.3
    region = m[0].DiscRegion(axis=1, c0=0.5, c1=0.5, radius=0.27)
    inlet = m[0].PatchBC(m[0].FIXED_VALUE, (0.0, vin, 0.0))
    slip3 = m[0].PatchBC(m[0].SLIP, (0.0, 0.0, 0.0))
    mixed = m[0].RegionPatchBC(inlet, slip3, region)
    outlet_u = m[0].PatchBC(m[0].INLET_OUTLET, (0.0, 0.0, 0.0))
    bcs = fstate.FluidBCs(
        alpha=m[0].make_field_bc({}),
        p=m[0].make_field_bc(
            {"yp": m[0].PatchBC(m[0].FIXED_VALUE, (0.0,))}),
        Ub=m[0].make_field_bc({"ym": mixed, "yp": outlet_u}, default=slip3),
        Ua=m[0].make_field_bc({}, default=slip3))
    c = m[1]
    fluid = c.FluidConfig(dt=5e-3, rhob=1000.0, nub=1e-4,
                          gravity=(0.0, -9.81, 0.0),
                          piso=c.PISOConfig(n_correctors=2, p_tol=1e-12))
    pair = c.PairParams(style="hertz_history", kn=1e5, gamman=0.7, xmu=0.3)
    walls = (c.WallSpec(style="yplane", lo=0.0, hi=1.5, params=pair),)
    r = 0.02
    dem = c.DEMConfig(dt=5e-3 / 20, pair=pair, walls=walls,
                      gravity=(0.0, -9.81, 0.0), backend="binned", nbr_k=8,
                      max_per_bin=8, cutoff=3.2 * r, skin=0.6 * r,
                      domain_lo=(0.0, 0.0, 0.0), domain_hi=(1.0, 1.5, 1.0))
    cloud = c.CloudConfig(drag_model="ErgunWenYu", sub_cycles=1,
                          sub_steps=20, diffusion_band_width=0.25,
                          diffusion_steps=3)
    rng = np.random.RandomState(6)
    pos = np.stack([rng.uniform(0.3, 0.7, 60), rng.uniform(0.03, 0.6, 60),
                    rng.uniform(0.3, 0.7, 60)], axis=1)
    return grid, bcs, fluid, cloud, dem, dict(
        pos=pos, radius=r, density=2500.0, n_walls=1, neighbor_k=8)


def test_coupled_step_with_region_patch():
    gj, bj, fj, cj, dj, pj = _jet((jbc, jcfg), jgrid, jfstate, jmake)
    gt, bt, ft, ct, dt, _ = _jet((tbc, tcfg), tgrid, tfstate, None)
    cfg_j = jsolver.SimConfig(grid=gj, bcs=bj, fluid=fj, cloud=cj, dem=dj)
    cfg_t = tsolver.SimConfig(grid=gt, bcs=bt, fluid=ft, cloud=ct, dem=dt)
    assert isinstance(cfg_t.bcs.Ub.ym, tbc.RegionPatchBC)
    sj = jsolver.initialize(jfstate.init_fluid(gj), jmake(**pj), cfg_j)
    st = bridge.sim_state_from_numpy(bridge.sim_state_to_numpy(sj))
    sj = jsolver.coupled_step(sj, cfg_j)
    st = tsolver.CoupledStep(cfg_t, device="cpu")(st)
    ref, got = bridge.sim_state_to_numpy(sj), bridge.sim_state_to_numpy(st)
    worst = assert_tree_close(ref, got, 1e-10, skip=ILL_CONDITIONED)
    assert worst <= 1e-10
    assert rel_err(np.asarray(sj.fluid.alpha)[None] * np.asarray(sj.fluid.Ua),
                   st.fluid.Uc) <= 1e-10
    # the disc's flux enters through the mixed face
    m = np.asarray(bj.Ub.ym.region.mask(gj))[0]
    q = 0.3 * m.sum() * gj.dx * gj.dz
    assert abs(float(st.fluid.phib.y[:, 0].sum()) - q) <= 1e-10 * q
    assert float(torch.abs(st.fluid.Asrc).max()) > 0.0
