"""The split step (sedifoam_tpu_torch/parallel/) on the DEM's options:
cohesion, lubrication, walls the contact kernel cannot fuse, rigid
clumps and the lattice backend, in f64 on the CPU with gloo ranks
spawned from the test (parallel/launch.run_ranks; one spawn per rank
count runs every case of this file, parallel/step.run_jobs).

Each case is __graft_entry__._tiny_case's configuration (the set-up of
tests/test_parallel.py, 16 x 8 x 8 cells, 256 particles, sorted at each
rebuild), set up by the port (torch_port_split.setup), with the option
of the JAX package's own test of it:

- cohesion: the binned table, the retarded law (model 0) of
  tests/test_binned_extras.py, smax within the binner's cutoff;
- lubrication: the binned table, log terms, the FLD drag with its
  volume fraction over the wall-bounded volume (tests/
  test_lubrication_walls.py);
- walls: the lower y wall wiggled along y, the z walls sheared along x
  and a z-cylinder that the outermost particles touch;
- clumps: 128 rigid dimers on the binned table (tests/test_rigid.py);
- dense: 8 rigid dimers on the dense backend (8 x 8 x 4 cells) with the
  unretarded cohesion (model 1) and lubrication: the dense forms of
  both;
- lattice: the lattice backend of tests/test_lattice.py's coupled step
  (8 x 8 x 8 cells, 64 particles), whole on every rank.

For each: at 2 and 4 ranks the split step equals the port's
one-process step (solver.CoupledStep, one thread) bit for bit in every
field through 2 steps, with the fluid split along grid-x; the ranks'
copies of the bodies and the lattice tables stay equal
(parallel/step.check_replicas, run by the rank job). The port's
one-process step equals the JAX package's jitted coupled_step after one
step within p, vel rtol 1e-10 / atol 1e-12 (tests/test_torch_parallel.
py's), pos 1e-12 / 1e-14, the body centres 1e-12 / 1e-14, and the
integer fields exactly, on "extras" (cohesion, lubrication and the
walls together, less the wiggle: the JAX package cannot step a wiggled
wall, torch_port_split.jax_step), the clumps, the dense case and the
lattice. And `placement` classifies a rigid state as the JAX package's
shard_state(..., make_mesh(8)) does, the body arrays kept whole.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu.config import CohesionParams, WallSpec  # noqa: E402
from sedifoam_tpu.dem.lubrication import LubricationParams  # noqa: E402
from sedifoam_tpu.dem.state import make_particles  # noqa: E402
from sedifoam_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from sedifoam_tpu.parallel.mesh import shard_state as jshard  # noqa: E402
from sedifoam_tpu_torch import bridge  # noqa: E402
from sedifoam_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from sedifoam_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from sedifoam_tpu_torch.parallel.step import run_jobs  # noqa: E402
from torch_port_split import RANKS, STEPS, TIMEOUT  # noqa: E402
from torch_port_split import close_to_jax, differ, jax_step  # noqa: E402
from torch_port_split import one_process, setup, tiny  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401

R = 2.5e-4                 # the tiny case's radius
CASES = ["cohesion", "lubrication", "walls", "clumps", "dense", "lattice"]
# held against the JAX package: "extras" is cohesion, lubrication and
# the walls together, less the wiggle, which the JAX package cannot step
# (torch_port_split.jax_step)
JAX_CASES = ["extras", "clumps", "dense", "lattice"]


def _cohesion(model):
    return CohesionParams(ah=1e-15, lam=1e-7, smin=1e-7, smax=5e-4,
                          model=model)


def _lub(cfg, cut=1.4e-3):
    d = cfg.dem
    vol = float(np.prod(np.subtract(d.domain_hi, d.domain_lo)))
    return LubricationParams(mu=1e-3, flaglog=1, flagfld=1,
                             cut_inner=2.1 * R, cut=cut, flag_hi=1,
                             flag_vf=1, box_volume=vol)


def _dimers(cfg, n_bodies, lo, hi, seed, k):
    """Rigid dimers: members R apart about a random centre in [lo, hi],
    along a random direction."""
    rng = np.random.RandomState(seed)
    centre = rng.uniform(lo, hi, size=(n_bodies, 3))
    u = rng.normal(size=(n_bodies, 3))
    u *= R / np.linalg.norm(u, axis=1, keepdims=True)
    pos = np.stack([centre - u, centre + u], axis=1).reshape(-1, 3)
    return make_particles(pos, R, 2500.0,
                          mol=np.repeat(np.arange(1, n_bodies + 1), 2),
                          n_walls=len(cfg.dem.walls), neighbor_k=k,
                          dtype=jnp.float64)


def _dem(cfg, **kw):
    return dataclasses.replace(cfg, dem=dataclasses.replace(cfg.dem, **kw))


def _moving_walls(cfg, wiggle=True):
    """The lower y wall wiggled along y (when `wiggle`), the z walls
    sheared along x, and a z-cylinder about the z axis."""
    w = cfg.dem.walls
    return (w[0],
            dataclasses.replace(w[1], wiggle=True, wiggle_axis=1,
                                amplitude=1e-4, period=4e-4)
            if wiggle else w[1],
            dataclasses.replace(w[2], vshear=0.05, shear_axis=0),
            WallSpec(style="zcylinder", cylradius=0.0152, params=w[0].params))


def build(name):
    """(cfg, fluid, particles) of the JAX package's case `name` (the
    module docstring) before its set-up, f64."""
    if name == "lattice":
        return tiny(nx=8, ny=8, nz=8, n_particles=64, sub_steps=2,
                    backend="lattice")
    if name == "dense":
        cfg, fluid, _ = tiny(nx=8, ny=8, nz=4, n_particles=16, sub_steps=2)
        cfg = _dem(cfg, cohesion=_cohesion(1), lubrication=_lub(cfg))
        return cfg, fluid, _dimers(cfg, 8, (1e-3, 1e-3, 1e-3),
                                   (7e-3, 3e-3, 3e-3), 3, None)
    cfg, fluid, parts = tiny(nx=16, ny=8, nz=8, n_particles=256,
                             sub_steps=2, backend="binned")
    if name == "clumps":
        return cfg, fluid, _dimers(cfg, 128, (1e-3, 1e-3, 1e-3),
                                   (15e-3, 4e-3, 7e-3), 5, cfg.dem.nbr_k)
    kw = {}
    if name in ("cohesion", "extras"):
        kw["cohesion"] = _cohesion(0)
    if name in ("lubrication", "extras"):
        kw["lubrication"] = _lub(cfg)
    if name in ("walls", "extras"):
        kw["walls"] = _moving_walls(cfg, wiggle=name == "walls")
        parts = parts._replace(wall_shear=jnp.zeros(
            (3, len(kw["walls"]), parts.n_capacity), parts.pos.dtype))
    return _dem(cfg, **kw), fluid, parts


@pytest.fixture(scope="module")
def cases():
    """{name: (port cfg, the state set up, as numpy, the port's
    one-process states after each of STEPS steps)}."""
    out = {}
    for name in CASES:
        cfg, snp, _ = setup(*build(name))
        out[name] = (cfg, snp, one_process(cfg, snp))
    return out


@pytest.fixture(scope="module")
def runs(cases):
    """ranks -> {name: the ranks' results of run_steps on the case},
    spawned once per rank count."""
    done = {}

    def run(ranks):
        if ranks not in done:
            jobs = [(cases[n][0], cases[n][1], STEPS) for n in CASES]
            res = run_ranks(run_jobs, ranks, args=(jobs,), device="cpu",
                            timeout=TIMEOUT)
            done[ranks] = {n: [r[i] for r in res]
                           for i, n in enumerate(CASES)}
        return done[ranks]
    return run


@pytest.mark.parametrize("ranks", RANKS)
@pytest.mark.parametrize("name", CASES)
def test_split_step_equals_one_process_bitwise(cases, runs, name, ranks):
    res = runs(ranks)[name]
    refs = cases[name][2]
    for i, ref in enumerate(refs, 1):
        assert differ(ref, res[0]["states"][i]) == [], (name, i)
    assert all(r["fluid"] == "slab" for r in res)
    tags = np.concatenate([r["tags_after"] for r in res])
    assert sorted(tags) == sorted(refs[-1]["particles"]["tag"])


@pytest.mark.parametrize("name", JAX_CASES)
def test_one_process_matches_the_jax_package(name):
    cfg_j, fluid_j, parts_j = build(name)
    cfg, snp, st_j = setup(cfg_j, fluid_j, parts_j)
    port = one_process(cfg, snp, 1)[0]
    ref = jax_step(cfg_j, st_j)
    close_to_jax(ref, port)
    p = port["particles"]
    if name in ("clumps", "dense"):
        np.testing.assert_allclose(p["rigid"]["xcm"],
                                   ref["particles"]["rigid"]["xcm"],
                                   rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(p["rigid"]["angmom"],
                                   ref["particles"]["rigid"]["angmom"],
                                   rtol=1e-10, atol=1e-24)
    if name == "extras":
        assert np.abs(p["wall_shear"][:, 2:]).max() > 0.0
    if name == "lattice":
        assert p["shear"].ndim == 5


def test_placement_of_a_rigid_state_matches_jax_shard_state():
    """Every tensor of the clumps' state (128 bodies, 256 rows) places as
    the JAX package's spec_for places it over 8 devices, and the split
    step's own layout (particle_axes, grid_axis) cuts it so: the body
    arrays whole in both. The port keeps them whole by their path, so
    also where B equals the capacity, which spec_for would split."""
    cfg, snp, st = setup(*build("clumps"))
    sharded = jshard(st, jmake_mesh(8))
    ps = bridge.particle_state_from_numpy(snp["particles"], device="cpu")
    axes = tmesh.particle_axes(ps)
    n_body = 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]:
        name = jax.tree_util.keystr(path).lstrip(".")
        spec = tuple(leaf.sharding.spec)
        want = ("split", spec.index("d")) if "d" in spec \
            else tmesh.REPLICATE
        x = snp
        for k in name.split("."):
            x = x[k]
        if name.startswith("particles.rigid."):
            n_body += 1
            assert want == tmesh.REPLICATE, name
            continue
        got = tmesh.placement(x, 256, 8, cfg.grid.nx)
        assert got == want, name
        a = axes[name.split(".")[1]] if name.startswith("particles.") \
            else tmesh.grid_axis(x, cfg.grid.nx, 8)
        assert got == (("split", a) if a is not None
                       else tmesh.REPLICATE), name
    assert n_body == 7 and axes["rigid"] is None
    # a body count equal to the capacity: spec_for's rule would split a
    # body array; the port keeps the bodies whole by their path
    assert tmesh.placement(np.zeros((256, 3)), 256, 8) == ("split", 0)
