"""The split step (sedifoam_tpu_torch/parallel/) on the cloud's and the
fluid's options: injection and deletion, a region patch on a fluid split
along grid-x and the DNS forcing on one, in f64 on the CPU with gloo
ranks spawned from the test (parallel/launch.run_ranks; one spawn per
rank count runs every case of this file, parallel/step.run_jobs).

The cases, each __graft_entry__._tiny_case's bed (tests/test_parallel.py)
on 16 x 8 x 8 cells with the option of the JAX package's own test of it:

- inject: tests/test_window.py's injection column on this bed: 192
  particles in a table of 256, an add of 32 sites due in step 1 (the
  countdown set to 0: a set-up edit) over a box that spans the slabs,
  and the delete box at the top holding 4 active particles, so that both
  branches fire;
- region: jetFlow's inlet, tests/test_region_bc.py's disc inlet in the
  lower y face (a fixedValue disc in a no-slip face), the disc across the
  seams of the slabs;
- dns: tests/test_ibm_dns.py's cyclic box with its forcing (the shell
  widened to this box's wavenumbers), the bed's spheres in its lower
  half under cyclic x and z;
- combined: the bed with the add, the delete box, the disc inlet and the
  walls sheared along x.

For each: at 2 and 4 ranks the split step equals the port's one-process
step (solver.CoupledStep, one thread) bit for bit in every field through
2 steps, the fluid split along grid-x; the ranks' copies of the
countdown, the key and every array held whole stay equal
(parallel/step.check_replicas, run by the rank job). The port's
one-process step equals the JAX package's jitted coupled_step, on one
device and placed by its shard_state(..., make_mesh(8)), on the combined
case, and on one device on the DNS box, within p, vel rtol 1e-10 / atol
1e-12 and the integer fields exactly (the DNS forcing's normal draws
agree to round-off, dem/inject.normal). The combined case shears its
walls instead of wiggling one: the JAX package cannot step a wiggled
wall (torch_port_split.jax_step). And the disc's mask on each slab is
the whole grid's mask cut to the slab, memoized on the slab's grid.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu import bc as jbc  # noqa: E402
from sedifoam_tpu.dem.state import make_particles  # noqa: E402
from sedifoam_tpu.fluid.state import FluidBCs  # noqa: E402
from sedifoam_tpu_torch import bc as tbc  # noqa: E402
from sedifoam_tpu_torch import ops as tops  # noqa: E402
from sedifoam_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from sedifoam_tpu_torch.parallel.step import run_jobs  # noqa: E402
from torch_port_split import RANKS, STEPS, TIMEOUT  # noqa: E402
from torch_port_split import close_to_jax, differ, jax_step  # noqa: E402
from torch_port_split import one_process, setup, tiny, to_port  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401

R = 2.5e-4
NX, NY, NZ, D = 16, 8, 8, 1e-3
L = (NX * D, NY * D, NZ * D)
CASES = ["inject", "region", "dns", "combined"]
DISC = dict(axis=1, c0=0.5 * L[0], c1=0.5 * L[2], radius=3.2e-3)


def _bed(cfg, n_active, capacity, extra=()):
    """The tiny case's bed of n_active particles (its seed and box) and
    the rows `extra`, in a table of `capacity`."""
    rng = np.random.RandomState(0)
    pos = rng.uniform([1e-3, 1e-3, 1e-3],
                      [L[0] - 1e-3, 0.5 * L[1], L[2] - 1e-3],
                      size=(n_active, 3))
    pos = np.concatenate([pos, np.reshape(extra, (-1, 3))])
    return make_particles(pos, R, 2500.0, capacity=capacity,
                          n_walls=len(cfg.dem.walls),
                          neighbor_k=cfg.dem.nbr_k, dtype=jnp.float64)


def _inject(cfg):
    """The injection column's add and delete over this box."""
    dt = cfg.fluid.dt
    return dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, add_particle=1, add_interval=2 * dt,
        add_box=(0.25 * L[0], 0.75 * L[0], 0.6 * L[1], 0.7 * L[1],
                 0.25 * L[2], 0.75 * L[2]),
        add_info=(2 * R, 2500.0, 1), add_velocity=(0.0, -0.05, 0.0),
        random_perturb=2e-4, delete_particle=1,
        delete_box=(0.0, L[0], 0.9 * L[1], L[1], 0.0, L[2])))


def _disc(cfg):
    """Ub's lower y face: the disc inlet in a no-slip face."""
    b = cfg.bcs
    inlet = b.Ub.ym
    wall = jbc.PatchBC(jbc.FIXED_VALUE, (0.0, 0.0, 0.0))
    ym = jbc.RegionPatchBC(inlet, wall, jbc.DiscRegion(**DISC))
    return dataclasses.replace(cfg, bcs=b._replace(
        Ub=dataclasses.replace(b.Ub, ym=ym)))


def _box(cfg):
    """tests/test_ibm_dns.py's cyclic box and forcing on this grid, the
    bed's DEM cyclic in x and z between the y walls."""
    cyc = jbc.PatchBC(jbc.CYCLIC)
    cyc3 = jbc.PatchBC(jbc.CYCLIC, (0.0, 0.0, 0.0))
    bcs = FluidBCs(alpha=jbc.FieldBC(*(cyc for _ in range(6))),
                   p=jbc.FieldBC(*(cyc for _ in range(6))),
                   Ub=jbc.FieldBC(*(cyc3 for _ in range(6))),
                   Ua=jbc.FieldBC(*(cyc3 for _ in range(6))))
    fluid = dataclasses.replace(
        cfg.fluid, gravity=(0.0, 0.0, 0.0), add_dns_force=True,
        dns_alpha=1.0, dns_sigma=0.5, dns_k_upper=1500.0, dns_k_lower=0.0)
    dem = dataclasses.replace(cfg.dem, walls=cfg.dem.walls[1:2],
                              periodic=(True, False, True))
    return dataclasses.replace(cfg, bcs=bcs, fluid=fluid, dem=dem)


def build(name):
    """(cfg, fluid, particles) of the JAX package's case `name` (the
    module docstring) before its set-up, f64."""
    cfg, fluid, parts = tiny(nx=NX, ny=NY, nz=NZ, n_particles=256,
                             sub_steps=2, backend="binned")
    if name == "region":
        return _disc(cfg), fluid, parts
    if name == "dns":
        cfg = _box(cfg)
        return cfg, fluid._replace(Ub=fluid.Ub * 0.0), _bed(cfg, 256, 256)
    top = [(x * L[0], 0.95 * L[1], 0.5 * L[2]) for x in (0.2, 0.4, 0.6, 0.8)]
    cfg = _inject(cfg)
    if name == "combined":
        cfg = _disc(cfg)
        w = cfg.dem.walls
        cfg = dataclasses.replace(cfg, dem=dataclasses.replace(
            cfg.dem, walls=w[:2] + (dataclasses.replace(
                w[2], vshear=0.05, shear_axis=0),)))
    return cfg, fluid, _bed(cfg, 188, 256, top)


def _due(snp):
    """The set-up edit: the add due in the first step."""
    snp["particles"]["time_to_add"] = np.zeros_like(
        snp["particles"]["time_to_add"])
    return snp


def _set_up(name):
    cfg_j, fluid_j, parts_j = build(name)
    cfg, snp, st_j = setup(cfg_j, fluid_j, parts_j)
    if cfg_j.cloud.add_particle:
        snp = _due(snp)
        st_j = st_j._replace(particles=st_j.particles._replace(
            time_to_add=jnp.zeros_like(st_j.particles.time_to_add)))
    return cfg_j, cfg, snp, st_j


@pytest.fixture(scope="module")
def cases():
    """{name: (port cfg, the state set up, as numpy, the port's
    one-process states after each of STEPS steps)}."""
    out = {}
    for name in CASES:
        _, cfg, snp, _ = _set_up(name)
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
    snp, refs = cases[name][1:]
    for i, ref in enumerate(refs, 1):
        assert differ(ref, res[0]["states"][i]) == [], (name, i)
    assert all(r["fluid"] == "slab" for r in res)
    if name in ("inject", "combined"):
        # by tag: a sorted rebuild moves the rows
        p0, p1 = snp["particles"], refs[0]["particles"]
        live = set(p1["tag"][p1["active"]])
        assert sum(t > p0["tag"].max() for t in live) == 32   # the add
        top = p0["active"] & (p0["pos"][:, 1] > 0.9 * L[1])
        assert top.sum() == 4 and not live & set(p0["tag"][top])


@pytest.mark.parametrize("which", ["combined one device", "combined sharded",
                                   "dns one device"])
def test_one_process_matches_the_jax_package(which):
    name = "dns" if which.startswith("dns") else "combined"
    cfg_j, cfg, snp, st_j = _set_up(name)
    port = one_process(cfg, snp, 1)[0]
    ref = jax_step(cfg_j, st_j, sharded=which.endswith("sharded"))
    close_to_jax(ref, port)
    if name == "dns":
        assert np.abs(port["fluid"]["turbulence_force"]).max() > 0.0
        np.testing.assert_allclose(port["fluid"]["dns_f_hat"],
                                   ref["fluid"]["dns_f_hat"], rtol=1e-10,
                                   atol=1e-12)


@pytest.mark.parametrize("ranks", RANKS)
def test_region_mask_on_slabs_is_the_whole_mask_cut(ranks):
    """The disc's coverage mask on each slab equals the whole grid's mask
    cut to the slab's x planes, bit for bit, and is memoized on the
    slab's own grid."""
    cfg = to_port(_disc(tiny(nx=NX, ny=NY, nz=NZ, n_particles=256,
                             sub_steps=2, backend="binned")[0]))
    patch = cfg.bcs.Ub.ym
    assert isinstance(patch, tbc.RegionPatchBC)
    like = torch.zeros((), dtype=torch.float64)
    whole = tops._region_mask(patch, cfg.grid, like)
    assert 0.0 < float(whole.sum()) < whole.numel()
    n = NX // ranks
    parts = []
    for r in range(ranks):
        slab = cfg.grid.slab(r * n, n, None)
        got = tops._region_mask(patch, slab, like)
        assert got.shape == (1, n, NZ)
        assert tops._region_mask(patch, slab, like) is got
        parts.append(got)
    assert torch.equal(torch.cat(parts, dim=1), whole)
