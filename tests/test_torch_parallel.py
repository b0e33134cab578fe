"""The coupled step split over ranks (sedifoam_tpu_torch/parallel/)
against sedifoam_tpu's sharded tests (tests/test_parallel.py), in f64 on
the CPU, with gloo ranks spawned from the test (parallel/launch.py).

The same __graft_entry__._tiny_case set-ups as tests/test_parallel.py,
initialized by the JAX package and carried across by bridge.py, each
split over 2 and 4 ranks (cases of one parametrised test):

- dense, one step: gathered p and vel within rtol 1e-10, atol 1e-12,
  alpha within rtol 1e-10, atol 1e-14, of the JAX package's one-device
  step (measured at 2 and 4 ranks alike: p 3.0e-15, vel 5.2e-15, alpha
  2.3e-16 of each field's scale; the split run equals the port's
  one-rank run bit for bit through 3 steps on this bed);
- binned (sorted at every rebuild): p and vel as above, pos within rtol
  1e-12, atol 1e-14, nbr_idx exactly (measured: p 2.2e-15, vel 5.0e-16,
  pos 2.9e-17 of scale);
- the per-rank bytes of nbr_idx, shear, wall_shear and pos are the
  whole's over the ranks;
- five dense steps stay finite.

Added here: one rank equals solver.CoupledStep bit for bit (both
backends); the plain contact chain on halves of the rows
(contact_chain_reference(rows=...)) equals the columns of the whole
call bit for bit; `placement` classifies every tensor of the tiny binned
state as the JAX package's shard_state(..., make_mesh(8)) does, but for
the grid fields the port keeps whole (listed below: none); the binned case on
2 ranks equals the port's one-rank step through three steps whose
rebuilds move particles between the ranks (measured: 2 particles
changed ranks; p within 4.3e-16, vel 1.1e-16 of scale, pos 0 apart; the
particles bit for bit after step 1). ShardedStep steps every
configuration CoupledStep steps: tests/test_torch_parallel_dem.py and
tests/test_torch_parallel_cases.py hold it on each option.
"""

import importlib

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch.distributed as dist  # noqa: E402

from sedifoam_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from sedifoam_tpu.parallel.mesh import shard_state as jshard  # noqa: E402
from sedifoam_tpu.solver import coupled_step as jcoupled  # noqa: E402
from sedifoam_tpu_torch import bridge  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.dem import fused as tfused  # noqa: E402
from sedifoam_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from sedifoam_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from sedifoam_tpu_torch.parallel.step import ShardedStep  # noqa: E402
from sedifoam_tpu_torch.parallel.step import TABLES, run_steps  # noqa: E402
from torch_port_cases import port_config  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401

ge = importlib.import_module("__graft_entry__")

RANKS = [2, 4]
TIMEOUT = 240.0            # seconds a spawn of ranks may take
# the tiny binned state's grid tensors that the JAX package splits along
# grid-x and the port keeps whole on every rank: none since the port
# splits the fluid along grid-x as the JAX package does (the fields on x
# faces, nx + 1 planes, stay whole in both)
GRID_KEPT_WHOLE = set()


def _case(kind):
    if kind == "dense":
        return ge._tiny_case(nx=8, ny=8, nz=4, n_particles=16, sub_steps=2,
                             dtype=jnp.float64)
    return ge._tiny_case(nx=16, ny=8, nz=8, n_particles=256, sub_steps=2,
                         backend="binned", dtype=jnp.float64)


@pytest.fixture(scope="module")
def cases():
    """{kind: (cfg_j, state_j, port cfg, state as numpy, JAX step 1)}."""
    out = {}
    for kind in ("dense", "binned"):
        cfg_j, st_j = _case(kind)
        ref = jax.jit(lambda s, c=cfg_j: jcoupled(s, c))(st_j)
        out[kind] = (cfg_j, st_j, port_config(cfg_j),
                     bridge.sim_state_to_numpy(st_j),
                     bridge.sim_state_to_numpy(ref))
    return out


@pytest.fixture(scope="module")
def runs(cases):
    """run(kind, ranks): the ranks' results of run_steps(...) on the
    case, 5 steps (dense) or 3 (binned), spawned once per (kind, ranks)."""
    done = {}

    def run(kind, ranks):
        if (kind, ranks) not in done:
            _, _, cfg, snp, _ = cases[kind]
            done[kind, ranks] = run_ranks(
                run_steps, ranks, args=(cfg, snp, 5 if kind == "dense" else 3),
                device="cpu", timeout=TIMEOUT)
        return done[kind, ranks]
    return run


def _close(got, ref, rtol, atol, what):
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol, err_msg=what)


@pytest.mark.parametrize("ranks", RANKS)
def test_sharded_step_matches_single_device(cases, runs, ranks):
    ref = cases["dense"][4]
    out = runs("dense", ranks)[0]["states"][1]
    _close(out["fluid"]["p"], ref["fluid"]["p"], 1e-10, 1e-12, "p")
    _close(out["particles"]["vel"], ref["particles"]["vel"], 1e-10, 1e-12,
           "vel")
    _close(out["fluid"]["alpha"], ref["fluid"]["alpha"], 1e-10, 1e-14,
           "alpha")


@pytest.mark.parametrize("ranks", RANKS)
def test_sharded_binned_step_matches_single_device(cases, runs, ranks):
    ref = cases["binned"][4]
    out = runs("binned", ranks)[0]["states"][1]
    _close(out["fluid"]["p"], ref["fluid"]["p"], 1e-10, 1e-12, "p")
    _close(out["particles"]["pos"], ref["particles"]["pos"], 1e-12, 1e-14,
           "pos")
    _close(out["particles"]["vel"], ref["particles"]["vel"], 1e-10, 1e-12,
           "vel")
    np.testing.assert_array_equal(out["particles"]["nbr_idx"],
                                  ref["particles"]["nbr_idx"])


@pytest.mark.parametrize("ranks", RANKS)
def test_dem_tables_shard_per_rank_memory(cases, runs, ranks):
    """The (K, N) table and the (3, K, N) and (3, W, N) histories, the
    largest DEM arrays, and the rows: each rank holds its share."""
    whole = cases["binned"][3]["particles"]
    for r, res in enumerate(runs("binned", ranks)):
        for name in TABLES:
            total = whole[name].nbytes
            assert res["tables"][name] * ranks == total, (r, name)


@pytest.mark.parametrize("ranks", RANKS)
def test_sharded_multi_step_stays_finite(runs, ranks):
    out = runs("dense", ranks)[0]["states"][5]
    assert np.isfinite(out["fluid"]["p"]).all()
    assert np.isfinite(out["particles"]["vel"]).all()


@pytest.mark.parametrize("ranks", [2])
def test_sorted_rebuilds_move_particles_between_ranks(cases, runs, ranks):
    """The binned case rebuilds (sorted by bin) in steps 2 and 3; the
    split run equals the one-rank run through them, and particles
    change ranks on the way: the re-bucketing at the rebuild loses
    none."""
    _, _, cfg, snp, _ = cases["binned"]
    assert cfg.dem.sort_on_rebuild
    res = runs("binned", ranks)
    step = tsolver.CoupledStep(cfg, device="cpu")
    st = bridge.sim_state_from_numpy(snp, device="cpu")
    for i in (1, 2, 3):
        st = step(st)
        ref = bridge.sim_state_to_numpy(st)
        out = res[0]["states"][i]
        _close(out["fluid"]["p"], ref["fluid"]["p"], 1e-10, 1e-12, "p")
        _close(out["particles"]["pos"], ref["particles"]["pos"], 1e-12,
               1e-14, "pos")
        _close(out["particles"]["vel"], ref["particles"]["vel"], 1e-10,
               1e-12, "vel")
        np.testing.assert_array_equal(out["particles"]["nbr_idx"],
                                      ref["particles"]["nbr_idx"])
        np.testing.assert_array_equal(out["particles"]["tag"],
                                      ref["particles"]["tag"])
        if i == 1:      # nothing read a summed field yet
            for k in ("pos", "vel", "omega", "shear", "wall_shear"):
                np.testing.assert_array_equal(out["particles"][k],
                                              ref["particles"][k], k)
    moved = sum(len(set(r["tags_before"]) - set(r["tags_after"]))
                for r in res)
    assert moved > 0
    tags = np.concatenate([r["tags_after"] for r in res])
    assert sorted(tags) == sorted(snp["particles"]["tag"])


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, and its mesh."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        yield tmesh.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("kind", ["dense", "binned"])
def test_one_rank_equals_coupled_step_bitwise(cases, one_rank, kind):
    _, _, cfg, snp, _ = cases[kind]
    st = bridge.sim_state_from_numpy(snp, device="cpu")
    ref = tsolver.CoupledStep(cfg, device="cpu")(st)
    step = ShardedStep(cfg, one_rank)
    local = tmesh.shard_state(st, one_rank)
    got = tmesh.gather_state(step(local), one_rank, step.comm)
    a, b = bridge.sim_state_to_numpy(ref), bridge.sim_state_to_numpy(got)
    for part in ("fluid", "particles"):
        for k, v in a[part].items():
            if isinstance(v, dict):
                for c in v:
                    np.testing.assert_array_equal(b[part][k][c], v[c])
            elif v is not None:
                np.testing.assert_array_equal(b[part][k], v, k)


@pytest.mark.parametrize("shearupdate", [True, False])
@pytest.mark.parametrize("parts", [2, 4])
def test_contact_chain_rows_equal_columns_of_whole_call(cases, parts,
                                                        shearupdate):
    """contact_chain_reference on each block of rows, against partners
    in all rows, equals the block's columns of the call on all rows bit
    for bit, walls fused in; contact_chain (the CPU's plain version)
    likewise. On the particles after one step, moved 0.8 mm toward the
    lo walls, so that the lowest rows touch them."""
    _, _, cfg, _, after = cases["binned"]
    p = bridge.particle_state_from_numpy(after["particles"], device="cpu")
    p = p._replace(pos=p.pos - 8e-4)
    d = cfg.dem
    args = (d.pair, d.dt, p.nbr_idx, shearupdate, d.periodic_len(), d.walls)
    whole = tfused.contact_chain_reference(p, *args)
    for out in whole[:4] if shearupdate else whole[:2]:
        assert bool((out != 0).any())
    n = p.n_capacity // parts
    for r in range(parts):
        cols = slice(r * n, (r + 1) * n)
        q = p._replace(shear=p.shear[..., cols].contiguous(),
                       wall_shear=p.wall_shear[..., cols].contiguous())
        idx = p.nbr_idx[:, cols].contiguous()
        tfused.check_inputs(q, idx, len(d.walls), rows=(r * n, n))
        for fn in (tfused.contact_chain_reference, tfused.contact_chain):
            got = fn(q, d.pair, d.dt, idx, shearupdate, d.periodic_len(),
                     d.walls, rows=(r * n, n))
            for a, b in zip(whole[:2], got[:2]):
                assert torch.equal(a[cols], b)
            for a, b in zip(whole[2:], got[2:]):
                assert torch.equal(a[..., cols], b)
    with pytest.raises(ValueError, match="outside"):
        tfused.check_inputs(q, idx, len(d.walls), rows=(p.n_capacity, n))


def test_placement_matches_jax_shard_state(cases):
    _, st_j, _, snp, _ = cases["binned"]
    sharded = jshard(st_j, jmake_mesh(8))
    kept_whole = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(sharded)[0]:
        name = jax.tree_util.keystr(path).lstrip(".")
        spec = tuple(leaf.sharding.spec)
        want = ("split", spec.index("d")) if "d" in spec \
            else tmesh.REPLICATE
        x = snp
        for k in name.split("."):
            x = x[k]
        got = tmesh.placement(x, 256, 8)
        if got != want:
            assert got == tmesh.REPLICATE and want[1] == x.ndim - 3, name
            kept_whole.add(name)
    assert kept_whole == GRID_KEPT_WHOLE


def test_placement_and_mesh_raise():
    """A capacity that does not divide by the ranks raises (the JAX
    package replicates it quietly), as does a mesh without a process
    group or of another size."""
    with pytest.raises(ValueError, match="does not divide"):
        tmesh.placement(np.zeros((256, 3)), 256, 3)
    assert tmesh.placement(np.zeros((3, 16, 16)), 16, 2) == ("split", 1)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh(device="cpu")
