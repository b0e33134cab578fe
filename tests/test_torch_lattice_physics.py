"""The reference's own lattice physics (tests/test_lattice.py's set-ups
and tolerances) on sedifoam_tpu_torch alone, in f64 on the CPU: the
lattice backend against the port's dense backend (forces at three
periodicities, two trajectories, the carry across a forced rebuild,
150 substeps with natural rebuilds, freeze and walls, the coupled step)
and tests/test_ghost_partner.py's deactivated partner; and the lattice
through the port's entry points: the small bench state of
--backend=lattice against bench.build_case (f32, 1e-5 of each field's
scale), the bench and run_case modules as subprocesses.

The JAX package enters only as the source of the tiny case's config
(__graft_entry__._tiny_case, rebuilt from the port's classes) and as
bench.py's state. tests/test_torch_lattice.py holds the lattice's
functions against the JAX package.
"""

import dataclasses
import functools
import importlib
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench as jbench  # noqa: E402
from sedifoam_tpu_torch import bench_case, bridge, cases  # noqa: E402
from sedifoam_tpu_torch import config as tcfg  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.dem import integrate as tint  # noqa: E402
from sedifoam_tpu_torch.dem import lattice as tlat  # noqa: E402
from sedifoam_tpu_torch.dem.state import make_particles as tmake  # noqa: E402
from tagsort import by_tag  # noqa: E402
from test_torch_lattice import (L, PERIODICITIES, R, _cfgs,  # noqa: E402
                                _eq, _packing, _tiny_port, _tparts)
from torch_port_cases import port_config  # noqa: E402
from torch_port_util import assert_tree_close, few_threads  # noqa: E402,F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=None)
def _tiny_cfg():
    """The reference tiny case's SimConfig (lattice, f64)."""
    ge = importlib.import_module("__graft_entry__")
    return ge._tiny_case(nx=8, ny=8, nz=8, n_particles=64, sub_steps=2,
                         backend="lattice", dtype=jnp.float64)[0]


def test_bench_small_lattice_state_matches_reference():
    """bench_case's --backend=lattice state (M = 10) against
    bench.build_case's, both initialized in f32: the slot table exactly,
    the fields within f32 round-off of their scale."""
    small = dict(n_particles=256, nx=8, ny=16, nz=8, sub_steps=10)
    cfg_j, st_j = jbench.build_case(backend="lattice", **small)
    cfg_t = bench_case.build_config(backend="lattice", **small)
    assert cfg_t == port_config(cfg_j) and cfg_t.dem.max_per_bin == 10
    fluid, parts = bench_case.build_state(cfg_t, 256, torch.float32, "cpu")
    st_t = tsolver.initialize(fluid, parts, cfg_t)
    _eq(st_t.particles.nbr_idx, st_j.particles.nbr_idx)
    assert_tree_close(bridge.sim_state_to_numpy(st_j),
                      bridge.sim_state_to_numpy(st_t), 1e-5)


def test_bench_and_run_case_modules_take_the_lattice(tmp_path):
    """`python -m sedifoam_tpu_torch.bench --small --backend=lattice
    --device cpu` prints its JSON line; run_case --backend lattice loads
    and steps xiaocase3 (20 steps, one host visit)."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="2")
    res = subprocess.run(
        [sys.executable, "-m", "sedifoam_tpu_torch.bench", "--small",
         "--backend=lattice", "--device", "cpu"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["value"] > 0 and np.isfinite(out["value"])
    # xiaocase3 at a DEM timestep of the fluid's (one substep a step):
    # run_case takes 20 steps a host visit, 20 x 100 lattice substeps
    # would take minutes on the CPU
    path = cases.write_xiaocase3(str(tmp_path / "xiaocase3"))
    script = os.path.join(path, "in.lammps")
    with open(script) as f:
        text = f.read()
    with open(script, "w") as f:
        f.write(text.replace("timestep        2e-7", "timestep        2e-5"))
    res = subprocess.run(
        [sys.executable, "-m", "sedifoam_tpu_torch.run_case", path,
         "--backend", "lattice", "--f64", "--t-end", "2e-5", "--device",
         "cpu"], capture_output=True, text=True, env=env, cwd=REPO,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    assert summary["n_particles"] == 1 and summary["steps_per_s"] > 0



# -- tests/test_lattice.py's physics on the port alone -----------------------

def _run(backend, pos, vel, rad, n1, rebuild=False, n2=0, **kw):
    cfg = _cfgs(backend, **kw)[1]
    parts = tint.setup_forces(_tparts(cfg, pos, vel, rad), cfg)
    parts = tint.run_dem(parts, cfg, n1)
    if rebuild:
        parts = tint.maybe_rebuild_neighbors(parts, cfg, force=True)
        parts = tint.run_dem(parts, cfg, n2)
    return parts


@pytest.mark.parametrize("periodic", PERIODICITIES)
def test_port_lattice_matches_dense_forces(periodic):
    pos, vel, rad = _packing(seed=1, spread=1.0 if any(periodic) else 0.9)
    out = {b: by_tag(_run(b, pos, vel, rad, 0, periodic=periodic),
                     "force", "torque") for b in ("dense", "lattice")}
    for i in range(2):
        a = out["dense"][i]
        np.testing.assert_allclose(out["lattice"][i], a,
                                   atol=1e-12 * (np.abs(a).max() + 1e-300))


@pytest.mark.parametrize("periodic", PERIODICITIES[:2])
def test_port_lattice_matches_dense_trajectory(periodic):
    """60 substeps with shear history accumulating (no rebuild)."""
    pos, vel, rad = _packing(seed=2)
    out = {b: by_tag(_run(b, pos, vel, rad, 60, periodic=periodic),
                     "pos", "vel", "omega") for b in ("dense", "lattice")}
    for a, b in zip(out["dense"], out["lattice"]):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-10 * (np.abs(a).max() + 1e-300))


def test_port_lattice_carry_across_rebuild():
    """Shear history survives a forced rebuild (slot re-assignment)."""
    pos, vel, rad = _packing(seed=3)
    out = {b: by_tag(_run(b, pos, vel, rad, 30, rebuild=True, n2=30),
                     "pos", "vel", "omega") for b in ("dense", "lattice")}
    for a, b in zip(out["dense"], out["lattice"]):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-9 * (np.abs(a).max() + 1e-300))


def test_port_lattice_natural_rebuild_long_run():
    """Long enough that the Verlet-skin criterion triggers rebuilds."""
    pos, vel, rad = _packing(seed=4)
    vel = vel * 4.0
    runs = {b: _run(b, pos, vel, rad, 150, periodic=(True, True, True))
            for b in ("dense", "lattice")}
    out = {b: by_tag(p, "pos", "vel") for b, p in runs.items()}
    for a, b in zip(out["dense"], out["lattice"]):
        np.testing.assert_allclose(b, a, rtol=0,
                                   atol=1e-8 * (np.abs(a).max() + 1e-300))


def test_port_lattice_freeze_and_walls():
    pos = np.array([[0.005, 0.0008, 0.005],   # resting on the bottom wall
                    [0.005, 0.004, 0.005]])
    out = {}
    for backend in ("dense", "lattice"):
        cfg = _cfgs(backend, frozen_types=(2,),
                    walls=lambda m: (m.WallSpec(
                        style="yplane", lo=0.0, hi=L,
                        params=m.PairParams(style="hertz_history", kn=1e5,
                                            gamman=0.7, xmu=0.5)),))[1]
        parts = tmake(pos=pos, radius=R, density=2500.0, ptype=[1, 2],
                      n_walls=1, device="cpu",
                      lattice_geom=tlat.make_geom(cfg)
                      if backend == "lattice" else None)
        parts = tint.setup_forces(parts, cfg)
        parts = tint.run_dem(parts, cfg, 80)
        out[backend] = tuple(by_tag(parts, "pos", "vel"))
    for a, b in zip(out["dense"], out["lattice"]):
        np.testing.assert_allclose(b, a, atol=1e-14)
    np.testing.assert_allclose(out["dense"][0][1], pos[1], atol=0.0)


def test_port_lattice_coupled_step():
    """The lattice backend drives the port's coupled step as the dense
    one does (three steps, 1e-12)."""
    cfg_j = _tiny_cfg()
    cfg_t, st = _tiny_port("lattice", cfg_j)
    cfg_d, st_d = _tiny_port("dense", dataclasses.replace(
        cfg_j, dem=dataclasses.replace(cfg_j.dem, backend="dense")))
    step = tsolver.make_step_fn(cfg_t, n_sub=3, device="cpu")
    step_d = tsolver.make_step_fn(cfg_d, n_sub=3, device="cpu")
    st, st_d = step(st), step_d(st_d)
    assert bool(torch.isfinite(st.fluid.p).all())
    np.testing.assert_allclose(st.fluid.alpha.numpy(),
                               st_d.fluid.alpha.numpy(), atol=1e-12)
    np.testing.assert_allclose(*(by_tag(s.particles, "pos")
                                 for s in (st, st_d)), atol=1e-12)


def test_port_deactivated_partner_lattice():
    """tests/test_ghost_partner.py's touching pair on the lattice: a
    partner deactivated without a rebuild exerts no force once the
    slot table is scrubbed."""
    d = 1e-3
    pair = tcfg.PairParams(style="hertz_history", kn=1e5, gamman=0.5,
                           xmu=0.3)
    cfg = tcfg.DEMConfig(dt=1e-6, pair=pair, walls=(),
                         gravity=(0.0, 0.0, 0.0), backend="lattice",
                         nbr_k=16, max_per_bin=8, cutoff=2.5 * d,
                         skin=0.5 * d, domain_lo=(0.0, 0.0, 0.0),
                         domain_hi=(16 * d, 16 * d, 16 * d))
    pos = np.array([[8e-3, 8e-3, 8e-3], [8e-3 + 0.9 * d, 8e-3, 8e-3],
                    [2e-3, 2e-3, 2e-3]])
    st = tmake(pos=pos, radius=0.5 * d, density=2500.0, capacity=4,
               n_walls=0, lattice_geom=tlat.make_geom(cfg), device="cpu")
    st = tint.setup_forces(st, cfg)
    assert float(st.force[0].abs().max()) > 0.0
    act = st.active.clone()
    act[1] = False
    st2 = tint.scrub_deactivated(st._replace(active=act), cfg)
    st2 = tint.compute_forces(st2, cfg, shearupdate=True)
    assert float(st2.force[0].abs().max()) == 0.0
    assert float(st2.force[1].abs().max()) == 0.0
