"""The reference's tests that read its own case directories, on the port
alone (the counterparts of tests/test_case_io.py,
test_golden_collide.py, test_dev_cases.py, test_wachem_explicit.py and
test_bedload_case.py), on the CPU. Imports nothing of JAX.

The cases are read from the reference's case tree named by
$SEDIFOAM_CASES_DIR (sedifoam_tpu_torch.validate.CASES_DIR): run them
with it set to the reference's `cases` directory. Each test carries its
original's skip where the tree is not given, and its `slow` mark; the
transport-bedload load, which its original runs unguarded, skips here
too where the case is absent.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sedifoam_tpu_torch import bc  # noqa: E402
from sedifoam_tpu_torch.io.case import load_case, read_block_mesh  # noqa: E402
from sedifoam_tpu_torch.solver import (coupled_step, initialize,  # noqa: E402
                                       make_step_fn)
from sedifoam_tpu_torch.validate import (CASES_DIR, EXAMPLE_CASES,  # noqa: E402
                                         TEST_CASES, collide)
from torch_port_util import few_threads  # noqa: E402,F401

TREE = CASES_DIR or ""
REF = os.path.join(TREE, TEST_CASES)
DEV = os.path.join(TREE, "development-testing")
EXAMPLES = os.path.join(TREE, EXAMPLE_CASES)
WACHEM = os.path.join(REF, "expWachem_PCM")
BEDLOAD = os.path.join(EXAMPLES, "transport-bedload")
CPU = "cpu"


def given(path):
    """A directory of the case tree, where $SEDIFOAM_CASES_DIR names one."""
    return bool(CASES_DIR) and os.path.isdir(path)


mounted = pytest.mark.skipif(not given(REF),
                             reason="reference cases not mounted")


def _semi(cfg, on=True):
    return dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=on))


# -- tests/test_case_io.py ----------------------------------------------------

@mounted
def test_blockmesh_xiaocase3():
    grid, patches = read_block_mesh(
        os.path.join(REF, "xiaocase3", "constant/polyMesh/blockMeshDict"))
    assert grid.shape == (10, 10, 1)
    np.testing.assert_allclose([grid.dx, grid.dy, grid.dz],
                               [4e-4, 4e-4, 5e-4])
    assert patches["inlet"] == [2]
    assert patches["outlet"] == [3]
    assert sorted(patches["walls"]) == [0, 1]
    assert sorted(patches["defaultFaces"]) == [4, 5]


@mounted
def test_load_xiaocase3():
    cfg, fluid, particles, controls = load_case(
        os.path.join(REF, "xiaocase3"), device=CPU)
    assert controls.dt == 2e-5
    assert controls.end_time == 0.005
    assert cfg.fluid.rhob == 1000.0
    assert cfg.fluid.nub == 1e-6
    assert cfg.cloud.drag_model == "SyamlalOBrien"
    assert cfg.cloud.sub_cycles == 1
    assert cfg.cloud.sub_steps == 100
    assert cfg.cloud.diffusion_band_width == 2e-4
    assert cfg.dem.pair.style == "hooke_history"
    assert cfg.dem.pair.kn == 5000.0
    assert cfg.dem.pair.gamman == 11200.0
    assert cfg.dem.pair.dampflag == 0
    assert len(cfg.dem.walls) == 3
    np.testing.assert_allclose(cfg.dem.dt, 2e-7)
    assert cfg.fluid.gravity == (0.0, 0.0, 0.0)
    np.testing.assert_allclose(cfg.dem.gravity, (0.0, 0.0, 0.0))
    assert int(particles.active.sum()) == 1
    np.testing.assert_allclose(particles.pos[0].numpy(),
                               [2.0e-3, 1.9e-3, 2.5e-4])
    np.testing.assert_allclose(float(particles.radius[0]), 8.3e-5 / 2)
    np.testing.assert_allclose(float(particles.density[0]), 2000.0)
    assert cfg.bcs.Ub.ym.kind == bc.FIXED_VALUE
    assert cfg.bcs.Ub.ym.value == (0.0, 0.05, 0.0)
    assert cfg.bcs.Ub.yp.kind == bc.INLET_OUTLET
    assert cfg.bcs.p.yp.kind == bc.FIXED_VALUE
    assert cfg.bcs.Ub.zm.kind == bc.EMPTY
    np.testing.assert_allclose(fluid.Ub[1].numpy(), 0.05)
    np.testing.assert_allclose(fluid.alpha.numpy(), 0.0)
    assert cfg.fluid.turbulence.model == "Smagorinsky"


@mounted
def test_load_xiaocase1():
    cfg, fluid, particles, controls = load_case(
        os.path.join(REF, "xiaocase1"), device=CPU)
    assert int(particles.active.sum()) == 2160
    assert cfg.fluid.rhob == 1.2
    assert cfg.cloud.sub_cycles == 2
    assert cfg.cloud.sub_steps == 5
    np.testing.assert_allclose(cfg.dem.gravity, (0.0, -9.8, 0.0))
    assert cfg.fluid.gravity == (0.0, -9.8, 0.0)
    assert cfg.dem.pair.kn == 4910.0
    np.testing.assert_allclose(float(particles.radius[0]), 7.5e-4)


@mounted
def test_load_case_runs_a_step():
    cfg, fluid, particles, controls = load_case(
        os.path.join(REF, "xiaocase3"), device=CPU)
    state = initialize(fluid, particles, cfg)
    state = make_step_fn(cfg, device=CPU)(state)
    assert bool(torch.isfinite(state.fluid.p).all())
    assert bool(torch.isfinite(state.particles.vel).all())


@mounted
def test_jetflow_ogrid_excluded_with_diagnostic():
    from sedifoam_tpu_torch.io.case import UnsupportedMeshError
    path = os.path.join(EXAMPLES, "jetFlow", "constant", "polyMesh",
                        "blockMeshDict")
    if not os.path.isfile(path):
        pytest.skip("jetFlow case not mounted")
    with pytest.raises(UnsupportedMeshError, match="arc|O-grid"):
        read_block_mesh(path)


@mounted
@pytest.mark.parametrize("case", ["transport-suspended",
                                  "transport-vortex-dune", "irregular"])
def test_missing_ic_cases_refuse_with_diagnostic(case):
    from sedifoam_tpu_torch.io.case import MissingICError
    path = os.path.join(EXAMPLES, case)
    if not os.path.isdir(path):
        pytest.skip(f"{case} not mounted")
    with pytest.raises(MissingICError, match="In_initial.in"):
        load_case(path, device=CPU)


# -- tests/test_golden_collide.py ---------------------------------------------

@mounted
@pytest.mark.slow
@pytest.mark.parametrize("case", collide.CASES)
def test_collide_trajectories(case):
    times, pos, vel, _ = collide.trace(os.path.join(REF, case), device=CPU)
    assert len(times) == 21
    cmp = collide.compare(pos, vel, os.path.join(collide.GOLDEN, case))
    for i in range(4):
        assert cmp["y_max_dev"][i] < collide.Y_TOL, (i, cmp)
        assert cmp["vy_max_dev"][i] < collide.VY_TOL, (i, cmp)


# -- tests/test_dev_cases.py --------------------------------------------------

@pytest.mark.skipif(not given(DEV),
                    reason="reference cases not mounted")
@pytest.mark.slow
def test_add_delete_particles_case():
    case = os.path.join(DEV, "addDeleteParticles")
    cfg, fluid, particles, controls = load_case(case, capacity=4096,
                                                backend="binned", device=CPU)
    assert cfg.cloud.add_particle == 1
    assert cfg.cloud.delete_particle == 1
    assert cfg.cloud.add_interval == 0.04
    assert cfg.cloud.add_info[0] == 0.005
    state = initialize(fluid, particles, cfg)
    n0 = int(state.particles.active.sum())
    step = make_step_fn(cfg, device=CPU)
    for _ in range(int(cfg.cloud.add_interval / cfg.fluid.dt) + 3):
        state = step(state)
    assert int(state.particles.active.sum()) > n0
    assert bool(torch.isfinite(state.particles.vel).all())
    assert int(state.particles.tag.max()) > n0


@pytest.mark.skipif(not given(DEV),
                    reason="reference cases not mounted")
@pytest.mark.slow
def test_wachem_semi_implicit_drag_stable():
    if not os.path.isdir(WACHEM):
        pytest.skip("case missing")
    cfg, fluid, particles, controls = load_case(WACHEM, backend="binned",
                                                device=CPU)
    cfg = _semi(cfg)
    state = initialize(fluid, particles, cfg)
    step = make_step_fn(cfg, device=CPU)
    for _ in range(8):
        state = step(state)
    assert int(state.particles.active.sum()) == 17562
    assert bool(torch.isfinite(state.fluid.Ub).all())
    assert float(state.fluid.Ub.abs().max()) < 10.0


# -- tests/test_wachem_explicit.py --------------------------------------------

wachem_mounted = pytest.mark.skipif(not given(WACHEM),
                                    reason="reference cases not mounted")


@pytest.fixture(scope="module")
def wachem():
    cfg, fluid, particles, controls = load_case(WACHEM, backend="binned",
                                                device=CPU)
    state = initialize(fluid, particles, cfg)
    # one stable (semi-implicit) step so the inlet gas flows: the drag's
    # Jd is Re-based and zero at rest
    state = make_step_fn(_semi(cfg), device=CPU)(state)
    return cfg, state


def _explicit_gain(cfg, state):
    """Max over cells of dt*Omega/(rhob*beta): the amplification rate of
    explicit drag in the Ub momentum equation."""
    from sedifoam_tpu_torch.coupling import drag as _drag
    from sedifoam_tpu_torch.coupling import transfer as _transfer
    ps, fl = state.particles, state.fluid
    cells = _transfer.particle_cells(ps, cfg.grid)
    p_alpha = _transfer.gather_from_grid(fl.alpha, cells, cfg.grid)
    uf_at_p = _transfer.gather_from_grid(fl.Ub, cells, cfg.grid)
    uri = uf_at_p - ps.vel
    mag_uri = torch.sqrt(torch.sum(uri * uri, dim=-1))
    jd_vals = _drag.jd(cfg.cloud.drag_model, mag_uri, p_alpha,
                       2.0 * ps.radius, cfg.fluid.nub, cfg.fluid.rhob)
    omega, _ = _transfer.calc_omega_asrc_semi(ps, jd_vals, cfg.grid)
    beta = torch.clamp(1.0 - fl.alpha, min=0.01)
    return float(torch.max(cfg.fluid.dt * omega / (cfg.fluid.rhob * beta)))


@wachem_mounted
def test_explicit_drag_gain_exceeds_stability_bound(wachem):
    cfg, state = wachem
    gain = _explicit_gain(cfg, state)
    assert gain > 2.0, gain


@wachem_mounted
def test_explicit_run_diverges_semi_implicit_bounded(wachem):
    cfg, state = wachem

    def umax_after(semi):
        step = make_step_fn(_semi(cfg, semi), device=CPU)
        s = state
        for _ in range(10):
            s = step(s)
        ub = s.fluid.Ub
        return float(ub.abs().max()) if bool(torch.isfinite(ub).all()) \
            else float("inf")

    u_semi = umax_after(True)
    u_expl = umax_after(False)
    assert u_semi < 10.0, u_semi
    assert u_expl > 10.0 * u_semi, (u_expl, u_semi)


# -- tests/test_bedload_case.py -----------------------------------------------

bedload_mounted = pytest.mark.skipif(not given(BEDLOAD),
                                     reason="reference cases not mounted")


def _synth_bed(path, box, d=0.0025, nx=8, nz=6, n_layers=3):
    """Two frozen bottom layers (type 2) + mobile layers above (type 1)."""
    rows = []
    tag = 1
    for layer in range(n_layers):
        for i in range(nx):
            for k in range(nz):
                x = box[0] + (i + 0.5) * (box[1] - box[0]) / nx
                z = box[4] + (k + 0.5) * (box[5] - box[4]) / nz
                y = box[2] + (layer + 0.5) * d
                t = 2 if layer == 0 else 1
                rows.append(f"{tag} {t} {d} 2650.0 {x:.6f} {y:.6f} {z:.6f}")
                tag += 1
    with open(path, "w") as f:
        f.write("synthetic bedload IC\n\n")
        f.write(f"{len(rows)} atoms\n2 atom types\n\n")
        f.write(f"{box[0]} {box[1]} xlo xhi\n")
        f.write(f"{box[2]} {box[3]} ylo yhi\n")
        f.write(f"{box[4]} {box[5]} zlo zhi\n\n")
        f.write("Atoms\n\n")
        f.write("\n".join(rows) + "\n")
    return len(rows)


def _assemble(tmp_path, blockmesh_override=None):
    case = tmp_path / "bedload"
    case.mkdir()
    for sub in ("0", "system"):
        os.symlink(os.path.join(BEDLOAD, sub), case / sub)
    (case / "constant").mkdir()
    for f in os.listdir(os.path.join(BEDLOAD, "constant")):
        src = os.path.join(BEDLOAD, "constant", f)
        if f == "polyMesh":
            (case / "constant" / "polyMesh").mkdir()
            bmd = os.path.join(src, "blockMeshDict")
            if blockmesh_override:
                (case / "constant" / "polyMesh" /
                 "blockMeshDict").write_text(blockmesh_override)
            else:
                shutil.copy(bmd, case / "constant" / "polyMesh")
        else:
            os.symlink(src, case / "constant" / f)
    shutil.copy(os.path.join(BEDLOAD, "in.lammps"), case)
    _synth_bed(case / "In_initial.in",
               (0.0, 0.121250, 0.0, 0.04, 0.0, 0.06001))
    return str(case)


@bedload_mounted
def test_bedload_loads_full_mesh(tmp_path):
    cfg, fluid, particles, controls = load_case(
        _assemble(tmp_path), backend="binned", dtype=torch.float32,
        device=CPU)
    assert cfg.grid.shape == (140, 65, 60)
    assert not cfg.grid.uniform
    w = cfg.grid.axis_widths(1)
    np.testing.assert_allclose(w[-1] / w[0], 10.0, rtol=1e-6)
    assert cfg.bcs.p.xm.kind == bc.CYCLIC
    assert cfg.bcs.p.zm.kind == bc.CYCLIC
    assert cfg.dem.periodic == (True, False, True)
    assert cfg.dem.frozen_types == (2,)
    assert cfg.dem.pair.style == "hooke_history"
    assert cfg.fluid.forcing.mode == "Ubar"
    np.testing.assert_allclose(cfg.fluid.forcing.mag_ubar, 0.8)
    assert int(particles.active.sum()) == 144


COARSE_BMD = """
FoamFile { version 2.0; format ascii; class dictionary;
           object blockMeshDict; }
convertToMeters 1;
vertices ( (0.00 0.00 0.00) (0.121250 0.00 0.00)
           (0.121250 0.04 0.00) (0.00 0.04 0.00)
           (0.00 0.00 0.06001) (0.121250 0.00 0.06001)
           (0.121250 0.04 0.06001) (0.00 0.04 0.06001) );
blocks ( hex (0 1 2 3 4 5 6 7) (14 13 6) simpleGrading (1 10 1) );
boundary (
  bottom { type wall; faces ( (1 5 4 0) ); }
  top    { type wall; faces ( (3 7 6 2) ); }
  left   { type cyclic; neighbourPatch right; faces ( (0 4 7 3) ); }
  right  { type cyclic; neighbourPatch left;  faces ( (2 6 5 1) ); }
  front  { type cyclic; neighbourPatch back;  faces ( (0 1 2 3) ); }
  back   { type cyclic; neighbourPatch front; faces ( (4 5 6 7) ); }
);
"""


@bedload_mounted
@pytest.mark.slow
def test_bedload_steps_coarse(tmp_path):
    case = _assemble(tmp_path, blockmesh_override=COARSE_BMD)
    cfg, fluid, particles, controls = load_case(case, backend="dense",
                                                dtype=torch.float64,
                                                device=CPU)
    state = initialize(fluid, particles, cfg)
    frozen0 = state.particles.pos[state.particles.ptype == 2].clone()
    for _ in range(10):
        state = coupled_step(state, cfg)
    assert bool(torch.isfinite(state.fluid.p).all())
    assert bool(torch.isfinite(state.particles.pos).all())
    assert float(state.fluid.Ub[0].mean()) > 0.01
    assert float(state.fluid.grad_p_value) > 0.0
    frozen1 = state.particles.pos[state.particles.ptype == 2]
    assert torch.equal(frozen0, frozen1)
    assert int(state.particles.active.sum()) == 144
