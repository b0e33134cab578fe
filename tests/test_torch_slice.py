"""The whole slice: 3 coupled steps of the bench case (small) in
sedifoam_tpu and in sedifoam_tpu_torch, f64 on the CPU.

The JAX case from bench.build_case (256 particles, 8x16x8 grid, binned
backend) is cast to f64, bridged into the port, and both packages step it
3 times; every state field must agree to 1e-8 relative to its scale
(measured: 6e-11 at worst, in Ua and the fluxes, where alpha is near 0).
Also: the port's config dataclasses match the reference's field for
field, and the port's own bench case builder reproduces
bench.build_case.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import bench  # noqa: E402
from sedifoam_tpu import config as jcfg  # noqa: E402
from sedifoam_tpu import solver as jsolver  # noqa: E402
from sedifoam_tpu_torch import bc as tbc  # noqa: E402
from sedifoam_tpu_torch import bench_case, bridge  # noqa: E402
from sedifoam_tpu_torch import config as tcfg  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu import bc as jbc  # noqa: E402
from torch_port_util import assert_tree_close  # noqa: E402

SMALL = dict(n_particles=256, nx=8, ny=16, nz=8)


def _f64(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64)
        if jnp.issubdtype(x.dtype, jnp.floating) else x, tree)


def test_three_coupled_steps_match_reference():
    cfg_j, state_j = bench.build_case(backend="binned", **SMALL)
    state_j = _f64(state_j)
    state_t = bridge.sim_state_from_numpy(
        bridge.sim_state_to_numpy(state_j))
    assert state_t.particles.pos.dtype == torch.float64

    cfg_t = bench_case.build_config(**SMALL)
    step_j = jsolver.make_step_fn(cfg_j)
    for _ in range(3):
        state_j = step_j(state_j)
    state_t = tsolver.make_step_fn(cfg_t, n_sub=3,
                                   dtype=torch.float64)(state_t)
    ref = bridge.sim_state_to_numpy(state_j)
    got = bridge.sim_state_to_numpy(state_t)
    assert np.any(ref["particles"]["shear"] != 0.0)   # contacts carried
    assert int(ref["particles"]["nbr_dropped"]) == 0
    worst = assert_tree_close(ref, got, 1e-8)
    assert worst < 1e-8


def _same_dataclass(a, b):
    fa = {f.name: f.default for f in dataclasses.fields(a)}
    fb = {f.name: f.default for f in dataclasses.fields(b)}
    assert list(fa) == list(fb), a.__name__
    for k in fa:
        da, db = fa[k], fb[k]
        if dataclasses.is_dataclass(da):
            assert type(da).__name__ == type(db).__name__
            assert dataclasses.asdict(da) == dataclasses.asdict(db), k
        else:
            assert da == db, (a.__name__, k)


@pytest.mark.parametrize("name", ["PairParams", "WallSpec", "DEMConfig",
                                  "CohesionParams", "PISOConfig",
                                  "ChannelForcing", "TurbulenceConfig",
                                  "CloudConfig", "FluidConfig"])
def test_config_fields_and_defaults_match(name):
    _same_dataclass(getattr(jcfg, name), getattr(tcfg, name))


@pytest.mark.parametrize("name", ["TimeTable", "PatchBC", "DiscRegion",
                                  "RegionPatchBC", "FieldBC"])
def test_bc_fields_and_defaults_match(name):
    _same_dataclass(getattr(jbc, name), getattr(tbc, name))


def test_time_table_interpolates_like_numpy():
    tt = tbc.TimeTable((0.0, 1.0, 3.0), ((0.0, 2.0, 0.0), (1.0, 4.0, 0.0),
                                         (3.0, 0.0, 0.0)))
    for t in (-1.0, 0.0, 0.25, 1.0, 2.0, 3.0, 7.0):
        got = float(tt.at(torch.tensor(t, dtype=torch.float64), 1))
        assert got == pytest.approx(np.interp(t, [0, 1, 3], [2, 4, 0]),
                                    abs=1e-15)


def test_bench_case_builder_matches_reference():
    """The port's bench case (config + initialize) equals bench.build_case."""
    cfg_j, state_j = bench.build_case(backend="binned", **SMALL)
    cfg_t = bench_case.build_config(**SMALL)
    for part in ("fluid", "cloud", "dem"):
        assert dataclasses.asdict(getattr(cfg_j, part)) == \
            dataclasses.asdict(getattr(cfg_t, part)), part
    assert dataclasses.asdict(cfg_j.grid) == dataclasses.asdict(cfg_t.grid)
    fluid, particles = bench_case.build_state(
        cfg_t, SMALL["n_particles"], dtype=torch.float32)
    state_t = tsolver.CoupledStep(cfg_t, dtype=torch.float32).initialize(
        fluid, particles)
    assert_tree_close(bridge.sim_state_to_numpy(state_j),
                      bridge.sim_state_to_numpy(state_t), 1e-5)


@pytest.mark.parametrize("args", [(5e-5, 5e-6, 1), (5e-5, 5e-6, 2),
                                  (1e-4, 3e-6, 3), (1e-4, 1e-3, 1)])
def test_adjust_dem_timestep_matches_reference(args):
    import warnings
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert tsolver.adjust_dem_timestep(*args) == \
            jsolver.adjust_dem_timestep(*args)


def test_need_ddtu_matches_reference():
    cfg_j, _ = bench.build_case(backend="binned", **SMALL)
    cfg_t = bench_case.build_config(**SMALL)
    assert tsolver.need_ddtu(cfg_t) == jsolver.need_ddtu(cfg_j) is False
    cj = dataclasses.replace(cfg_j, dem=dataclasses.replace(
        cfg_j.dem, carrier_rho=1000.0))
    ct = dataclasses.replace(cfg_t, dem=dataclasses.replace(
        cfg_t.dem, carrier_rho=1000.0))
    assert tsolver.need_ddtu(ct) == jsolver.need_ddtu(cj) is True
