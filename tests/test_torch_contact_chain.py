"""The port's contact chain against the JAX package's Pallas kernel.

sedifoam_tpu_torch.dem.fused.contact_chain_reference (the plain PyTorch
version of the CUDA kernel) is held against
sedifoam_tpu.dem.fused.pair_forces_binned_fused run in Pallas interpret
mode, as tests/test_fused.py runs it: f32, 1e-6 relative to each
output's scale (measured 1.6e-7; 8.1e-7 with shearupdate=False), on
open and periodic boxes, with shearupdate=False, and with the plane
walls fused in. test_cuda_kernel_matches_plain_version runs the CUDA
kernel itself against the plain version (all three pair styles, with and
without shear update, f32 and f64) and needs a card; it imports no JAX,
so it runs where JAX is not installed.
"""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from sedifoam_tpu_torch import config as tcfg  # noqa: E402
from sedifoam_tpu_torch.dem import fused as tfused  # noqa: E402
from sedifoam_tpu_torch.dem import integrate as tint  # noqa: E402
from sedifoam_tpu_torch.dem.state import make_particles as tmake  # noqa: E402
from torch_port_util import particles_to_torch, rel_err  # noqa: E402

BOX = (0.0, 0.0, 0.0), (8e-3, 16e-3, 8e-3)
R = 5e-4
TOL = 1e-6


def _state_cfg(n=96, seed=0, periodic=(False, False, False), settle=100,
               wall_gap=2.0):
    """tests/test_fused.py's case: a random f32 bed settled in JAX.
    JAX is imported here, not at module level, so that the CUDA test of
    this file also runs where JAX is not installed."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from sedifoam_tpu.config import DEMConfig, PairParams, WallSpec
    from sedifoam_tpu.dem.integrate import run_dem, setup_forces
    from sedifoam_tpu.dem.state import make_particles
    rng = np.random.RandomState(seed)
    pos = rng.uniform(wall_gap * R, np.asarray(BOX[1]) - wall_gap * R,
                      size=(n, 3))
    vel = rng.randn(n, 3) * 0.05
    pair = PairParams(style="hertz_history", kn=1e5, gamman=0.7, xmu=0.4)
    walls = tuple(WallSpec(style=s, lo=0.0, hi=h, params=pair)
                  for a, (s, h) in enumerate(
                      (("xplane", BOX[1][0]), ("yplane", BOX[1][1]),
                       ("zplane", BOX[1][2]))) if not periodic[a])
    cfg = DEMConfig(
        dt=1e-6, pair=pair, walls=walls, gravity=(0.0, -9.81, 0.0),
        backend="binned", nbr_k=24, max_per_bin=8,
        cutoff=2 * R * 1.6, skin=0.6 * R, periodic=periodic,
        domain_lo=BOX[0], domain_hi=BOX[1])
    st = make_particles(pos, R, 2500.0, vel=vel, n_walls=len(walls),
                        neighbor_k=cfg.nbr_k, dtype=jnp.float32)
    st = setup_forces(st, cfg)
    if settle:
        st = run_dem(st, cfg, settle)
    return st, cfg


def _port(params):
    return tcfg.PairParams(style=params.style, kn=params.kn,
                           gamman=params.gamman, xmu=params.xmu)


def _port_walls(walls):
    return tuple(tcfg.WallSpec(style=w.style, lo=w.lo, hi=w.hi,
                               params=_port(w.params)) for w in walls)


def _pallas(*args, **kw):
    from sedifoam_tpu.dem.fused import pair_forces_binned_fused
    return pair_forces_binned_fused(*args, interpret=True, donate=False,
                                    **kw)


def _check(ref, got, n_out):
    assert len(got) == 4
    for a, b in list(zip(ref, got))[:n_out]:
        assert b.dtype == torch.float32
        assert rel_err(a, b) < TOL


@pytest.mark.parametrize("periodic", [(False, False, False),
                                      (True, False, True)])
def test_chain_matches_pallas_kernel(periodic):
    st, cfg = _state_cfg(periodic=periodic)
    plen = cfg.periodic_len()
    ref = _pallas(st, cfg.pair, cfg.dt, st.nbr_idx, True, plen)
    tst = particles_to_torch(st)
    got = tfused.contact_chain_reference(tst, _port(cfg.pair), cfg.dt,
                                         tst.nbr_idx, True, plen)
    assert ref[3] is None and got[3] is None
    assert np.any(np.asarray(ref[0]) != 0)      # real contacts present
    _check(ref, got, 3)


def test_chain_no_shearupdate_matches_pallas_kernel():
    st, cfg = _state_cfg(seed=3)
    ref = _pallas(st, cfg.pair, cfg.dt, st.nbr_idx, False, None)
    tst = particles_to_torch(st)
    got = tfused.contact_chain_reference(tst, _port(cfg.pair), cfg.dt,
                                         tst.nbr_idx, False, None)
    _check(ref, got, 3)


def test_chain_fused_walls_match_pallas_kernel():
    # wall_gap < 1 puts particle centers within R of the planes
    st, cfg = _state_cfg(seed=5, settle=0, wall_gap=0.6)
    ref = _pallas(st, cfg.pair, cfg.dt, st.nbr_idx, True, None,
                  walls=cfg.walls)
    tst = particles_to_torch(st)
    got = tfused.contact_chain_reference(tst, _port(cfg.pair), cfg.dt,
                                         tst.nbr_idx, True, None,
                                         walls=_port_walls(cfg.walls))
    assert ref[3] is not None and got[3] is not None
    assert np.any(np.asarray(ref[3]) != 0)       # wall contacts present
    _check(ref, got, 4)


def test_wrapper_takes_plain_version_on_cpu():
    """On CPU tensors contact_chain is contact_chain_reference, and no
    kernel launch is counted."""
    st, cfg = _state_cfg(seed=5, settle=0, wall_gap=0.6)
    tst = particles_to_torch(st)
    before = tfused.LAUNCHES
    args = (_port(cfg.pair), cfg.dt, tst.nbr_idx, True, None,
            _port_walls(cfg.walls))
    a = tfused.contact_chain(tst, *args)
    b = tfused.contact_chain_reference(tst, *args)
    assert tfused.LAUNCHES == before
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _port_case(dtype, device, style="hertz_history"):
    """A JAX-free bed for the CUDA test: random positions with wall and
    pair overlaps, random velocities, after the port's setup_forces and
    20 substeps (on the CPU, plain path)."""
    rng = np.random.RandomState(31)
    n = 400
    pair = tcfg.PairParams(style=style, kn=1e5, gamman=0.7, xmu=0.4)
    walls = tuple(tcfg.WallSpec(style=s, lo=0.0, hi=h, params=pair)
                  for s, h in (("xplane", BOX[1][0]), ("yplane", BOX[1][1]),
                               ("zplane", BOX[1][2])))
    cfg = tcfg.DEMConfig(
        dt=1e-6, pair=pair, walls=walls, backend="binned", nbr_k=16,
        max_per_bin=8, cutoff=2 * R * 1.6, skin=0.6 * R,
        domain_lo=BOX[0], domain_hi=BOX[1])
    pos = rng.uniform(0.6 * R, np.asarray(BOX[1]) - 0.6 * R, size=(n, 3))
    st = tmake(pos, R, 2500.0, vel=0.05 * rng.randn(n, 3),
               omega=20.0 * rng.randn(n, 3), n_walls=3, neighbor_k=16,
               dtype=dtype)
    st = tint.run_dem(tint.setup_forces(st, cfg), cfg, 20)
    return cfg, type(st)(*(t.to(device) if isinstance(t, torch.Tensor)
                           else t for t in st))


@pytest.mark.cuda
@pytest.mark.parametrize("style", ["hooke", "hooke_history",
                                   "hertz_history"])
@pytest.mark.parametrize("shearupdate", [True, False])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_cuda_kernel_matches_plain_version(dtype, tol, shearupdate, style):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    cfg, p = _port_case(dtype, torch.device("cuda"), style)
    args = (cfg.pair, cfg.dt, p.nbr_idx, shearupdate, None, cfg.walls)
    ref = tfused.contact_chain_reference(
        p._replace(shear=p.shear.clone(), wall_shear=p.wall_shear.clone()),
        *args)
    before = tfused.LAUNCHES
    got = tfused.contact_chain(
        p._replace(shear=p.shear.clone(), wall_shear=p.wall_shear.clone()),
        *args)
    torch.cuda.synchronize()
    assert tfused.LAUNCHES == before + 1
    assert bool(torch.any(ref[0] != 0))          # contacts present
    for a, b in zip(ref, got):
        assert b.is_cuda and b.dtype == dtype
        assert rel_err(a, b) < tol


def test_kernel_wrapper_rejects_what_it_cannot_take():
    """The kernel's input checks and parameter packing, on the CPU: a
    wrong dtype, shape or non-contiguous tensor and a non-plane wall
    raise before any launch."""
    cfg, p = _port_case(torch.float64, torch.device("cpu"))
    tfused.check_inputs(p, p.nbr_idx, 3)
    with pytest.raises(ValueError, match="dtype"):
        tfused.check_inputs(p._replace(vel=p.vel.float()), p.nbr_idx, 3)
    with pytest.raises(ValueError, match="contiguous"):
        tfused.check_inputs(
            p._replace(shear=p.shear.transpose(1, 2).contiguous()
                       .transpose(1, 2)), p.nbr_idx, 3)
    with pytest.raises(ValueError, match="shape"):
        tfused.check_inputs(p, p.nbr_idx[:4], 3)
    cyl = tcfg.WallSpec(style="zcylinder", cylradius=1e-3,
                        params=cfg.pair)
    with pytest.raises(ValueError, match="plane"):
        tfused._params(p.n_capacity, 16, cfg.dt, True, None, cfg.pair,
                       (cyl,))
    cp = tfused._params(p.n_capacity, 16, cfg.dt, True, (None, 8e-3, None),
                        cfg.pair, cfg.walls)
    assert (cp.W, list(cp.periodic), cp.plen[1]) == (3, [0, 1, 0], 8e-3)
    assert cp.pair.style == 2 and cp.walls[1].axis == 1
