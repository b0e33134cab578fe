"""sedifoam_tpu_torch's DNS spectral forcing (fluid/bodyforce.py, the
threefry `normal` of dem/inject.py and the hooks in fluid/step.py and
fluid/piso.py) against sedifoam_tpu, on the CPU.

The key is the same in both packages, so the random stream is: the
uniform draw under `normal` is equal bit for bit, the normal values to
round-off (XLA and PyTorch evaluate erfinv with different polynomials;
held to 1e-5 in f32 and 1e-13 in f64, relative and absolute; measured
2.1e-6 relative in f32, in the tails, and 3.4e-15 in f64). Tolerance on
the forcing and on the fluid fields, relative to each field's scale:
1e-12 in f64 (measured 3.2e-15 for 3 forcing steps, 7.3e-15 for 3
fluid steps), 2e-5 in f32 against JAX f32 (measured 3.5e-7). The port
takes the inverse transform with an FFT, the reference with three DFT
matrix products: the same sum in another order.
"""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu import bc as jbc  # noqa: E402
from sedifoam_tpu import config as jcfg  # noqa: E402
from sedifoam_tpu import grid as jgrid  # noqa: E402
from sedifoam_tpu.fluid import bodyforce as jbf  # noqa: E402
from sedifoam_tpu.fluid import state as jfstate  # noqa: E402
from sedifoam_tpu.fluid import step as jstep  # noqa: E402
from sedifoam_tpu_torch import bc as tbc  # noqa: E402
from sedifoam_tpu_torch import bridge  # noqa: E402
from sedifoam_tpu_torch import config as tcfg  # noqa: E402
from sedifoam_tpu_torch import grid as tgrid  # noqa: E402
from sedifoam_tpu_torch.dem import inject as trng  # noqa: E402
from sedifoam_tpu_torch.fluid import bodyforce as tbf  # noqa: E402
from sedifoam_tpu_torch.fluid import state as tfstate  # noqa: E402
from sedifoam_tpu_torch.fluid import step as tstep  # noqa: E402
from torch_port_util import few_threads  # noqa: E402,F401
from torch_port_util import (assert_tree_close, fluid_to_torch,  # noqa: E402
                             rel_err)

TOL = {"f64": 1e-12, "f32": 2e-5}
JDT = {"f64": jnp.float64, "f32": jnp.float32}
TDT = {"f64": torch.float64, "f32": torch.float32}
SHAPE = (8, 6, 10)         # three different axis lengths, one not 2^n
BOX = 0.08


def _key(seed):
    kj = jax.random.PRNGKey(seed)
    return kj, torch.as_tensor(np.asarray(kj).astype(np.int64))


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_threefry_normal(prec):
    """jax.random.normal at the forcing's shape (2, 3, nx, ny, nz)."""
    kj, kt = _key(7)
    shape = (2, 3) + SHAPE
    ref = np.asarray(jax.random.normal(kj, shape, JDT[prec]))
    got = trng.normal(kt, shape, TDT[prec])
    assert got.dtype == TDT[prec] and tuple(got.shape) == shape
    assert torch.all(torch.isfinite(got))
    # the uniform under it, on jax's interval [nextafter(-1, 0), 1)
    lo = np.nextafter(ref.dtype.type(-1.0), ref.dtype.type(0.0))
    u_ref = np.asarray(jax.random.uniform(kj, shape, JDT[prec], lo, 1.0))
    u_got = trng.uniform(kt, shape, TDT[prec]).numpy() \
        * (ref.dtype.type(1.0) - lo) + lo
    assert u_got.dtype == ref.dtype
    np.testing.assert_array_equal(u_got, np.maximum(u_ref, lo))
    np.testing.assert_array_equal(np.maximum(u_got, lo), u_ref)
    tol = {"f64": 1e-13, "f32": 1e-5}[prec]
    np.testing.assert_allclose(got.numpy(), ref, rtol=tol, atol=tol)
    assert abs(float(got.mean())) < 0.1 and 0.9 < float(got.std()) < 1.1


def _grids():
    d = tuple(BOX / n for n in SHAPE)
    return tuple(m.Grid(*SHAPE, dx=d[0], dy=d[1], dz=d[2])
                 for m in (jgrid, tgrid))


@pytest.mark.parametrize("prec", ["f64", "f32"])
def test_uo_forcing_step(prec):
    gj, gt = _grids()
    kj, kt = _key(7)
    uj = jbf.init_uo_state(gj, kj, JDT[prec])
    ut = tbf.init_uo_state(gt, kt, TDT[prec], device="cpu")
    # the default key is PRNGKey(7) in both
    np.testing.assert_array_equal(
        tbf.init_uo_state(gt, device="cpu").key.numpy(), np.asarray(kj))
    # a shell inside every axis' Nyquist plane (pi/dy = 235.6): there the
    # real part of the transform keeps the projection solenoidal
    args = dict(dt=1e-3, alpha=1.0, sigma=0.5, k_upper=230.0, k_lower=50.0)
    for _ in range(3):
        uj, fj = jbf.uo_forcing_step(uj, gj, **args)
        ut, ft = tbf.uo_forcing_step(ut, gt, **args)
        assert ft.dtype == TDT[prec]
        assert float(jnp.abs(fj).max()) > 0.0
        assert rel_err(fj, ft) <= TOL[prec]
        assert rel_err(uj.f_hat, ut.f_hat) <= TOL[prec]
        np.testing.assert_array_equal(np.asarray(uj.key), ut.key.numpy())
    # the shell: modes outside [k_lower, k_upper] are exactly zero
    np.testing.assert_array_equal(np.asarray(uj.f_hat) == 0.0,
                                  ut.f_hat.numpy() == 0.0)
    # the force is solenoidal: K . F(K) = 0 to round-off
    K, k_mag, _ = tbf._wavevectors(gt, TDT[prec], torch.device("cpu"))
    Fk = torch.fft.fftn(ft, dim=(-3, -2, -1))
    div = torch.abs((K * Fk).sum(dim=0)).max()
    assert float(div) <= 1e3 * torch.finfo(TDT[prec]).eps * float(
        (k_mag[None] * torch.abs(Fk)).max())
    assert tbf.ibm_relaxation_diag(torch.ones(2), 4.0).tolist() == [0.25] * 2


def _box(m, fstate):
    cyc = m.PatchBC(m.CYCLIC)
    cyc3 = m.PatchBC(m.CYCLIC, (0.0, 0.0, 0.0))
    return fstate.FluidBCs(
        alpha=m.FieldBC(*(cyc for _ in range(6))),
        p=m.FieldBC(*(cyc for _ in range(6))),
        Ub=m.FieldBC(*(cyc3 for _ in range(6))),
        Ua=m.FieldBC(*(cyc3 for _ in range(6))))


def test_fluid_step_dns_force():
    """tests/test_ibm_dns.py's forced periodic box: 3 fluid steps."""
    gj, gt = _grids()
    cfgs = [m.FluidConfig(dt=1e-3, rhob=1000.0, nub=1e-6,
                          piso=m.PISOConfig(n_correctors=1, p_tol=1e-12),
                          add_dns_force=True, dns_alpha=1.0, dns_sigma=0.5,
                          dns_k_upper=600.0, dns_k_lower=0.0)
            for m in (jcfg, tcfg)]
    fj = jfstate.init_fluid(gj)
    fj = fj._replace(dns_key=jax.random.PRNGKey(3))
    ft = fluid_to_torch(fj)
    assert ft.dns_key.dtype == torch.int64
    bj, bt = _box(jbc, jfstate), _box(tbc, tfstate)
    for _ in range(3):
        fj = jstep.fluid_step(fj, gj, bj, cfgs[0], need_ddtu=True)
        ft = tstep.fluid_step(ft, gt, bt, cfgs[1], need_ddtu=True)
    assert float(jnp.abs(fj.turbulence_force).max()) > 0.0
    assert float(jnp.sum(fj.Ub ** 2)) > 0.0
    ref, got = bridge.tree_to_numpy(fj), bridge.tree_to_numpy(ft)
    np.testing.assert_array_equal(ref["dns_key"].astype(np.int64),
                                  got["dns_key"])
    # p is fixed up to a constant in a periodic box: compare its gradient
    # carriers (Ub, phib) and p itself with the mean removed
    for d in (ref, got):
        d["p"] = d["p"] - d["p"].mean()
    worst = assert_tree_close(ref, got, TOL["f64"], skip=("dns_key",))
    assert worst <= TOL["f64"]
