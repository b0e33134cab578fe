"""The reference's compiled control flow in the port (graphs.py): the
while_loop form of PCG and BiCGStab, the cond form of the Verlet rebuild
and of injection and deletion, held against sedifoam_tpu on the CPU.

On the CPU there is no graph: `graphs.host_reads_forbidden()` stands in
for a capture. Under it the decisions of cond and while_loop are the
only host reads allowed and every other one raises, so a step that
passes here has no host read left to break a capture on the card (the
card's tests and chip_smoke.py replay the captured graphs themselves).

- pcg and bicgstab against the JAX package's on one seeded f64 system:
  the same iteration count, x within 1e-12 of its scale and the
  residuals within 1e-12 of the initial one, for the tolerance,
  max_iter, stall and non-finite exits;
- both against the parent's eager loop, kept here: bit for bit, eagerly
  and in the graph form;
- maybe_rebuild_neighbors against the JAX package's on a bed that needs
  a rebuild and one that does not, sort_on_rebuild off and on: nbr_idx,
  shear and the whole state exactly;
- the injection column (cases.inject_case, small) for a few coupled
  steps against the JAX package, eagerly and in the graph form;
- the coupled step of the bench and channel cases with no host read but
  the decisions', equal to the eager step bit for bit (the clumps' and
  the injection column's replayed graphs are held against their eager
  steps on the card: chip_smoke.py phase_graph);
- linsolve.STATS and the graphs helpers.
"""

import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from sedifoam_tpu import linsolve as jsolve  # noqa: E402
from sedifoam_tpu import solver as jsolver  # noqa: E402
from sedifoam_tpu.dem import integrate as jint  # noqa: E402
from sedifoam_tpu_torch import bench_case, bridge, cases, graphs  # noqa: E402
from sedifoam_tpu_torch import linsolve as tsolve  # noqa: E402
from sedifoam_tpu_torch import solver as tsolver  # noqa: E402
from sedifoam_tpu_torch.dem import integrate as tint  # noqa: E402
from sedifoam_tpu_torch.dem import inject as tinj  # noqa: E402
from sedifoam_tpu_torch.io.case import load_case  # noqa: E402
from sedifoam_tpu_torch.validate import semi_implicit  # noqa: E402
from test_torch_dem import _cfgs, _particles  # noqa: E402
from torch_port_cases import f64, port_config, window_case  # noqa: E402
from torch_port_util import (assert_tree_close, few_threads,  # noqa: E402,F401
                             particles_to_torch, rel_err)

SHAPE = (8, 6, 5)


# ---- the systems: one operator in each package --------------------------

def _lap(x, roll):
    """7-point Laplacian, periodic: negative semidefinite."""
    out = -6.0 * x
    for a in range(3):
        out = out + roll(x, 1, a) + roll(x, -1, a)
    return out


def _ops(kind, shift=0.3):
    """(jax apply, torch apply, diag) of a symmetric negative definite
    ("spd": the Laplacian less `shift`) or a nonsymmetric ("convection":
    that plus upwind convection) operator on SHAPE."""
    conv = 0.0 if kind == "spd" else (20.0 if shift < 0.1 else 2.0)

    def make(roll):
        def apply(x):
            return _lap(x, roll) - shift * x - conv * (x - roll(x, 1, 0))
        return apply

    return (make(lambda x, s, a: jnp.roll(x, s, axis=a)),
            make(lambda x, s, a: torch.roll(x, s, dims=a)),
            np.full(SHAPE, -6.0 - shift - conv))


def _system(seed=3):
    rng = np.random.RandomState(seed)
    return rng.randn(*SHAPE), 0.1 * rng.randn(*SHAPE)


# the exits: (tol, max_iter, operator shift, NaN in b). The stall: below
# the round-off floor of the normalized residual (tol 1e-30 is raised to
# 50 eps) a weakly shifted operator's |r| sum stops improving
EXITS = {
    "tolerance": (1e-9, 500, 0.3, False),
    "max_iter": (1e-14, 4, 0.3, False),
    "stall": (1e-30, 500, 0.003, False),
    "nonfinite": (1e-9, 500, 0.3, True),
}


def _exit_case(name, kind):
    tol, max_iter, shift, nan = EXITS[name]
    b, x0 = _system()
    japply, tapply, diag = _ops(kind, shift)
    if nan:
        b[1, 2, 3] = np.nan
    return japply, tapply, diag, b, x0, tol, max_iter


def _run_both(solver, name, kind):
    japply, tapply, diag, b, x0, tol, max_iter = _exit_case(name, kind)
    jfn = getattr(jsolve, solver)
    tfn = getattr(tsolve, solver)
    rj = jax.jit(lambda bb, xx, dd: jfn(japply, bb, xx, dd, tol=tol,
                                        max_iter=max_iter))(
        jnp.asarray(b), jnp.asarray(x0), jnp.asarray(diag))
    args = (tapply, torch.as_tensor(b), torch.as_tensor(x0),
            torch.as_tensor(diag))
    rt = tfn(*args, tol=tol, max_iter=max_iter)
    with graphs.host_reads_forbidden():
        rg = tfn(*args, tol=tol, max_iter=max_iter)
    return rj, rt, rg, (tapply, b, x0, diag, tol, max_iter)


@pytest.mark.parametrize("name", sorted(EXITS))
@pytest.mark.parametrize("solver,kind", [("pcg", "spd"),
                                         ("bicgstab", "convection")])
def test_solver_matches_reference(solver, kind, name):
    rj, rt, rg, _ = _run_both(solver, name, kind)
    n = int(rj.n_iterations)
    assert int(rt.n_iterations) == int(rg.n_iterations) == n
    # without host reads the solve is the eager one, bit for bit
    for a, b in zip(rt, rg):
        assert torch.equal(a, b) or (torch.isnan(a).all() and
                                      torch.isnan(b).all())
    if name == "nonfinite":
        assert n == 0 and not np.isfinite(float(rt.initial_residual))
        return
    assert n == (EXITS[name][1] if name == "max_iter" else n) and n > 2
    floor = 50 * np.finfo(np.float64).eps
    if name == "stall":
        assert n < EXITS[name][1] and float(rt.final_residual) > floor
    if name == "stall" and solver == "bicgstab":
        # past its stall BiCGStab's iterates follow the round-off, which
        # the summation order sets: the iteration count is compared here,
        # x bit for bit against the parent's loop in
        # test_solver_bitwise_parent_loop
        return
    assert rel_err(np.asarray(rj.x), rt.x) <= 1e-12
    # the residuals are normalized sums of |r|: against the larger of the
    # two (the final residual of a converged solve is r's round-off,
    # whose own digits follow the summation order)
    for a, b in ((rj.initial_residual, rt.initial_residual),
                 (rj.final_residual, rt.final_residual)):
        scale = max(float(rj.initial_residual), float(rj.final_residual))
        assert abs(float(a) - float(b)) <= 1e-12 * scale


# ---- the parent's eager loops, kept as they were ------------------------

def _parent_pcg(apply_fn, b, x0, diag, tol=1e-10, rel_tol=0.0,
                max_iter=1000):
    tol = max(tol, tsolve._dtype_tol_floor(x0.dtype))
    inv_diag = 1.0 / torch.where(diag == 0.0, torch.ones_like(diag), diag)
    nf = tsolve.norm_factor(apply_fn, x0, b)
    r = b - apply_fn(x0)
    res0 = torch.sum(torch.abs(r)) / nf
    x, p = x0, torch.zeros_like(x0)
    rz_old = torch.ones((), dtype=x0.dtype)
    res, best = res0, res0
    stall = torch.zeros((), dtype=torch.int32)
    it = 0
    while it < max_iter:
        go = (res > tol) & (res > rel_tol * res0) & (stall < 8) \
            & torch.isfinite(res)
        if not bool(go):
            break
        z = inv_diag * r
        rz = torch.sum(r * z)
        beta = torch.zeros_like(rz) if it == 0 else \
            tsolve._safe_ratio(rz, rz_old)
        p = z + beta * p
        Ap = apply_fn(p)
        alpha = tsolve._safe_ratio(rz, torch.sum(p * Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        res = torch.sum(torch.abs(r)) / nf
        improved = res < 0.999 * best
        stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
        best = torch.minimum(best, res)
        rz_old = rz
        it += 1
    return x, res0, res, it


def _parent_bicgstab(apply_fn, b, x0, diag, tol=1e-10, rel_tol=0.0,
                     max_iter=1000):
    tol = max(tol, tsolve._dtype_tol_floor(x0.dtype))
    inv_diag = 1.0 / torch.where(diag == 0.0, torch.ones_like(diag), diag)

    def prec_apply(v):
        return apply_fn(inv_diag * v)

    nf = tsolve.norm_factor(apply_fn, x0, b)
    y = diag * x0
    r = b - prec_apply(y)
    rhat = r
    res0 = torch.sum(torch.abs(r)) / nf
    p, v = torch.zeros_like(x0), torch.zeros_like(x0)
    rho_old = alpha = omega = torch.ones((), dtype=x0.dtype)
    res, best = res0, res0
    stall = torch.zeros((), dtype=torch.int32)
    it = 0
    while it < max_iter:
        go = (res > tol) & (res > rel_tol * res0) & (stall < 10) \
            & torch.isfinite(res)
        if not bool(go):
            break
        rho = torch.sum(rhat * r)
        beta = torch.zeros_like(rho) if it == 0 else \
            tsolve._safe_ratio(rho, rho_old) * tsolve._safe_ratio(alpha,
                                                                  omega)
        p = r + beta * (p - omega * v)
        v = prec_apply(p)
        alpha = tsolve._safe_ratio(rho, torch.sum(rhat * v))
        s = r - alpha * v
        t = prec_apply(s)
        omega = tsolve._safe_ratio(torch.sum(t * s), torch.sum(t * t))
        y = y + alpha * p + omega * s
        r = s - omega * t
        res = torch.sum(torch.abs(r)) / nf
        improved = res < 0.999 * best
        stall = torch.where(improved, torch.zeros_like(stall), stall + 1)
        best = torch.minimum(best, res)
        rho_old = rho
        it += 1
    return inv_diag * y, res0, res, it


@pytest.mark.parametrize("name", ["tolerance", "max_iter", "stall"])
@pytest.mark.parametrize("solver,kind,parent", [
    ("pcg", "spd", _parent_pcg), ("bicgstab", "convection",
                                  _parent_bicgstab)])
def test_solver_bitwise_parent_loop(solver, kind, parent, name):
    _, rt, rg, (tapply, b, x0, diag, tol, max_iter) = _run_both(
        solver, name, kind)
    x, res0, res, it = parent(tapply, torch.as_tensor(b),
                              torch.as_tensor(x0), torch.as_tensor(diag),
                              tol=tol, max_iter=max_iter)
    for r in (rt, rg):
        assert int(r.n_iterations) == it
        assert torch.equal(r.x, x)
        assert torch.equal(r.initial_residual, res0)
        assert torch.equal(r.final_residual, res)


def test_stats_count_solves_and_iterations():
    _, tapply, diag, b, x0, tol, max_iter = _exit_case("tolerance", "spd")
    args = (tapply, torch.as_tensor(b), torch.as_tensor(x0),
            torch.as_tensor(diag))
    tsolve.reset_stats()
    its = [int(tsolve.pcg(*args, tol=t).n_iterations)
           for t in (1e-4, 1e-9)]
    with graphs.host_reads_forbidden():
        r = tsolve.pcg(*args, tol=1e-6)     # counted on the device
    its.append(int(r.n_iterations))
    assert tsolve.STATS["pcg"] == [3, sum(its)]
    assert tsolve.STATS["bicgstab"] == [0, 0]
    assert dict(tsolve.STATS) == {"pcg": [3, sum(its)],
                                  "pcg_multi": [0, 0],
                                  "bicgstab": [0, 0]}
    tsolve.reset_stats()
    assert tsolve.STATS["pcg"] == [0, 0]


# ---- the Verlet rebuild as a cond ---------------------------------------

@functools.lru_cache(maxsize=1)
def _bed():
    """A JAX bed after setup and 3 substeps: a filled table with shear
    history."""
    jc, _ = _cfgs()
    st = _particles(jc, seed=5, vscale=2.0)
    st = jax.jit(lambda s: jint.run_dem(jint.setup_forces(s, jc), jc, 3))(st)
    assert float(jnp.abs(st.shear).max()) > 0.0
    return st


@pytest.mark.parametrize("sort", [False, True])
@pytest.mark.parametrize("moved", [False, True])
def test_rebuild_cond_matches_reference(moved, sort):
    """The bed's positions moved by less (no rebuild) or more (rebuild)
    than half the skin."""
    jc, tc = _cfgs()
    jc = dataclasses.replace(jc, sort_on_rebuild=sort)
    tc = dataclasses.replace(tc, sort_on_rebuild=sort)
    st = _bed()
    shift = (0.6 if moved else 0.1) * jc.skin
    st = st._replace(pos=st.pos + jnp.asarray([shift, 0.0, 0.0]))
    ref = jint.maybe_rebuild_neighbors(st, jc)
    assert bool(jnp.all(ref.pos_at_build == ref.pos)) == moved  # rebuilt
    tst = particles_to_torch(st)
    got = tint.maybe_rebuild_neighbors(tst, tc)
    with graphs.host_reads_forbidden():
        gph = tint.maybe_rebuild_neighbors(
            graphs.tree_map(torch.clone, tst), tc)
    r = bridge.tree_to_numpy(ref)
    for out in (got, gph):
        o = bridge.tree_to_numpy(out)
        np.testing.assert_array_equal(r["nbr_idx"], o["nbr_idx"])
        np.testing.assert_array_equal(r["shear"], o["shear"])
        assert_tree_close(r, o, 0.0)


# ---- injection and deletion as conds ------------------------------------

def test_inject_steps_match_reference():
    """Three coupled steps of the injection column (an add every second
    step, deletion at the top) from an f64 state whose countdown is due:
    the port eagerly and with host reads forbidden against the JAX
    package."""
    cfg_j, st = window_case(capacity=256)
    st = f64(st)
    st = st._replace(particles=st.particles._replace(
        time_to_add=jnp.asarray(0.0)))
    cfg_t = port_config(cfg_j)
    step_j = jax.jit(lambda s: jsolver.coupled_step(s, cfg_j))
    sj = st
    for _ in range(3):
        sj = step_j(sj)
    assert int(np.sum(np.asarray(sj.particles.active))) > \
        int(np.sum(np.asarray(st.particles.active)))        # adds fired
    ref = bridge.sim_state_to_numpy(sj)
    step_t = tsolver.CoupledStep(cfg_t, device="cpu")
    for graph_form in (False, True):
        s = bridge.sim_state_from_numpy(bridge.sim_state_to_numpy(st))
        syncs = tinj.SYNCS
        if graph_form:
            with graphs.warming():
                step_t(graphs.tree_map(torch.clone, s))
            syncs = tinj.SYNCS
            with graphs.host_reads_forbidden():
                for _ in range(3):
                    s = step_t(s)
        else:
            for _ in range(3):
                s = step_t(s)
        # the add's and the delete's conds: read on the host only here
        assert tinj.SYNCS - syncs == 3 * 3 * cfg_t.cloud.sub_cycles
        got = bridge.tree_to_numpy(s.particles)
        # an empty slot's drag is 0/0 in both packages
        nan = np.isnan(ref["particles"]["fdrag"])
        np.testing.assert_array_equal(nan, np.isnan(got["fdrag"]))
        got["fdrag"] = np.where(nan, 0.0, got["fdrag"])
        assert_tree_close(dict(ref["particles"], fdrag=np.where(
            nan, 0.0, ref["particles"]["fdrag"])), got, 1e-10)


# ---- whole coupled steps in the graph form ------------------------------

def _bench_case(sort=False):
    cfg = bench_case.build_config(n_particles=256, nx=8, ny=16, nz=8,
                                  backend="binned", sort_on_rebuild=sort)
    return (cfg,) + bench_case.build_state(cfg, 256, torch.float32, "cpu")


def _channel_case(tmp):
    case = cases.write_channel_case(tmp + "/c", counts=(14, 13, 6),
                                    layers=2, overlap=2e-6)
    cfg, fluid, particles, _ = load_case(case, backend="binned",
                                         dtype=torch.float32, device="cpu")
    return semi_implicit(cfg), fluid, particles


@pytest.mark.parametrize("which,steps", [("bench", 3), ("bench_sorted", 3),
                                         ("channel", 2)])
def test_coupled_step_graph_form_is_eager_step(which, steps, tmp_path):
    """Steps with no host read but the conds' and loops' own equal the
    eager steps bit for bit, and the solvers ran inside them."""
    make = {"bench": lambda _: _bench_case(),
            "bench_sorted": lambda _: _bench_case(True),
            "channel": _channel_case}[which]
    cfg, fluid, particles = make(str(tmp_path))
    step = tsolver.CoupledStep(cfg, dtype=torch.float32, device="cpu")
    s0 = step.initialize(fluid, particles)
    with graphs.warming():
        s0 = step(s0)
    eager = s0
    tsolve.reset_stats()
    for _ in range(steps):
        eager = step(eager)
    stats = dict(tsolve.STATS)
    tsolve.reset_stats()
    g = graphs.tree_map(torch.clone, s0)
    with graphs.host_reads_forbidden():
        for _ in range(steps):
            g = step(g)
    assert dict(tsolve.STATS) == stats and stats["pcg"][1] > 0
    a, b = graphs.flatten(eager), graphs.flatten(g)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y) or (x.is_floating_point() and torch.equal(
            torch.nan_to_num(x, nan=7.0), torch.nan_to_num(y, nan=7.0)))


# ---- the helpers --------------------------------------------------------

def test_assign_respects_aliases():
    a = torch.arange(4.0)
    b = torch.zeros(4)
    # the body swaps two carried tensors: each source is the other's
    # destination, and must be read before it is overwritten
    graphs.assign((a, b), (b, a))
    assert a.tolist() == [0.0] * 4 and b.tolist() == [0.0, 1.0, 2.0, 3.0]
    with pytest.raises(ValueError):
        graphs.assign((torch.zeros(2),), (torch.zeros(3),))


def test_warming_runs_a_while_body_the_loop_skips():
    """A loop whose condition is false at entry (a solve that starts
    converged, as the pressure of an x-invariant channel does) runs no
    body eagerly; in warming() its body runs once, on a copy, as a
    capture captures it (its first-use caches filled before the
    capture), and the carry comes back as it was."""
    ran = []

    def body(c):
        ran.append(1)
        return (c[0] + 1, c[1] * 2)

    carry = (torch.tensor(5), torch.tensor([1.0, 2.0]))
    out = graphs.while_loop(lambda c: c[0] < 5, body, carry)
    assert not ran and out[0] is carry[0]
    with graphs.warming():
        out = graphs.while_loop(lambda c: c[0] < 5, body, carry)
    assert ran == [1] and out[0] is carry[0] and out[1] is carry[1]
    assert int(carry[0]) == 5 and carry[1].tolist() == [1.0, 2.0]
    ran.clear()
    with graphs.warming():
        out = graphs.while_loop(lambda c: c[0] < 7, body, carry)
    assert ran == [1, 1] and int(out[0]) == 7      # no extra body


def test_cond_and_while_loop_forms():
    """Functional in both forms, the predicate read on the host; in
    warming() the branch not taken runs on a copy; other host reads
    raise under host_reads_forbidden."""
    x = torch.tensor([1.0, 2.0])
    out = graphs.cond(torch.tensor(True), lambda c: (c[0] * 2,), (x,))
    assert out[0].tolist() == [2.0, 4.0] and x.tolist() == [1.0, 2.0]
    ran = []
    with graphs.warming():
        out = graphs.cond(torch.tensor(False),
                          lambda c: ran.append(1) or (c[0] + 1,), (x,))
    assert ran and out[0] is x
    carry = (torch.tensor(0), torch.tensor(1))
    with graphs.host_reads_forbidden():
        out = graphs.cond(x.sum() > 0, lambda c: (c[0] * 2,), (x,))
        n, k = graphs.while_loop(lambda c: c[0] < 5,
                                 lambda c: (c[0] + 1, c[1] * 2), carry)
    assert out[0].tolist() == [2.0, 4.0] and x.tolist() == [1.0, 2.0]
    assert int(n) == 5 and int(k) == 32
    for bad in (lambda: float(x.sum()), lambda: x[x > 0],
                lambda: torch.tensor([1.0]), lambda: x.nonzero()):
        with graphs.host_reads_forbidden(), \
                pytest.raises(graphs.HostRead):
            bad()
    assert not graphs.capturing()
