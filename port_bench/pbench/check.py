"""The comparison that decides `correct`: what the program produced,
held against the plain reference (`pbref`), number by number against
the cell's limits.

Three checks, each giving the same numbers:

- start: the program's state after `initialize` against the reference's
  own load and `initialize` of the same inputs;
- first_visit: the program's state after its first host visit (set-up,
  through Simulation.run on the captured step) against the reference's
  as many steps from its own start;
- check_visit: the window's visit that the cell's traffic names. The
  reference starts from the program's state before that visit (the
  window copies it on the device), works the neighbor table out again
  from the positions, carrying the contact history over, and takes the
  visit's steps; contacts grow round-off, so no reference can follow
  the program over a whole window. The visit is fixed, not the window's
  last, so that a faster program is checked at the same simulated time.

The numbers, each the worst relative gap over its fields (particle
fields on active rows) in the norm NUMBERS gives it: ||got - ref|| /
||ref|| ("l2") or max|got - ref| / max|ref| ("max"):

- fluid: p, Ub, and k and nut where the reference's are not all zero;
- coupling: alpha, alpha*Ua, the smoothed fluid velocity, the drag
  source Asrc and the implicit drag coefficient where not all zero;
- dem: pos (against the largest displacement of the step's span), vel,
  omega;
- history: the contact history by (particle, partner) pair, whatever
  slot either table keeps it in, and the wall history;
- force: the particles' total force.

`numbers` takes the worst of the three checks for each; a cell compares
the numbers its limits file lists.
"""

from __future__ import annotations

import importlib

import torch

from pbench.tree import rebuild, to_host

# each number's norm (see _gaps). Every number is compared over all its
# cells, contacts and rows: the widest gap is set by a single threshold
# event, a contact that opens or closes a substep apart or a particle on
# a cell face, which two sound float32 runs part on now and then by as
# much as a lower precision does
NUMBERS = {"fluid": "l2", "coupling": "l2", "dem": "l2", "history": "l2",
           "force": "l2"}
TINY = 1e-30


def _gaps(got, ref, scale=None):
    """(max|got - ref| / max|ref|, ||got - ref||_2 / ||ref||_2); with
    `scale`, both over that scale (times the root of the count, for the
    second). A non-finite difference reads as infinite."""
    got, ref = got.double().reshape(-1), ref.double().reshape(-1)
    d = torch.nan_to_num((got - ref).abs(), nan=float("inf"))
    if not d.numel() or not bool(torch.any(d != 0)):
        return 0.0, 0.0
    if scale is None:
        s_max, s_l2 = float(ref.abs().max()), float(ref.norm())
    else:
        s_max, s_l2 = scale, scale * d.numel() ** 0.5
    return (float(d.max()) / max(s_max, TINY),
            float(d.norm()) / max(s_l2, TINY))


def _nonzero(t) -> bool:
    return bool(torch.any(t != 0))


def _pairs(ps):
    """(keys i*N + j, (M, 3) history) of every valid slot of an active
    particle whose history is not zero."""
    idx = ps.nbr_idx.long()
    K, N = idx.shape
    i = torch.arange(N).expand(K, N)
    valid = (idx >= 0) & (idx < N) & ps.active[None, :]
    vals = ps.shear[:, valid].T.double()
    keys = (i * N + idx)[valid]
    keep = vals.abs().sum(1) > 0
    return keys[keep], vals[keep]


def _by_pair(got, ref):
    """The two states' contact histories on the union of their (particle,
    partner) pairs, zero where a table holds none."""
    kg, vg = _pairs(got)
    kr, vr = _pairs(ref)
    keys = torch.cat([kg, kr]).unique()
    G = torch.zeros(len(keys), 3, dtype=torch.float64)
    R = torch.zeros(len(keys), 3, dtype=torch.float64)
    G[torch.searchsorted(keys, kg)] = vg
    R[torch.searchsorted(keys, kr)] = vr
    return G, R


def compare(got, ref, start=None) -> dict:
    """{number: {norm: (gap, worst field)}} of two host states, for the
    norms "max" and "l2" (see _gaps); `start` is the state the span of
    steps started from (None at the start check)."""
    gf, rf = got.fluid, ref.fluid
    gp, rp = got.particles, ref.particles
    act = rp.active
    out = {}

    def worst(name, fields):
        best = {"max": (0.0, ""), "l2": (0.0, "")}
        for label, g, r, *scale in fields:
            for norm, e in zip(("max", "l2"), _gaps(g, r, *scale)):
                if e > best[norm][0] or not best[norm][1]:
                    best[norm] = (e, label)
        out[name] = best

    fluid = [("p", gf.p, rf.p), ("Ub", gf.Ub, rf.Ub)]
    fluid += [(k, getattr(gf, k), getattr(rf, k)) for k in ("k", "nut")
              if _nonzero(getattr(rf, k))]
    worst("fluid", fluid)
    coupling = [("alpha", gf.alpha, rf.alpha),
                ("alpha*Ua", gf.alpha * gf.Ua, rf.alpha * rf.Ua),
                ("uf_smoothed", got.uf_smoothed, ref.uf_smoothed),
                ("Asrc", gf.Asrc, rf.Asrc)]
    if _nonzero(rf.drag_coef):
        coupling.append(("drag_coef", gf.drag_coef, rf.drag_coef))
    worst("coupling", coupling)
    moved = 0.0 if start is None else float(
        (rp.pos[act].double() - start.particles.pos[act].double())
        .abs().max())
    worst("dem", [("pos", gp.pos[act], rp.pos[act], moved),
                  ("vel", gp.vel[act], rp.vel[act]),
                  ("omega", gp.omega[act], rp.omega[act])])
    worst("history", [("shear", *_by_pair(gp, rp)),
                      ("wall_shear", gp.wall_shear[:, :, act],
                       rp.wall_shear[:, :, act])])
    worst("force", [("force", gp.force[act], rp.force[act])])
    return out


def precision(tf32: bool) -> None:
    """TF32 on or off for float32 matrix products (the control's
    precision, or the configuration's)."""
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")


class Reference:
    """The reference's own case, built from the same inputs, and its
    eager step; `tf32` computes it in TF32 (the control)."""

    def __init__(self, case, spec, inp, device, tf32=False):
        self.solver = importlib.import_module("pbref.solver")
        self.integrate = importlib.import_module("pbref.dem.integrate")
        self.tf32 = tf32
        self.device = device
        precision(tf32)
        try:
            cfg, fluid, particles = case.load("pbref", spec, inp, device)
            self.cfg = cfg
            self.step = self.solver.CoupledStep(cfg, fluid.p.dtype, device)
            self.start = self.step.initialize(fluid, particles)
        finally:
            precision(False)

    def advance(self, state, n):
        precision(self.tf32)
        try:
            for _ in range(n):
                state = self.step(state)
        finally:
            precision(False)
        return state

    def from_program(self, host_state):
        """The program's state as the reference's, its neighbor table
        worked out again from the positions (history carried over)."""
        st = rebuild(host_state, "pbref", self.device)
        precision(self.tf32)
        try:
            ps = self.integrate.maybe_rebuild_neighbors(
                st.particles, self.cfg.dem, force=True)
        finally:
            precision(False)
        return st._replace(particles=ps)


def reference_states(ref: Reference, steps: int, before_check_host):
    """The reference's (start, first visit, checked visit) on the host:
    its own start, `steps` steps from it, and `steps` steps from the
    program's state before the window's checked visit."""
    start = to_host(ref.start)
    first = to_host(ref.advance(ref.start, steps))
    checked = to_host(ref.advance(ref.from_program(before_check_host),
                                  steps))
    return start, first, checked


def run_checks(got, ref, before_check_host) -> dict:
    """{check: compare(...)} of the three checks (see the module's
    docstring); `got` and `ref` are (start, first visit, checked
    visit)."""
    return {"start": compare(got[0], ref[0]),
            "first_visit": compare(got[1], ref[1], ref[0]),
            "check_visit": compare(got[2], ref[2], before_check_host)}


def numbers(checks: dict, norms=None) -> dict:
    """The worst of the checks for each number, in its norm."""
    norms = norms or NUMBERS
    return {n: max(c[n][norm][0] for c in checks.values())
            for n, norm in norms.items()}
