"""A rank job for tests/test_torch_parallel_fluid.py (JAX-free: every
spawned rank imports this module): each stencil operator of ops.py,
linop.py and fluid/piso.py, the FastDiag solves and the PCG and BiCGStab
solvers on this rank's x-slab of a grid, joined over the ranks, against
the same call on the whole grid.

    run_ranks(slab_ops_job, ranks, args=(seed,), device="cpu")

returns, on rank 0, {grid kind: {operation: whether the joined slabs
equal the whole call bit for bit}} and, under "iterations", the
iteration counts of the solves both ways. Two grids: uniform with
cyclic x and z, and graded along all three axes with x walls
(fixedValue, inletOutlet and zeroGradient patches on the x ends).
`shape` and `dtype` (by default 8 x 6 x 5, float64) size the fields;
they lie on the mesh's device (chip_smoke.py runs the job on the card
to name the operations that part there).
"""

from __future__ import annotations

import numpy as np
import torch

from sedifoam_tpu_torch import bc as _bc
from sedifoam_tpu_torch import fastsolve, linop, linsolve, ops
from sedifoam_tpu_torch.fluid import piso
from sedifoam_tpu_torch.grid import FaceField, Grid
from sedifoam_tpu_torch.parallel.comm import Comm

SHAPE = (8, 6, 5)


def grids(shape=SHAPE):
    """{kind: (Grid, scalar FieldBC, vector FieldBC)}."""
    NX, NY, NZ = shape
    uniform = Grid(nx=NX, ny=NY, nz=NZ, dx=0.1, dy=0.05, dz=0.08)
    cyc = _bc.PatchBC(_bc.CYCLIC)
    wall = _bc.PatchBC(_bc.FIXED_VALUE, (0.0, 0.0, 0.0))
    sbc_u = _bc.FieldBC(xm=cyc, xp=cyc, ym=_bc.PatchBC(_bc.FIXED_VALUE,
                                                      (1.5,)),
                        yp=_bc.PatchBC(_bc.ZERO_GRADIENT), zm=cyc, zp=cyc)
    vbc_u = _bc.FieldBC(xm=cyc, xp=cyc, ym=wall, yp=_bc.PatchBC(_bc.SLIP),
                        zm=cyc, zp=cyc)

    def geo(n, r):
        w = r ** np.arange(n)
        return np.concatenate([[0.0], np.cumsum(w / w.sum())])
    graded = Grid.from_faces(geo(NX, 1.3), 0.5 * geo(NY, 0.8),
                             0.3 * geo(NZ, 1.1))
    sbc_g = _bc.FieldBC(
        xm=_bc.PatchBC(_bc.FIXED_VALUE, (0.7,)),
        xp=_bc.PatchBC(_bc.INLET_OUTLET, (0.2,)),
        ym=_bc.PatchBC(_bc.ZERO_GRADIENT), yp=_bc.PatchBC(_bc.FIXED_VALUE,
                                                          (0.1,)),
        zm=_bc.PatchBC(_bc.EMPTY), zp=_bc.PatchBC(_bc.EMPTY))
    vbc_g = _bc.FieldBC(
        xm=_bc.PatchBC(_bc.FIXED_VALUE, (0.3, 0.0, 0.1)),
        xp=_bc.PatchBC(_bc.ZERO_GRADIENT), ym=wall, yp=_bc.PatchBC(_bc.SLIP),
        zm=_bc.PatchBC(_bc.ZERO_GRADIENT), zp=_bc.PatchBC(_bc.ZERO_GRADIENT))
    return {"uniform-cyclic": (uniform, sbc_u, vbc_u),
            "graded": (graded, sbc_g, vbc_g)}


def _fields(grid, seed, dtype, device):
    rng = np.random.RandomState(seed)

    def t(*shape, positive=False):
        x = 0.5 + rng.rand(*shape) if positive else \
            rng.standard_normal(shape)
        return torch.as_tensor(x, dtype=dtype, device=device)
    n = grid.shape
    faces = [(n[0] + 1, n[1], n[2]), (n[0], n[1] + 1, n[2]),
             (n[0], n[1], n[2] + 1)]
    return {"c": t(*n), "v": t(3, *n), "x": t(*n),
            "pos": t(*n, positive=True),
            "phi": FaceField(*(t(*s) for s in faces)),
            "gamma": FaceField(*(t(*s, positive=True) for s in faces)),
            "b": t(*n), "b4": t(4, *n)}


def _cut(value, g):
    """This slab's part of a whole-grid value (tensors along grid-x)."""
    x0, n = g.x_start, g.nx
    if isinstance(value, FaceField):
        return FaceField(value.x[x0:x0 + n + 1], value.y[x0:x0 + n],
                         value.z[x0:x0 + n])
    return value[..., x0:x0 + n, :, :]


def _join(value, g, comm):
    """The whole-grid value from the slabs' parts."""
    if isinstance(value, FaceField):
        parts = comm.gather_planes(value.x.contiguous())
        x = torch.cat([q[:g.nx] for q in parts[:-1]] + [parts[-1]])
        return FaceField(x, g.join(value.y.contiguous()),
                         g.join(value.z.contiguous()))
    if isinstance(value, torch.Tensor) and value.ndim >= 3:
        return g.join(value.contiguous())
    return value


def _operations(f, sbc, vbc):
    """{name: fn(grid, fields) -> tensor or FaceField}."""
    t = 0.0

    def central(f):
        return FaceField(*(torch.full_like(p, 0.5) for p in f["phi"]))
    return {
        "face_interp": lambda g, f: ops.face_interp(f["c"], g, sbc, f["phi"]),
        "sn_grad": lambda g, f: ops.sn_grad(f["c"], g, sbc, f["phi"], t),
        "grad": lambda g, f: ops.grad(f["c"], g, sbc),
        "grad_vec": lambda g, f: ops.grad_vec(f["v"], g, vbc),
        "curl": lambda g, f: ops.curl(f["v"], g, vbc),
        "div_flux": lambda g, f: ops.div_flux(f["phi"], g),
        "div_flux_field": lambda g, f: ops.div_flux_field(
            f["phi"], ops.face_interp(f["c"], g, sbc), g),
        "ops.laplacian": lambda g, f: ops.laplacian(f["gamma"], f["c"], g,
                                                    sbc),
        "flux_of": lambda g, f: ops.flux_of(f["v"], g, vbc, f["phi"]),
        "average_to_cells": lambda g, f: ops.average_to_cells(
            f["gamma"], g, sbc),
        "limited_weights": lambda g, f: ops.limited_weights(
            f["c"], g, sbc, f["phi"]),
        "limited_weights_vec": lambda g, f: ops.limited_weights_vec(
            f["v"], g, vbc, f["phi"]),
        "weighted_face_value": lambda g, f: ops.weighted_face_value(
            f["c"], ops.limited_weights(f["c"], g, sbc, f["phi"]), g, sbc,
            f["phi"]),
        "linop.div diag": lambda g, f: linop.div(f["phi"], f["c"], g, sbc,
                                                 None).diag,
        "linop.div rhs": lambda g, f: linop.div(f["phi"], f["c"], g,
                                                vbc.component(0), None).rhs,
        "linop.div apply": lambda g, f: linop.div(
            f["phi"], f["c"], g, sbc,
            ops.limited_weights(f["c"], g, sbc, f["phi"])).apply(f["x"]),
        "linop.div apply central": lambda g, f: linop.div(
            f["phi"], f["c"], g, vbc.component(1), central(f)).apply(
                f["x"]),
        "linop.laplacian diag": lambda g, f: linop.laplacian(
            f["gamma"], g, sbc, f["phi"]).diag,
        "linop.laplacian rhs": lambda g, f: linop.laplacian(
            f["gamma"], g, sbc, f["phi"]).rhs,
        "linop.laplacian apply": lambda g, f: linop.laplacian(
            f["gamma"], g, sbc).apply(f["x"]),
        "laplacian_flux": lambda g, f: linop.laplacian_flux(
            f["gamma"], f["c"], g, sbc),
        "A and H": lambda g, f: _momentum(g, f, sbc),
        "div_tensor": lambda g, f: piso.div_tensor(
            piso.dev2_T_grad(f["v"], f["pos"], g, vbc), g),
        "reconstruct": lambda g, f: piso.reconstruct(f["phi"], g),
    }


def _momentum(g, f, sbc):
    term = (linop.ddt(f["c"], 1e-3, g, coeff=f["pos"])
            + linop.div(f["phi"], f["c"], g, sbc, None)
            - linop.laplacian(f["gamma"], g, sbc)
            + linop.Sp(f["pos"], g) + linop.source(f["b"], g))
    term = term.relax(f["c"], 0.7)
    return torch.stack([term.A(g), term.H(f["x"], g)])


def _equal(a, b):
    if isinstance(a, FaceField):
        return all(torch.equal(p, q) for p, q in zip(a, b))
    return torch.equal(a, b)


def _solves(g, f, sbc, kinds):
    """The FastDiag solves, PCG on a Poisson operator and BiCGStab on a
    convection-diffusion one: (results, iteration counts)."""
    like = f["b"]
    fd = fastsolve.FastDiag(g, (1.0, 0.5, 2.0), kinds, like.dtype,
                            like.device)
    pre = fastsolve.pressure_preconditioner(g, sbc, like.dtype, like.device)
    lap = linop.laplacian(f["gamma"], g, sbc)
    hom = linop._homogeneous(sbc)
    inv_vol = g.geom("inv_cell_volume", lambda: 1.0 / g.cell_volume,
                     f["b"].dtype, f["b"].device)
    b = f["b"] * g.cell_volume_like(f["b"])
    sol_p = linsolve.pcg(lap.apply, b, torch.zeros_like(b), lap.diag,
                         tol=1e-12, max_iter=200, grid=g,
                         precond=lambda r: -pre.solve(r * inv_vol, 0.0,
                                                      project_null=True))
    conv = (linop.ddt(f["c"], 1e-2, g)
            + linop.div(f["phi"], f["c"], g, hom, None)
            - linop.laplacian(f["gamma"], g, hom))
    sol_b = linsolve.bicgstab(conv.apply, conv.rhs + f["b"], f["c"],
                              conv.diag, tol=1e-12, max_iter=200, grid=g)
    lap_h = linop.laplacian(f["gamma"], g, hom)
    multi = linsolve.pcg_multi(lambda x: 50.0 * x - lap_h.apply(x),
                               f["b4"][:3], torch.zeros_like(f["b4"][:3]),
                               50.0 - lap_h.diag, tol=1e-12, max_iter=200,
                               grid=g)
    out = {"FastDiag.solve": fd.solve(f["b4"], 3.0),
           "FastDiag.solve project_null": pre.solve(f["b"], 0.0,
                                                    project_null=True),
           "FastDiag.solve_pow": fd.solve_pow(f["b4"], 7.0, 5),
           "pcg": sol_p.x, "bicgstab": sol_b.x, "pcg_multi": multi.x,
           "grid.total": torch.stack([g.total(f["b"]), g.mean(f["b"])]),
           "grid.mean x faces": g.mean(f["phi"].x, x_faces=True)}
    its = {"pcg": int(sol_p.n_iterations),
           "bicgstab": int(sol_b.n_iterations),
           "pcg_multi": int(multi.n_iterations)}
    return out, its


def slab_ops_job(mesh, seed, shape=SHAPE, dtype=torch.float64):
    """The rank job (module docstring)."""
    comm = Comm()
    result = {}
    for kind, (grid, sbc, vbc) in grids(shape).items():
        f = _fields(grid, seed, dtype, mesh.device)
        n = grid.nx // comm.ranks
        slab = grid.slab(comm.rank * n, n, comm)
        mine = {k: _cut(v, slab) for k, v in f.items()}
        ok = {}
        for name, fn in _operations(f, sbc, vbc).items():
            ok[name] = _equal(fn(grid, f), _join(fn(slab, mine), slab, comm))
        kinds = ((("periodic", "periodic"), ("dirichlet", "neumann"),
                  ("periodic", "periodic")) if kind == "uniform-cyclic"
                 else (("neumann", "dirichlet"), ("dirichlet", "neumann"),
                       ("neumann", "neumann")))
        whole, its_w = _solves(grid, f, sbc, kinds)
        part, its_s = _solves(slab, mine, sbc, kinds)
        for name in whole:
            got = part[name]
            if got.ndim >= 3:
                got = slab.join(got.contiguous())
            ok[name] = torch.equal(whole[name], got)
        ok["iterations"] = (its_w, its_s)
        result[kind] = ok
    result["bytes"] = dict(comm.bytes)
    return result
