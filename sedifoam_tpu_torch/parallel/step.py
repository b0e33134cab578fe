"""The coupled step split over the ranks of a mesh (parallel/mesh.py).

What GSPMD derives for the JAX package from its placement, written out
by hand: each rank steps its own block of particle rows, and its own
x-slab of the fluid where grid-x divides by the ranks (else the whole
fluid on every rank, alike: `fluid_layout`).

- The fluid on a slab (grid.SlabGrid; the same code as
  solver.coupled_step, given the slab's grid): the stencils read one
  ghost plane from each x-neighbour (the processor patch, ops.py,
  linop.py), every global reduction sums plane partials gathered from
  the ranks in x order (grid.Grid.total: the dots and norms of PCG and
  BiCGStab, the means, the Ubar forcing), the FastDiag x transform runs
  between two all-to-alls (fastsolve.py), the pressure reference value
  comes from its owner. The fields on x faces stay whole in the state:
  the step cuts its slab's faces out and gathers them back at its end.
  On the CPU the step equals one process's bit for bit at any number of
  ranks.
- The DEM: each substep's drift and kicks are per row; before each
  force evaluation pos, vel and omega are gathered from the ranks, and
  the contact chain (the kernel on the card) takes the own rows against
  partners in all rows; the rebuild test takes the largest displacement
  over the ranks; a rebuild gathers the whole particle state, rebuilds
  (and sorts) it on every rank alike and cuts the own block out again
  (dem/integrate.py).
- Particle to grid: with the fluid whole, each rank scatters its rows
  into a partial grid and the partials are summed over the ranks; with
  slabs, the rows go to the rank whose slab holds their cell and are
  scattered there in their global order (coupling/transfer.py). Grid to
  particle reads the fields of the whole domain: gathered from the slabs
  (an all-gather of the fields it reads), none with the fluid whole.

The step is eager: capturing it as one CUDA graph needs the collectives
inside the capture, which NCCL can give and gloo cannot (ROADMAP).
"""

from __future__ import annotations

import collections
import dataclasses
import time

import torch
from torch import nn

from sedifoam_tpu_torch import bridge
from sedifoam_tpu_torch.dem import fused
from sedifoam_tpu_torch.parallel.comm import Comm
from sedifoam_tpu_torch.parallel.mesh import Mesh, Shard, fluid_layout, \
    gather_state, shard_state
from sedifoam_tpu_torch.solver import CoupledStep, SimConfig, SimState, \
    coupled_step


def check_supported(cfg: SimConfig, particles=None, ranks=None) -> None:
    """Raise NotImplementedError, naming it, for each combination the
    split step does not cover yet (each is queued in ROADMAP.md; the JAX
    package reaches them through GSPMD). `ranks`: where the fluid splits
    over them, the fluid's too."""
    from sedifoam_tpu_torch.bc import PATCHES, RegionPatchBC
    from sedifoam_tpu_torch.dem.fused import walls_fusible
    d, c = cfg.dem, cfg.cloud
    missing = []
    if ranks is not None and fluid_layout(cfg.grid.nx, ranks) == "slab":
        if any(isinstance(f.patch(p), RegionPatchBC)
               for f in cfg.bcs for p in PATCHES):
            missing.append("region patches (RegionPatchBC) on a fluid split "
                           "along x")
        if cfg.fluid.add_dns_force:
            missing.append("the DNS forcing on a fluid split along x")
    if d.backend == "lattice":
        missing.append("the lattice backend")
    if d.cohesion is not None:
        missing.append("cohesion")
    if d.lubrication is not None:
        missing.append("lubrication")
    if c.add_particle > 0 or c.delete_particle > 0:
        missing.append("injection and deletion (add_particle, "
                       "delete_particle)")
    if not walls_fusible(d.walls):
        missing.append("walls the contact kernel cannot fuse (cylinder, "
                       "wiggle, shear)")
    if particles is not None and particles.rigid is not None:
        missing.append("rigid clumps")
    if missing:
        raise NotImplementedError("ShardedStep does not split "
                                  + ", ".join(missing) + " over ranks yet")


class ShardedStep(nn.Module):
    """solver.CoupledStep split over `mesh`: forward(local) takes this
    rank's SimState (parallel/mesh.shard_state) and returns it after one
    coupled step. Every rank calls it at once. `fluid` is the fluid's
    layout ("slab" or "whole"); `grid` the rank's (its slab, or the
    whole grid). The constant operators are CoupledStep's, built once on
    the rank's grid and mesh.device (the FastDiag buffers of the
    smoothing and the pressure preconditioner: the whole grid's
    transforms, the slab's eigenvalues); `comm` counts the bytes the
    step's collectives return."""

    def __init__(self, cfg: SimConfig, mesh: Mesh, dtype=torch.float64):
        super().__init__()
        check_supported(cfg, ranks=mesh.ranks)
        self.cfg = cfg
        self.mesh = mesh
        self.comm = Comm()
        self.fluid = fluid_layout(cfg.grid.nx, mesh.ranks)
        local = cfg
        if self.fluid == "slab":
            n = cfg.grid.nx // mesh.ranks
            local = dataclasses.replace(cfg, grid=cfg.grid.slab(
                mesh.rank * n, n, self.comm))
        self.local_cfg = local
        self.grid = local.grid
        self.step = CoupledStep(local, dtype, mesh.device)

    def forward(self, local: SimState) -> SimState:
        check_supported(self.cfg, local.particles)
        shard = Shard(self.comm, local.particles)
        if self.fluid == "whole":
            return coupled_step(local, self.cfg, self.step.smoother,
                                self.step.pprecond, shard)
        whole = local.fluid
        faces = ("phia", "phib", "phi", "phia_old", "phib_old")
        out = coupled_step(
            local._replace(fluid=whole._replace(**{
                k: self._cut_x(getattr(whole, k)) for k in faces})),
            self.local_cfg, self.step.smoother, self.step.pprecond, shard)
        fluid = out.fluid._replace(
            phia_old=whole.phia, phib_old=whole.phib,
            **{k: self._join_x(getattr(out.fluid, k))
               for k in ("phia", "phib", "phi")})
        return out._replace(fluid=fluid)

    def _cut_x(self, f):
        """The slab's faces of a face field whose x faces are whole."""
        g = self.grid
        return f._replace(x=f.x[g.x_start:g.x_start + g.nx + 1])

    def _join_x(self, f):
        """The whole x faces of a slab's face field; a seam's face from
        the slab above it (both hold it alike)."""
        if self.comm.ranks == 1:
            return f
        parts = self.comm.gather_planes(f.x)
        n = self.grid.nx
        return f._replace(x=torch.cat([q[:n] for q in parts[:-1]]
                                      + [parts[-1]]))


# the DEM tables and the fluid fields whose bytes run_steps reports per
# rank
TABLES = ("nbr_idx", "shear", "wall_shear", "pos")
FIELDS = ("p", "Ub", "alpha")


def run_steps(mesh: Mesh, cfg: SimConfig, state_np: dict, n_steps: int,
              keep=None) -> dict:
    """A rank's job (parallel/launch.run_ranks): the whole state state_np
    (a bridge.sim_state_to_numpy dict) cut to this rank's block, then
    n_steps steps of ShardedStep. Returns, for this rank: the bytes of
    its own TABLES and FIELDS, the fluid's layout ("slab" or "whole"),
    the tags of its rows before and after, per step the wall
    milliseconds (synchronized on a card) and the bytes its collectives
    returned by kind, the kernel's launches in the steps by the rows
    each computed, and (rank 0) the whole state gathered after each step
    in `keep` (all when None), by step number."""
    local = shard_state(bridge.sim_state_from_numpy(state_np,
                                                    device=mesh.device),
                        mesh)
    step = ShardedStep(cfg, mesh, local.particles.pos.dtype)
    sync = torch.cuda.synchronize if mesh.device.type == "cuda" \
        else (lambda: None)
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "backend": step.comm.backend,
           "tables": {k: getattr(local.particles, k).numel()
                      * getattr(local.particles, k).element_size()
                      for k in TABLES},
           "fluid": step.fluid,
           "fields": {k: getattr(local.fluid, k).numel()
                      * getattr(local.fluid, k).element_size()
                      for k in FIELDS},
           "tags_before": local.particles.tag.cpu().numpy(),
           "ms": [], "comm": [], "states": {},
           "launch_sizes": collections.Counter()}
    for i in range(1, n_steps + 1):
        bytes0, sizes0 = dict(step.comm.bytes), fused.launch_sizes()
        sync()
        t0 = time.perf_counter()
        local = step(local)
        sync()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launch_sizes"] += fused.launch_sizes() - sizes0
        out["comm"].append({k: v - bytes0.get(k, 0)
                            for k, v in step.comm.bytes.items()})
        if keep is None or i in keep:
            whole = gather_state(local, mesh, step.comm)
            if mesh.rank == 0:
                out["states"][i] = bridge.sim_state_to_numpy(whole)
    out["launch_sizes"] = dict(out["launch_sizes"])
    out["launches"] = sum(out["launch_sizes"].values())
    out["tags_after"] = local.particles.tag.cpu().numpy()
    return out
