"""The coupled step split over the ranks of a mesh (parallel/mesh.py).

What GSPMD derives for the JAX package from its placement, written out
by hand: each rank steps its own block of particle rows, and the fluid
is whole on every rank.

- The fluid step runs on every rank alike (the same code as
  solver.coupled_step, on the same fields: the same bits).
- The DEM: each substep's drift and kicks are per row; before each
  force evaluation pos, vel and omega are gathered from the ranks, and
  the contact chain (the kernel on the card) takes the own rows against
  partners in all rows; the rebuild test takes the largest displacement
  over the ranks; a rebuild gathers the whole particle state, rebuilds
  (and sorts) it on every rank alike and cuts the own block out again
  (dem/integrate.py).
- Particle to grid: each rank scatters its rows into a partial grid;
  the partials are summed over the ranks (coupling/transfer.py). Grid to
  particle needs no exchange.

The step is eager: capturing it as one CUDA graph needs the collectives
inside the capture, which NCCL can give and gloo cannot (ROADMAP).
"""

from __future__ import annotations

import collections
import time

import torch
from torch import nn

from sedifoam_tpu_torch import bridge
from sedifoam_tpu_torch.dem import fused
from sedifoam_tpu_torch.parallel.comm import Comm
from sedifoam_tpu_torch.parallel.mesh import Mesh, Shard, gather_state, \
    shard_state
from sedifoam_tpu_torch.solver import CoupledStep, SimConfig, SimState, \
    coupled_step


def check_supported(cfg: SimConfig, particles=None) -> None:
    """Raise NotImplementedError, naming it, for each combination the
    split step does not cover yet (each is queued in ROADMAP.md; the JAX
    package reaches them through GSPMD)."""
    from sedifoam_tpu_torch.dem.fused import walls_fusible
    d, c = cfg.dem, cfg.cloud
    missing = []
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
    coupled step. Every rank calls it at once. The constant operators
    are CoupledStep's, built on mesh.device; `comm` counts the bytes the
    step's collectives return."""

    def __init__(self, cfg: SimConfig, mesh: Mesh, dtype=torch.float64):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.mesh = mesh
        self.step = CoupledStep(cfg, dtype, mesh.device)
        self.comm = Comm()

    def forward(self, local: SimState) -> SimState:
        check_supported(self.cfg, local.particles)
        shard = Shard(self.comm, local.particles)
        return coupled_step(local, self.cfg, self.step.smoother,
                            self.step.pprecond, shard)


# the DEM tables whose bytes run_steps reports per rank
TABLES = ("nbr_idx", "shear", "wall_shear", "pos")


def run_steps(mesh: Mesh, cfg: SimConfig, state_np: dict, n_steps: int,
              keep=None) -> dict:
    """A rank's job (parallel/launch.run_ranks): the whole state state_np
    (a bridge.sim_state_to_numpy dict) cut to this rank's block, then
    n_steps steps of ShardedStep. Returns, for this rank: the bytes of
    its own TABLES, the tags of its rows before and after, per step the
    wall milliseconds (synchronized on a card) and the bytes its
    collectives returned by kind, the kernel's launches in the steps by
    the rows each computed, and (rank 0) the whole state gathered after
    each step in `keep` (all when None), by step number."""
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
