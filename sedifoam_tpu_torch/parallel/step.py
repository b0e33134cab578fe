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
  BiCGStab, the means, the Ubar forcing), every FastDiag solve gathers
  its right-hand side and solves on the whole grid, alike on every rank
  (fastsolve.py), the pressure reference value comes from its owner.
  The fields on x faces stay whole in the state: the step cuts its
  slab's faces out and gathers them back at its end. The DNS forcing
  gathers its spectral planes and takes the whole inverse transform on
  every rank alike (fluid/step.py); a region patch (jetFlow's disc
  inlet) blends over the slab's faces of its mask.
- The DEM: each substep's drift and kicks are per row; before each
  force evaluation pos, vel and omega are gathered from the ranks, and
  the contact chain (the kernel on the card), cohesion and lubrication
  take the own rows against partners in all rows; the walls are per
  row; the rebuild test takes the largest displacement over the ranks;
  a rebuild gathers the whole particle state, rebuilds (and sorts) it
  on every rank alike and cuts the own block out again
  (dem/integrate.py). The lattice backend's table and history are
  whole on every rank, as GSPMD computes them: its force pass and
  rebuild run on the gathered rows, and each rank keeps its own rows.
  Rigid clumps: the bodies are whole on every rank and summed from the
  gathered member rows alike on every rank (dem/rigid.py).
- Injection and deletion (dem/inject.py): the countdown and the key are
  whole, so every rank takes an add alike; the add runs on the gathered
  state and each rank cuts its block out; whether the delete box
  removed anyone is the largest over the ranks.
- Particle to grid: with the fluid whole, each rank scatters its rows
  into a partial grid and the partials are summed over the ranks; with
  slabs, the rows go to the rank whose slab holds their cell and are
  scattered there in their global order (coupling/transfer.py). Grid to
  particle reads the fields of the whole domain: gathered from the slabs
  (an all-gather of the fields it reads), none with the fluid whole.

Every decision is taken alike on every rank, and every sum is one
process's sum in one process's order, so that on the CPU the split step
equals one process's bit for bit on every configuration CoupledStep
steps, at any number of ranks that divides the capacity.

No collective's shape depends on the data and nothing is read on the
host inside the step: its decisions are graphs.cond and
graphs.while_loop, and the arrays a branch changes ride its carry
(parallel/mesh.Shard.cond). So under NCCL `GraphedShardedStep` captures
the step as one CUDA graph per rank with its collectives inside, and
replays it with one launch a step, as solver.GraphedStep does the
one-process step (the JAX package jits the sharded step alike). Gloo
cannot be captured: over gloo the split step runs eagerly, its
decisions read on the host. Under NCCL, one rank a card, the step has
run eagerly and captured on 1, 2 and 4 ranks, every field bit for bit
with one process (tests/torch_port_measure_split_graph.py, chip_smoke.py
phase_sharded); its ranks run with NCCL's graph-mixing support off
(parallel/launch.NCCL_ENV), without which no collective can be captured
in a conditional node's body at two ranks or more.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import time
import warnings

import torch
from torch import nn

from sedifoam_tpu_torch import bridge, graphs, telemetry
from sedifoam_tpu_torch.dem import fused
from sedifoam_tpu_torch.parallel.comm import Comm, replay_launched
from sedifoam_tpu_torch.parallel.launch import NCCL_ENV
from sedifoam_tpu_torch.parallel.mesh import Mesh, Shard, fluid_layout, \
    gather_state, particle_axes, shard_state
from sedifoam_tpu_torch.solver import CoupledStep, SimConfig, SimState, \
    coupled_step


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


class GraphedShardedStep:
    """A ShardedStep captured as one CUDA graph on this rank, its NCCL
    collectives inside (graphs.StepGraph), and replayed once per call:
    step(local) -> this rank's state after one coupled step, the graph's
    own buffers, valid until the next call (a call on them steps them
    without a host copy). Every rank calls it at once. An eager
    collective of parallel/comm.Comm after a call waits for the replay
    to end (comm.replay_launched); one made otherwise must follow a
    synchronize. One capture per
    particle capacity, as solver.GraphedStep; the capture's warm-up step
    (graphs.warming) runs every branch, so every collective the graph
    holds has been called once before it. A replay makes no host sync.

    Raises unless the process group is NCCL's (gloo runs the split step
    eagerly: ShardedStep) with parallel/launch.NCCL_ENV set, and when a
    capture fails. `capture_bytes`:
    the bytes by kind of every collective the graph holds, each body's
    once (what a replay moves when every branch is taken once and every
    loop runs once); a replay's own bytes are counted on the device
    (`comm.replayed_bytes`)."""

    def __init__(self, step: ShardedStep):
        if step.comm.backend != "nccl":
            raise RuntimeError(
                f"GraphedShardedStep captures under NCCL; this process "
                f"group's backend is {step.comm.backend}, whose collectives "
                "a CUDA graph cannot hold: run ShardedStep eagerly")
        unset = {k: v for k, v in NCCL_ENV.items()
                 if os.environ.get(k) != v}
        if unset:
            raise RuntimeError(
                f"GraphedShardedStep: NCCL needs {unset} to capture the "
                "step's collectives in conditional nodes: call "
                "parallel.launch.nccl_environment() before "
                "init_process_group (run_ranks does)")
        self.step = step
        self.comm = step.comm
        self.graph = None
        self.capture_seconds = 0.0
        self.capture_bytes = {}

    def capture(self, local: SimState):
        """Capture the step for local's capacity (freeing the last one)."""
        self.graph = None
        # the warm-up step is thrown away: its solves, rebuilds and clock
        # marks do not count
        saved = telemetry.snapshot(telemetry.CAPTURE_RESTORED)
        before = collections.Counter(self.comm.captured)
        g = graphs.StepGraph(self.step).capture(local)
        telemetry.restore(saved, telemetry.CAPTURE_RESTORED)
        g.capacity = local.particles.n_capacity
        self.capture_bytes = dict(collections.Counter(self.comm.captured)
                                  - before)
        self.graph = g
        self.capture_seconds += g.capture_seconds
        return g

    @property
    def nodes(self) -> dict:
        return dict(self.graph.nodes)

    def __call__(self, local: SimState) -> SimState:
        if self.graph is None or \
                self.graph.capacity != local.particles.n_capacity:
            self.capture(local)
        out = self.graph.replay(local)
        replay_launched()
        return out


# the DEM tables and the fluid fields whose bytes run_steps reports per
# rank
TABLES = ("nbr_idx", "shear", "wall_shear", "pos")
FIELDS = ("p", "Ub", "alpha")


def _as_bits(x):
    """x as integers of its width, for an exact elementwise max."""
    if x.dtype == torch.bool:
        return x.to(torch.int32)
    if x.is_floating_point():
        return x.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[x.element_size()])
    return x


def check_replicas(particles, comm) -> None:
    """Raise, naming them, unless the particle arrays every rank holds
    whole (the countdown and key of the injection, nbr_dropped, the
    rigid bodies, the lattice's table and history) are the same on every
    rank bit for bit: the decisions of the split step read them, so a
    rank whose copy parted would take another branch than the rest."""
    whole = {k: getattr(particles, k)
             for k, a in particle_axes(particles).items()
             if a is None and isinstance(getattr(particles, k),
                                         torch.Tensor)}
    if particles.rigid is not None:
        whole.update({f"rigid.{k}": v for k, v in
                      zip(particles.rigid._fields, particles.rigid)})
    parted = [k for k, x in whole.items()
              if not torch.equal(_as_bits(x),
                                 comm.all_reduce_max(_as_bits(x)))]
    parted = comm.all_reduce_max(torch.tensor(
        [k in parted for k in whole], dtype=torch.int32,
        device=particles.pos.device))
    names = [k for k, bad in zip(whole, parted.tolist()) if bad]
    if names:
        raise RuntimeError("the ranks' copies of " + ", ".join(names)
                           + " part")


SYNC_WARNING = "called a synchronizing CUDA operation"


def _counting_syncs(fn):
    """(fn(), the host syncs torch's sync debug mode saw in it)."""
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    return out, sum(SYNC_WARNING in str(w.message) for w in seen)


def _parted(a, b) -> list:
    """The fields of two states of one structure that are not equal bit
    for bit, by path."""
    return [n for (n, x), (_, y) in zip(_paths(a), _paths(b))
            if not torch.equal(_as_bits(x), _as_bits(y))]


def _paths(tree, prefix=""):
    """(path, tensor) of each tensor of a tree of NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, tuple):
        names = tree._fields if hasattr(tree, "_fields") \
            else [str(i) for i in range(len(tree))]
        return [p for k, v in zip(names, tree)
                for p in _paths(v, f"{prefix}.{k}" if prefix else k)]
    return []


def run_steps(mesh: Mesh, cfg: SimConfig, state_np: dict, n_steps: int,
              keep=None, graphed: bool = False) -> dict:
    """A rank's job (parallel/launch.run_ranks): the whole state state_np
    (a bridge.sim_state_to_numpy dict) cut to this rank's block, then
    n_steps steps of ShardedStep, the ranks' whole arrays held equal
    after each (check_replicas). Returns, for this rank: the bytes of
    its own TABLES and FIELDS, the fluid's layout ("slab" or "whole"),
    the tags of its rows before and after, per step the wall
    milliseconds (the ranks started together, synchronized on a card)
    and the bytes its collectives
    returned by kind, the kernel's launches in the steps by the rows
    each computed, and (rank 0) the whole state gathered after each step
    in `keep` (all when None), by step number.

    graphed=True (NCCL only: GraphedShardedStep raises otherwise): the
    step captured first, then n_steps replays; the eager ShardedStep
    steps from the same state beside them, the oracle. Adds the
    capture's seconds, conditional nodes, captured bytes and kernel
    launches (the warm-up's), per replay the host syncs, the fields that
    part from the eager step's (none, when all is well) and the eager
    step's milliseconds; the bytes and launches per step are then the
    replays', counted on the device."""
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
    if graphed:
        runner = GraphedShardedStep(step)
        eager = graphs.tree_map(torch.clone, local)
        sizes0 = fused.launch_sizes()
        runner.capture(local)
        out.update(capture_s=runner.capture_seconds, nodes=runner.nodes,
                   capture_bytes=runner.capture_bytes,
                   capture_launches=sum((fused.launch_sizes()
                                         - sizes0).values()),
                   syncs=[], parted=[], eager_ms=[])
    counted = step.comm.replayed_bytes if graphed \
        else (lambda: dict(step.comm.bytes))
    # the ranks start each timed step together: rank 0 gathers the state
    # between steps, and another rank would time its wait for it
    start = Comm()
    flag = torch.zeros(1, device=mesh.device)
    for i in range(1, n_steps + 1):
        bytes0, sizes0 = counted(), fused.launch_sizes()
        start.all_reduce_max(flag)
        sync()
        t0 = time.perf_counter()
        if graphed:
            local, n_syncs = _counting_syncs(lambda: runner(local))
            out["syncs"].append(n_syncs)
        else:
            local = step(local)
        sync()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launch_sizes"] += fused.launch_sizes() - sizes0
        out["comm"].append({k: v - bytes0.get(k, 0)
                            for k, v in counted().items()})
        if graphed:
            sync()
            t0 = time.perf_counter()
            eager = step(eager)
            sync()
            out["eager_ms"].append((time.perf_counter() - t0) * 1e3)
            out["parted"].append(_parted(eager, local))
        check_replicas(local.particles, Comm())
        if keep is None or i in keep:
            whole = gather_state(local, mesh, step.comm)
            if mesh.rank == 0:
                out["states"][i] = bridge.sim_state_to_numpy(whole)
    out["launch_sizes"] = dict(out["launch_sizes"])
    out["launches"] = sum(out["launch_sizes"].values())
    out["tags_after"] = local.particles.tag.cpu().numpy()
    return out


def run_jobs(mesh: Mesh, jobs) -> list:
    """run_steps(mesh, *job) for each job (cfg, state_np, n_steps[, keep[,
    graphed]]) in turn, in one spawn of the ranks: their results in
    order."""
    out = []
    for job in jobs:
        out.append(run_steps(mesh, *job))
        if mesh.device.type == "cuda":
            torch.cuda.empty_cache()
    return out
