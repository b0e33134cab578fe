"""The layout of the coupled state over ranks (port of
``sedifoam_tpu/parallel/mesh.py``).

The JAX module builds a 1-D ``jax.sharding.Mesh`` and places every array
of a ``SimState`` on it; GSPMD then partitions the step. Here the ranks
are processes of a ``torch.distributed`` group, and `shard_state` gives
each rank its own block of the state; the split step (parallel/step.py)
exchanges what its other rows are needed for.

`placement` is the JAX module's ``spec_for``, rule for rule:

- an array whose leading axis is the particle capacity N splits along it;
- an array whose last axis is N splits along that axis: the (K, N)
  neighbor table, the (3, K, N) contact history and the (3, W, N) wall
  history, the largest DEM state; the dense backend's (3, N, N) history
  splits along its row axis (-2), which holds the own rows (the JAX
  module splits it along the last);
- a grid field (.., nx, ny, nz) splits along grid-x where nx divides by
  the ranks: each rank holds the planes [x_start, x_start + nx/R) of its
  slab (grid.SlabGrid), the fields on x faces (.., nx+1, ny, nz) stay
  whole, as the JAX rule keeps them; where nx does not divide, the whole
  fluid is replicated (`fluid_layout` says which);
- everything else is replicated.

With ``DEMConfig.sort_on_rebuild`` the rows are sorted by bin at every
neighbor rebuild, so a rank's block of rows is an x-slab of the bed, and
a particle that crossed into another rank's slab changes ranks at the
next rebuild: the stand-in for MPI's particle migration.

Where N does not divide by the ranks the JAX module quietly replicates
the particle arrays; `placement` raises instead, since a replicated
split would hide that nothing is split.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

REPLICATE = ("replicate",)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of the ranks of a process group: `ranks` of them, this
    process being `rank`, its tensors on `device`."""

    ranks: int
    rank: int
    device: torch.device


def make_mesh(n_devices=None, device=None) -> Mesh:
    """The mesh of the process group the caller started (torchrun, a
    test's spawn, parallel/launch.run_ranks). The device is
    cuda:(rank % cards) unless `device` says otherwise ("cpu" for the
    CPU); this raises with no process group, with `n_devices` other than
    the group's size, and with no card unless the CPU was asked for."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no process group: start one with "
                           "torch.distributed.init_process_group first")
    ranks = dist.get_world_size()
    rank = dist.get_rank()
    if n_devices is not None and n_devices != ranks:
        raise ValueError(f"make_mesh: {n_devices} devices asked for, the "
                         f"process group has {ranks} ranks")
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError('make_mesh: no CUDA device: pass device="cpu"'
                               ' to run on the CPU')
        if device.index is None:
            device = torch.device("cuda", rank % torch.cuda.device_count())
    return Mesh(ranks, rank, device)


def placement(x, capacity: int, n_ranks: int, nx=None):
    """("split", axis) or ("replicate",) for an array of this shape in a
    state of particle capacity `capacity` and nx cells along grid-x,
    over n_ranks ranks (the module docstring has the rules; without nx
    any array of three or more axes whose third from last divides by
    the ranks is taken as a grid field)."""
    shape = tuple(x.shape)
    nd = len(shape)
    if nd == 0:
        return REPLICATE
    lead = shape[0] == capacity
    minor = nd >= 2 and shape[-1] == capacity
    if (lead or minor) and capacity % n_ranks:
        raise ValueError(f"capacity {capacity} does not divide over "
                         f"{n_ranks} ranks")
    if lead:
        return ("split", 0)
    if minor:
        if nd >= 3 and shape[-2] == capacity:     # the dense (3, N, N)
            return ("split", nd - 2)
        return ("split", nd - 1)
    if nd >= 3 and (nx is None or shape[-3] == nx) \
            and shape[-3] % n_ranks == 0:
        return ("split", nd - 3)
    return REPLICATE


def fluid_layout(nx: int, n_ranks: int) -> str:
    """"slab": the fluid split along grid-x; "whole": replicated."""
    return "slab" if nx % n_ranks == 0 else "whole"


def _owned(path):
    """Whether a state path is of the particles (else the fluid's)."""
    return path.startswith("particles.")


# the tensors of a ParticleState that hold no capacity axis, and those
# whose capacity axis is the last: the (K, N) table, the (3, K, N) and
# (3, W, N) histories (the dense backend's (3, N, N) history splits along
# -2, its rows); every other tensor's capacity axis is its first
_WHOLE = ("time_to_add", "rng_key", "nbr_dropped")
_MINOR = ("nbr_idx", "shear", "wall_shear")


def particle_axes(ps) -> dict:
    """{field: the axis its rows split along, or None} of a ParticleState,
    whole or a rank's block alike: the layout the split step cuts and
    joins by (shard_state checks it against `placement`)."""
    dense = ps.nbr_idx.shape[0] == 0
    out = {}
    for name, x in zip(ps._fields, ps):
        if name in _WHOLE or not isinstance(x, torch.Tensor):
            out[name] = None
        elif name == "shear" and dense:
            out[name] = 1
        elif name in _MINOR:
            out[name] = x.ndim - 1
        else:
            out[name] = 0
    return out


def _block(x, axis, rank, ranks):
    """This rank's block of x along `axis`: a contiguous copy."""
    size = x.shape[axis] // ranks
    return x.narrow(axis, rank * size, size).clone(
        memory_format=torch.contiguous_format)


def split_particles(ps, rank: int, ranks: int):
    """A whole ParticleState's block of rows for `rank` of `ranks`."""
    axes = particle_axes(ps)
    return ps._replace(**{k: _block(getattr(ps, k), a, rank, ranks)
                          for k, a in axes.items() if a is not None})


def join_particles(ps, comm):
    """The whole ParticleState from the ranks' blocks, on every rank."""
    axes = particle_axes(ps)
    return ps._replace(**{k: comm.all_gather_rows(getattr(ps, k), a)
                          for k, a in axes.items() if a is not None})


def _check_layout(state, n, ranks, nx=None):
    """Raise unless `placement` splits exactly what particle_axes splits
    among the particles, and outside them grid-x of the grid fields of
    nx planes, or nothing (no nx: a ParticleState)."""
    ps = state.particles if hasattr(state, "particles") else state
    if ps.rigid is not None:
        raise NotImplementedError("shard_state: rigid clumps are not split "
                                  "over ranks yet")
    axes = particle_axes(ps)

    def check(path, x):
        place = placement(x, n, ranks, nx)
        name = path.split(".")[-1]
        owned = _owned(path) or ps is state
        if owned:
            want = ("split", axes[name]) if axes[name] is not None \
                else REPLICATE
        else:
            grid_field = nx is not None and x.ndim >= 3 \
                and x.shape[-3] == nx and nx % ranks == 0
            want = ("split", x.ndim - 3) if grid_field else REPLICATE
        if place != want:
            raise ValueError(f"shard_state: {path} of shape "
                             f"{tuple(x.shape)} places as {place}, the "
                             f"split step cuts it as {want}")
        return x
    _map(check, state)


def _map(fn, tree, path=""):
    """fn(path, tensor) over the tensors of a tree of NamedTuples."""
    if isinstance(tree, torch.Tensor):
        return fn(path, tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v, f"{path}.{k}" if path else k)
                            for k, v in zip(tree._fields, tree)))
    return tree


def _on_particles(fn, state):
    if hasattr(state, "particles"):
        return state._replace(particles=fn(state.particles))
    return fn(state)


def _grid_nx(state):
    """nx of a SimState's fluid (its x-face fields stay whole), or None
    for a ParticleState."""
    return state.fluid.phi.x.shape[0] - 1 if hasattr(state, "fluid") \
        else None


def shard_state(state, mesh: Mesh):
    """This rank's SimState (or ParticleState) on mesh.device: each split
    tensor cut to the rank's contiguous block (a copy, not a view): the
    particle rows, and the grid-x planes of the grid fields where the
    fluid splits (fluid_layout); every other tensor as it is. Raises
    where the capacity does not divide by the ranks, and where
    `placement` would place a tensor otherwise than the split step cuts
    it (a grid dimension equal to the capacity, a lattice state)."""
    ps = state.particles if hasattr(state, "particles") else state
    nx = _grid_nx(state)
    _check_layout(state, ps.n_capacity, mesh.ranks, nx)
    local = _on_particles(
        lambda p: split_particles(p, mesh.rank, mesh.ranks), state)

    def cut(path, x):
        if nx is not None and not _owned(path):
            place = placement(x, ps.n_capacity, mesh.ranks, nx)
            if place != REPLICATE:
                x = _block(x, place[1], mesh.rank, mesh.ranks)
        return x.to(mesh.device)
    return _map(cut, local)


def gather_state(state, mesh: Mesh, comm=None):
    """The whole SimState (or ParticleState) from the ranks' own blocks,
    on every rank: the inverse of shard_state. `comm`: the
    parallel.comm.Comm to gather with (one is made when None)."""
    from sedifoam_tpu_torch.parallel.comm import Comm
    comm = comm or Comm()
    whole = _on_particles(lambda p: join_particles(p, comm), state)
    nx = _grid_nx(state)
    if nx is None or fluid_layout(nx, mesh.ranks) == "whole":
        return whole

    def join(path, x):
        if not _owned(path) and x.ndim >= 3 and \
                x.shape[-3] * mesh.ranks == nx:
            return comm.all_gather_rows(x, axis=x.ndim - 3)
        return x
    return _map(join, whole)


class Shard:
    """One rank's part in a split coupled step (parallel/step.py): its
    `rows` (row0, n_rows) of the ranks' rows, the `comm` that joins the
    ranks, and the row arrays of all rows that the contact chain reads
    partners from: radius, mass and active, gathered when the step opens
    and again after every neighbor rebuild and every deletion (they
    change nowhere else); pos, vel and omega, gathered for each force
    evaluation (`view`)."""

    def __init__(self, comm, particles):
        self.comm = comm
        n_rows = particles.n_capacity
        self.rows = (comm.rank * n_rows, n_rows)
        self.full = {k: comm.all_gather_rows(getattr(particles, k))
                     for k in ("radius", "mass", "active")}

    def set_active(self, active):
        """The own rows' active flags changed (a deletion): gather them."""
        self.full["active"] = self.comm.all_gather_rows(active)

    @property
    def active(self):
        return self.full["active"]

    def view(self, particles):
        """The own state with pos, vel, omega, radius, mass and active of
        all n rows (gathered), the table and the histories its own: what
        the contact chain takes with rows=self.rows."""
        return particles._replace(
            pos=self.comm.all_gather_rows(particles.pos),
            vel=self.comm.all_gather_rows(particles.vel),
            omega=self.comm.all_gather_rows(particles.omega),
            **self.full)

    def gather(self, particles):
        """The whole ParticleState, on every rank."""
        return join_particles(particles, self.comm)

    def cut(self, particles):
        """This rank's block of a whole ParticleState; radius, mass and
        active of all rows taken from it."""
        self.full.update(radius=particles.radius, mass=particles.mass,
                         active=particles.active)
        return split_particles(particles, self.comm.rank, self.comm.ranks)
