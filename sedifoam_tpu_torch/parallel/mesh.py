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

Two kinds of particle array stay whole by their path, whatever their
shape (`particle_axes`): the rigid bodies (`particles.rigid.*`, B
bodies: a body array is replicated even where B happens to equal N,
which ``spec_for`` would split), and the lattice's (M, S) slot table and
(3, NOFF, M, M, S) history, which hold no axis of N, so ``spec_for``
replicates them and GSPMD computes the lattice on every device; the
split step does the same.

With ``DEMConfig.sort_on_rebuild`` the rows are sorted by bin at every
neighbor rebuild, so a rank's block of rows is an x-slab of the bed, and
a particle that crossed into another rank's slab changes ranks at the
next rebuild: the stand-in for MPI's particle migration.

Where N does not divide by the ranks the JAX module quietly replicates
the particle arrays; `placement` and `shard_state` raise instead, since
a replicated split would hide that nothing is split.
"""

from __future__ import annotations

import copy
import dataclasses

import torch
import torch.distributed as dist

from sedifoam_tpu_torch import graphs

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
# -2, its rows); every other tensor's capacity axis is its first. The
# lattice's table and history hold no capacity axis (the module
# docstring), nor do the rigid bodies (no tensor: a RigidBodies)
_WHOLE = ("time_to_add", "rng_key", "nbr_dropped")
_MINOR = ("nbr_idx", "shear", "wall_shear")
_LATTICE = ("nbr_idx", "shear")


def is_lattice(ps) -> bool:
    """Whether a ParticleState holds the lattice's (3, NOFF, M, M, S)
    history."""
    return ps.shear.ndim == 5


def particle_axes(ps) -> dict:
    """{field: the axis its rows split along, or None} of a ParticleState,
    whole or a rank's block alike: the layout the split step cuts and
    joins by."""
    dense = ps.nbr_idx.shape[0] == 0
    lattice = is_lattice(ps)
    out = {}
    for name, x in zip(ps._fields, ps):
        if name in _WHOLE or not isinstance(x, torch.Tensor) \
                or (lattice and name in _LATTICE):
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


def grid_axis(x, nx, ranks):
    """The axis a fluid tensor splits along (grid-x of a field of nx
    planes where nx divides by the ranks), or None: the fields on x
    faces (nx + 1 planes) and everything else stay whole."""
    if nx is not None and x.ndim >= 3 and x.shape[-3] == nx \
            and nx % ranks == 0:
        return x.ndim - 3
    return None


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
    particle rows (particle_axes), and the grid-x planes of the grid
    fields where the fluid splits (grid_axis); every other tensor as it
    is. The layout is the split step's, by path: where a grid axis or a
    body count happens to equal the capacity, `placement` (the JAX
    rule) would place an array otherwise. Raises where the capacity
    does not divide by the ranks."""
    ps = state.particles if hasattr(state, "particles") else state
    if ps.n_capacity % mesh.ranks:
        raise ValueError(f"capacity {ps.n_capacity} does not divide over "
                         f"{mesh.ranks} ranks")
    nx = _grid_nx(state)
    local = _on_particles(
        lambda p: split_particles(p, mesh.rank, mesh.ranks), state)

    def cut(path, x):
        if not _owned(path):
            axis = grid_axis(x, nx, mesh.ranks)
            if axis is not None:
                x = _block(x, axis, mesh.rank, mesh.ranks)
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
    ranks, and the row arrays of all rows that the force passes read
    partners from: radius, mass and active (and mol with rigid clumps),
    gathered when the step opens and again after every neighbor rebuild,
    add and deletion (they change nowhere else); pos, vel and omega,
    gathered for each force evaluation (`view`).

    A branch that changes these arrays (a rebuild, an add) runs through
    `cond`, which carries them through the conditional: a captured
    cond's body runs on replay only when its branch is taken, and a
    warm-up runs the branch not taken on a copy, so an attribute that a
    branch rebound would point at the arrays of a branch that may not
    have run."""

    def __init__(self, comm, particles):
        self.comm = comm
        n_rows = particles.n_capacity
        self.rows = (comm.rank * n_rows, n_rows)
        self.keys = ("radius", "mass", "active") + (
            ("mol",) if particles.rigid is not None else ())
        self.full = {k: comm.all_gather_rows(getattr(particles, k))
                     for k in self.keys}

    def set_active(self, active):
        """The own rows' active flags changed (a deletion): gather them."""
        self.full = {**self.full, "active": self.comm.all_gather_rows(active)}

    @property
    def active(self):
        return self.full["active"]

    def view(self, particles):
        """The own state with pos, vel, omega and the arrays of `full` of
        all n rows (gathered), the table and the histories its own: what
        the contact chain takes with rows=self.rows."""
        return particles._replace(
            pos=self.comm.all_gather_rows(particles.pos),
            vel=self.comm.all_gather_rows(particles.vel),
            omega=self.comm.all_gather_rows(particles.omega),
            **self.full)

    def own(self, x):
        """The own rows of a row array x of all rows."""
        row0, n = self.rows
        return x[row0:row0 + n]

    def gather(self, particles):
        """The whole ParticleState, on every rank."""
        return join_particles(particles, self.comm)

    def cut(self, particles):
        """This rank's block of a whole ParticleState; the arrays of
        `full` taken from it."""
        self.full = {**self.full,
                     **{k: getattr(particles, k) for k in self.keys}}
        return split_particles(particles, self.comm.rank, self.comm.ranks)

    def cond(self, pred, fn, particles):
        """graphs.cond(pred, ..., particles) for a branch fn(particles,
        shard) -> particles that may change the arrays of `full` (a
        rebuild, an add): they ride the cond's carry, the branch works on
        a Shard of its own, and this one takes the arrays the cond
        returned."""
        def branch(carried):
            sub = self._with(carried[1])
            return fn(carried[0], sub), sub._arrays()

        out = graphs.cond(pred, branch, (particles, self._arrays()))
        self.full = dict(zip(self.keys, out[1]))
        return out[0]

    def _arrays(self):
        return tuple(self.full[k] for k in self.keys)

    def _with(self, arrays):
        """A copy of this Shard holding `arrays` as its `full`."""
        sub = copy.copy(self)
        sub.full = dict(zip(self.keys, arrays))
        return sub
