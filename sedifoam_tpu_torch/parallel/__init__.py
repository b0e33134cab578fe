"""The coupled step split over ranks (port of ``sedifoam_tpu/parallel``).

The reference parallelizes by decomposing space twice (OpenFOAM mesh
ranks and LAMMPS bricks) and reconciles the two with an all-to-all
transpose (softParticleCloud.C:602-687). The JAX package carries both
on one ``jax.sharding.Mesh``: grid fields shard along x, particle
arrays along the capacity axis, and GSPMD emits the halo exchanges,
gathers and psums from the sharding annotations alone.

PyTorch has nothing that partitions this program by itself (DTensor
has no rule for the contact-chain kernel, the sorted scatter of the
particle-to-grid transfer or the graph's conditional nodes), so the
port writes the split out by hand, over a ``torch.distributed`` process
group:

- ``mesh``: ``make_mesh`` (a 1-D mesh of the group's ranks),
  ``placement`` (the JAX module's layout rules), ``shard_state`` /
  ``gather_state``, and ``Shard``, a rank's part in a split step;
- ``comm``: the collectives the step uses, with a byte counter by kind;
- ``step``: ``ShardedStep``, the coupled step split over the mesh, and
  ``GraphedShardedStep``, the same captured as one CUDA graph per rank
  with its NCCL collectives inside;
- ``launch``: ``run_ranks``, which starts ranks on one host;
- ``probe``: which collectives a CUDA graph takes, and where.

What is split: the particle arrays (rows, and the (K, N) table and the
contact and wall histories along N), where the DEM's state and time go;
the contact-chain kernel runs on each rank's own rows. The fluid grid
splits along grid-x where nx divides by the ranks (``grid.SlabGrid``:
ghost planes in the stencils, plane-ordered reductions summed over the
ranks, FastDiag solves on the gathered whole field), else it is
whole on every rank, stepped by every rank alike. What has no axis of
N stays whole on every rank, computed alike by each: the rigid bodies,
the lattice's slot table and history. ``ShardedStep`` steps every
configuration ``solver.CoupledStep`` steps, eagerly over gloo and, under
NCCL, replayed as one graph, as the JAX package jits its sharded step.
"""
