#!/usr/bin/env python3
"""Smoke test of the PyTorch port (sedifoam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Drives the port's main path — the coupled CFD-DEM step of the bench case
at full width (131,072 particles, 32x64x32 grid, K = 8, three plane
walls, f32, the seeded jittered lattice) — and checks it. Phases, each of
which passes or exits nonzero:

1. environment: torch/CUDA/nvcc/triton versions, the card's name and
   power limit (nvidia-smi); no CUDA device -> exit 2 at once;
2. build: the contact-chain kernel from csrc/ (seconds, ptxas report);
   TF32 off;
3. kernel vs its plain PyTorch version at the bench shape, on clones of
   one state with pair and wall contacts: max error relative to each
   output's scale <= 1e-5 (f32) and 1e-12 (f64), also periodic,
   shearupdate=False and rebuilt at K = 20, and a second launch on a
   clone equal bit for bit; at the clumps' K = 160 and the extras' K =
   29 in f32 and f64, on the transport-suspended and -dune tables
   (65,536 rows, K = 23, after TRANSPORT_KERNEL_SETTLE settling steps),
   and on jetFlow's table at JETFLOW_KERNEL_STEPS steps of one run (K =
   16, three wall planes, the window grown to 4,096 rows, then to
   16,384, the full run's largest window) in f32 and f64;
   then at eleven shapes (bench f32 and f64, the channel's particles at
   N = 8,192, K = 16, the injection window's N = 2,048 and 65,536, the
   clumps' 8,192 x 160, the extras' 131,072 x 29, the suspended and the
   dune tables' 65,536 x 23, jetFlow's 4,096 and 16,384 x 16 x 3): the
   kernel's device time (torch.profiler,
   100 launches on clones), its bound (bytes each input read once and
   each output written once, counted from the state, over HBM's rate),
   the share of it, the empty kernel's time (the launch floor) and host
   microseconds per call;
4. main path: the bench entry point's own loop
   (sedifoam_tpu_torch.bench.run: initialize, 1 warm-up step that
   captures the coupled step as a CUDA graph, 10 timed replays ending in
   a device-to-host fetch, the neighbor audit; particle-substeps/s), a
   per-phase split over 3 more eager steps; no host sync inside a replay
   (torch's sync debug mode); the state
   must be finite, nbr_dropped 0, alpha in [0, max_possible_alpha] up to
   f32 round-off of the smoothing transform (1e-6), the
   kernel's launch count must equal the setups + substeps run, and one
   coupled step through the kernel must agree with one through the plain
   chain (<= 1e-3 of each field's scale, f32);
4b. graph: the coupled step captured once and replayed (solver.
   GraphedStep, the step of Simulation on the card) against the eager
   step (CoupledStep.forward, the oracle) from the same state, GRAPH_STEPS
   steps each, on the bench case, the channel (140x65x60), the clumps
   (72x50x36, 600 clumps), the injection column with its active window
   (a capture per window), the transport-suspended and -dune cases as
   their validators load them (65,536 rows; the dune's step is five
   coupling cycles of 16 substeps), and jetFlow at its full 56x120x56
   O-grid (200 substeps a step, the window of 2,048 rows) from the state
   after JETFLOW_GRAPH_PRERUN steps, an add among the compared steps:
   the states equal bit for bit (else
   within
   GRAPH_TOL of scale, the worst field printed), the same PCG and
   BiCGStab solves and iterations, no host sync inside a replay (the
   visits' own reads aside), unrelated allocations between the replays;
   capture seconds, ms per step both ways, the kernel's launches inside
   the graphs, and but for the injection column the device's busy share,
   the kernel's device time inside a replay and the kernels that take
   most device time (torch.profiler);
5. runner: the bench case through runtime.runner.Simulation, 6 steps
   with 4 probes, a diagnostics log every step and one write(); a
   checkpoint after step 3 resumed by a fresh Simulation and run to
   step 6 must agree with the straight run (<= 1e-4 of each field's
   scale; the particle-to-grid scatter sums in a fixed order, so it is
   bitwise in practice); finite, nbr_dropped 0, launches = setups +
   substeps; the runner's timing split;
6. inject: the injection column at jetFlow's capacity (65,536;
   sedifoam_tpu_torch/cases.py), 40 steps windowed and 40 at full
   capacity: the window must grow at least twice, the kernel must run
   at >= 3 distinct N, and the two runs must agree by tag (pos, vel,
   omega; <= 1e-5 of scale); host syncs per step in torch's sync debug
   mode;
7. dense: xiaocase3 (dense backend, f64) for 25 steps through
   Simulation, inside the reference test's bounds;
8. case: the transport-bedload channel written as a case directory
   (sedifoam_tpu_torch/cases.py) at its full 140x65x60 mesh with 6 bed
   layers (6,072 particles, capacity 8,192, the layers pressed 2 um into
   each other), loaded by io/case.load_case (binned, f32) with the
   semi-implicit drag on: the loaded config is checked (periodic x/z,
   frozen type 2, hooke_history, Ubar 0.8, kEqn, K = 16); 5 settling
   steps without forcing, then 10 Ubar steps through Simulation; finite,
   nbr_dropped 0, the frozen rows exactly still, no escapes, alpha in
   range, the forcing positive, launches = setup + substeps; the kernel
   against its plain version at this shape, and one coupled step through
   the kernel against one through the plain chain (<= 1e-3 of scale);
   ms/step, the phase split, host syncs, PCG/BiCGStab iterations and the
   Ubar compensated sums' time;
8b. case, jetFlow: cases.write_jetflow_case at its full O-grid, loaded
   as its validator loads it (embed_ogrid, binned, f32, 65,536 rows):
   the embedded 56x120x56 grid (box, uniform column, mirrored graded
   sides), the inlet disc's covered area within 2e-2 of pi r^2, the BC
   kinds (the RegionPatchBC inlet, inletOutlet/fixedValue top, slip
   floor), kEqn, the frozen type 2, adding and deleting, 36 add sites,
   200 substeps, K = 16, three wall planes; seconds to write and load;
9. entry: Simulation.from_case on the written xiaocase3 (dense, f64, 5
   steps) equal to cases.xiaocase3() run the same way, and
   `python -m sedifoam_tpu_torch.run_case` on it with --device cuda;
10. clumps: the irregular-grain channel (rigid trimer clumps,
   sedifoam_tpu_torch/cases.py) written and loaded at its full 72x50x36
   mesh with 600 clumps over 2,592 frozen floor spheres (4,392 particles,
   capacity 8,192, the loader's K = 160, f32, semi-implicit drag), 10
   steps through Simulation: finite, members rigid to 1e-7 m, the floor
   exactly still, none lost, alpha >= -1e-4, nbr_dropped 0, no same-body
   partner in the table, the run through the kernel against the run
   through the plain chain (<= 1e-3 of scale) and against a second run
   resumed from a checkpoint at step 5 (bit for bit); ms/step, the
   split, the two body passes' ms per substep;
11. extras: the bench lattice (131,072 particles, the loader's K = 29)
   with cohesion (model 0, model 1) and lubrication, setup_forces and 10
   substeps each: finite, nbr_dropped 0, the cohesive and the pairwise
   lubrication forces sum to zero (<= 1e-5 of their absolute sum), f32
   against f64 at 8,192 particles (the extra's own force on one state <=
   2e-2 of scale; after the substeps pos <= 1e-5, vel <= 2e-2), binned
   against
   dense at 2,048 (f64, <= 1e-10), the observables' slot counts against
   an independent count; ms per substep with and without each extra,
   peak memory;
12. dns: a 64^3 periodic box with the DNS spectral forcing, 10 fluid
   steps in f32 and f64: finite, the force nonzero and solenoidal
   (spectral divergence <= 1e3 eps of |K||F|), a second run from the same
   key equal bit for bit; ms per forcing step;
13. bench: sedifoam_tpu_torch.bench at full width, 5 timed blocks of 10
   steps (the median is the rate), once as it stands and once with
   DEMConfig.sort_on_rebuild: nbr_dropped 0 in both, the sorted run's
   rows really moved, and after the 51 steps the two runs agree by tag
   (pos <= 1e-5, vel <= 2e-3, omega <= 2e-2, alpha/p/Ub <= 1e-4 of
   scale: f32, and the particle-to-grid sums add in another order); the
   kernel
   against its plain version on the sorted state (<= 1e-5), and its
   device time on the unsorted and the sorted state;
14. validate: the irregular, transport-bedload, transport-suspended,
   transport-vortex-dune and jetFlow validators
   (sedifoam_tpu_torch/validate/)
   at the full mesh and table of each (72x50x36 coarsened 4x, 140x65x60
   and 140x65x60 coarsened 2x, the dune's two-block 156x26x40 coarsened
   2x; tables of 8,192, 8,192, 65,536 and 65,536 rows, as the reference
   scripts default), cut in depth only: 200 of 6,000 steps, 50 settling
   + 250 of 30,000 forced steps, 50 + 200 of 2,000 + 15,000 for the
   suspended and dune cases (the dune's cut run marked quick), and
   jetFlow's 250 of 7,500 steps at its full O-grid and 65,536 rows
   (marked quick: its decay and population gates need the whole 1.5 s;
   one more launch a step that adds); every gate such a
   run evaluates must hold (finite, rigid members, frozen rows still, no
   escapes, alpha bounds, k_audit), the full-run gates are printed as
   not evaluated; nbr_dropped 0, launches = setup + substeps, the step
   run as a replayed graph; ms per forced step;
14b. lattice: the lattice DEM backend (dem/lattice.py, plain PyTorch:
   the JAX package's lattice is XLA-generated, no Pallas kernel) at the
   bench case's full width: `python -m sedifoam_tpu_torch.bench
   --backend=binned` and `--backend=lattice` (LATTICE_REPEATS timed
   blocks each, subprocesses); in this process the lattice bench step
   captured and replayed (capture s, nodes, peak memory, ms per step
   eager and replayed, particle-substeps/s, the top kernels of a
   replay), a replay equal to the eager step bit for bit with 0 host
   syncs, lattice_unslotted 0, no contact_chain launched; the force pass
   and the carry alone (CUDA events), two force passes bitwise equal;
   lattice against binned on the bench bed after LATTICE_SETTLE binned
   steps, f32 and f64 (one force pass; a trajectory through forced
   rebuilds; LATTICE_TOL); the channel loaded on both backends (f64,
   LATTICE_CHANNEL_STEPS graphed steps through Simulation, by tag); and
   run_case --backend lattice on xiaocase3;
14c. physics: the reference's physics gates on the port alone, on the
   card: `python -m pytest --noconftest -q -m "cuda and not slow"
   tests/test_torch_physics_*.py` in a subprocess (the DEM contacts,
   the dense and binned neighbor tables, PISO, LES, graded meshes,
   region BCs, drag; each binned case asserts that the kernel's launch
   count grew across it), with the plugin tests/torch_port_launch_count
   counting the kernel's launches in that process; prints the passes,
   the seconds and the launches on one line; fails on a nonzero exit or
   no pass;
14d. sharded: the coupled step split over ranks (sedifoam_tpu_torch/
   parallel/): the kernel on each half of the bench table's rows (f32,
   f64) equal bit for bit to the whole launch and within 1e-5 / 1e-12
   of scale of its plain version on the same rows, a half's device time
   and bound; the bench bed with sort_on_rebuild on SHARDED_RANKS gloo
   ranks sharing the card, SHARDED_STEPS steps of ShardedStep against
   CoupledStep run eagerly here (the particles bit for bit after step 1,
   every field within SHARDED_TOL = 1e-5 of scale after each step); the
   same on one NCCL rank (bit for bit); the bed with its rows shuffled
   and a rebuild every substep on the gloo ranks (particles change
   ranks, bit for bit after the step); per rank the bytes of nbr_idx,
   shear, wall_shear and pos (half of the whole), the collective bytes
   per step, ms per step and the
   kernel's launches (once a substep, on the rank's rows); the fluid is
   split along grid-x on the gloo ranks (each rank steps its x-slab:
   halo planes, plane-ordered sums, FastDiag all-to-alls): each run says
   its layout, the bytes of p, Ub and alpha per rank (half of the
   whole), the collective bytes by kind and which fields are bit for bit
   (the first that parts named); the transport-bedload channel at its
   full 140x65x60 (f32, 8,192 rows, K = 16) on the gloo ranks, its fluid
   split, SHARDED_STEPS steps against the one-process step, held as the
   bench bed; and every stencil, FastDiag solve and solver of the slab
   path at the channel's shape (f32, tests/torch_port_slabs.py) against
   the whole grid's call, naming any operation that parts on the card;
   (g) which collectives a CUDA graph takes: those the split step
   calls, with its own split patterns (parallel/probe.py: the halo's
   all_gather_into_tensor of every rank's end planes, the
   particle-to-grid exchange's equal-block all_to_all_single of values
   and of int32 cells, all_gather_into_tensor, all_reduce sum and max,
   a broadcast from the last rank), each called straight through
   torch.distributed on one
   NCCL rank, eagerly (against its value computed on the host), in a
   plain capture (global and thread-local error modes) and in the body
   of an IF and of a WHILE node (graphs.cond, graphs.while_loop), each
   replay held against the eager call bit for bit; the phase fails,
   printing the error, if one is refused; (h) the split step captured
   as one CUDA graph
   (parallel/step.GraphedShardedStep) on one NCCL rank, on the bench
   bed, the channel and every configuration of (f), SHARDED_STEPS
   replays each: bit for bit with the eager ShardedStep stepped beside
   them on the rank and with CoupledStep here, 0 host syncs a replay,
   the kernel's launches inside the replays (counted on the device) as
   one process's and its halves of the last replayed table against the
   whole launch and the plain version; capture seconds, conditional
   nodes, ms per replayed step beside the eager ShardedStep's and the
   one-process GraphedStep's on the same state, the collective bytes a
   replay (counted on the device) and those the graph holds; (i) where
   several cards are visible, the probe of (g) at min(cards, 4) NCCL
   ranks, one a card (the exchanges between peers), and the bench bed's
   GraphedShardedStep on those ranks, held as (h) holds one rank's; on
   one card a line saying that no second card ran;
   each phase's seconds in the last line before the output;
14e. refcases: the reference's own auto-testing and example cases
   (xiaocase1, expMueller06/09, expWachem_PCM, BL24-TH1,
   multiParticlesCollideDia/Rho) as stand-in case directories at the
   real cases' particle counts (tests/torch_port_refcases.py: 2,160,
   9,240, 9,240, 17,562, 9,341 in a table of 16,384, and 4; their
   geometry and data/ curves chosen, so no gate on them judges physics)
   laid out as the reference's case tree; `python -m
   sedifoam_tpu_torch.validate.battery --quick --cases-dir` on them with
   the quick lengths cut in depth (120, 100, 100, 100 and 25 steps, the
   collisions 50): every case runs and is judged by run_all_cases.py's
   gates, its keys, the gates a cut run evaluates and ms per step
   printed; each binned case's kernel launches = 1 setup + (steps + the
   capture's warm-up + 6 evolves of the timing split) x substeps, the
   dense collisions none; at each new shape (2,160, 9,240, 17,562 and
   16,384 rows, K = 16) the kernel against its plain version after
   REFCASE_SETTLE steps (<= 1e-5 of scale, a second launch bit for bit)
   and its device time and bound; then validate/report.py on the
   battery's report (no plots on a host without matplotlib);
15. output: nvidia-smi's name/power line, a JSON line with the kernel
   table (launches summed over the main path, graph (from each case's
   set-up on), runner, inject, case, clumps, extras, bench, the sharded
   ranks, validate and refcases,
   with the N and K it ran at,
   launches inside replayed graphs counted on the device; device time,
   bound, host time and floor per shape; its device time inside a
   replay), and last {"ok": true, "device": {...}}.

Every phase that steps through Simulation or the bench entry point
steps through the captured graph; launches counted for a path include
each capture's eager warm-up step.

Imports nothing of JAX. Needs one card; builds into build/kernels/.
"""

import collections
import contextlib
import dataclasses
import gc
import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
N_SPLIT = 3
KERNEL_SUBSTEPS = 20
ALPHA_ROUNDOFF = 1e-6
RUNNER_STEPS = 6          # a checkpoint after RUNNER_STEPS // 2
INJECT_STEPS = 40
DENSE_STEPS = 25
CASE_SETTLE = 5           # steps without forcing (the validator's settle)
CASE_STEPS = 10           # Ubar steps after them
CASE_OVERLAP = 2e-6       # bed layers pressed together: contacts at once
ENTRY_STEPS = 5
CLUMP_STEPS = 10
CLUMP_PRESS = 1e-5        # trimers lowered into the floor: contacts at once
CLUMP_KERNEL_SUBSTEPS = 5  # a member's contact lasts 19 substeps
EXTRAS_SUBSTEPS = 10
DNS_STEPS = 10
DNS_N = 64
BENCH_REPEATS = 5         # timed blocks of 10 steps; the median is reported
# sorted vs unsorted bench run by tag after 51 steps, of each field's
# scale (f32; about 10x what an H100 run showed: pos 8.3e-7, vel 2.2e-4,
# omega 1.7e-3, p 9.2e-6)
SORT_TOL = {"pos": 1e-5, "vel": 2e-3, "omega": 2e-2, "fluid": 1e-4}
# the validators' depth: steps of 1e-4 s, whole host visits of 25
VALIDATE_IRREGULAR_STEPS = 200     # of 6,000
VALIDATE_BEDLOAD_SETTLE = 50       # of 3,000
VALIDATE_BEDLOAD_STEPS = 250       # of 30,000
VALIDATE_SUSPENDED_SETTLE = 50     # of 2,000
VALIDATE_SUSPENDED_STEPS = 200     # of 15,000
VALIDATE_DUNE_SETTLE = 50          # of 2,000
VALIDATE_DUNE_STEPS = 200          # of 15,000
# settling steps before the kernel is measured on the two transport
# cases' states: their mobile grains land on the frozen layer after ~100
TRANSPORT_KERNEL_SETTLE = 200
# jetFlow: the steps of one run at which the kernel's states are taken
# (the window has grown from 2,048 to 4,096 rows at step ~425 and to
# 16,384 at step ~1,600, when the population passed 4,096), steps before
# the graph's and the eager step's comparison (three adds of 36
# particles; an add falls every 14 steps, one among the compared ones),
# and the cut validator run (of 7,500)
JETFLOW_KERNEL_STEPS = (450, 1800)
JETFLOW_KERNEL_WINDOWS = [4096, 16384]      # the windows at those steps
JETFLOW_GRAPH_PRERUN = 45
VALIDATE_JETFLOW_STEPS = 250
# the lattice backend (phase_lattice): timed blocks of the bench module,
# eager steps held against as many replays, timed replays, profiled
# replays, passes per CUDA-event time, binned steps before the backends
# are compared, substeps before each forced rebuild there, channel steps
LATTICE_REPEATS = 3
LATTICE_STEPS = 2
LATTICE_TIMED = 5
LATTICE_PROFILE = 2
LATTICE_PASSES = 3
LATTICE_SETTLE = 5
LATTICE_SUBSTEPS = 5
LATTICE_CHANNEL_STEPS = 3
# lattice vs binned on one bed, of each field's scale: the contact force
# and torque of one pass, pos/vel and omega after 2 x (5 substeps + a
# forced rebuild); the two backends sum each particle's contacts in
# another order (an H100 run measured at most 1.8e-7 in f32, 3.4e-16 in
# f64); the channel's particles by tag and Ub after 3 f64 steps
# (measured 4.9e-12: round-off grown through the coupled steps)
LATTICE_TOL = {"float32": {"force": 1e-5, "traj": 1e-5, "omega": 1e-4},
               "float64": {"force": 1e-12, "traj": 1e-12, "omega": 1e-12}}
LATTICE_CHANNEL_TOL = 1e-10
# the refcases phase: the reference's own cases as stand-ins at their
# particle counts (tests/torch_port_refcases.py), each validator quick
# and cut in depth
REFCASE_STEPS = 100       # the Mueller cases, expWachem_PCM
REFCASE_XIAOCASE1_STEPS = 120   # 6 visits: a probe sample inside the ramp
REFCASE_BL24_STEPS = 25   # of BL24-TH1's 500 quick steps
REFCASE_COLLIDE_END = 0.05  # of the collisions' 0.2 s (50 of 200 steps)
REFCASE_SETTLE = 10       # steps before the chain is held at a new shape
REFCASE_NAMES = ("xiaocase1", "expMueller06", "expMueller09",
                 "expWachem_PCM", "BL24-TH1", "multiParticlesCollide")
GRAPH_STEPS = 10          # replays held against as many eager steps
GRAPH_TOL = 1e-6          # replay vs eager, of scale, where not bit for bit
GRAPH_PROFILE = 5         # replays in the profile of a graphed step
GRAPH_TOP = 8             # kernels listed by their device time per replay
PROFILE_REPS = 100        # launches per device-time measurement
PROFILE_LEAD = 100        # launches before them that a profile may lose
HOST_CALLS = 1000         # wrapper calls per host-time measurement
# the text of torch's sync debug mode warning (its first use also warns
# that the mode is a prototype: that notice is no sync)
SYNC_WARNING = "called a synchronizing CUDA operation"
HBM_BYTES_PER_S = 3.35e12                  # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}   # outside tensor cores
FLOPS_PER_CONTACT = 150   # geometry and contact law of one touching slot


# what the graphed paths report for the kernels line: launches inside
# replayed graphs, per path, and the kernel's device time in a replay
GRAPHS = {}


def fail(msg):
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def rel_err(ref, got):
    """max |ref - got| / max |ref| (error relative to the field's scale)."""
    ref, got = ref.double(), got.double()
    return float((ref - got).abs().max() / ref.abs().max().clamp_min(1e-300))


def tree_map(fn, obj):
    """Apply fn to every tensor of a NamedTuple tree."""
    import torch
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if hasattr(obj, "_asdict"):
        return type(obj)(*(tree_map(fn, v) for v in obj))
    return obj


def tree_leaves(obj, prefix=""):
    import torch
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif hasattr(obj, "_asdict"):
        for k, v in obj._asdict().items():
            yield from tree_leaves(v, f"{prefix}.{k}" if prefix else k)


def fields_that_differ(a, b):
    """Names of the tensors of two NamedTuple trees that are not equal
    bit for bit (a NaN, as an empty particle slot's 0/0 drag, equals a
    NaN)."""
    out = []
    for (name, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
        same = (x == y)
        if x.is_floating_point():
            same = same | (x.isnan() & y.isnan())
        if not bool(same.all()):
            out.append(name)
    return out


def count_syncs(fn, where=None):
    """Host syncs made by fn(), as torch's sync debug mode reports them;
    `where` (a list) receives the file:line of each."""
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in seen if SYNC_WARNING in str(w.message)]
    if where is not None:
        where += [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
                  for w in syncs]
    return len(syncs)


def launch_snapshot():
    """The kernel's launch counts: eager, and its device counters inside
    graphs (copies). launch_restore puts them back, so launches made to
    compare or time a kernel do not count."""
    from sedifoam_tpu_torch.dem import fused
    return fused.launch_snapshot()


def launch_restore(snap):
    from sedifoam_tpu_torch.dem import fused
    fused.launch_restore(snap)


def captures():
    """Captures of the coupled step so far; each capture's eager warm-up
    step launches the kernel once a substep."""
    from sedifoam_tpu_torch.solver import GraphedStep
    return GraphedStep.CAPTURES


def compare_states(a, b):
    """(worst rel_err, field) over the floating fields of two SimStates.
    The solid-phase velocity Ua = (smoothed sum of vol*U) / alpha is
    ill-conditioned where alpha is at round-off level (no particles), and
    so are its previous-step copy, its material derivative DDtUa and the
    solid fluxes phia built from it: alpha*Ua is compared instead, and
    the mixture flux phi carries phia where it matters."""
    import torch
    skip = {"fluid.Ua", "fluid.Ua_old", "fluid.DDtUa"}
    worst, where = 0.0, ""
    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    pairs.append((("fluid.alpha*Ua", a.fluid.Uc), ("", b.fluid.Uc)))
    for (name, x), (_, y) in pairs:
        if name in skip or name.startswith("fluid.phia"):
            continue
        if x.is_floating_point() and bool(torch.any(x != 0)):
            e = rel_err(x, y)
            if e > worst:
                worst, where = e, name
    return worst, where


def run_steps(sim, n, **kw):
    """Run sim until its step counter reads n (the loop tests time, which
    f32 accumulates with round-off: stop half a step early)."""
    sim.run((n - 0.5) * sim.cfg.fluid.dt, **kw)
    if int(sim.state.fluid.step) != n:
        fail(f"runner stopped at step {int(sim.state.fluid.step)}, not {n}")


def device_us(launch, reps=PROFILE_REPS):
    """Mean device microseconds of launch(r) over r = 0 .. reps-1: the
    device time of every kernel that ran, from torch.profiler; by CUDA
    events around a CUDA graph of the launches where the profiler saw no
    device time. A profile drops the kernel records of its first
    launches, the more of them the longer the process has run (none at
    14 s, 4 at 59 s, 7 at 104 s, idle or busy; the launch records are
    all there: tests/torch_port_profiler_probe.py): so PROFILE_LEAD
    launches go before the reps that count, and of each kernel the last
    records are read, as many as the reps made. The run fails if the
    profiler saw fewer than that. Returns (us, how, kernel names)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    launch(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(PROFILE_LEAD + reps):
            launch(r % reps)
        torch.cuda.synchronize()
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name.setdefault(e.name.split("(")[0], []).append(
                (e.time_range.start, e.time_range.elapsed_us()))
    total = 0.0
    for name, seen in by_name.items():
        # kernels of this name in one launch
        each = -(-len(seen) // (PROFILE_LEAD + reps))
        if len(seen) < each * reps:
            fail(f"the profiler saw {name} {len(seen)} times in "
                 f"{PROFILE_LEAD + reps} launches")
        total += sum(us for _, us in sorted(seen)[-each * reps:])
    if by_name:
        return total / reps, "profiler", sorted(by_name)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for r in range(reps):
            launch(r)
    graph.replay()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) * 1e3 / reps, "CUDA graph", []


def slots_within(p, periodic_len, gap=0.0, rows=None):
    """The count of table slots of state p whose partner's surface is
    closer than `gap` (0: touching), counted here from the positions; of
    the rows rows=(row0, n_rows) alone when given."""
    import torch
    n = p.n_capacity
    r0, nr = (0, n) if rows is None else rows
    own = slice(r0, r0 + nr)
    idx = p.nbr_idx[:, own].long()
    j = idx.clamp(0, n - 1)
    d = p.pos[None, own] - p.pos[j]
    for a, L in enumerate(periodic_len or ()):
        if L is not None:
            d[..., a] -= L * torch.round(d[..., a] / L)
    reach = p.radius[None, own] + p.radius[j] + gap
    within = (idx >= 0) & (idx < n) & p.active[None, own] & \
        ((d * d).sum(-1) < reach * reach)
    return int(within.sum())


def chain_bound(p, walls, periodic_len, rows=None):
    """The least time one contact_chain call on state p could take on
    the card: each input byte read once, each output byte written once,
    over HBM's rate, against FLOPS_PER_CONTACT per contact over the
    peak rate of the dtype. Per particle: its row (pos, vel, omega,
    radius, mass, active), its (K,) index column, the shear written (3K
    values), the wall shear written (3W), force and torque; plus three
    values of history read for each touching slot and each touching
    wall, counted from this state. rows=(row0, n_rows): a launch on
    those rows alone (their partners' rows in the other rows are not
    counted: a boundary layer of a sorted bed)."""
    import torch
    K, W = p.nbr_idx.shape[0], len(walls)
    r0, n = (0, p.n_capacity) if rows is None else rows
    own = slice(r0, r0 + n)
    b = p.pos.element_size()
    pairs = slots_within(p, periodic_len, rows=rows)
    wall_contacts = 0
    for w in walls:
        x = p.pos[own, w.axis]
        lo = w.lo if w.lo is not None else -1e30
        hi = w.hi if w.hi is not None else 1e30
        da = torch.where(x - lo < hi - x, x - lo, x - hi)
        wall_contacts += int((p.active[own] & (da * da <= p.radius[own] ** 2)
                              & (da * da > 0)).sum())
    contacts = pairs + wall_contacts
    nbytes = n * (11 * b + 1 + 4 * K + 3 * K * b + 3 * W * b + 6 * b) + \
        3 * b * contacts
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = FLOPS_PER_CONTACT * contacts / \
        PEAK_FLOPS[str(p.pos.dtype).split(".")[-1]]
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "touching_slots": pairs,
            "wall_contacts": wall_contacts}


def floor_us():
    """Device time of the kernel library's empty kernel (one warp): the
    launch floor."""
    import torch
    from sedifoam_tpu_torch.dem import fused
    lib = fused._library()

    def launch(_):
        err = lib.contact_chain_empty(torch.cuda.current_stream().cuda_stream)
        if err:
            fail(f"empty kernel: {lib.contact_chain_error_string(err)}")
    return device_us(launch)[0]


def chain_launcher(p, cfg_dem):
    """launch(r): the kernel on the r-th of PROFILE_REPS clones of p's
    contact history, through the wrapper. Callers restore the launch
    counts."""
    from sedifoam_tpu_torch.dem import fused
    walls = cfg_dem.walls if fused.walls_fusible(cfg_dem.walls) else ()
    args = (cfg_dem.pair, cfg_dem.dt, p.nbr_idx, True,
            cfg_dem.periodic_len(), walls)
    clones = [p._replace(shear=p.shear.clone(),
                         wall_shear=p.wall_shear.clone())
              for _ in range(PROFILE_REPS)]
    return lambda r: fused._launch(clones[r], *args)


def measure_chain(label, p, cfg_dem, floor):
    """The kernel's device time (profiler, PROFILE_REPS launches on
    clones of p), its bound, share of the bound and of the launch floor,
    and host microseconds per contact_chain call (HOST_CALLS calls, no
    sync inside the loop). Launches made here do not count."""
    import torch
    from sedifoam_tpu_torch.dem import fused
    walls = cfg_dem.walls if fused.walls_fusible(cfg_dem.walls) else ()
    plen = cfg_dem.periodic_len()
    counted = launch_snapshot()
    dev, how, names = device_us(chain_launcher(p, cfg_dem))
    q = p._replace(shear=p.shear.clone(), wall_shear=p.wall_shear.clone())
    args = (cfg_dem.pair, cfg_dem.dt, q.nbr_idx, True, plen, walls)
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fused.contact_chain(q, *args)
    host = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    launch_restore(counted)
    out = {"shape": label, "N": p.n_capacity, "K": p.nbr_idx.shape[0],
           "W": len(walls), "dtype": str(p.pos.dtype).split(".")[-1],
           "slot_warps": fused._library().contact_chain_slot_warps(
               p.n_capacity, int(p.pos.dtype == torch.float64)),
           "device_ms": dev * 1e-3, "host_us": host, "floor_ms": floor * 1e-3,
           **chain_bound(p, walls, plen)}
    out["share_of_bound"] = out["bound_ms"] / out["device_ms"]
    out["x_floor"] = out["device_ms"] / out["floor_ms"]
    say(f"kernel [{label}] N={out['N']} K={out['K']} W={out['W']} "
        f"{out['dtype']}, {out['slot_warps']} slot warps: device "
        f"{out['device_ms']:.5f} ms ({how}, mean of {PROFILE_REPS}; "
        f"{', '.join(names)}); bound {out['bound_ms']:.5f} ms by "
        f"{out['bound_by']} ({out['bytes']} B, "
        f"{out['touching_slots']} touching slots, {out['wall_contacts']} "
        f"wall contacts), {100 * out['share_of_bound']:.1f}% of it; floor "
        f"{out['floor_ms']:.5f} ms, device = {out['x_floor']:.2f} x floor; "
        f"host {host:.2f} us per call (mean of {HOST_CALLS})")
    return out


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def phase_environment():
    import torch
    say(f"torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        sys.exit(2)
    if not os.path.isdir(os.path.join(REPO, "sedifoam_tpu_torch")):
        fail("sedifoam_tpu_torch/ is not beside chip_smoke.py")
    sys.path.insert(0, REPO)
    from sedifoam_tpu_torch import _build
    nvcc = _build.nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    say(f"nvcc: {ver[-1] if ver else '?'}")
    try:
        import triton
        say(f"triton {triton.__version__}")
    except ImportError:
        say("triton: not importable")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    say(f"card: {smi} ({torch.cuda.device_count()} visible)")
    return smi


def phase_build():
    import torch
    from sedifoam_tpu_torch import _build, full_f32_precision
    from sedifoam_tpu_torch.dem import fused
    t0 = time.perf_counter()
    fused._library()
    say(f"build: contact_chain.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    log = _build.library_path("contact_chain").with_suffix(".log")
    kernel = ""
    for line in log.read_text().splitlines() if log.exists() else ():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]  # mangled: chain_kernel<T, S>
        elif "registers" in line or "spill" in line:
            say(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
    full_f32_precision()
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.backends.cudnn.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        fail("TF32 is still on")
    say("TF32: off (matmul, cuDNN, float32_matmul_precision=highest)")


def kernel_case(dev):
    """The bench lattice shifted 1.02 r toward the lo walls (so the first
    layers overlap the x, y and z planes) with seeded random velocities,
    after setup_forces and KERNEL_SUBSTEPS substeps: pair and wall
    contacts with shear history."""
    import numpy as np
    import torch
    from sedifoam_tpu_torch import bench_case
    from sedifoam_tpu_torch.dem import integrate
    cfg = bench_case.build_config(**bench_case.FULL)
    fluid, p = bench_case.build_state(cfg, bench_case.FULL["n_particles"],
                                      dtype=torch.float32, device=dev)
    rng = np.random.RandomState(7)
    n = p.n_capacity
    p = p._replace(
        pos=p.pos - 1.02 * 5e-4,
        vel=torch.as_tensor(0.05 * rng.randn(n, 3), dtype=torch.float32,
                            device=dev),
        omega=torch.as_tensor(20.0 * rng.randn(n, 3), dtype=torch.float32,
                              device=dev))
    p = p._replace(pos_at_build=p.pos)
    p = integrate.setup_forces(p, cfg.dem)
    p = integrate.run_dem(p, cfg.dem, KERNEL_SUBSTEPS)
    return cfg, p


def compare_chain(label, p, cfg_dem, shearupdate, tol, timing=False,
                  may_be_zero=()):
    """Kernel vs contact_chain_reference on clones of p. Every output
    must carry contacts (nonzero) except those named in may_be_zero."""
    import torch
    from sedifoam_tpu_torch.dem import fused
    walls = cfg_dem.walls if fused.walls_fusible(cfg_dem.walls) else ()
    args = (cfg_dem.pair, cfg_dem.dt, p.nbr_idx, shearupdate,
            cfg_dem.periodic_len(), walls)
    pa = tree_map(torch.clone, p)
    pb = tree_map(torch.clone, p)
    pc = tree_map(torch.clone, p)
    ref = fused.contact_chain_reference(pa, *args)
    counted = launch_snapshot()
    got = fused._launch(pb, *args)
    again = fused._launch(pc, *args)
    torch.cuda.synchronize()
    # the sum over slots runs in a fixed order: a second launch on a
    # clone gives the same bits
    if not all(torch.equal(x, y) for x, y in zip(got, again)
               if x is not None):
        fail(f"{label}: two launches on clones of one state differ")
    errs, abs_err = {}, 0.0
    for name, a, b in zip(("force", "torque", "shear", "wall_shear"),
                          ref, got):
        if a is None:
            continue
        if not bool(torch.any(a != 0)):
            if name in may_be_zero:
                say(f"kernel vs plain [{label}]: {name} all zero in both: "
                    f"{bool(torch.all(b == 0))}")
                if bool(torch.any(b != 0)):
                    fail(f"{label}: {name} is zero only in the plain chain")
                continue
            fail(f"{label}: {name} is all zero: no contacts to compare")
        errs[name] = rel_err(a, b)
        abs_err = max(abs_err, float((a.double() - b.double()).abs().max()))
    worst = max(errs.values())
    say(f"kernel vs plain [{label}]: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {tol:.0e}); "
        "a second launch on a clone equal bit for bit")
    if worst > tol:
        fail(f"{label}: kernel disagrees with the plain chain: {errs}")
    out = {"max_abs_err": abs_err}
    if timing:
        out["ms"] = cuda_ms(lambda: fused._launch(pb, *args), 50)
        out["plain_ms"] = cuda_ms(
            lambda: fused.contact_chain_reference(pa, *args), 10)
        say(f"contact chain at N={p.n_capacity} K={p.nbr_idx.shape[0]} "
            f"W={len(walls)}: kernel {out['ms']:.4f} ms, plain "
            f"{out['plain_ms']:.4f} ms (CUDA events around the Python loop "
            "of calls: host-bound, the wrapper included)")
    launch_restore(counted)          # comparison launches do not count
    return out


def phase_kernel(dev):
    import torch
    from sedifoam_tpu_torch.dem import integrate
    cfg, p = kernel_case(dev)
    nwall = int((p.wall_shear != 0).any(dim=0).any(dim=0).sum())
    npair = int((p.shear != 0).any(dim=0).sum())
    say(f"kernel case: {npair} pair slots and {nwall} particles with "
        f"wall history after {KERNEL_SUBSTEPS} substeps")
    if npair == 0 or nwall == 0:
        fail("kernel case has no pair or no wall contacts")
    res = compare_chain("f32", p, cfg.dem, True, 1e-5, timing=True)
    compare_chain("f32 shearupdate=False", p, cfg.dem, False, 1e-5)
    p64 = tree_map(lambda t: t.double() if t.is_floating_point() else t, p)
    compare_chain("f64", p64, cfg.dem, True, 1e-12)
    # periodic x and z: y walls only, table rebuilt with the wrap
    dem_p = dataclasses.replace(
        cfg.dem, periodic=(True, False, True),
        walls=tuple(w for w in cfg.dem.walls if w.style == "yplane"))
    pp = integrate.maybe_rebuild_neighbors(
        p._replace(wall_shear=p.wall_shear[:, 1:2].contiguous()), dem_p,
        force=True)
    compare_chain("f32 periodic", pp, dem_p, True, 1e-5)
    # the lattice rebuilt with 20 slots
    dem_20 = dataclasses.replace(cfg.dem, nbr_k=20)
    compare_chain("f32 K=20", integrate.maybe_rebuild_neighbors(
        p, dem_20, force=True), dem_20, True, 1e-5)

    # device time, bound and host time at the shapes the paths give it:
    # the bench lattice; the channel; the injection window's first and
    # last N, filled with the bench lattice's first N particles (the
    # column's own state barely touches)
    from sedifoam_tpu_torch.runtime.window import window_slice
    ccfg, cp = channel_kernel_case(dev)
    # the two K > 16: the clumps' table (the loader's cap of 160) and the
    # bench lattice on the extras' table (the loader's ring rule: K = 29,
    # cutoff 1.6 d), each against the plain version in f32 and f64
    kcfg, kp = clump_kernel_case(dev)
    dem_x, _ = extras_table_case(dev)
    xp = integrate.maybe_rebuild_neighbors(p, dem_x, force=True)
    for label, q, dem, zero in (("clumps K=160", kp, kcfg.dem,
                                 ("wall_shear",)),
                                ("extras K=29", xp, dem_x, ())):
        compare_chain(f"f32 {label}", q, dem, True, 1e-5, may_be_zero=zero)
        compare_chain(f"f64 {label}", tree_map(
            lambda t: t.double() if t.is_floating_point() else t, q), dem,
            True, 1e-12, may_be_zero=zero)
    # the transport-suspended and -dune tables (65,536 rows, the loader's
    # K = 23) after their validators' settling: pair contacts of the
    # mobile grains on the frozen layer
    transport = []
    for which in ("suspended", "dune"):
        tcfg, tp = transport_kernel_case(dev, which)
        compare_chain(f"f32 {which} K=23", tp, tcfg.dem, True, 1e-5,
                      may_be_zero=("wall_shear",))
        transport.append((f"{which} f32", tp, tcfg.dem))
    # jetFlow's table (K = 16, the three wall planes) at
    # JETFLOW_KERNEL_STEPS steps of one run: the window grown to 4,096
    # rows, then to 16,384, the full run's largest
    jcfg, jstates = jetflow_run(dev, *JETFLOW_KERNEL_STEPS)
    jet = [s.particles for s in jstates]
    if [q.n_capacity for q in jet] != JETFLOW_KERNEL_WINDOWS:
        fail(f"jetFlow kernel states: windows {[q.n_capacity for q in jet]}"
             f" at steps {JETFLOW_KERNEL_STEPS}, not "
             f"{JETFLOW_KERNEL_WINDOWS}")
    jet_zero = ("torque", "shear", "wall_shear")
    for steps, q in zip(JETFLOW_KERNEL_STEPS, jet):
        say(f"jetFlow kernel state: {int(q.active.sum())} active particles "
            f"in {q.n_capacity} rows after {steps} steps, "
            f"{slots_within(q, jcfg.dem.periodic_len())} touching slots")
        label = f"jetflow {q.n_capacity}"
        compare_chain(f"f32 {label}", q, jcfg.dem, True, 1e-5,
                      may_be_zero=jet_zero)
        compare_chain(f"f64 {label}", tree_map(
            lambda t: t.double() if t.is_floating_point() else t, q),
            jcfg.dem, True, 1e-12, may_be_zero=jet_zero)
    jet_shapes = [(f"jetflow f32 {q.n_capacity}", q, jcfg.dem)
                  for q in jet]
    shapes = [("bench f32", p, cfg.dem), ("bench f64", p64, cfg.dem),
              ("channel f32", cp, ccfg.dem),
              ("window 2048", window_slice(p, 2048), cfg.dem),
              ("window 65536", window_slice(p, 65536), cfg.dem),
              ("clumps f32", kp, kcfg.dem), ("extras f32", xp, dem_x)] \
        + transport + jet_shapes
    floor = floor_us()
    res["floor_us"] = floor
    res["shapes"] = [measure_chain(label, q, dem, floor)
                     for label, q, dem in shapes]
    res["bench_case"] = (cfg, p)
    return res


def channel_kernel_case(dev):
    """The channel's particles as the case loads them (6 layers pressed
    CASE_OVERLAP into each other, capacity 8,192, K = 16, periodic x/z,
    the y walls), written on a coarse mesh (the DEM state does not depend
    on it), after setup_forces and KERNEL_SUBSTEPS substeps."""
    import torch
    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.dem import integrate
    from sedifoam_tpu_torch.io.case import load_case
    with tempfile.TemporaryDirectory() as tmp:
        case = cases.write_channel_case(
            os.path.join(tmp, "channel"), counts=(14, 13, 6),
            layers=cases.CHANNEL_FULL["layers"], overlap=CASE_OVERLAP)
        cfg, _, p, _ = load_case(case, backend="binned", dtype=torch.float32,
                                 capacity=8192, device=dev)
    if p.nbr_idx.shape[0] != 16 or cfg.dem.periodic != (True, False, True):
        fail(f"channel kernel case: K {p.nbr_idx.shape[0]}, periodic "
             f"{cfg.dem.periodic}")
    p = integrate.setup_forces(p, cfg.dem)
    return cfg, integrate.run_dem(p, cfg.dem, KERNEL_SUBSTEPS)


def load_transport(dev, which):
    """The transport-suspended ("suspended") or transport-vortex-dune
    ("dune") case written at its full mesh and loaded as its validator
    loads it: binned, f32, K = 8 asked of the loader (which raises it to
    23), capacity 65,536, the semi-implicit drag, the mesh coarsened 2x
    (the fluid anew at rest on it). Returns (cfg, fluid, particles)."""
    import torch
    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.fluid.state import init_fluid
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.validate import coarsened, semi_implicit, suspended
    write, full, box = (
        (cases.write_suspended_case, cases.SUSPENDED_FULL,
         cases.SUSPENDED_BOX) if which == "suspended" else
        (cases.write_dune_case, cases.DUNE_FULL, cases.DUNE_BOX))
    with tempfile.TemporaryDirectory() as tmp:
        case = write(os.path.join(tmp, which), **full, box=box)
        cfg, _, particles, _ = load_case(
            case, backend="binned", neighbor_k=suspended.NEIGHBOR_K,
            dtype=torch.float32, capacity=suspended.CAPACITY, device=dev)
    cfg = coarsened(semi_implicit(cfg), 2)
    if particles.nbr_idx.shape[0] != 23 or cfg.dem.periodic != (
            True, False, True) or cfg.cloud.sub_cycles * cfg.cloud.sub_steps \
            != 80:
        fail(f"{which}: K {particles.nbr_idx.shape[0]}, periodic "
             f"{cfg.dem.periodic}, {cfg.cloud.sub_cycles} x "
             f"{cfg.cloud.sub_steps} substeps")
    return cfg, init_fluid(cfg.grid, dtype=torch.float32,
                           device=dev), particles


def transport_kernel_case(dev, which):
    """(cfg, particles) of load_transport's case after its validator's
    settling phase cut to TRANSPORT_KERNEL_SETTLE steps (forcing off,
    through Simulation)."""
    from sedifoam_tpu_torch.solver import initialize
    from sedifoam_tpu_torch.validate import settle
    cfg, fluid, particles = load_transport(dev, which)
    state = settle(cfg, initialize(fluid, particles, cfg),
                   (TRANSPORT_KERNEL_SETTLE - 0.5) * cfg.fluid.dt, dev)
    return cfg, tree_map(lambda t: t.clone(), state.particles)


def load_jetflow(dev):
    """jetFlow written at cases.JET_FULL (56x120x56, the O-grid embedded)
    and loaded as its validator loads it: binned, f32, embed_ogrid,
    capacity 65,536, the loader's K, initialized. Returns (cfg, state,
    seconds to write, seconds to load)."""
    import torch
    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.validate import jetflow
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        case = cases.write_jetflow_case(os.path.join(tmp, "jetFlow"),
                                        **cases.JET_FULL)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        cfg, state = jetflow.load(case, 1, dev, jetflow.CAPACITY,
                                  torch.float32)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    return cfg, state, t_write, t_load


def jetflow_run(dev, *stops):
    """(cfg, [state after each of `stops` steps]) of one jetFlow run
    through Simulation (windowed, graphed, 5 steps a host visit; each
    stop a multiple of 5, in order), each state cloned out of the graph's
    buffers."""
    from sedifoam_tpu_torch.runtime.runner import Simulation
    cfg, state, _, _ = load_jetflow(dev)
    sim = Simulation(cfg, state, steps_per_host_visit=5, device=dev)
    states = []
    for steps in stops:
        run_steps(sim, steps)
        states.append(tree_map(lambda t: t.clone(), sim.state))
    return cfg, states


def load_clumps(dev, counts):
    """The irregular case written with CLUMP_PRESS at mesh `counts` and
    loaded as the validator loads it: binned, f32, capacity 8,192, the
    semi-implicit drag. Returns (cfg, fluid, particles, seconds to write,
    seconds to load)."""
    import torch
    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.io.case import load_case
    full = cases.IRREGULAR_FULL
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        case = cases.write_irregular_case(
            os.path.join(tmp, "irregular"), n_clumps=full["n_clumps"],
            counts=counts, floor_d=full["floor_d"], press=CLUMP_PRESS)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            cfg, fluid, particles, _ = load_case(
                case, backend="binned", dtype=torch.float32, capacity=8192,
                device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    for w in seen:
        # the ring of the 1 mm floor over the 0.35 mm grains asks for more
        # slots than the loader's cap; the audit (nbr_dropped) tells
        # whether a partner was lost
        say(f"load_case warns: {w.message}")
    cfg = dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=True))
    return cfg, fluid, particles, t_write, t_load


def clump_kernel_case(dev):
    """The clumps' particles as the case loads them (K = 160, periodic
    x/z, the y walls), written on a coarse mesh (the DEM state does not
    depend on it), after setup_forces and CLUMP_KERNEL_SUBSTEPS substeps:
    the pressed members in contact with the floor, with shear history."""
    from sedifoam_tpu_torch.dem import integrate
    cfg, _, p, _, _ = load_clumps(dev, (9, 8, 6))
    if p.nbr_idx.shape[0] != 160 or p.rigid is None:
        fail(f"clump kernel case: K {p.nbr_idx.shape[0]}, rigid {p.rigid}")
    p = integrate.setup_forces(p, cfg.dem)
    return cfg, integrate.run_dem(p, cfg.dem, CLUMP_KERNEL_SUBSTEPS)


def extras_table_case(dev):
    """(DEMConfig, particles) of the bench lattice on the extras' table,
    no extra switched on: what the kernel sees in phase_extras."""
    import torch
    from sedifoam_tpu_torch import bench_case, cases
    dem, p = cases.extras_bed(bench_case.FULL["n_particles"],
                              cohesion_model=0, lubrication=True,
                              dtype=torch.float32, device=dev)
    return dataclasses.replace(dem, cohesion=None, lubrication=None), p


def phase_main_path(dev):
    import torch
    from sedifoam_tpu_torch import bench, bench_case
    from sedifoam_tpu_torch.coupling import cloud
    from sedifoam_tpu_torch.dem import fused
    from sedifoam_tpu_torch.fluid.step import advance_time, fluid_step
    from sedifoam_tpu_torch.solver import CoupledStep, need_ddtu
    n = bench_case.FULL["n_particles"]

    # the bench entry point's own loop: initialize, 1 warm-up (the
    # capture of the step's graph), its 10 timed replays ending in a
    # device-to-host fetch, the neighbor audit
    fused.reset_launches()
    caps = captures()
    run = bench.run(device=dev)
    graphed, cfg = run.step, run.cfg
    step = graphed.step                       # the eager CoupledStep
    state = tree_map(torch.clone, run.state)  # not the graph's buffers
    sub = cfg.cloud.sub_steps
    wall, rate = run.walls[0], run.rates[0]
    say(f"main path: {run.n_timed} coupled steps in {wall:.4f} s = "
        f"{wall / run.n_timed * 1e3:.3f} ms/step, {rate:.1f} "
        "particle-substeps/s")

    # per-phase split: coupled_step's three phases, CUDA events between
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    split = [0.0, 0.0, 0.0]
    for _ in range(N_SPLIT):
        st = state
        ev[0].record()
        fl = fluid_step(advance_time(st.fluid, cfg.fluid), cfg.grid,
                        cfg.bcs, cfg.fluid, advance=False,
                        need_ddtu=need_ddtu(cfg), pprecond=step.pprecond)
        ev[1].record()
        fl, pa, ufs = cloud.evolve(fl, st.particles, st.uf_smoothed,
                                   cfg.grid, cfg.bcs, cfg.cloud, cfg.dem,
                                   cfg.fluid, step.smoother)
        ev[2].record()
        fl = cloud.lift_drag_coeffs(fl, pa, ufs, cfg.grid, cfg.bcs,
                                    cfg.cloud, cfg.fluid, step.smoother)
        ev[3].record()
        torch.cuda.synchronize()
        for i in range(3):
            split[i] += ev[i].elapsed_time(ev[i + 1]) / N_SPLIT
        state = type(st)(fl, pa, ufs, st.uf_smoothed)
    say(f"per-phase (CUDA events, mean of {N_SPLIT} steps): fluid_step "
        f"{split[0]:.3f} ms, evolve {split[1]:.3f} ms, lift_drag_coeffs "
        f"{split[2]:.3f} ms")

    launches = fused.launches()
    in_graphs = fused.graph_launches()
    caps = captures() - caps
    n_steps = 1 + run.n_timed + N_SPLIT

    # host syncs of one coupled step, as torch's sync debug mode reports
    # them (outside the counted and timed runs: same path, same count)
    n_sync = count_syncs(lambda: graphed(tree_map(torch.clone, state)))
    n_eager = count_syncs(lambda: step(tree_map(torch.clone, state)))
    say(f"host syncs in one coupled step: {n_sync} in a replay of its graph"
        f", {n_eager} in the eager step (torch sync debug mode; "
        f"{cfg.cloud.sub_steps} Verlet rebuild tests + PCG stop tests)")
    if n_sync:
        fail(f"a replayed step made {n_sync} host syncs")
    GRAPHS["main_path_launches_in_graph"] = in_graphs
    expected = 1 + (n_steps + caps) * cfg.cloud.sub_cycles * sub
    say(f"contact_chain launches: {launches} (1 setup + ({n_steps} steps + "
        f"{caps} capture warm-up) x {sub} substeps = {expected}; "
        f"{in_graphs} of them inside the replayed graph)")
    if launches != expected:
        fail(f"kernel launched {launches} times, expected {expected}")

    for name, t in tree_leaves(state):
        if t.is_floating_point() and not bool(torch.isfinite(t).all()):
            fail(f"state field {name} is not finite")
    dropped = int(state.particles.nbr_dropped)
    alpha = state.fluid.alpha
    amin, amax = float(alpha.min()), float(alpha.max())
    say(f"state: finite; nbr_dropped {dropped}; alpha in [{amin:.4g}, "
        f"{amax:.4g}]; active {int(state.particles.active.sum())}")
    if dropped != 0:
        fail(f"neighbor audit: {dropped} in-ring partners dropped")
    # the f32 smoothing transform leaves alpha a few 1e-8 below 0 where
    # there are no particles (the JAX reference does the same in f32)
    if amin < -ALPHA_ROUNDOFF or amax > cfg.fluid.max_possible_alpha:
        fail(f"alpha outside [-{ALPHA_ROUNDOFF}, max_possible_alpha]")

    # one step through the kernel vs one through the plain chain
    plain_cfg = dataclasses.replace(
        cfg, dem=dataclasses.replace(cfg.dem, fused_chain=False))
    plain = CoupledStep(plain_cfg, dtype=torch.float32, device=dev)
    a = tree_map(torch.clone, graphed(tree_map(torch.clone, state)))
    b = plain(tree_map(torch.clone, state))
    worst, where = 0.0, ""
    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    # Ua = (smoothed sum of vol*U) / alpha is ill-conditioned where alpha
    # is at round-off level (no particles): compare alpha*Ua instead
    pairs.append((("fluid.alpha*Ua", a.fluid.Uc), ("", b.fluid.Uc)))
    for (name, x), (_, y) in pairs:
        if name == "fluid.Ua":
            continue
        if x.is_floating_point() and bool(torch.any(x != 0)):
            e = rel_err(x, y)
            if e > worst:
                worst, where = e, name
    say(f"one coupled step, kernel vs plain chain: worst {worst:.3e} "
        f"({where}; tol 1e-3; fluid.Ua compared as alpha*Ua)")
    if worst > 1e-3:
        fail("the main path through the kernel disagrees with the plain "
             "chain")
    return launches


class CountedAdvance:
    """A Simulation's graphed step (solver.GraphedStep), wrapped: the host
    syncs made inside each call (torch's sync debug mode), apart for the
    calls that captured and those that only replayed; before each call,
    unrelated allocations from the ordinary pool filled with NaN, which a
    graph that kept memory outside its pools would read or overwrite."""

    def __init__(self, graphed, dev):
        self.graphed, self.dev = graphed, dev
        self.replays = self.replay_syncs = self.capture_syncs = 0
        self.junk, self.where = [], []

    def __call__(self, state):
        import torch
        self.junk = [torch.full((1 << 20,), float("nan"), device=self.dev)
                     for _ in range(4)] + self.junk[:4]
        caps, out, where = self.graphed.captures, [], []
        n = count_syncs(lambda: out.append(self.graphed(state)), where)
        if self.graphed.captures != caps:
            self.capture_syncs += n
        else:
            self.replays += 1
            self.replay_syncs += n
            self.where += where
        return out[0]


def profile_replays(graphed, state, reps):
    """(device busy share, contact_chain microseconds per launch, kernels
    seen, the GRAPH_TOP kernels by device time with their microseconds
    per replay) over `reps` replays of a captured step, from
    torch.profiler: the kernels' summed time over the span from the first
    kernel's start to the last one's end (a profile may lose its first
    records: what it saw is counted)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    graphed(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            state = graphed(state)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        return None, None, 0, []
    busy = sum(b - a for a, b, _ in spans)
    span = max(b for _, b, _ in spans) - min(a for a, _, _ in spans)
    chain = [b - a for a, b, n in spans if "chain_kernel" in n]
    by_name = {}
    for a, b, n in spans:
        by_name[n[:60]] = by_name.get(n[:60], 0.0) + (b - a) / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:GRAPH_TOP]
    return busy / span, (sum(chain) / len(chain) if chain else None), \
        len(spans), [(n, round(us, 1)) for n, us in top]


def phase_graph(dev):
    """The coupled step captured as one CUDA graph and replayed, held
    against the eager step (CoupledStep.forward) on the bench case, the
    channel, the clumps and the windowed injection column: the same
    states (bit for bit, else within GRAPH_TOL of scale), the same PCG and
    BiCGStab iteration counts, no host sync inside a replay."""
    import torch
    from sedifoam_tpu_torch import bench_case, cases, linsolve
    from sedifoam_tpu_torch.dem import fused
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import initialize

    def bench():
        cfg = bench_case.build_config(**bench_case.FULL)
        fluid, particles = bench_case.build_state(
            cfg, bench_case.FULL["n_particles"], torch.float32, dev)
        return cfg, fluid, particles

    def channel():
        with tempfile.TemporaryDirectory() as tmp:
            case = cases.write_channel_case(os.path.join(tmp, "channel"),
                                            **cases.CHANNEL_FULL,
                                            overlap=CASE_OVERLAP)
            cfg, fluid, particles, _ = load_case(
                case, backend="binned", dtype=torch.float32, capacity=8192,
                device=dev)
        return dataclasses.replace(cfg, cloud=dataclasses.replace(
            cfg.cloud, semi_implicit_drag=True)), fluid, particles

    def clumps():
        return load_clumps(dev, cases.IRREGULAR_FULL["counts"])[:3]

    def inject():
        return cases.inject_case(**cases.INJECT_FULL, dtype=torch.float32,
                                 device=dev)

    def jetflow():
        # a few adds into the window first: the compared steps start from
        # jet particles in flight, and one add falls among them
        cfg, (state,) = jetflow_run(dev, JETFLOW_GRAPH_PRERUN)
        return cfg, state

    out = []
    for label, build in (("bench", bench), ("channel", channel),
                         ("clumps", clumps), ("inject", inject),
                         ("suspended", lambda: load_transport(dev,
                                                              "suspended")),
                         ("dune", lambda: load_transport(dev, "dune")),
                         ("jetflow", jetflow)):
        sizes0 = fused.launch_sizes()
        built = build()
        if len(built) == 2:                   # a state stepped already
            cfg, state0 = built
        else:
            cfg, fluid, particles = built
            state0 = initialize(fluid, particles, cfg)
        particles = state0.particles
        eager = Simulation(cfg, state0, device=dev)
        eager.advance = eager.step_fn               # the oracle
        graph = Simulation(cfg, state0, device=dev)
        counted = CountedAdvance(graph.advance, dev)
        graph.advance = counted
        s0 = int(state0.fluid.step)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        t0 = time.perf_counter()
        run_steps(graph, s0 + 1)                     # with the capture
        t_first = time.perf_counter() - t0
        reserved = (torch.cuda.memory_reserved(dev) - reserved) / 2**20
        run_steps(eager, s0 + 1)
        torch.cuda.synchronize()
        linsolve.reset_stats()
        t0 = time.perf_counter()
        run_steps(eager, s0 + 1 + GRAPH_STEPS)
        torch.cuda.synchronize()
        ms_eager = (time.perf_counter() - t0) / GRAPH_STEPS * 1e3
        stats_eager = dict(linsolve.STATS)
        linsolve.reset_stats()
        in_graphs, captured = fused.graph_launches(), dict(fused.CAPTURED)
        cap_s0 = counted.graphed.capture_seconds
        t0 = time.perf_counter()
        run_steps(graph, s0 + 1 + GRAPH_STEPS)
        torch.cuda.synchronize()
        # a window that grew captured anew in the run: its time is set-up
        recaptured = counted.graphed.capture_seconds - cap_s0
        ms_graph = (time.perf_counter() - t0 - recaptured) / GRAPH_STEPS * 1e3
        stats_graph = dict(linsolve.STATS)
        in_graphs = fused.graph_launches() - in_graphs
        captured = sum(fused.CAPTURED.values()) - sum(captured.values())
        g = counted.graphed
        differ = fields_that_differ(eager.state, graph.state)
        worst, where = compare_states(eager.state, graph.state) \
            if differ else (0.0, "")
        busy = chain_us = None
        top, seen = [], 0
        if label != "inject":
            busy, chain_us, seen, top = profile_replays(
                g, tree_map(torch.clone, graph.state), GRAPH_PROFILE)
            GRAPHS[f"{label}_busy_share_in_replay"] = busy
        if label == "bench":
            GRAPHS["chain_ms_in_replay"] = None if chain_us is None \
                else chain_us * 1e-3
        res = {"case": label, "captures": g.captures,
               "capture_s": g.capture_seconds,
               "first_step_s": t_first, "recapture_s": recaptured,
               "first_step_reserved_mb": reserved,
               "ms_eager": ms_eager,
               "ms_graph": ms_graph, "replays": counted.replays,
               "replay_syncs": counted.replay_syncs,
               "capture_syncs": counted.capture_syncs,
               "nodes": g.graph.nodes if g.graph else None,
               "iterations_eager": stats_eager,
               "iterations_graph": stats_graph,
               "kernel_launches_in_graphs": in_graphs,
               "kernel_launches_captured": captured,
               "bitwise": not differ, "worst": worst, "worst_field": where,
               "busy_share": busy, "chain_us_in_replay": chain_us,
               "top_kernels_us_per_replay": top}
        cap_s = g.capture_seconds
        say(f"graph [{label}]: {g.captures} capture(s) in {cap_s:.2f} s "
            f"({res['nodes']} conditional nodes in the last), first "
            f"step {t_first:.2f} s; {GRAPH_STEPS} steps {ms_eager:.3f} "
            f"ms/step eager, {ms_graph:.3f} ms/step replayed (host clock; "
            f"{recaptured:.2f} s of captures in the run taken out); "
            f"host syncs inside {counted.replays} replays: "
            f"{counted.replay_syncs} (in the captures' warm-ups: "
            f"{counted.capture_syncs}); PCG/BiCGStab [solves, iterations] "
            f"eager {stats_eager}, replayed {stats_graph}; replay vs eager "
            + ("equal bit for bit" if not differ else
               f"differ in {differ}, worst {worst:.3e} ({where}; tol "
               f"{GRAPH_TOL:.0e})")
            + f"; contact_chain launches inside the graphs {in_graphs} "
            f"({captured} captured)"
            + (f"; device busy {100 * busy:.1f}% of the replays' span "
               f"(torch.profiler, {GRAPH_PROFILE} replays, {seen} kernels "
               f"seen), the kernel {chain_us:.2f} us a launch inside a "
               f"replay; most device time per replay: {top}"
               if busy is not None and chain_us is not None else ""))
        if counted.replay_syncs:
            fail(f"graph [{label}]: {counted.replay_syncs} host syncs inside "
                 f"the replays, at {counted.where}")
        if stats_eager != stats_graph:
            fail(f"graph [{label}]: solver iterations differ")
        if differ and worst > GRAPH_TOL:
            fail(f"graph [{label}]: the replay disagrees with the eager step")
        if label == "inject" and g.captures < 2:
            fail("graph [inject]: the window never grew: one capture")
        if label == "jetflow":
            n_act = int(graph.state.particles.active.sum())
            say(f"graph [jetflow]: {n_act} active particles in "
                f"{graph.state.particles.n_capacity} rows after "
                f"{JETFLOW_GRAPH_PRERUN} + {1 + GRAPH_STEPS} steps, "
                f"{cfg.cloud.sub_steps} substeps a step; the first step "
                f"(its capture) reserved {reserved:.1f} MB")
            if n_act <= int(state0.particles.active.sum()):
                fail("graph [jetflow]: no add among the compared steps")
        sizes = fused.launch_sizes() - sizes0
        K = particles.nbr_idx.shape[0]
        out += [{"N": n, "K": K, "launches": c} for n, c in sizes.items()]
        res["launches"] = sum(sizes.values())
        GRAPHS[f"{label}_launches_in_graphs"] = in_graphs
        say("graph [" + label + "] " + json.dumps(res))
        del eager, graph, counted, g
    return out


def bench_probes(cfg):
    """Four probe points in the bed and above it."""
    L = cfg.grid.lengths
    return [(0.5 * L[0], 0.1 * L[1], 0.5 * L[2]),
            (0.25 * L[0], 0.3 * L[1], 0.75 * L[2]),
            (0.5 * L[0], 0.6 * L[1], 0.5 * L[2]),
            (0.75 * L[0], 0.9 * L[1], 0.25 * L[2])]


def check_finite(state, label):
    """Every floating field finite; per-particle fields on active rows
    only (an empty slot has radius 0, so its drag is 0/0, as in the
    reference)."""
    import torch
    active = state.particles.active
    for name, t in tree_leaves(state):
        if not t.is_floating_point():
            continue
        if name.startswith("particles.") and t.ndim and \
                t.shape[0] == active.shape[0]:
            t = t[active]
        if not bool(torch.isfinite(t).all()):
            fail(f"{label}: state field {name} is not finite")


def phase_runner(dev):
    """The bench case through Simulation: probes, a log every step, one
    write(), a checkpoint at the half-way step resumed by a fresh
    Simulation, and the runner's own timing split."""
    import torch
    from sedifoam_tpu_torch import bench_case
    from sedifoam_tpu_torch.dem import fused
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import CoupledStep
    cfg = bench_case.build_config(**bench_case.FULL)
    n = bench_case.FULL["n_particles"]
    half = RUNNER_STEPS // 2
    fluid, particles = bench_case.build_state(cfg, n, torch.float32, dev)
    probes = bench_probes(cfg)

    fused.reset_launches()
    caps = captures()
    state0 = CoupledStep(cfg, torch.float32, dev).initialize(fluid,
                                                             particles)
    setups = 1
    sim = Simulation(cfg, state0, probe_locations=probes, device=dev)
    run_steps(sim, half, log_every=1)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = sim.save_checkpoint(os.path.join(tmp, "ck.npz"))
        t0 = time.perf_counter()
        run_steps(sim, RUNNER_STEPS, log_every=1)
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        tdir = sim.write(tmp)
        t_write = time.perf_counter() - t1
        written = sorted(os.listdir(tdir))
        sim2 = Simulation(cfg, state0, probe_locations=probes, device=dev)
        sim2.resume(ckpt)
        if int(sim2.state.fluid.step) != half:
            fail(f"resumed at step {int(sim2.state.fluid.step)}, not {half}")
        run_steps(sim2, RUNNER_STEPS, log_every=1)
    torch.cuda.synchronize()
    launches = fused.launches()
    caps = captures() - caps
    expected = setups + (RUNNER_STEPS + RUNNER_STEPS - half + caps) * \
        cfg.cloud.sub_cycles * cfg.cloud.sub_steps
    say(f"runner: {RUNNER_STEPS} steps with {len(probes)} probes, a log "
        f"every step; steps {half + 1}-{RUNNER_STEPS} in {wall:.4f} s "
        f"({wall / (RUNNER_STEPS - half) * 1e3:.3f} ms/step incl. probes "
        f"and logs); write() {t_write:.3f} s: {', '.join(written)}")
    say(f"runner diagnostics at step {RUNNER_STEPS}: "
        + json.dumps(sim.log[-1]))
    t_a, p_a = sim.probes.series("p")
    t_b, p_b = sim2.probes.series("p")
    if len(t_a) != RUNNER_STEPS or len(t_b) != RUNNER_STEPS:
        fail(f"probe series of {len(t_a)} and {len(t_b)} samples")
    worst, where = compare_states(sim.state, sim2.state)
    import numpy as np
    pe = float(np.abs(p_a - p_b).max() / max(np.abs(p_a).max(), 1e-300))
    say(f"resume at step {half} vs straight run at step {RUNNER_STEPS}: "
        f"worst {worst:.3e} ({where}), probe p {pe:.3e} (tol 1e-4)")
    if worst > 1e-4 or pe > 1e-4:
        fail("the resumed run disagrees with the straight run")
    for s, label in ((sim.state, "runner"), (sim2.state, "resumed")):
        check_finite(s, label)
        if int(s.particles.nbr_dropped) != 0:
            fail(f"{label}: neighbor audit dropped in-ring partners")
    say(f"contact_chain launches: {launches} ({setups} setup + "
        f"({2 * RUNNER_STEPS - half} steps + {caps} capture warm-ups) x "
        f"{cfg.cloud.sub_steps} substeps = {expected})")
    if launches != expected:
        fail(f"kernel launched {launches} times, expected {expected}")
    split = sim.timing_split(n=2)          # launches after the count
    say("runner timing_split (CUDA events, mean of 2): " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in split.items()))
    from sedifoam_tpu_torch.runtime import diagnostics
    t0 = time.perf_counter()
    diagnostics.to_host(sim.diag_fn(sim.state))
    say(f"one diagnostics log (compute + one copy to the host): "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    return launches


def phase_inject(dev):
    """The injection column at jetFlow's capacity, windowed and at full
    capacity, compared by tag."""
    import numpy as np
    import torch
    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.dem import fused, inject
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import CoupledStep
    cfg, fluid, particles = cases.inject_case(**cases.INJECT_FULL,
                                              dtype=torch.float32,
                                              device=dev)
    cap = cases.INJECT_FULL["capacity"]
    sub = cfg.cloud.sub_cycles * cfg.cloud.sub_steps

    fused.reset_launches()
    caps = captures()
    syncs0 = inject.SYNCS
    state0 = CoupledStep(cfg, torch.float32, dev).initialize(fluid,
                                                             particles)
    win = Simulation(cfg, state0, device=dev)
    if not win.windowed:
        fail("the injection case did not switch the active window on")
    sizes = [win.state.particles.n_capacity]

    def track(s):
        sizes.append(s.state.particles.n_capacity)

    t0 = time.perf_counter()
    run_steps(win, INJECT_STEPS, on_sample=track)
    t_win = time.perf_counter() - t0
    full = Simulation(cfg, state0, active_window=False, device=dev)
    t0 = time.perf_counter()
    run_steps(full, INJECT_STEPS)
    t_full = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = fused.launches()
    by_n = dict(sorted(fused.launch_sizes().items()))
    caps = captures() - caps
    inject_syncs = inject.SYNCS - syncs0

    windows = [w for i, w in enumerate(sizes) if i == 0 or w != sizes[i - 1]]
    grows = len(windows) - 1
    pw, pf = win.state.particles, full.state.particles
    n_active = int(pw.active.sum())
    n_sites = len(inject.seed_positions(cfg.grid, cfg.cloud.add_box,
                                        cfg.cloud.reduce_number_factor))
    max_tag = int(pw.tag[pw.active].max())
    n_adds, rest = divmod(max_tag - 1, n_sites)
    say(f"inject: capacity {cap}, {n_sites} sites per add, {n_adds} adds "
        f"in {INJECT_STEPS} steps; windows {windows} ({grows} grows); "
        f"active {n_active}; windowed {t_win:.3f} s, full capacity "
        f"{t_full:.3f} s")
    say(f"contact_chain launches by N: {by_n}")
    if rest != 0:
        fail(f"max tag {max_tag} is not 1 + adds x {n_sites}")
    if grows < 2:
        fail(f"the window grew {grows} times (need >= 2)")
    if len(by_n) < 3:
        fail(f"the kernel ran at {len(by_n)} distinct N (need >= 3)")
    # a capture's warm-up step runs every substep and, taken or not, the
    # setup after an add once a subcycle
    expected = 1 + 2 * (n_adds + INJECT_STEPS * sub) + \
        caps * (sub + cfg.cloud.sub_cycles)
    say(f"contact_chain launches: {launches} (1 setup + 2 runs x "
        f"({n_adds} add setups + {INJECT_STEPS} steps x {sub} substeps) "
        f"+ {caps} captures (one per window) x ({sub} substeps + "
        f"{cfg.cloud.sub_cycles} setups) = {expected})")
    if launches != expected:
        fail(f"kernel launched {launches} times, expected {expected}")

    aw, af = pw.active, pf.active
    tw, tf = pw.tag[aw], pf.tag[af]
    ow, of = torch.argsort(tw), torch.argsort(tf)
    if not torch.equal(tw[ow], tf[of]):
        fail("windowed and full-capacity runs hold different tags")
    errs = {name: rel_err(getattr(pf, name)[af][of],
                          getattr(pw, name)[aw][ow])
            for name in ("pos", "vel", "omega")}
    say("windowed vs full capacity by tag: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + " (tol 1e-5)")
    if max(errs.values()) > 1e-5:
        fail("the windowed run disagrees with the full-capacity run")
    for s, label in ((win.state, "windowed"), (full.state, "full")):
        check_finite(s, label)

    # host syncs of two more steps (a plain one, then an add): inside the
    # eager coupled steps, and through the runner (its replays, the loop's
    # time test and the window check per visit)
    st = tree_map(torch.clone, win.state)
    in_step = count_syncs(lambda: win.step_fn(win.step_fn(st)))
    per_visit = count_syncs(
        lambda: win.run((INJECT_STEPS + 1.5) * cfg.fluid.dt))
    say(f"host syncs with injection, per step (mean of a plain step and "
        f"an add step; torch sync debug mode): {in_step / 2:.1f} in the "
        f"eager coupled step, {per_visit / 2:.1f} per runner visit (the "
        f"replay and the visit's reads); injection decisions read on the "
        f"host: {inject_syncs} in {2 * INJECT_STEPS} steps (the capture "
        f"warm-ups' eager steps)")
    return launches, by_n


def phase_dense(dev):
    """xiaocase3 on the dense backend in f64 through Simulation."""
    import torch
    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.dem import fused
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import CoupledStep
    cfg, fluid, particles = cases.xiaocase3(torch.float64, dev)
    launches = fused.launches()
    state = CoupledStep(cfg, torch.float64, dev).initialize(fluid,
                                                            particles)
    sim = Simulation(cfg, state, device=dev)
    run_steps(sim, DENSE_STEPS)
    st = sim.state
    v = float(st.particles.vel[0, 1])
    dy = abs(float(st.particles.pos[0, 1]) - 1.9e-3)
    say(f"dense: xiaocase3 {DENSE_STEPS} steps x {cfg.cloud.sub_steps} "
        f"substeps in {sim.wall_time:.3f} s; v_y {v:.6f} m/s "
        f"(bounds 0.01-0.045), |dy| {dy:.3e} m")
    if not 0.01 < v < 0.045:
        fail(f"xiaocase3 v_y {v} outside (0.01, 0.045)")
    if not (bool(torch.isfinite(st.fluid.p).all())
            and bool(torch.isfinite(st.fluid.Ub).all())):
        fail("xiaocase3 p or Ub is not finite")
    if dy >= 5e-4:
        fail(f"xiaocase3 particle moved {dy} m")
    if fused.launches() != launches:
        fail("the dense backend launched the binned kernel")


def phase_case(dev):
    """The transport-bedload channel loaded from its written case
    directory at full width, through Simulation."""
    import torch
    from sedifoam_tpu_torch import cases, linsolve
    from sedifoam_tpu_torch.config import ChannelForcing
    from sedifoam_tpu_torch.dem import fused
    from sedifoam_tpu_torch.fluid import piso
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import CoupledStep
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        case = cases.write_channel_case(os.path.join(tmp, "channel"),
                                        **cases.CHANNEL_FULL,
                                        overlap=CASE_OVERLAP)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        cfg, fluid, particles, controls = load_case(
            case, backend="binned", dtype=torch.float32, capacity=8192,
            device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    cfg = dataclasses.replace(cfg, cloud=dataclasses.replace(
        cfg.cloud, semi_implicit_drag=True))
    n_cells = cfg.grid.n_cells
    n0 = int(particles.active.sum())
    K = particles.nbr_idx.shape[0]
    full = cases.CHANNEL_FULL
    n_bed = len(cases.channel_bed(n_layers=full["layers"]))
    checks = {
        f"grid {cfg.grid.shape}": cfg.grid.shape == full["counts"],
        "graded y (1:10)": not cfg.grid.uniform,
        "periodic (T, F, T)": cfg.dem.periodic == (True, False, True),
        "frozen_types (2,)": cfg.dem.frozen_types == (2,),
        "hooke_history": cfg.dem.pair.style == "hooke_history",
        "Ubar 0.8": (cfg.fluid.forcing.mode == "Ubar"
                     and abs(cfg.fluid.forcing.mag_ubar - 0.8) < 1e-12),
        "kEqn": cfg.fluid.turbulence.model == "kEqn",
        "K 16": cfg.dem.nbr_k == K == 16,
        "carrier_rho 1000": cfg.dem.carrier_rho == 1000.0,
        f"{n0} particles, capacity {particles.n_capacity}": (
            n0 == n_bed and particles.n_capacity == 8192),
    }
    say(f"case: channel written in {t_write:.3f} s, loaded in {t_load:.3f} s"
        f" ({n_cells} cells, {n0} particles, capacity "
        f"{particles.n_capacity}, K {K}, dt {cfg.fluid.dt:g}, "
        f"{cfg.cloud.sub_steps} substeps); config: "
        + ", ".join(f"{k} {'ok' if v else 'WRONG'}" for k, v in checks.items()))
    if not all(checks.values()):
        fail(f"case config: {[k for k, v in checks.items() if not v]}")
    sub = cfg.cloud.sub_cycles * cfg.cloud.sub_steps

    settle_cfg = dataclasses.replace(cfg, fluid=dataclasses.replace(
        cfg.fluid, forcing=ChannelForcing(mode="none")))
    fused.reset_launches()
    caps = captures()
    state0 = CoupledStep(settle_cfg, torch.float32, dev).initialize(
        fluid, particles)
    frozen = state0.particles.ptype == 2
    pos_frozen = state0.particles.pos[frozen].clone()
    settle = Simulation(settle_cfg, state0, device=dev)
    t0 = time.perf_counter()
    run_steps(settle, 1)
    # the kernel and the whole step against their plain versions while
    # the pressed layers are in contact (launches made to compare do not
    # count)
    counted = launch_snapshot()
    p = settle.state.particles
    res = compare_chain("case f32", p, cfg.dem, True, 1e-5, timing=True,
                        may_be_zero=("wall_shear",))
    npair = int((p.shear != 0).any(dim=0).sum())
    say(f"case kernel state: {npair} pair slots with shear history")
    st = settle.state
    kern = CoupledStep(cfg, torch.float32, dev)
    plain = CoupledStep(dataclasses.replace(cfg, dem=dataclasses.replace(
        cfg.dem, fused_chain=False)), torch.float32, dev)
    worst, where = compare_states(kern(tree_map(torch.clone, st)),
                                  plain(tree_map(torch.clone, st)))
    say(f"case: one coupled step, kernel vs plain chain: worst {worst:.3e} "
        f"({where}; tol 1e-3; Ua, DDtUa and phia compared as alpha*Ua)")
    if worst > 1e-3:
        fail("the case path through the kernel disagrees with the plain "
             "chain")
    launch_restore(counted)
    run_steps(settle, CASE_SETTLE)
    torch.cuda.synchronize()
    t_settle = time.perf_counter() - t0

    sim = Simulation(cfg, settle.state, device=dev)
    gp_series = []                 # device scalars: read after the run
    record = lambda m: gp_series.append(                      # noqa: E731
        m.state.fluid.grad_p_value.clone())
    t0 = time.perf_counter()
    run_steps(sim, CASE_SETTLE + 1, on_sample=record)   # with the capture
    t_capture = time.perf_counter() - t0
    linsolve.reset_stats()
    t0 = time.perf_counter()
    run_steps(sim, CASE_SETTLE + CASE_STEPS, on_sample=record)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused.launches()
    by_n = dict(fused.launch_sizes())
    caps = captures() - caps
    timed = CASE_STEPS - 1
    it = {k: v[1] / timed for k, v in linsolve.STATS.items()}
    ms = wall / timed * 1e3
    say(f"case: {CASE_SETTLE} settling steps in {t_settle:.3f} s (with the "
        f"comparisons), the first Ubar step with its capture in "
        f"{t_capture:.3f} s, {timed} Ubar steps in {wall:.4f} s = "
        f"{ms:.3f} ms/step; per step {it['pcg']:.1f} PCG and "
        f"{it['bicgstab']:.1f} BiCGStab iterations "
        f"({linsolve.STATS['pcg'][0] / timed:.1f} and "
        f"{linsolve.STATS['bicgstab'][0] / timed:.1f} solves; counted on "
        "the device inside the replays)")

    s = sim.state
    check_finite(s, "case")
    dropped = int(s.particles.nbr_dropped)
    n_active = int(s.particles.active.sum())
    moved = float((s.particles.pos[frozen] - pos_frozen).abs().max())
    alpha = s.fluid.alpha
    amin, amax = float(alpha.min()), float(alpha.max())
    gp = [float(g) for g in gp_series]
    gp_mean = sum(gp) / len(gp)
    # the controller's own target: the beta*V-weighted mean of the
    # mixture velocity along the flow direction (chPressureGrad.C:242-257)
    bV = s.fluid.beta * torch.as_tensor(cfg.grid.cell_volume,
                                        dtype=alpha.dtype, device=dev)
    ubar = float((s.fluid.U[0] * bV).sum() / bV.sum())
    ubx = float(s.fluid.Ub[0].mean())
    say(f"case state: finite; nbr_dropped {dropped}; active {n_active}; "
        f"frozen rows moved {moved:.3e} m; alpha in [{amin:.4g}, "
        f"{amax:.4g}]; Ubar {ubar:.6f} m/s (target 0.8); mean Ub_x "
        f"{ubx:.6g} m/s; grad_p_value by Ubar step "
        f"{[round(g, 4) for g in gp]} (mean {gp_mean:.6g}); "
        f"mobile mean |v| "
        f"{float(s.particles.vel[s.particles.ptype == 1].norm(dim=1).mean()):.4g}"
        " m/s")
    if dropped != 0:
        fail(f"case: neighbor audit dropped {dropped} in-ring partners")
    if n_active != n0:
        fail(f"case: {n0 - n_active} particles escaped")
    if not torch.equal(s.particles.pos[frozen], pos_frozen):
        fail(f"case: the frozen bed moved ({moved} m)")
    if amin < -ALPHA_ROUNDOFF or amax > cfg.fluid.max_possible_alpha:
        fail(f"case: alpha outside [-{ALPHA_ROUNDOFF}, max_possible_alpha]")
    # the forcing that took the stream from rest to Ubar is positive over
    # the run; its value at a single step of the spin-up may change sign
    if not (gp_mean > 0.0 and ubx > 0.0 and abs(ubar - 0.8) < 1e-3):
        fail(f"case: Ubar forcing: mean grad_p_value {gp_mean}, mean Ub_x "
             f"{ubx}, Ubar {ubar}")
    expected = 1 + (CASE_SETTLE + CASE_STEPS + caps) * sub
    say(f"contact_chain launches: {launches} (1 setup + "
        f"({CASE_SETTLE + CASE_STEPS} steps + {caps} capture warm-ups) x "
        f"{sub} substeps = {expected}) by N {by_n} at K {K}")
    if launches != expected:
        fail(f"kernel launched {launches} times, expected {expected}")

    # host syncs, the split, the Ubar sums (after the counted run)
    n_sync = count_syncs(lambda: sim.step_fn(tree_map(torch.clone, s)))
    n_replay = count_syncs(lambda: sim.advance(tree_map(torch.clone, s)))
    say(f"case: host syncs in one coupled step: {n_replay} in a replay of "
        f"its graph, {n_sync} in the eager step (torch sync debug mode; "
        f"{sub} Verlet rebuild tests + PCG and BiCGStab stop tests)")
    if n_replay:
        fail(f"case: a replayed step made {n_replay} host syncs")
    split = sim.timing_split(n=2)
    say("case timing_split (CUDA events, mean of 2): " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in split.items()))
    fs = s.fluid
    rua = torch.full_like(fs.alpha, 1e-3)
    ubar_ms = cuda_ms(lambda: piso.adjust_channel_forcing(
        fs, rua, cfg.grid, cfg.fluid), 3)
    say(f"case: one Ubar adjust (its 4 compensated sums over {n_cells} "
        f"cells, {-(-n_cells // 1024)} block partials each) {ubar_ms:.3f} ms"
        f" (CUDA events), {ubar_ms / ms * 100:.1f}% of a step")
    res["launches"] = launches
    res["by_n"], res["K"] = by_n, K
    return res


def phase_case_jetflow(dev):
    """jetFlow written as a case directory at its full O-grid
    (cases.JET_FULL) and loaded as its validator loads it: the embedded
    grid, the inlet disc's covered area against pi r^2, the BC kinds,
    turbulence, frozen type, injection and the run shape."""
    import numpy as np
    from sedifoam_tpu_torch import bc, cases
    from sedifoam_tpu_torch.dem.inject import seed_positions
    from sedifoam_tpu_torch.validate import jetflow
    cfg, state, t_write, t_load = load_jetflow(dev)
    p = state.particles
    g = cfg.grid
    full = cases.JET_FULL
    nc = full["column_cells"]
    side = (full["counts"][0] - nc) // 2
    w = np.diff(np.asarray(g.axis_faces(0)))
    ub = cfg.bcs.Ub.ym
    _, q_disc, q_exact = jetflow.inlet_fluxes(cfg, state.fluid, cases.JET_U)
    area_err = abs(q_disc / q_exact - 1.0)
    sites = len(seed_positions(g, cfg.cloud.add_box,
                               cfg.cloud.reduce_number_factor))
    # the column's cell centres inside the square inscribed in the disc
    centres = (np.arange(nc) + 0.5) * cases.JET_COLUMN / nc \
        - 0.5 * cases.JET_COLUMN
    per_axis = int((np.abs(centres) <= cases.JET_D / 8 ** 0.5).sum())
    checks = {
        f"grid {g.shape}": g.shape == tuple(full["counts"]),
        "x from -0.05 to 0.05 m": bool(np.allclose(
            np.asarray(g.axis_faces(0))[[0, -1]], [-0.05, 0.05])),
        "column uniform 4.4 mm": bool(np.allclose(
            w[side:side + nc], cases.JET_COLUMN / nc)),
        "sides mirrored, fine at the column": bool(
            np.allclose(w[:side], w[::-1][:side]) and w[0] > 5 * w[side - 1]),
        "Ub.ym RegionPatchBC fixedValue (0 1.72 0) / slip": (
            isinstance(ub, bc.RegionPatchBC)
            and ub.inside.kind == bc.FIXED_VALUE
            and ub.inside.value == (0.0, cases.JET_U, 0.0)
            and ub.outside.kind == bc.SLIP
            and abs(ub.region.radius - 0.5 * cases.JET_D) < 1e-15),
        "Ub.yp inletOutlet, p.yp fixedValue": (
            cfg.bcs.Ub.yp.kind == bc.INLET_OUTLET
            and cfg.bcs.p.yp.kind == bc.FIXED_VALUE),
        "alpha.ym zeroGradient, Ua.ym slip": (
            cfg.bcs.alpha.ym.kind == bc.ZERO_GRADIENT
            and cfg.bcs.Ua.ym.kind == bc.SLIP),
        f"disc area within 2e-2 of pi r^2 ({area_err:.3e})": area_err < 2e-2,
        "kEqn": cfg.fluid.turbulence.model == "kEqn",
        "frozen_types (2,)": cfg.dem.frozen_types == (2,),
        "add and delete, add velocity (0 1.72 0)": (
            cfg.cloud.add_particle == 1 and cfg.cloud.delete_particle == 1
            and cfg.cloud.add_velocity == (0.0, cases.JET_U, 0.0)),
        f"{sites} add sites": sites == per_axis ** 2,
        "200 substeps of 1e-6 s": (cfg.cloud.sub_steps == 200
                                   and abs(cfg.dem.dt - 1e-6) < 1e-18),
        "K 16, three wall planes": (p.nbr_idx.shape[0] == cfg.dem.nbr_k == 16
                                    and len(cfg.dem.walls) == 3),
        f"6 particles in {p.n_capacity} rows": (
            int(p.active.sum()) == 6 and p.n_capacity == jetflow.CAPACITY),
    }
    say(f"case [jetflow]: written in {t_write:.2f} s, loaded (embedded "
        f"O-grid, {g.n_cells} cells, initialized) in {t_load:.2f} s; "
        + ", ".join(f"{k}: {v}" for k, v in checks.items()))
    bad = [k for k, v in checks.items() if not v]
    if bad:
        fail(f"case [jetflow]: {bad}")


def phase_entry(dev):
    """Simulation.from_case and the run_case module on the written
    xiaocase3."""
    import torch
    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import initialize
    with tempfile.TemporaryDirectory() as tmp:
        case = cases.write_xiaocase3(os.path.join(tmp, "xiaocase3"))
        sim = Simulation.from_case(case, device=dev)
        cfg, fluid, particles = cases.xiaocase3(torch.float64, dev)
        built = Simulation(cfg, initialize(fluid, particles, cfg),
                           device=dev)
        for s in (sim, built):
            run_steps(s, ENTRY_STEPS)
        worst, where = compare_states(built.state, sim.state)
        say(f"entry: Simulation.from_case(xiaocase3) vs cases.xiaocase3(), "
            f"{ENTRY_STEPS} steps (dense, f64): worst {worst:.3e} ({where}; "
            f"tol 1e-12); controls {sim.controls}")
        if worst > 1e-12 or sim.state.fluid.p.device.type != "cuda":
            fail("Simulation.from_case disagrees with the built case")
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=REPO)
        res = subprocess.run(
            [sys.executable, "-m", "sedifoam_tpu_torch.run_case", case,
             "--f64", "--backend", "dense", "--t-end", "6e-5",
             "--device", "cuda"], capture_output=True, text=True, env=env,
            cwd=REPO, timeout=600)
        t_run = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"run_case exited {res.returncode}: {res.stderr[-2000:]}")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    keys = {"case", "t_end", "n_particles", "wall_time_s", "steps_per_s"}
    say(f"entry: python -m sedifoam_tpu_torch.run_case --device cuda: exit "
        f"0 in {t_run:.2f} s, {json.dumps(summary)}")
    if not keys <= set(summary) or summary["n_particles"] != 1:
        fail(f"run_case summary {summary}")


def phase_clumps(dev):
    """The irregular-grain channel loaded from its written case directory
    at full width, through Simulation, with scripts/validate_irregular.py's
    gates."""
    import torch
    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.dem import fused, integrate, rigid
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import CoupledStep
    from sedifoam_tpu_torch.validate.irregular import (member_gaps,
                                                       same_body_slots)
    full = cases.IRREGULAR_FULL
    cfg, fluid, particles, t_write, t_load = load_clumps(dev, full["counts"])
    n0 = int(particles.active.sum())
    K = particles.nbr_idx.shape[0]
    n_floor = int((particles.ptype == 2).sum())
    n_clumps = full["n_clumps"]
    n_bed = len(cases.trimer_bed(n_clumps, full["floor_d"])[0])
    checks = {
        f"grid {cfg.grid.shape}": cfg.grid.shape == full["counts"],
        "graded y (1:10)": not cfg.grid.uniform,
        "periodic (T, F, T)": cfg.dem.periodic == (True, False, True),
        "frozen_types (2,)": cfg.dem.frozen_types == (2,),
        "hooke_history": cfg.dem.pair.style == "hooke_history",
        "Ubar 0.5": (cfg.fluid.forcing.mode == "Ubar"
                     and abs(cfg.fluid.forcing.mag_ubar - 0.5) < 1e-12),
        "kEqn": cfg.fluid.turbulence.model == "kEqn",
        "K 160": cfg.dem.nbr_k == K == 160,
        f"{n0} particles ({n_floor} floor), capacity "
        f"{particles.n_capacity}": (
            n0 == n_bed == n_floor + 3 * n_clumps
            and particles.n_capacity == 8192),
        f"{n_clumps} bodies": (
            particles.rigid is not None
            and int(particles.rigid.valid.sum()) == n_clumps
            and int((particles.mol > 0).sum()) == 3 * n_clumps),
    }
    sub = cfg.cloud.sub_cycles * cfg.cloud.sub_steps
    say(f"clumps: case written in {t_write:.3f} s, loaded in {t_load:.3f} s "
        f"({cfg.grid.n_cells} cells, {n0} particles, K {K}, dt "
        f"{cfg.fluid.dt:g}, {sub} substeps); config: " + ", ".join(
            f"{k} {'ok' if v else 'WRONG'}" for k, v in checks.items()))
    if not all(checks.values()):
        fail(f"clumps config: {[k for k, v in checks.items() if not v]}")

    fused.reset_launches()
    caps = captures()
    state0 = CoupledStep(cfg, torch.float32, dev).initialize(fluid,
                                                             particles)
    p0 = state0.particles
    floor = p0.ptype == 2
    gaps0 = member_gaps(p0)
    if same_body_slots(p0):
        fail("clumps: the first table holds same-body partners")
    sim = Simulation(cfg, state0, device=dev)
    if sim.windowed:
        fail("clumps: the active window must stay off with rigid bodies")
    run_steps(sim, 1)                      # warm-up, with the capture
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run_steps(sim, CLUMP_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fused.launches()
    by_n = dict(fused.launch_sizes())
    caps = captures() - caps
    counted = launch_snapshot()
    ms = wall / (CLUMP_STEPS - 1) * 1e3
    expected = 1 + (CLUMP_STEPS + caps) * sub
    say(f"clumps: steps 2-{CLUMP_STEPS} in {wall:.4f} s = {ms:.3f} ms/step; "
        f"contact_chain launches {launches} (1 setup + ({CLUMP_STEPS} steps "
        f"+ {caps} capture warm-up) x {sub} substeps = {expected}; {sub} a "
        f"step) by N {by_n} at K {K}")
    if launches != expected:
        fail(f"clumps: kernel launched {launches} times, expected {expected}")

    # the same steps through the plain chain ...
    plain_cfg = dataclasses.replace(cfg, dem=dataclasses.replace(
        cfg.dem, fused_chain=False))
    plain = Simulation(plain_cfg, state0, device=dev)
    run_steps(plain, CLUMP_STEPS)
    # ... and through the kernel again, by way of a checkpoint half-way
    # that a fresh Simulation resumes
    again = Simulation(cfg, state0, device=dev)
    run_steps(again, CLUMP_STEPS // 2)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = again.save_checkpoint(os.path.join(tmp, "ck.npz"))
        again = Simulation(cfg, state0, device=dev)
        again.resume(ckpt)
    if int(again.state.fluid.step) != CLUMP_STEPS // 2:
        fail(f"clumps: resumed at step {int(again.state.fluid.step)}")
    run_steps(again, CLUMP_STEPS)
    launch_restore(counted)
    worst, where = compare_states(sim.state, plain.state)
    say(f"clumps: {CLUMP_STEPS} steps, kernel vs plain chain: worst "
        f"{worst:.3e} ({where}; tol 1e-3; Ua, DDtUa and phia compared as "
        "alpha*Ua)")
    if worst > 1e-3:
        fail("the clump path through the kernel disagrees with the plain "
             "chain")
    differ = fields_that_differ(sim.state, again.state)
    say(f"clumps: a second run of the same {CLUMP_STEPS} steps, resumed "
        f"from its checkpoint at step {CLUMP_STEPS // 2}, equal bit for "
        f"bit: {not differ} (the body sums add in a fixed order)")
    if differ:
        fail(f"clumps: the resumed run differs from the straight run in "
             f"{differ}")

    s = sim.state
    p = s.particles
    check_finite(s, "clumps")
    dropped = int(p.nbr_dropped)
    n_active = int(p.active.sum())
    gap_dev = float((member_gaps(p) - gaps0).abs().max())
    moved = float((p.pos[floor] - p0.pos[floor]).abs().max())
    alpha = s.fluid.alpha
    amin, amax = float(alpha.min()), float(alpha.max())
    vel = p.vel[p.mol > 0]
    touched = int((p.shear != 0).any(dim=0)[:, p.mol > 0].any(dim=0).sum())
    rebuilt = integrate.maybe_rebuild_neighbors(p, cfg.dem, force=True)
    same = same_body_slots(p), same_body_slots(rebuilt)
    say(f"clumps state: finite; nbr_dropped {dropped}; active {n_active}; "
        f"member gaps changed by at most {gap_dev:.3e} m; floor moved "
        f"{moved:.3e} m; alpha in [{amin:.4g}, {amax:.4g}]; members' mean "
        f"vx {float(vel[:, 0].mean()):.4g}, vy {float(vel[:, 1].mean()):.4g}"
        f" m/s; {touched} members in contact; same-body slots {same[0]} in "
        f"the run's table, {same[1]} after a forced rebuild")
    if dropped != 0:
        fail(f"clumps: neighbor audit dropped {dropped} in-ring partners")
    if n_active != n0:
        fail(f"clumps: {n0 - n_active} particles lost")
    if gap_dev >= 1e-7:
        fail(f"clumps: member distances changed by {gap_dev} m")
    if not torch.equal(p.pos[floor], p0.pos[floor]):
        fail(f"clumps: the frozen floor moved ({moved} m)")
    if amin <= -1e-4:
        fail(f"clumps: alpha {amin} below -1e-4")
    if same != (0, 0):
        fail(f"clumps: same-body partners in the table: {same}")

    split = sim.timing_split(n=2)
    say("clumps timing_split (CUDA events, mean of 2): " + ", ".join(
        f"{k} {v * 1e3:.3f} ms" for k, v in split.items()))
    # the two body passes of a substep, beside the substep itself
    def body_passes():
        return rigid.final_integrate(rigid.initial_integrate(
            p, cfg.dem.dt, cfg.dem.domain_lo, cfg.dem.domain_hi,
            cfg.dem.periodic), cfg.dem.dt)

    body_ms = cuda_ms(body_passes, 50)
    q = p._replace(shear=p.shear.clone(), wall_shear=p.wall_shear.clone())
    sub_ms = cuda_ms(lambda: integrate.run_dem(q, cfg.dem, 1), 50)
    free = q._replace(rigid=None)
    free_ms = cuda_ms(lambda: integrate.run_dem(free, cfg.dem, 1), 50)
    launch_restore(counted)
    say(f"clumps: the two body passes {body_ms:.4f} ms per substep (CUDA "
        f"events, mean of 50; host-bound), "
        f"{100 * body_ms / sub_ms:.1f}% of "
        f"a substep of {sub_ms:.4f} ms ({free_ms:.4f} ms with the bodies "
        "taken out of the state)")
    return {"launches": launches, "by_n": by_n, "K": K}


def phase_extras(dev):
    """Cohesion and lubrication on the bench lattice, and the contact
    observables, at full width."""
    import torch
    from sedifoam_tpu_torch import bench_case, cases
    from sedifoam_tpu_torch.dem import (cohesion, fused, integrate,
                                        lubrication, observables)
    from sedifoam_tpu_torch.dem.state import make_particles
    n = bench_case.FULL["n_particles"]
    variants = (("cohesion model 0", dict(cohesion_model=0)),
                ("cohesion model 1", dict(cohesion_model=1)),
                ("lubrication", dict(lubrication=True)))

    def f64(t):
        return t.double() if t.is_floating_point() else t

    def fresh(q):
        return q._replace(shear=q.shear.clone(),
                          wall_shear=q.wall_shear.clone())

    def extra_force(q, dem, pairwise_only=False):
        """(force, torque or None) of the one extra that dem switches on,
        over q's table; pairwise_only leaves lubrication's FLD drag out."""
        plen = dem.periodic_len()
        if dem.cohesion is not None:
            return cohesion.cohesion_forces_binned(
                q, dem.cohesion, q.nbr_idx, plen), None
        lub = dem.lubrication
        if pairwise_only:
            lub = dataclasses.replace(lub, flagfld=0)
        return lubrication.lubrication_forces_binned(q, lub, q.nbr_idx, plen)

    fused.reset_launches()
    K = None
    for label, kw in variants:
        torch.cuda.reset_peak_memory_stats()
        dem, p = cases.extras_bed(n, dtype=torch.float32, device=dev, **kw)
        K = dem.nbr_k
        if K > 32:
            fail(f"extras [{label}]: K {K} > 32")
        bare = dataclasses.replace(dem, cohesion=None, lubrication=None)
        p = integrate.setup_forces(p, dem)
        counted = launch_snapshot()
        ms_with = cuda_ms(lambda: integrate.run_dem(fresh(p), dem, 1), 10)
        ms_bare = cuda_ms(lambda: integrate.run_dem(fresh(p), bare, 1), 10)
        launch_restore(counted)
        p = integrate.run_dem(p, dem, EXTRAS_SUBSTEPS)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        for name in ("pos", "vel", "omega", "force", "torque"):
            if not bool(torch.isfinite(getattr(p, name)).all()):
                fail(f"extras [{label}]: {name} is not finite")
        dropped = int(p.nbr_dropped)
        if dropped != 0:
            fail(f"extras [{label}]: {dropped} in-ring partners dropped")
        # Newton's third law over the table: the pair terms cancel
        plen = dem.periodic_len()
        f, _ = extra_force(p, dem, pairwise_only=True)
        total = float(f.double().sum(dim=0).abs().max())
        scale = float(f.double().abs().sum(dim=0).max())
        say(f"extras [{label}]: N {n}, K {K}, cutoff {dem.cutoff:g}; "
            f"{ms_with:.3f} ms per substep with it, {ms_bare:.3f} without "
            f"(CUDA events, mean of 10); peak memory {peak:.0f} MiB; "
            f"nbr_dropped 0; pair forces sum to {total:.3e} of {scale:.3e} "
            f"summed in magnitude ({total / scale:.2e}; tol 1e-5)")
        if not scale > 0.0 or total > 1e-5 * scale:
            fail(f"extras [{label}]: the pair forces do not cancel")

        # the observables against a count made here
        ct = observables.contact_table(p, dem)
        touching = int(ct["touching"].sum())
        counts = f"contact_table {touching} touching slots"
        ok = touching == slots_within(p, plen) and touching > 0
        if dem.cohesion is not None:
            co = observables.cohesion_table(p, dem)
            ring = int(co["touching"].sum())
            counts += f", cohesion_table {ring} slots within smax"
            ok = ok and ring == slots_within(p, plen, dem.cohesion.smax) \
                and ring > touching
        say(f"extras [{label}]: {counts}: equal to the counts from the "
            f"positions: {ok}")
        if not ok:
            fail(f"extras [{label}]: the observables' counts are off")

        # f32 against f64 on the same (f32-rounded) window of 8,192: the
        # extra's own force on one state (2e-2: the surface separation of
        # a pair 1e-7 m apart is the difference of two lengths of 1e-3 m,
        # f32 resolves it to 6e-4 of itself, and the cohesive law goes
        # with its inverse cube), then the motion after the substeps.
        # (The total force is not held: the contact law takes
        # an overlap of ~1e-5 m as the difference of two lengths of 1e-3
        # m, which f32 resolves to 6e-6 of itself on one state and, once
        # the f32 run has rounded its own positions, to 4e-4; and
        # lubrication's inner cutoff is a jump in the law.)
        dem_w, w32 = cases.extras_bed(8192, dtype=torch.float32, device=dev,
                                      **kw)
        counted = launch_snapshot()
        w64 = tree_map(f64, w32)
        w32 = integrate.setup_forces(w32, dem_w)
        w64 = integrate.setup_forces(w64, dem_w)
        errs0 = {k: rel_err(a, b) for k, a, b in zip(
            ("force", "torque"), extra_force(w64, dem_w),
            extra_force(w32, dem_w)) if a is not None}
        w32 = integrate.run_dem(w32, dem_w, EXTRAS_SUBSTEPS)
        w64 = integrate.run_dem(w64, dem_w, EXTRAS_SUBSTEPS)
        errs = {name: rel_err(getattr(w64, name), getattr(w32, name))
                for name in ("pos", "vel", "omega", "force", "torque")}
        # binned against dense at 2,048, f64
        dem_b, b = cases.extras_bed(2048, dtype=torch.float64, device=dev,
                                    **kw)
        dem_d = dataclasses.replace(dem_b, backend="dense")
        d = make_particles(b.pos.cpu().numpy(), b.radius.cpu().numpy(),
                           b.density.cpu().numpy(), vel=b.vel.cpu().numpy(),
                           omega=b.omega.cpu().numpy(),
                           n_walls=len(dem_b.walls), dtype=torch.float64,
                           device=dev)
        b = integrate.setup_forces(b, dem_b)
        d = integrate.setup_forces(d, dem_d)
        launch_restore(counted)
        errs_d = {name: rel_err(getattr(d, name), getattr(b, name))
                  for name in ("force", "torque")}
        say(f"extras [{label}]: f32 vs f64 at 8,192, the extra's own "
            "terms on one state: "
            + ", ".join(f"{k} {v:.3e}" for k, v in errs0.items())
            + f" (tol 2e-2); after {EXTRAS_SUBSTEPS} substeps: " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs.items())
            + " (tol: pos 1e-5, vel 2e-2; the rest is not held); binned vs "
            "dense at 2,048 (f64): " + ", ".join(
                f"{k} {v:.3e}" for k, v in errs_d.items()) + " (tol 1e-10)")
        if max(errs0.values()) > 2e-2 or errs["pos"] > 1e-5 \
                or errs["vel"] > 2e-2 or max(errs_d.values()) > 1e-10:
            fail(f"extras [{label}]: precisions or backends disagree")
    launches = fused.launches()
    expected = len(variants) * (1 + EXTRAS_SUBSTEPS)
    by_n = dict(fused.launch_sizes())
    say(f"extras: contact_chain launches {launches} ({len(variants)} "
        f"variants x (1 setup + {EXTRAS_SUBSTEPS} substeps) = {expected}) "
        f"by N {by_n} at K {K}")
    if launches != expected:
        fail(f"extras: kernel launched {launches} times, expected {expected}")
    return {"launches": launches, "by_n": by_n, "K": K}


def phase_dns(dev):
    """The DNS spectral forcing in tests/test_ibm_dns.py's periodic box at
    DNS_N^3 cells."""
    import torch
    from sedifoam_tpu_torch import bc
    from sedifoam_tpu_torch.config import FluidConfig, PISOConfig
    from sedifoam_tpu_torch.fluid import bodyforce
    from sedifoam_tpu_torch.fluid.state import FluidBCs, init_fluid
    from sedifoam_tpu_torch.fluid.step import fluid_step
    from sedifoam_tpu_torch.grid import Grid
    n, L = DNS_N, 0.08
    grid = Grid(nx=n, ny=n, nz=n, dx=L / n, dy=L / n, dz=L / n)
    cyc = bc.PatchBC(bc.CYCLIC)
    cyc3 = bc.PatchBC(bc.CYCLIC, (0.0, 0.0, 0.0))
    bcs = FluidBCs(alpha=bc.FieldBC(*(cyc for _ in range(6))),
                   p=bc.FieldBC(*(cyc for _ in range(6))),
                   Ub=bc.FieldBC(*(cyc3 for _ in range(6))),
                   Ua=bc.FieldBC(*(cyc3 for _ in range(6))))
    for dtype, p_tol in ((torch.float32, 1e-6), (torch.float64, 1e-9)):
        name = str(dtype).split(".")[-1]
        # the test's parameters; f32 cannot reach its p_tol of 1e-9
        cfg = FluidConfig(dt=1e-3, rhob=1000.0, nub=1e-6,
                          piso=PISOConfig(n_correctors=1, p_tol=p_tol),
                          add_dns_force=True, dns_alpha=1.0, dns_sigma=0.5,
                          dns_k_upper=600.0, dns_k_lower=0.0)
        fs0 = init_fluid(grid, dtype=dtype, device=dev)
        fs0 = fs0._replace(dns_key=torch.tensor([0, 7], dtype=torch.int64,
                                                device=dev))

        def run():
            fs = fs0
            for _ in range(DNS_STEPS):
                fs = fluid_step(fs, grid, bcs, cfg)
            return fs

        run()                                              # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fs = run()
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) / DNS_STEPS * 1e3
        again = run()
        for field, t in tree_leaves(fs):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                fail(f"dns {name}: {field} is not finite")
        differ = fields_that_differ(fs, again)
        force = fs.turbulence_force
        K, k_mag, _ = bodyforce._wavevectors(grid, dtype, dev)
        Fk = torch.fft.fftn(force, dim=(-3, -2, -1))
        div = float((K * Fk).sum(dim=0).abs().max())
        scale = float((k_mag[None] * Fk.abs()).max())
        modes = int((fs.dns_f_hat != 0).any(dim=0).any(dim=0).sum())
        uo = bodyforce.UOForcingState(fs.dns_f_hat, fs.dns_key)
        ms_force = cuda_ms(lambda: bodyforce.uo_forcing_step(
            uo, grid, cfg.dt, cfg.dns_alpha, cfg.dns_sigma, cfg.dns_k_upper,
            cfg.dns_k_lower), 20)
        eps = torch.finfo(dtype).eps
        say(f"dns {name}: {n}^3 box, {DNS_STEPS} fluid steps, "
            f"{ms_step:.3f} ms/step (host clock), {ms_force:.4f} ms per "
            f"forcing step (CUDA events, mean of 20); {modes} modes in the "
            f"shell; max |force| {float(force.abs().max()):.4g}, kinetic "
            f"energy sum {float((fs.Ub ** 2).sum()):.4g}; spectral "
            f"divergence {div:.3e} of {scale:.3e} = {div / scale:.2e} (tol "
            f"{1e3 * eps:.1e}); a second run equal bit for bit: "
            f"{not differ}")
        if not float(force.abs().max()) > 0.0 or modes == 0:
            fail(f"dns {name}: the forcing is zero")
        if div > 1e3 * eps * scale:
            fail(f"dns {name}: the force is not solenoidal")
        if differ:
            fail(f"dns {name}: two runs from one key differ in {differ}")


def phase_bench(dev, floor):
    """The bench entry point (sedifoam_tpu_torch.bench) at full width,
    BENCH_REPEATS timed blocks each, once as it stands and once with
    bin-sorted rebuilds: the same physics by tag, the kernel against its
    plain version on the sorted state, its device time on both states."""
    import torch
    from sedifoam_tpu_torch import bench
    from sedifoam_tpu_torch.dem import fused

    def report(label):
        def fn(i, wall, rate):
            say(f"bench [{label}] repeat {i + 1}/{BENCH_REPEATS}: "
                f"{wall:.4f} s, {rate:.1f} particle-substeps/s")
        return fn

    fused.reset_launches()
    caps = captures()
    runs = {}
    for label, sort in (("unsorted", False), ("sorted", True)):
        runs[label] = bench.run(device=dev, repeats=BENCH_REPEATS,
                                sort_on_rebuild=sort, report=report(label))
        line = bench.result_line(runs[label].value)
        say(f"bench [{label}]: median of {BENCH_REPEATS}: "
            + json.dumps(line))
    torch.cuda.synchronize()
    launches = fused.launches()
    by_n = dict(fused.launch_sizes())
    caps = captures() - caps
    plain, srt = runs["unsorted"], runs["sorted"]
    sub = plain.cfg.cloud.sub_cycles * plain.cfg.cloud.sub_steps
    n_steps = 1 + BENCH_REPEATS * plain.n_timed
    expected = 2 * (1 + n_steps * sub) + caps * sub
    say(f"bench: contact_chain launches {launches} (2 runs x (1 setup + "
        f"{n_steps} steps x {sub} substeps) + {caps} capture warm-ups x "
        f"{sub} = {expected}) by N {by_n}")
    if launches != expected:
        fail(f"bench: kernel launched {launches} times, expected {expected}")

    pa, pb = plain.state.particles, srt.state.particles
    for label, r in runs.items():
        check_finite(r.state, f"bench {label}")
        if int(r.state.particles.nbr_dropped) != 0:
            fail(f"bench {label}: neighbor audit dropped in-ring partners")
    n = pa.n_capacity
    rows = torch.arange(1, n + 1, device=dev, dtype=pb.tag.dtype)
    moved = int((pb.tag != rows).sum())
    if not torch.equal(pa.tag, rows) or moved == 0:
        fail(f"bench: the sorted run moved {moved} rows; the unsorted run "
             f"kept its rows: {torch.equal(pa.tag, rows)}")
    oa, ob = torch.argsort(pa.tag), torch.argsort(pb.tag)
    if not torch.equal(pa.tag[oa], pb.tag[ob]):
        fail("bench: sorted and unsorted runs hold different tags")
    errs = {name: rel_err(getattr(pa, name)[oa], getattr(pb, name)[ob])
            for name in ("pos", "vel", "omega")}
    ferrs = {name: rel_err(getattr(plain.state.fluid, name),
                           getattr(srt.state.fluid, name))
             for name in ("alpha", "p", "Ub")}
    say(f"bench: sorted vs unsorted after {n_steps} steps, rows matched by "
        f"tag ({moved} of {n} rows moved): " + ", ".join(
            f"{k} {v:.3e}" for k, v in {**errs, **ferrs}.items())
        + f" (tol: pos {SORT_TOL['pos']:.0e}, vel {SORT_TOL['vel']:.0e}, "
        f"omega {SORT_TOL['omega']:.0e}, fluid {SORT_TOL['fluid']:.0e} of "
        "scale; f32: the particle-to-grid sums and the rebuilt tables' "
        "ties add in another order)")
    if any(errs[k] > SORT_TOL[k] for k in errs) or \
            max(ferrs.values()) > SORT_TOL["fluid"]:
        fail("bench: the sorted run disagrees with the unsorted run")

    # the kernel on the sorted state (partner rows near each other)
    res = compare_chain("bench sorted f32", pb, srt.cfg.dem, True, 1e-5,
                        may_be_zero=("wall_shear",))
    shapes = [measure_chain("bench run unsorted f32", pa, plain.cfg.dem,
                            floor),
              measure_chain("bench run sorted f32", pb, srt.cfg.dem, floor)]
    us = [sh["device_ms"] * 1e3 for sh in shapes]
    say(f"bench: kernel device time unsorted {us[0]:.2f} us, sorted "
        f"{us[1]:.2f} us (same bytes: bound "
        f"{shapes[1]['bound_ms'] * 1e3:.2f} us)")
    return {"launches": launches, "by_n": by_n, "K": srt.cfg.dem.nbr_k,
            "max_abs_err": res["max_abs_err"], "shapes": shapes,
            "rates": {k: r.value for k, r in runs.items()}}


def lattice_state(ps, cfg_dem):
    """Particles ps (any backend) on the lattice of cfg_dem: an empty
    history of the lattice's shape, slotted by a forced rebuild."""
    import torch
    from sedifoam_tpu_torch.dem import integrate, lattice
    g = lattice.make_geom(cfg_dem)
    n = ps.n_capacity
    ps = ps._replace(
        shear=torch.zeros((3, len(lattice.geom_offsets(g)), g.M, g.M, g.S),
                          dtype=ps.pos.dtype, device=ps.pos.device),
        nbr_idx=torch.full((g.M, g.S), n, dtype=torch.int32,
                           device=ps.pos.device))
    return integrate.maybe_rebuild_neighbors(ps, cfg_dem, force=True)


def unslotted(state, cfg):
    from sedifoam_tpu_torch.runtime import diagnostics
    d = diagnostics.compute(state, cfg.grid, cfg.fluid, cfg.dem)
    return int(d["lattice_unslotted"])


def bench_module(backend):
    """`python -m sedifoam_tpu_torch.bench --backend=... --repeats
    LATTICE_REPEATS` on the card: (each repeat's rate, the JSON line,
    seconds of the process)."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "sedifoam_tpu_torch.bench",
         f"--backend={backend}", "--repeats", str(LATTICE_REPEATS)],
        capture_output=True, text=True, env=dict(os.environ,
                                                 PYTHONPATH=REPO),
        cwd=REPO, timeout=900)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        fail(f"bench --backend={backend} exited {res.returncode}: "
             f"{res.stderr[-2000:]}")
    lines = res.stdout.strip().splitlines()
    rates = [float(ln.split(",")[1].split()[0]) for ln in lines
             if ln.startswith("repeat ")]
    return rates, json.loads(lines[-1]), wall


PHYSICS_TIMEOUT = 300     # seconds the physics phase's pytest may take


def phase_physics():
    """The card cases of tests/test_torch_physics_*.py that are not
    `slow`, in a pytest subprocess (--noconftest: tests/conftest.py
    imports JAX; the files import nothing of it). Returns {"passed",
    "seconds", "launches"}: the kernel's launches counted in that
    process by the plugin tests/torch_port_launch_count."""
    import glob
    files = sorted(glob.glob(os.path.join(REPO, "tests",
                                          "test_torch_physics_*.py")))
    if not files:
        fail("physics: no tests/test_torch_physics_*.py in the checkout")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "launches.json")
        env = dict(os.environ, CHAIN_LAUNCHES_OUT=out,
                   PYTHONPATH=os.pathsep.join(
                       [REPO, os.path.join(REPO, "tests")]))
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-q",
             "-p", "no:cacheprovider", "-p", "torch_port_launch_count",
             "-m", "cuda and not slow", *files],
            capture_output=True, text=True, env=env, cwd=REPO,
            timeout=PHYSICS_TIMEOUT)
        seconds = time.perf_counter() - t0
        tail = res.stdout.strip().splitlines()[-1:] or [""]
        m = re.search(r"(\d+) passed", tail[0])
        passed = int(m.group(1)) if m else 0
        if res.returncode != 0 or passed == 0:
            fail(f"physics: pytest exited {res.returncode} with {passed} "
                 f"passed:\n{res.stdout[-4000:]}\n{res.stderr[-2000:]}")
        with open(out) as f:
            launches = json.load(f)["launches"]
    if launches == 0:
        fail("physics: the binned cases launched no kernel")
    got = {"passed": passed, "seconds": round(seconds, 1),
           "launches": launches}
    say("physics: " + json.dumps(got))
    return got


def phase_lattice(dev):
    """The lattice DEM backend (dem/lattice.py) at the bench case's full
    width through the port's entry points, held against the binned
    backend on the same bed, and on the loaded channel case. The lattice
    path launches no contact_chain: its launches here are the binned
    runs it is compared with, made to compare and not counted."""
    import torch
    from sedifoam_tpu_torch import bench_case, cases, device_vector
    from sedifoam_tpu_torch.dem import fused, integrate, lattice
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import CoupledStep, GraphedStep, \
        initialize

    counted = launch_snapshot()
    out = {}
    # -- the bench module, both backends, in this call -------------------
    gc.collect()
    torch.cuda.empty_cache()
    gib = 2 ** 30
    say(f"lattice: this process holds "
        f"{torch.cuda.memory_allocated(dev) / gib:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved(dev) / gib:.2f} GB reserved before "
        f"the subprocesses")
    for backend in ("binned", "lattice"):
        rates, line, wall = bench_module(backend)
        out[f"module_{backend}"] = line["value"]
        say(f"lattice: python -m sedifoam_tpu_torch.bench "
            f"--backend={backend} --repeats {LATTICE_REPEATS}: repeats "
            f"{rates} particle-substeps/s, {json.dumps(line)} ({wall:.1f} "
            f"s of process)")
        if not (line["value"] > 0 and len(rates) == LATTICE_REPEATS):
            fail(f"lattice: bench --backend={backend} printed {line}")

    # -- the bench case on the lattice, in this process ------------------
    full = bench_case.FULL
    n = full["n_particles"]
    cfg = bench_case.build_config(**full, backend="lattice")
    geom = lattice.make_geom(cfg.dem)
    noff = len(lattice.geom_offsets(geom))
    fluid, particles = bench_case.build_state(cfg, n, torch.float32, dev)
    step = CoupledStep(cfg, torch.float32, dev)
    state0 = step.initialize(fluid, particles)
    sh = state0.particles.shear
    say(f"lattice: bench geometry nb {geom.nb}, padded {geom.padded}, S "
        f"{geom.S}, M {geom.M}, {noff} offsets; shear {tuple(sh.shape)} "
        f"= {sh.numel() * sh.element_size() / 1e9:.3f} GB (f32); "
        f"{noff * geom.M ** 2 * geom.S:.4e} slot pairs a force pass")
    if unslotted(state0, cfg):
        fail(f"lattice: {unslotted(state0, cfg)} unslotted particles")
    launches0 = fused.launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reserved0 = torch.cuda.memory_reserved(dev)
    graphed = CountedAdvance(GraphedStep(step), dev)
    t0 = time.perf_counter()
    s_g = graphed(tree_map(torch.clone, state0))     # the capture + 1 step
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    g = graphed.graphed
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    reserved = (torch.cuda.memory_reserved(dev) - reserved0) / 2**30
    s_e = tree_map(torch.clone, state0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(1 + LATTICE_STEPS):
        s_e = step(s_e)
    torch.cuda.synchronize()
    ms_eager = (time.perf_counter() - t0) / (1 + LATTICE_STEPS) * 1e3
    for _ in range(LATTICE_STEPS):
        s_g = graphed(s_g)
    differ = fields_that_differ(s_e, s_g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LATTICE_TIMED):
        s_g = graphed(s_g)
    float(torch.sum(s_g.particles.vel[:, 1]))
    ms_graph = (time.perf_counter() - t0) / LATTICE_TIMED * 1e3
    sub = cfg.cloud.sub_cycles * cfg.cloud.sub_steps
    rate = n * sub / (ms_graph * 1e-3)
    check_finite(s_g, "lattice bench")
    busy, _, seen, top = profile_replays(
        g, tree_map(torch.clone, s_g), LATTICE_PROFILE)
    out.update(capture_s=g.capture_seconds, nodes=g.graph.nodes,
               ms_eager=ms_eager, ms_graph=ms_graph, rate=rate,
               peak_gb=peak, busy=busy,
               kernels_per_replay=seen / LATTICE_PROFILE, top=top)
    say(f"lattice: bench step captured in {g.capture_seconds:.2f} s "
        f"({g.graph.nodes} conditional nodes), first step {t_first:.2f} "
        f"s; peak allocated {peak:.2f} GB, reserved +{reserved:.2f} GB "
        f"around the capture; {1 + LATTICE_STEPS} eager steps "
        f"{ms_eager:.3f} ms/step, {LATTICE_TIMED} replays {ms_graph:.3f} "
        f"ms/step ({rate:.1f} particle-substeps/s; host clock ending in a "
        f"fetch); host syncs inside {graphed.replays} replays: "
        f"{graphed.replay_syncs}; replay vs eager after "
        f"{1 + LATTICE_STEPS} steps: "
        + ("equal bit for bit" if not differ else f"differ in {differ}")
        + f"; device busy {100 * busy:.1f}% of {LATTICE_PROFILE} profiled "
        f"replays, {seen / LATTICE_PROFILE:.0f} kernels a replay; most "
        f"device time per replay (us): {top}")
    if graphed.replay_syncs:
        fail(f"lattice: {graphed.replay_syncs} host syncs inside the "
             f"replays, at {graphed.where}")
    if differ:
        fail("lattice: the replayed step differs from the eager step")
    if unslotted(s_g, cfg):
        fail(f"lattice: {unslotted(s_g, cfg)} unslotted after the steps")
    if fused.launches() != launches0:
        fail("lattice: the lattice path launched contact_chain")

    # -- the force pass and the carry alone (CUDA events) ----------------
    p = tree_map(torch.clone, s_g.particles)
    del s_e, s_g, state0, graphed, g
    torch.cuda.empty_cache()

    def force():
        return lattice.lattice_pair_forces(p, cfg.dem, geom, p.nbr_idx,
                                           p.shear, True)
    a, b = force(), force()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    del a, b
    ms_force = cuda_ms(force, LATTICE_PASSES)
    new_slot, overflow = lattice.bin_slots(geom, p.pos, p.active)
    kc = max(16, cfg.dem.nbr_k)

    def carry():
        return lattice.carry_shear_lattice(p.nbr_idx, new_slot, p.shear,
                                           geom, n, k_compact=kc)
    ms_carry = cuda_ms(carry, LATTICE_PASSES)
    ms_slots = cuda_ms(lambda: lattice.bin_slots(geom, p.pos, p.active),
                       LATTICE_PASSES)
    out.update(force_ms=ms_force, carry_ms=ms_carry, slots_ms=ms_slots)
    say(f"lattice: lattice_pair_forces {ms_force:.3f} ms a pass, "
        f"carry_shear_lattice {ms_carry:.3f} ms and bin_slots "
        f"{ms_slots:.3f} ms a rebuild (CUDA events, mean of "
        f"{LATTICE_PASSES}, f32, the bench state after "
        f"{2 + LATTICE_STEPS + LATTICE_TIMED + LATTICE_PROFILE} steps); "
        f"two force passes bitwise equal: {same}; overflow {int(overflow)}")
    if not same:
        fail("lattice: two force passes differ")
    del p, new_slot
    torch.cuda.empty_cache()

    # -- lattice against binned on one settled bed -----------------------
    cfg_b = bench_case.build_config(**full, backend="binned")
    fluid, particles = bench_case.build_state(cfg_b, n, torch.float32, dev)
    step_b = CoupledStep(cfg_b, torch.float32, dev)
    s = step_b.initialize(fluid, particles)
    for _ in range(LATTICE_SETTLE):
        s = step_b(s)
    settled = s.particles
    del s, step_b
    errs = {}
    for dtype in (torch.float32, torch.float64):
        ps = tree_map(lambda t: t.to(dtype) if t.is_floating_point() else t,
                      settled)
        db = cfg_b.dem
        dl = dataclasses.replace(db, backend="lattice")
        pb = integrate.maybe_rebuild_neighbors(
            ps._replace(shear=torch.zeros_like(ps.shear)), db, force=True)
        pl = lattice_state(ps, dl)
        fb = integrate.compute_forces(pb, db, shearupdate=True)
        fl = integrate.compute_forces(pl, dl, shearupdate=True)
        act = ps.active
        g_vec = device_vector(tuple(db.gravity), dtype, dev)
        base = ps.mass[:, None] * g_vec[None] + ps.fdrag
        contact = (fb.force - base)[act]
        e_f = float((fl.force - fb.force)[act].abs().max()
                    / contact.abs().max())
        e_t = rel_err(fb.torque[act], fl.torque[act])
        # a trajectory through a forced rebuild on both
        for _ in range(2):
            fb = integrate.run_dem(fb, db, LATTICE_SUBSTEPS)
            fl = integrate.run_dem(fl, dl, LATTICE_SUBSTEPS)
            fb = integrate.maybe_rebuild_neighbors(fb, db, force=True)
            fl = integrate.maybe_rebuild_neighbors(fl, dl, force=True)
        if int(fb.nbr_dropped) or not torch.equal(fb.tag, fl.tag):
            fail("lattice: the binned run dropped partners or moved rows")
        e_p = rel_err(fb.pos[act], fl.pos[act])
        e_v = rel_err(fb.vel[act], fl.vel[act])
        e_w = rel_err(fb.omega[act], fl.omega[act])
        name = str(dtype).split(".")[-1]
        tol = LATTICE_TOL[name]
        errs[name] = dict(force=e_f, torque=e_t, pos=e_p, vel=e_v,
                          omega=e_w)
        say(f"lattice vs binned [{name}], the bench bed after "
            f"{LATTICE_SETTLE} binned steps: contact force {e_f:.3e} of "
            f"its scale, torque {e_t:.3e}; after 2 x ({LATTICE_SUBSTEPS} "
            f"substeps + a forced rebuild): pos {e_p:.3e}, vel {e_v:.3e}, "
            f"omega {e_w:.3e} of scale (tol {tol})")
        if max(e_f, e_t) > tol["force"] or max(e_p, e_v) > tol["traj"] \
                or e_w > tol["omega"]:
            fail(f"lattice: lattice and binned disagree in {name}")
        del ps, pb, pl, fb, fl
        torch.cuda.empty_cache()
    out["vs_binned"] = errs

    # -- the channel case loaded on the lattice --------------------------
    sims = {}
    with tempfile.TemporaryDirectory() as tmp:
        case = cases.write_channel_case(os.path.join(tmp, "channel"),
                                        **cases.CHANNEL_FULL,
                                        overlap=CASE_OVERLAP)
        for backend in ("binned", "lattice"):
            c, fl_, pa, _ = load_case(case, backend=backend,
                                      dtype=torch.float64, capacity=8192,
                                      device=dev)
            sims[backend] = (c, Simulation(c, initialize(fl_, pa, c),
                                           device=dev))
        # run_case's 20 steps a visit on xiaocase3 at one substep a step
        x3 = cases.write_xiaocase3(os.path.join(tmp, "xiaocase3"))
        script = os.path.join(x3, "in.lammps")
        with open(script) as f:
            text = f.read()
        with open(script, "w") as f:
            f.write(text.replace("timestep        2e-7",
                                 "timestep        2e-5"))
        res = subprocess.run(
            [sys.executable, "-m", "sedifoam_tpu_torch.run_case", x3,
             "--backend", "lattice", "--f64", "--t-end", "2e-5"],
            capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=REPO), cwd=REPO, timeout=600)
    if res.returncode != 0:
        fail(f"lattice: run_case --backend lattice exited "
             f"{res.returncode}: {res.stderr[-2000:]}")
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    c_l, sim_l = sims["lattice"]
    t0 = time.perf_counter()
    for c, sim in sims.values():
        run_steps(sim, LATTICE_CHANNEL_STEPS)
    t_run = time.perf_counter() - t0
    st_b, st_l = sims["binned"][1].state, sim_l.state
    check_finite(st_l, "lattice channel")
    oa = torch.argsort(st_b.particles.tag)
    ob = torch.argsort(st_l.particles.tag)
    act = st_b.particles.active[oa]
    e = {k: rel_err(getattr(st_b.particles, k)[oa][act],
                    getattr(st_l.particles, k)[ob][act])
         for k in ("pos", "vel")}
    e_fluid = rel_err(st_b.fluid.Ub, st_l.fluid.Ub)
    g_l = lattice.make_geom(c_l.dem)
    n_un = unslotted(st_l, c_l)
    out["channel"] = dict(M=c_l.dem.max_per_bin, unslotted=n_un, **e,
                          Ub=e_fluid)
    say(f"lattice: channel {cases.CHANNEL_FULL} loaded on the lattice: M "
        f"{c_l.dem.max_per_bin} (the fullest bin + 2), nb {g_l.nb}, S "
        f"{g_l.S}; {LATTICE_CHANNEL_STEPS} graphed steps (f64, both "
        f"backends, {t_run:.1f} s with the captures): lattice_unslotted "
        f"{n_un}; lattice vs binned by tag pos {e['pos']:.3e}, vel "
        f"{e['vel']:.3e}, Ub {e_fluid:.3e} of scale (tol "
        f"{LATTICE_CHANNEL_TOL}); run_case --backend lattice "
        f"on xiaocase3 (on the card by default): {json.dumps(summary)}")
    if n_un or max(e["pos"], e["vel"], e_fluid) > LATTICE_CHANNEL_TOL:
        fail("lattice: the channel on the lattice disagrees with binned")
    if summary["n_particles"] != 1:
        fail(f"lattice: run_case summary {summary}")
    launch_restore(counted)
    del sims, st_b, st_l
    gc.collect()
    torch.cuda.empty_cache()
    return out


SHARDED_STEPS = 2          # cut from 3: the script keeps inside its time limit
SHARDED_REBUILD_STEPS = 1  # of the bench bed rebuilt at every substep
SHARDED_RANKS = 2
SHARDED_TOL = 1e-5        # of each field's scale, where not bit for bit
SHARDED_TIMEOUT = 600     # seconds a spawn of ranks may take
SHARDED_CARDS = 4         # the most NCCL ranks (i) spreads over, one a card
SPLIT_LATTICE = dict(n_particles=32768, nx=32, ny=16, nz=32)  # cut in depth
SPLIT_DNS_ROWS = 8192
SPLIT_DELETE_ROWS = 4     # active rows placed in jetFlow's delete box
SPLIT_WIGGLE = dict(wiggle=True, wiggle_axis=1, amplitude=2e-4, period=0.01)
SPLIT_WALL_LO = 6e-4      # the wiggled floor 0.1 mm into the lowest layer
OWN_ROW_KS = (16, 29, 160)   # new own-row launch shapes, timed
TABLES = ("nbr_idx", "shear", "wall_shear", "pos")
FIELDS = ("p", "Ub", "alpha")


def nbytes(t):
    return t.numel() * t.element_size()


def field_errs(a, b):
    """{field: rel_err} over the floating fields of two SimStates, as
    compare_states reads them (alpha*Ua for Ua)."""
    skip = {"fluid.Ua", "fluid.Ua_old", "fluid.DDtUa"}
    out = {}
    pairs = list(zip(tree_leaves(a), tree_leaves(b)))
    pairs.append((("fluid.alpha*Ua", a.fluid.Uc), ("", b.fluid.Uc)))
    for (name, x), (_, y) in pairs:
        if name in skip or name.startswith("fluid.phia"):
            continue
        if x.is_floating_point() and bool((x != 0).any()):
            out[name] = rel_err(x, y)
    return out


def chain_halves(label, p, d, tol):
    """The kernel on each half of p's rows (rows=(r0, N/2), against
    partners in all rows) equals the whole launch's columns bit for bit
    in force, torque, shear and wall shear, and agrees with the plain
    version on the same rows within `tol` of scale; the walls fused as
    dem/integrate.compute_forces fuses them. Returns the plain version's
    worst relative error by output."""
    import torch
    from sedifoam_tpu_torch.dem import fused
    walls = d.walls if fused.walls_fusible(d.walls) else ()
    plen = d.periodic_len()
    n = p.n_capacity
    half = n // 2
    args = (d.pair, d.dt)
    whole = fused._launch(tree_map(torch.clone, p), *args, p.nbr_idx, True,
                          plen, walls)
    errs = {}
    for r0 in (0, half):
        own = slice(r0, r0 + half)

        def block():
            return p._replace(shear=p.shear[..., own].clone(),
                              wall_shear=p.wall_shear[..., own].clone())
        idx = p.nbr_idx[:, own].contiguous()
        got = fused._launch(block(), *args, idx, True, plen, walls,
                            rows=(r0, half))
        ref = fused.contact_chain_reference(block(), *args, idx, True, plen,
                                            walls, rows=(r0, half))
        for name, w, g, rf in zip(("force", "torque", "shear", "wall_shear"),
                                  whole, got, ref):
            if w is None:       # no wall fused: no wall shear out
                if g is not None:
                    fail(f"sharded: the kernel on rows [{r0}, {r0 + half}) "
                         f"of the {label} returns a {name} the whole "
                         "launch does not")
                continue
            part = w[own] if name in ("force", "torque") else w[..., own]
            if not torch.equal(part, g):
                fail(f"sharded: the kernel on rows [{r0}, {r0 + half}) of "
                     f"the {label} differs from the whole launch in {name}")
            errs[name] = max(errs.get(name, 0.0), rel_err(rf, g))
    say(f"sharded [kernel rows, {label}, N {n}, K {p.nbr_idx.shape[0]}]: "
        f"the halves [0, {half}) and [{half}, {n}) equal the whole launch "
        "bit for bit in force, torque, shear and wall shear; against the "
        "plain version on the same rows: " + ", ".join(
            f"{x} {v:.3e}" for x, v in errs.items()) + f" (tol {tol:.0e})")
    if max(errs.values()) > tol:
        fail(f"sharded: a half of the rows of the {label} disagrees with the "
             f"plain version: {errs}")
    return errs


def split_jetflow(dev):
    """jetFlow as its validator loads it (65,536 rows, K = 16), at full
    capacity (the split step takes no window), with two set-up edits: the
    countdown at 0, so that an add fires in step 1, and SPLIT_DELETE_ROWS
    rows made active in the delete box (copies of an active particle
    with fresh tags), so that the deletion fires too."""
    import torch
    cfg, state, _, _ = load_jetflow(dev)
    ps = state.particles
    box = cfg.cloud.delete_box
    src = int(torch.argmax(ps.active.to(torch.int32)))
    rows = torch.arange(ps.n_capacity - SPLIT_DELETE_ROWS, ps.n_capacity,
                        device=dev)
    if bool(ps.active[rows].any()) or not bool(ps.active[src]):
        fail("split jetFlow: no active particle to copy or no free rows")
    fields = {}
    for name, x in zip(ps._fields, ps):
        if isinstance(x, torch.Tensor) and x.ndim >= 1 and \
                x.shape[0] == ps.n_capacity:
            y = x.clone()
            y[rows] = x[src]
            fields[name] = y
    frac = torch.linspace(0.2, 0.8, SPLIT_DELETE_ROWS, device=dev,
                          dtype=ps.pos.dtype)
    pos = fields["pos"]
    for a in range(3):
        lo, hi = box[2 * a], box[2 * a + 1]
        pos[rows, a] = lo + (hi - lo) * (frac if a == 0 else 0.5)
    fields["pos_at_build"][rows] = pos[rows]
    fields["vel"][rows] = 0.0
    fields["tag"][rows] = int(ps.tag.max()) + 1 + torch.arange(
        SPLIT_DELETE_ROWS, device=dev, dtype=ps.tag.dtype)
    ps = ps._replace(time_to_add=torch.zeros_like(ps.time_to_add), **fields)
    return cfg, state._replace(particles=ps)


def split_clumps(dev):
    """The irregular case at full width, as phase_clumps loads it."""
    from sedifoam_tpu_torch import cases
    from sedifoam_tpu_torch.solver import CoupledStep
    cfg, fluid, parts, _, _ = load_clumps(
        dev, cases.IRREGULAR_FULL["counts"])
    return cfg, CoupledStep(cfg, parts.pos.dtype, dev).initialize(fluid,
                                                                  parts)


def split_extras(dev):
    """The bench bed with the unretarded cohesion and lubrication on
    (cases.extras_bed: K = 29), rows sorted at each rebuild."""
    import torch
    from sedifoam_tpu_torch import bench_case, cases
    from sedifoam_tpu_torch.solver import CoupledStep
    full = bench_case.FULL
    cfg = bench_case.build_config(**full, sort_on_rebuild=True)
    dem, parts = cases.extras_bed(full["n_particles"], cohesion_model=1,
                                  lubrication=True, dtype=torch.float32,
                                  device=dev)
    cfg = dataclasses.replace(cfg, dem=dataclasses.replace(
        dem, sort_on_rebuild=True))
    fluid, _ = bench_case.build_state(cfg, 1, torch.float32, dev)
    return cfg, CoupledStep(cfg, torch.float32, dev).initialize(fluid, parts)


def split_moving_wall(dev):
    """The bench bed (K = 8, sorted at each rebuild) with its lower y
    wall raised to SPLIT_WALL_LO and wiggling along y (SPLIT_WIGGLE, as
    tests/test_torch_extras.py's wall-bounded volume sets one): walls
    the kernel cannot fuse, through walls.wall_forces."""
    import torch
    from sedifoam_tpu_torch import bench_case
    from sedifoam_tpu_torch.dem.fused import walls_fusible
    from sedifoam_tpu_torch.solver import CoupledStep
    full = bench_case.FULL
    cfg = bench_case.build_config(**full, sort_on_rebuild=True)
    walls = tuple(dataclasses.replace(w, lo=SPLIT_WALL_LO, **SPLIT_WIGGLE)
                  if w.style == "yplane" else w for w in cfg.dem.walls)
    cfg = dataclasses.replace(cfg, dem=dataclasses.replace(cfg.dem,
                                                           walls=walls))
    if walls_fusible(walls):
        fail("split moving wall: the kernel would fuse the wiggled wall")
    fluid, parts = bench_case.build_state(cfg, full["n_particles"],
                                          torch.float32, dev)
    return cfg, CoupledStep(cfg, torch.float32, dev).initialize(fluid, parts)


def split_dns(dev):
    """phase_dns's DNS_N^3 cyclic box (0.08 m) and forcing parameters,
    with the bench's spheres: SPLIT_DNS_ROWS rows of the bench lattice in
    its lower part, the DEM cyclic in x and z between y walls; the
    bench's time steps. Constructed: the repo holds no IBM-DNS case
    directory."""
    import torch
    from sedifoam_tpu_torch import bc, bench_case
    from sedifoam_tpu_torch.fluid.state import FluidBCs
    from sedifoam_tpu_torch.grid import Grid
    from sedifoam_tpu_torch.solver import CoupledStep
    n, L = DNS_N, 0.08
    cfg = bench_case.build_config(SPLIT_DNS_ROWS, nx=n, ny=n, nz=n,
                                  sort_on_rebuild=True)
    cyc = bc.PatchBC(bc.CYCLIC)
    cyc3 = bc.PatchBC(bc.CYCLIC, (0.0, 0.0, 0.0))
    bcs = FluidBCs(alpha=bc.FieldBC(*(cyc for _ in range(6))),
                   p=bc.FieldBC(*(cyc for _ in range(6))),
                   Ub=bc.FieldBC(*(cyc3 for _ in range(6))),
                   Ua=bc.FieldBC(*(cyc3 for _ in range(6))))
    fluid_cfg = dataclasses.replace(
        cfg.fluid, gravity=(0.0, 0.0, 0.0), add_dns_force=True,
        dns_alpha=1.0, dns_sigma=0.5, dns_k_upper=600.0, dns_k_lower=0.0)
    walls = tuple(dataclasses.replace(w, hi=L) for w in cfg.dem.walls
                  if w.style == "yplane")
    dem = dataclasses.replace(cfg.dem, walls=walls, domain_hi=(L, L, L),
                              periodic=(True, False, True))
    cfg = dataclasses.replace(cfg, grid=Grid(nx=n, ny=n, nz=n, dx=L / n,
                                             dy=L / n, dz=L / n),
                              bcs=bcs, fluid=fluid_cfg, dem=dem)
    fluid, parts = bench_case.build_state(cfg, SPLIT_DNS_ROWS, torch.float32,
                                          dev)
    fluid = fluid._replace(Ub=torch.zeros_like(fluid.Ub))
    return cfg, CoupledStep(cfg, torch.float32, dev).initialize(fluid, parts)


def split_lattice(dev):
    """The bench bed on the lattice at SPLIT_LATTICE: 32,768 particles,
    the grid cut to 16 cells in y (the lattice's slot table and history
    scale with the domain, and each rank holds them whole)."""
    import torch
    from sedifoam_tpu_torch import bench_case
    from sedifoam_tpu_torch.solver import CoupledStep
    cfg = bench_case.build_config(**SPLIT_LATTICE, backend="lattice")
    fluid, parts = bench_case.build_state(
        cfg, SPLIT_LATTICE["n_particles"], torch.float32, dev)
    return cfg, CoupledStep(cfg, torch.float32, dev).initialize(fluid, parts)


# the configurations phase_sharded splits beside the bench bed and the
# channel: (label, builder)
SPLIT_CONFIGS = (("jetFlow", split_jetflow), ("irregular clumps", split_clumps),
                 ("extras bed", split_extras),
                 ("moving wall", split_moving_wall), ("DNS box", split_dns),
                 ("lattice", split_lattice))


def own_rows_timing(label, p, d, smi):
    """The kernel on the second half of p's rows: device time (profiler,
    PROFILE_REPS launches on clones), its bound, host microseconds per
    contact_chain call (HOST_CALLS calls), and the plain version's
    milliseconds on the same rows (CUDA events). Launches made here do
    not count."""
    import torch
    from sedifoam_tpu_torch.dem import fused
    walls = d.walls if fused.walls_fusible(d.walls) else ()
    plen = d.periodic_len()
    n = p.n_capacity
    half = n // 2
    counted = launch_snapshot()

    def block():
        return p._replace(shear=p.shear[..., half:].clone(),
                          wall_shear=p.wall_shear[..., half:].clone())
    idx = p.nbr_idx[:, half:].contiguous()
    args = (d.pair, d.dt, idx, True, plen, walls)
    clones = [block() for _ in range(PROFILE_REPS)]
    us, how, _ = device_us(lambda r: fused._launch(clones[r], *args,
                                                   rows=(half, half)))
    del clones
    q = block()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fused.contact_chain(q, *args, rows=(half, half))
    host = (time.perf_counter() - t0) / HOST_CALLS * 1e6
    torch.cuda.synchronize()
    plain = cuda_ms(lambda: fused.contact_chain_reference(
        block(), *args, rows=(half, half)), 5)
    launch_restore(counted)
    bound = chain_bound(p, walls, plen, rows=(half, half))
    out = {"label": label, "N": n, "rows": half, "K": p.nbr_idx.shape[0],
           "W": len(walls), "ms": us * 1e-3, "host_us": host,
           "plain_ms": plain, **bound}
    say(f"sharded [kernel rows, {label}]: rows [{half}, {n}), K "
        f"{out['K']}, W {out['W']} (f32): device {us:.2f} us ({how}, mean "
        f"of {PROFILE_REPS}), bound {bound['bound_ms'] * 1e3:.2f} us by "
        f"{bound['bound_by']} ({bound['touching_slots']} touching slots, "
        f"{bound['wall_contacts']} wall contacts; "
        f"{100 * bound['bound_ms'] * 1e3 / us:.1f}% of it); host "
        f"{host:.2f} us per call (mean of {HOST_CALLS}); plain version "
        f"{plain:.4f} ms (CUDA events, mean of 5) ({smi})")
    return out


def graphed_ms(cfg, state, n_steps):
    """The one-process step captured (solver.GraphedStep) from a copy of
    `state`: (capture seconds, ms per replayed step, host clock
    synchronized, n_steps replays). Its launches do not count."""
    import torch
    from sedifoam_tpu_torch.solver import CoupledStep, GraphedStep
    counted = launch_snapshot()
    step = GraphedStep(CoupledStep(cfg, state.particles.pos.dtype,
                                   state.particles.pos.device))
    st = step(tree_map(torch.clone, state))
    ms = []
    for _ in range(n_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = step(st)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    cap = step.capture_seconds
    del step, st
    launch_restore(counted)
    gc.collect()
    torch.cuda.empty_cache()
    return cap, ms


def probe_table(n, dev, smi):
    """parallel/probe.probe_ranks at n NCCL ranks (on `dev` at one rank):
    printed; fails on any case not "ok" (refused, parted or stalled)."""
    from sedifoam_tpu_torch.parallel.probe import probe_ranks
    t0 = time.perf_counter()
    probe = probe_ranks(n, backend="nccl", device=dev if n == 1 else None,
                        log=say)
    table = probe["results"]
    refused = {f"{c} in {p}": r for c, d in table.items()
               for p, r in d.items() if r != "ok"}
    say(f"sharded [capture probe, {n} NCCL rank{'s' if n > 1 else ''}, "
        f"NCCL {probe['nccl']}, {time.perf_counter() - t0:.1f} s]: "
        + "; ".join(f"{c}: " + ", ".join(
            f"{p} {'ok' if r == 'ok' else 'REFUSED'}" for p, r in d.items())
            for c, d in table.items()) + f" ({smi})")
    if refused:
        fail(f"sharded: at {n} NCCL ranks a collective of the split step is "
             "refused, parts or stalls: " + "; ".join(
                 f"{w}: {e}" for w, e in refused.items()))
    return {"nccl": probe["nccl"], "ranks": n,
            "ok": sorted(f"{c} in {p}" for c, d in table.items()
                         for p in d)}


def cards_run(n, cfg, snp, refs, one_graphed, held, smi):
    """phase_sharded (i): the capture probe at n NCCL ranks, one a card,
    then the bench bed's GraphedShardedStep on them, SHARDED_STEPS
    replays held as (h) holds one rank's (`held`: bit for bit with the
    one-process states `refs`); ms per replay a rank beside the
    one-process GraphedStep's. Returns held's record."""
    from sedifoam_tpu_torch.parallel.launch import run_ranks
    from sedifoam_tpu_torch.parallel.step import run_steps
    probe = probe_table(n, None, smi)
    t0 = time.perf_counter()
    try:
        res = run_ranks(run_steps, n, args=(cfg, snp, SHARDED_STEPS, None,
                                            True), backend="nccl",
                        timeout=SHARDED_TIMEOUT)
    except Exception as e:      # noqa: BLE001 - the phase fails on it
        fail(f"sharded (i): the bench bed graphed on {n} NCCL ranks: "
             f"{type(e).__name__}: {e}")
    say(f"sharded (i): {n} NCCL ranks, one a card, captured and replayed "
        f"the bench bed in {time.perf_counter() - t0:.1f} s of wall time, "
        "process start-up included")
    cap_s, one_ms = one_graphed
    for r in res:
        parted = [(i, f) for i, fs in enumerate(r["parted"], 1) for f in fs]
        say(f"sharded [bench bed, graphed, {n} NCCL ranks] rank {r['rank']} "
            f"on {r['device']}: capture {r['capture_s']:.2f} s; ms per "
            "replayed step " + ", ".join(f"{m:.2f}" for m in r["ms"])
            + " (eager ShardedStep " + ", ".join(f"{m:.1f}"
                                                 for m in r["eager_ms"])
            + "; one process GraphedStep " + ", ".join(f"{m:.2f}"
                                                       for m in one_ms)
            + f"); host syncs a replay {r['syncs']}; bytes a replay "
            f"{json.dumps(r['comm'])}; fields parted from the eager "
            f"ShardedStep: {parted or 'none'} ({smi})")
        if parted:
            fail(f"sharded (i): rank {r['rank']}'s replays part from the "
                 f"eager ShardedStep in {parted}")
        if any(r["syncs"]):
            fail(f"sharded (i): host syncs inside a replay on rank "
                 f"{r['rank']}: {r['syncs']}")
    got = held(f"bench bed graphed nccl x{n}", res, refs, bitwise=True)
    got.update(probe=probe, capture_s=[r["capture_s"] for r in res],
               syncs=[r["syncs"] for r in res],
               one_process_graphed_ms=one_ms)
    return got


def phase_sharded(dev, k, smi):
    """The coupled step split over ranks (sedifoam_tpu_torch/parallel/):
    (a) the kernel on row ranges of the bench table: the two halves equal
    the whole launch bit for bit (f32, f64) and agree with the plain
    version on the same rows; a half's device time and bound; (b) the
    bench bed with sort_on_rebuild on SHARDED_RANKS gloo ranks sharing
    the card, SHARDED_STEPS steps of ShardedStep against CoupledStep run
    eagerly here: the particles bit for bit after step 1, every field
    within SHARDED_TOL of scale after each step; per-rank table bytes,
    collective bytes, ms per step (gloo takes the CUDA tensors itself); (c) the same on one NCCL
    rank: bit for bit after each step; (b') the bed of (b) with its rows
    in a seeded random order and a rebuild at every substep (skin 0),
    SHARDED_REBUILD_STEPS steps on SHARDED_RANKS gloo ranks: the sorted
    rebuilds move particles between the ranks, and the particles stay bit
    for bit; (d) the channel at full width on SHARDED_RANKS gloo ranks,
    held as (b). The fluid is split along grid-x in (b), (b') and (d):
    each run reports its layout, the per-rank bytes of p, Ub and alpha
    (1/ranks of the whole), the collective bytes by kind and the fields
    that are not bit for bit; (e) every stencil and solve of the slab
    path at the channel's shape on SHARDED_RANKS gloo ranks against the
    whole grid's call (the operations that part, if any); (f) each of
    SPLIT_CONFIGS (jetFlow with an add and a deletion in step 1, the
    irregular clumps, the extras bed, the bed under a wiggled wall, the
    DNS box, the lattice) on SHARDED_RANKS gloo ranks in one spawn,
    SHARDED_STEPS steps against CoupledStep here: every field bit for bit
    or within SHARDED_TOL of scale, the fields that part named; the
    kernel's halves of each binned table equal its whole launch bit for
    bit, and the own-row launches at OWN_ROW_KS are timed beside their
    bounds, host time and plain version; (g) the capture probe
    (parallel/probe.py) on one NCCL rank: whether a plain capture and
    the bodies of IF and WHILE nodes take each collective of the split
    step, with the step's split patterns, eagerly too (probe_table);
    (h) GraphedShardedStep on one NCCL rank, on the
    bench bed, the channel and every configuration of (f) in one spawn:
    each replay bit for bit with the eager ShardedStep on the rank and
    with CoupledStep here, 0 host syncs, the kernel launched inside the
    replays as one process launches it, its halves of the last replayed
    table held as in (f); ms per replay beside the one-process
    GraphedStep's (graphed_ms); (i) where several cards are visible,
    the probe and the bench bed's replays over min(cards, SHARDED_CARDS)
    NCCL ranks, one a card (cards_run); on one card, one line. Returns
    the launches of the ranks (the main path of the split step)."""
    import numpy as np
    import torch
    from sedifoam_tpu_torch import bench_case, bridge, cases
    from sedifoam_tpu_torch.dem import fused
    from sedifoam_tpu_torch.dem.neighbor import permute_particle_state
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.parallel.launch import run_ranks
    from sedifoam_tpu_torch.parallel.mesh import particle_axes
    from sedifoam_tpu_torch.parallel.step import FIELDS, TABLES, run_jobs, \
        run_steps
    from sedifoam_tpu_torch.solver import CoupledStep

    # (a) the kernel on each half of the bench table's rows
    cfg0, p = k["bench_case"]
    d = cfg0.dem
    out = {"halves": {}}
    counted = launch_snapshot()
    for label, q in (("f32", p), ("f64", tree_map(
            lambda t: t.double() if t.is_floating_point() else t, p))):
        out["halves"][label] = chain_halves(
            f"bench table {label}", q, d, 1e-5 if label == "f32" else 1e-12)
    rows = own_rows_timing("bench table", p, d, smi)
    out["rows_ms"] = rows["ms"]
    out["rows_bound_ms"] = rows["bound_ms"]
    out["own_rows"] = [rows]
    launch_restore(counted)

    # (b) and (c): the bench bed split over ranks against one process
    cfg = bench_case.build_config(**bench_case.FULL, sort_on_rebuild=True)
    fluid, parts = bench_case.build_state(cfg, bench_case.FULL["n_particles"],
                                          dtype=torch.float32, device=dev)
    step = CoupledStep(cfg, dtype=torch.float32, device=dev)
    state = step.initialize(fluid, parts)
    snp = bridge.sim_state_to_numpy(state)
    cfg_r = dataclasses.replace(cfg, dem=dataclasses.replace(cfg.dem,
                                                              skin=0.0))

    def one_process(step, n_steps, state):
        out, ms = [], []
        st = tree_map(torch.clone, state)
        for _ in range(n_steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = step(st)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            out.append(tree_map(lambda t: t.cpu(), st))
        return out, ms
    refs, ref_ms = one_process(step, SHARDED_STEPS, state)
    one_graphed = {"bench bed": graphed_ms(cfg, state, SHARDED_STEPS)}
    # rows in a seeded random order: the first sorted rebuild moves them
    order = torch.as_tensor(np.random.RandomState(11).permutation(
        state.particles.n_capacity), device=dev)
    shuffled = state._replace(particles=permute_particle_state(
        state.particles, order))
    snp_r = bridge.sim_state_to_numpy(shuffled)
    refs_r, ref_ms_r = one_process(
        CoupledStep(cfg_r, dtype=torch.float32, device=dev),
        SHARDED_REBUILD_STEPS, shuffled)
    del state, shuffled
    say(f"sharded: one process, CoupledStep eagerly: "
        + ", ".join(f"{m:.1f}" for m in ref_ms) + " ms a step; rebuilt at "
        "every substep: " + ", ".join(f"{m:.1f}" for m in ref_ms_r)
        + f" ms ({smi})")

    def held(label, res, refs, bitwise, cfg=cfg, expected=None,
             particles_first=True):
        # each rank launches the kernel once a substep, on its own rows
        # (CPU ranks run its plain version), or as often as one process
        # did (`expected`: an add's set-up forces, the lattice's none).
        # particles_first: the particles bit for bit after step 1 where
        # the fields may part; else every field within SHARDED_TOL
        if expected is None:
            expected = len(refs) * cfg.cloud.sub_cycles \
                * cfg.cloud.sub_steps
        expected = expected if dev.type == "cuda" else 0
        states = [bridge.sim_state_from_numpy(res[0]["states"][i],
                                              device="cpu")
                  for i in sorted(res[0]["states"])]
        layout = res[0]["fluid"]
        if len(res) > 1 and layout != "slab":
            fail(f"sharded [{label}]: the fluid is {layout}, not split "
                 "along x")
        bit = []
        for i, (got, ref) in enumerate(zip(states, refs), 1):
            differ = fields_that_differ(ref, got)
            n_fields = sum(1 for _ in tree_leaves(ref))
            bit.append(n_fields - len(differ))
            say(f"sharded [{label}] step {i}: {n_fields - len(differ)} of "
                f"{n_fields} fields bit for bit" + (
                    f"; the first that parts: {differ[0]}" if differ
                    else ""))
            if bitwise:
                if differ:
                    fail(f"sharded [{label}]: step {i} differs from the "
                         f"one-process step in {differ}")
                continue
            if i == 1 and particles_first:
                moved = [f for f in differ if f.startswith("particles.")]
                if moved:
                    fail(f"sharded [{label}]: after step 1 the particles "
                         f"differ from the one-process step in {moved}")
            errs = field_errs(ref, got)
            misses = {f: e for f, e in errs.items() if e > SHARDED_TOL}
            worst = max(errs, key=errs.get)
            say(f"sharded [{label}] step {i}: {len(differ)} fields not bit "
                f"for bit, worst {worst} {errs[worst]:.3e} of scale (tol "
                f"{SHARDED_TOL:.0e})")
            if misses:
                fail(f"sharded [{label}]: step {i} misses the one-process "
                     f"step: " + ", ".join(f"{f} {e:.3e}"
                                           for f, e in misses.items()))
        whole = {name: nbytes(getattr(refs[0].particles, name))
                 for name in TABLES}
        # the arrays each rank holds whole (the lattice's table and
        # history): all of their bytes on every rank
        split = particle_axes(refs[0].particles)
        share = {name: len(res) if split[name] is not None else 1
                 for name in TABLES}
        whole_f = {name: nbytes(getattr(refs[0].fluid, name))
                   for name in FIELDS}
        for r in res:
            say(f"sharded [{label}] rank {r['rank']} on {r['device']} "
                f"({r['backend']}), fluid {r['fluid']}: "
                + ", ".join(f"{name} {r['tables'][name]} of {whole[name]} B"
                            for name in TABLES) + ", " + ", ".join(
                    f"{name} {r['fields'][name]} of {whole_f[name]} B"
                    for name in FIELDS)
                + "; collective bytes per step " + ", ".join(
                    json.dumps(c) for c in r["comm"])
                + "; ms per step " + ", ".join(f"{m:.1f}" for m in r["ms"])
                + f"; {r['launches']} kernel launches at "
                f"{r['launch_sizes']} rows ({smi})")
            if r["launches"] != expected:
                fail(f"sharded [{label}]: rank {r['rank']} launched the "
                     f"kernel {r['launches']} times, not {expected}")
            for name in TABLES:
                if r["tables"][name] * share[name] != whole[name]:
                    fail(f"sharded [{label}]: rank {r['rank']} holds "
                         f"{r['tables'][name]} B of {name}, not "
                         f"1/{share[name]} of {whole[name]}")
            for name in FIELDS:
                if r["fields"][name] * len(res) != whole_f[name]:
                    fail(f"sharded [{label}]: rank {r['rank']} holds "
                         f"{r['fields'][name]} B of {name}, not "
                         f"1/{len(res)} of {whole_f[name]}")
            if len(res) > 1 and not {"collective-permute", "all-to-all"} \
                    <= set(r["comm"][0]):
                fail(f"sharded [{label}]: rank {r['rank']} made no halo "
                     f"exchange or all-to-all: {r['comm'][0]}")
        moved = sum(len(set(r["tags_before"]) - set(r["tags_after"]))
                    for r in res)
        say(f"sharded [{label}]: {moved} particles changed ranks")
        sizes = collections.Counter()
        for r in res:
            sizes.update(r["launch_sizes"])
        return {"ranks": len(res), "moved": moved,
                "launches": sum(r["launches"] for r in res),
                "launch_sizes": dict(sizes), "N": refs[0].particles.n_capacity,
                "K": refs[0].particles.nbr_idx.shape[0],
                "ms": [r["ms"] for r in res], "comm": res[0]["comm"],
                "tables": res[0]["tables"], "fluid": layout,
                "fields": res[0]["fields"], "bitwise_fields": bit}

    t0 = time.perf_counter()
    res = run_ranks(run_steps, SHARDED_RANKS,
                    args=(cfg, snp, SHARDED_STEPS), backend="gloo",
                    device=dev, timeout=SHARDED_TIMEOUT)
    say(f"sharded: {SHARDED_RANKS} gloo ranks sharing {dev} ran "
        f"{SHARDED_STEPS} steps in {time.perf_counter() - t0:.1f} s of "
        "wall time, process start-up included")
    out["gloo"] = held("gloo x2", res, refs, bitwise=False)
    t0 = time.perf_counter()
    res = run_ranks(run_steps, 1, args=(cfg, snp, SHARDED_STEPS),
                    backend="nccl", device=dev, timeout=SHARDED_TIMEOUT)
    say(f"sharded: one NCCL rank ran {SHARDED_STEPS} steps in "
        f"{time.perf_counter() - t0:.1f} s of wall time")
    out["nccl"] = held("nccl x1", res, refs, bitwise=True)
    res = run_ranks(run_steps, SHARDED_RANKS,
                    args=(cfg_r, snp_r, SHARDED_REBUILD_STEPS),
                    backend="gloo", device=dev, timeout=SHARDED_TIMEOUT)
    out["rebuilt"] = held("gloo x2, a rebuild every substep", res, refs_r,
                          bitwise=False)
    if out["rebuilt"]["moved"] == 0:
        fail("sharded: the rebuilds moved no particle between the ranks")

    # (d) the channel at full width, its fluid split along x
    with tempfile.TemporaryDirectory() as tmp:
        case = cases.write_channel_case(os.path.join(tmp, "channel"),
                                        **cases.CHANNEL_FULL,
                                        overlap=CASE_OVERLAP)
        ccfg, cfluid, cparts, _ = load_case(
            case, backend="binned", dtype=torch.float32, capacity=8192,
            device=dev)
    ccfg = dataclasses.replace(ccfg, cloud=dataclasses.replace(
        ccfg.cloud, semi_implicit_drag=True))
    cstep = CoupledStep(ccfg, dtype=torch.float32, device=dev)
    cstate = cstep.initialize(cfluid, cparts)
    csnp = bridge.sim_state_to_numpy(cstate)
    crefs, cref_ms = one_process(cstep, SHARDED_STEPS, cstate)
    one_graphed["channel"] = graphed_ms(ccfg, cstate, SHARDED_STEPS)
    del cstate, cstep
    say(f"sharded: the channel {ccfg.grid.shape}, one process, "
        "CoupledStep eagerly: " + ", ".join(f"{m:.1f}" for m in cref_ms)
        + f" ms a step ({smi})")
    t0 = time.perf_counter()
    res = run_ranks(run_steps, SHARDED_RANKS,
                    args=(ccfg, csnp, SHARDED_STEPS), backend="gloo",
                    device=dev, timeout=SHARDED_TIMEOUT)
    say(f"sharded: {SHARDED_RANKS} gloo ranks sharing {dev} ran the "
        f"channel {SHARDED_STEPS} steps in {time.perf_counter() - t0:.1f} "
        "s of wall time, process start-up included (two ranks on one card "
        "measure the path, not a speed-up)")
    out["channel"] = held("channel gloo x2", res, crefs, bitwise=False,
                          cfg=ccfg)

    # (e) the slab path's operations at the channel's shape on the card
    sys.path.insert(0, os.path.join(REPO, "tests"))
    from torch_port_slabs import slab_ops_job
    res = run_ranks(slab_ops_job, SHARDED_RANKS,
                    args=(5, ccfg.grid.shape, torch.float32), backend="gloo",
                    device=dev, timeout=SHARDED_TIMEOUT)[0]
    parting = {kind: [op for op, ok in ops.items()
                      if op != "iterations" and not ok]
               for kind, ops in res.items() if kind != "bytes"}
    its = {kind: ops["iterations"] for kind, ops in res.items()
           if kind != "bytes"}
    say(f"sharded [slab operations, {ccfg.grid.shape}, f32, "
        f"{SHARDED_RANKS} gloo ranks]: the operations whose slabs part "
        f"from the whole grid's call on the card: {json.dumps(parting)}; "
        f"solver iterations (whole, slabs): {json.dumps(its)}")
    out["slab_ops_parting"] = parting
    del step
    gc.collect()
    torch.cuda.empty_cache()

    # (f) every other configuration CoupledStep steps, each split over
    # SHARDED_RANKS gloo ranks sharing the card (one spawn runs them all)
    jobs, split = [], []
    for label, build in SPLIT_CONFIGS:
        t0 = time.perf_counter()
        scfg, sstate = build(dev)
        t_build = time.perf_counter() - t0
        ps = sstate.particles
        launches0 = fused.launches()
        srefs, sms = one_process(CoupledStep(scfg, torch.float32, dev),
                                 SHARDED_STEPS, sstate)
        ones = fused.launches() - launches0
        if scfg.dem.backend == "binned" and scfg.dem.fused_chain:
            # the kernel's own-row launches on the table after the steps
            last = tree_map(lambda t: t.to(dev), srefs[-1].particles)
            counted = launch_snapshot()
            out["halves"][label] = chain_halves(label, last, scfg.dem, 1e-5)
            if last.nbr_idx.shape[0] in OWN_ROW_KS:
                out["own_rows"].append(own_rows_timing(label, last,
                                                       scfg.dem, smi))
            launch_restore(counted)
            del last
        one_graphed[label] = graphed_ms(scfg, sstate, SHARDED_STEPS)
        jobs.append((scfg, bridge.sim_state_to_numpy(sstate), SHARDED_STEPS))
        split.append((label, scfg, srefs, sms, ones))
        say(f"sharded [{label}]: grid {scfg.grid.shape}, {ps.n_capacity} "
            f"rows, {int(ps.active.sum())} active, K "
            f"{ps.nbr_idx.shape[0] if scfg.dem.backend == 'binned' else '-'}"
            f", {scfg.cloud.sub_steps} substeps, backend "
            f"{scfg.dem.backend}; built in {t_build:.1f} s; one process, "
            "CoupledStep eagerly: " + ", ".join(f"{m:.1f}" for m in sms)
            + f" ms a step, {ones} kernel launches ({smi})")
        del sstate, ps
        gc.collect()
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    res = run_ranks(run_jobs, SHARDED_RANKS, args=(jobs,), backend="gloo",
                    device=dev, timeout=SHARDED_TIMEOUT)
    say(f"sharded: {SHARDED_RANKS} gloo ranks sharing {dev} ran "
        f"{len(jobs)} configurations {SHARDED_STEPS} steps each in "
        f"{time.perf_counter() - t0:.1f} s of wall time, process start-up "
        "included (two ranks on one card measure the path, not a "
        "speed-up)")
    out["configs"] = {}
    for i, (label, scfg, srefs, sms, ones) in enumerate(split):
        got = held(f"{label} gloo x{SHARDED_RANKS}", [r[i] for r in res],
                   srefs, bitwise=False, cfg=scfg, expected=ones,
                   particles_first=False)
        got["ref_ms"] = sms
        out["configs"][label] = got

    # (g) which collectives of the split step a CUDA graph takes, and
    # where: each, with the step's own split pattern, called straight
    # through torch.distributed on one NCCL rank, eagerly, in a plain
    # capture (both error modes) and in the bodies of an IF and a WHILE
    # node
    out["probe"] = probe_table(1, dev, smi)

    # (h) the split step captured as one CUDA graph (GraphedShardedStep) on
    # one NCCL rank: the bench bed, the channel and every configuration
    # of (f), in one spawn
    graphed = [("bench bed", cfg, snp, refs, None),
               ("channel", ccfg, csnp, crefs, None)] + [
        (label, scfg, job[1], srefs, ones)
        for (label, scfg, srefs, _, ones), job in zip(split, jobs)]
    t0 = time.perf_counter()
    res = run_ranks(run_jobs, 1, args=([
        (gcfg, gsnp, SHARDED_STEPS, None, True)
        for _, gcfg, gsnp, _, _ in graphed],), backend="nccl", device=dev,
        timeout=SHARDED_TIMEOUT)[0]
    say(f"sharded: one NCCL rank captured and replayed {len(graphed)} "
        f"configurations in {time.perf_counter() - t0:.1f} s of wall time, "
        "process start-up included")
    out["graphed"] = {}
    for r, (label, gcfg, _, grefs, ones) in zip(res, graphed):
        parted = [(i, f) for i, fs in enumerate(r["parted"], 1) for f in fs]
        cap_s, one_ms = one_graphed[label]
        say(f"sharded [{label}, graphed, one NCCL rank]: capture "
            f"{r['capture_s']:.2f} s, {r['nodes']['if']} IF and "
            f"{r['nodes']['while']} WHILE nodes; ms per replayed step "
            + ", ".join(f"{m:.2f}" for m in r["ms"]) + " (eager ShardedStep "
            + ", ".join(f"{m:.1f}" for m in r["eager_ms"]) + "; one process "
            "GraphedStep " + ", ".join(f"{m:.2f}" for m in one_ms)
            + f", its capture {cap_s:.2f} s); host syncs a replay "
            f"{r['syncs']}; bytes a replay {json.dumps(r['comm'])}, "
            f"captured {json.dumps(r['capture_bytes'])}; fields parted "
            f"from the eager ShardedStep: {parted or 'none'} ({smi})")
        if parted:
            fail(f"sharded [{label}, graphed]: replays part from the eager "
                 f"ShardedStep in {parted}")
        if any(r["syncs"]):
            fail(f"sharded [{label}, graphed]: host syncs inside a replay: "
                 f"{r['syncs']}")
        got = held(f"{label} graphed nccl x1", [r], grefs, bitwise=True,
                   cfg=gcfg, expected=ones)
        got.update(capture_s=r["capture_s"], nodes=r["nodes"],
                   syncs=r["syncs"], eager_ms=r["eager_ms"],
                   capture_bytes=r["capture_bytes"],
                   one_process_graphed_ms=one_ms,
                   one_process_capture_s=cap_s)
        if gcfg.dem.backend == "binned" and gcfg.dem.fused_chain:
            if got["launches"] == 0:
                fail(f"sharded [{label}, graphed]: no kernel launch inside "
                     "the replays")
            last = bridge.sim_state_from_numpy(
                r["states"][SHARDED_STEPS], device=dev).particles
            counted = launch_snapshot()
            got["halves"] = chain_halves(f"{label} after the replays", last,
                                         gcfg.dem, 1e-5)
            launch_restore(counted)
            del last
        out["graphed"][label] = got
    # (i) on several cards: the probe and the bench bed graphed over
    # min(cards, SHARDED_CARDS) NCCL ranks, one a card
    cards = torch.cuda.device_count()
    out["cards"] = None
    if cards < 2:
        say(f"sharded (i): {cards} card visible: the split step ran on no "
            "second card")
    else:
        out["cards"] = cards_run(min(cards, SHARDED_CARDS), cfg, snp, refs,
                                 one_graphed["bench bed"], held, smi)
    paths = [out[key] for key in ("gloo", "nccl", "rebuilt", "channel")] \
        + list(out["configs"].values()) + list(out["graphed"].values()) \
        + ([out["cards"]] if out["cards"] else [])
    out["launches"] = sum(path["launches"] for path in paths)
    out["ran_at"] = [{"N": path["N"], "rows": rows, "K": path["K"],
                      "launches": c, "path": "sharded"}
                     for path in paths
                     for rows, c in sorted(path["launch_sizes"].items())]
    out["ref_ms"] = ref_ms + ref_ms_r
    out["channel_ref_ms"] = cref_ms
    return out


@contextlib.contextmanager
def counted_adds(dev):
    """Within the block, each add of particles (inject.add_particles,
    eager or in a replayed graph's add branch, into which the count's
    own add is captured) adds one to a counter on the device; yields the
    counter."""
    import torch
    from sedifoam_tpu_torch.dem import inject
    count = torch.zeros((), dtype=torch.int64, device=dev)
    add = inject.add_particles

    def counted(*args, **kw):
        count.add_(1)
        return add(*args, **kw)

    inject.add_particles = counted
    try:
        yield count
    finally:
        inject.add_particles = add


def phase_validate(dev):
    """The irregular, bedload, suspended and dune validators through the
    battery's runners' modules at the full mesh of each (coarsen 4, 2, 2
    and 2, the validators' defaults) and their tables (8,192, 8,192,
    65,536, 65,536), cut in depth only; every gate that a cut run
    evaluates must hold. The dune has no averaging window that a cut run
    falls short of: its cut run is marked quick, which leaves its
    full-run gates unevaluated."""
    from sedifoam_tpu_torch.dem import fused
    from sedifoam_tpu_torch.validate import (battery, bedload, dune,
                                             irregular, jetflow, suspended)
    out = {}
    dt = 1e-4

    def t(steps, dt=dt):
        return steps * dt - 0.5 * dt

    specs = (
        ("irregular", lambda: irregular.run(
            t_end=t(VALIDATE_IRREGULAR_STEPS), device=dev),
         VALIDATE_IRREGULAR_STEPS, 0, 160, 50,
         f"t_end 0.6 s (6,000 steps) cut to {VALIDATE_IRREGULAR_STEPS} "
         "steps"),
        ("transport-bedload", lambda: bedload.run(
            t_end=t(VALIDATE_BEDLOAD_STEPS),
            t_settle=t(VALIDATE_BEDLOAD_SETTLE), device=dev),
         VALIDATE_BEDLOAD_STEPS, VALIDATE_BEDLOAD_SETTLE, 16, 40,
         f"0.3 s settling + 3.0 s (33,000 steps) cut to "
         f"{VALIDATE_BEDLOAD_SETTLE} + {VALIDATE_BEDLOAD_STEPS} steps"),
        ("transport-suspended", lambda: suspended.run(
            t_end=t(VALIDATE_SUSPENDED_STEPS),
            t_settle=t(VALIDATE_SUSPENDED_SETTLE), device=dev),
         VALIDATE_SUSPENDED_STEPS, VALIDATE_SUSPENDED_SETTLE, 23, 80,
         f"0.2 s settling + 1.5 s (17,000 steps) cut to "
         f"{VALIDATE_SUSPENDED_SETTLE} + {VALIDATE_SUSPENDED_STEPS} steps"),
        ("transport-vortex-dune", lambda: dune.run(
            t_end=t(VALIDATE_DUNE_STEPS), t_settle=t(VALIDATE_DUNE_SETTLE),
            quick=True, device=dev),
         VALIDATE_DUNE_STEPS, VALIDATE_DUNE_SETTLE, 23, 80,
         f"0.2 s settling + 1.5 s (17,000 steps) cut to "
         f"{VALIDATE_DUNE_SETTLE} + {VALIDATE_DUNE_STEPS} steps, 5 coupling "
         "cycles a step"),
        ("jetFlow", lambda: jetflow.run(
            t_end=t(VALIDATE_JETFLOW_STEPS, 2e-4), quick=True, device=dev),
         VALIDATE_JETFLOW_STEPS, 0, 16, 200,
         f"1.5 s (7,500 steps) cut to {VALIDATE_JETFLOW_STEPS} steps at the "
         "full mesh and table (marked quick)"))
    for name, fn, steps, settle, K, sub, cut in specs:
        fused.reset_launches()
        caps = captures()
        t0 = time.perf_counter()
        with counted_adds(dev) as added:
            res = fn()
        wall = time.perf_counter() - t0
        adds = int(added)
        launches, by_n = fused.launches(), dict(fused.launch_sizes())
        in_graphs = fused.graph_launches()
        caps = captures() - caps
        say(f"validate [{name}]: {cut}; {wall:.1f} s in all, "
            f"{res['wall_time_s'] / steps * 1e3:.1f} ms/step; "
            + json.dumps(res))
        say(f"validate [{name}]: gates evaluated {sorted(res['gates'])}, "
            f"not evaluated at this length {res['not_evaluated']}")
        graphed = caps > 0 and in_graphs > 0
        say(f"validate [{name}]: {res['wall_time_s'] / steps * 1e3:.3f} ms "
            f"per forced step (the forced run's wall time incl. its capture"
            f"); the step ran as a replayed graph: {graphed} ({caps} "
            f"captures, {in_graphs} contact_chain launches inside replays)")
        if res["steps"] != steps + settle:
            fail(f"validate {name}: ran {res['steps']} steps, not "
                 f"{steps + settle}")
        if not battery.judge(name, res):
            fail(f"validate {name}: gates {res['gates']}")
        if res["nbr_dropped"] != 0:
            fail(f"validate {name}: neighbor audit dropped "
                 f"{res['nbr_dropped']} in-ring partners")
        if not graphed:
            fail(f"validate {name}: the step did not run as a replayed graph")
        # 1 setup, the steps, a warm-up step per capture (the settling
        # run and the forced run capture one each) and timing_split's
        # 1 + 5 evolves, each sub substeps; an add (in any of these
        # steps) rebuilds the table and sets up the forces once more
        expected = 1 + (steps + settle + caps + 6) * sub + adds
        say(f"validate [{name}]: contact_chain launches {launches} (1 setup"
            f" + ({steps + settle} steps + {caps} capture warm-ups + 6 "
            f"evolves of the timing split) x {sub} substeps + {adds} adds "
            f"= {expected}) by N {by_n} at K {K}")
        if (adds > 0) != (name == "jetFlow"):
            fail(f"validate {name}: {adds} adds of particles")
        if launches != expected:
            fail(f"validate {name}: kernel launched {launches} times, "
                 f"expected {expected}")
        out[name] = {"launches": launches, "by_n": by_n, "K": K}
    return out


def refcase_runners(counts):
    """battery.case_runners wrapped so that each runner records, in
    counts[name], the kernel's launches of its run (eager and inside
    replayed graphs), by N, the captures and the seconds."""
    from sedifoam_tpu_torch.dem import fused
    from sedifoam_tpu_torch.validate import battery
    make = battery.case_runners

    def runners(*args, **kw):
        def counted(name, fn):
            def run():
                fused.reset_launches()
                caps = captures()
                t0 = time.perf_counter()
                res = fn()
                counts[name] = {"launches": fused.launches(),
                                "by_n": dict(fused.launch_sizes()),
                                "in_graphs": fused.graph_launches(),
                                "captures": captures() - caps,
                                "seconds": time.perf_counter() - t0}
                return res
            return run
        return {n: counted(n, f) for n, f in make(*args, **kw).items()}
    return runners


def phase_refcases(dev, floor):
    """The reference's own auto-testing and example cases on the port:
    stand-ins at the real cases' particle counts (xiaocase1 2,160,
    expMueller06/09 9,240, expWachem_PCM 17,562, BL24-TH1 9,341 in a
    table of 16,384, the collisions' 4) written as the reference's case
    tree, `python -m sedifoam_tpu_torch.validate.battery --quick
    --cases-dir` on them with the quick lengths cut in depth, each binned
    case's kernel launches = 1 setup + (steps + captures + 6 evolves of
    the timing split) x substeps, the dense collisions none; the contact
    chain against its plain version and timed at each new shape after
    REFCASE_SETTLE steps; then the report (validate/report.py). The
    stand-ins' gates judge no physics: each case must run and be judged,
    its verdict is printed."""
    import torch
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import torch_port_refcases as rc
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import initialize
    from sedifoam_tpu_torch.validate import (battery, bl24, report,
                                             semi_implicit)
    dt = 1e-4
    root = tempfile.mkdtemp(prefix="refcases_")
    t0 = time.perf_counter()
    rc.write_tree(root, sizes=rc.FULL, collide_end=REFCASE_COLLIDE_END)
    say(f"refcases: stand-ins written at the real counts in "
        f"{time.perf_counter() - t0:.1f} s")
    counts = {}
    saved = battery.case_runners, battery.QUICK_T
    cut = (REFCASE_STEPS - 0.5) * dt
    battery.case_runners = refcase_runners(counts)
    battery.QUICK_T = {"xiaocase1": (REFCASE_XIAOCASE1_STEPS - 0.5) * dt,
                       "mueller": cut, "mueller_avg": 0.0, "wachem": cut,
                       "bl24": (REFCASE_BL24_STEPS - 0.5) * dt}
    path = os.path.join(root, "torch_report.json")
    t0 = time.perf_counter()
    try:
        battery.main(["--device", str(dev), "--quick", "--cases-dir", root,
                      "--report", path, "--only", ",".join(REFCASE_NAMES)])
        code = 0
    except SystemExit as e:
        code = e.code
    finally:
        battery.case_runners, battery.QUICK_T = saved
    say(f"refcases: the battery ran in {time.perf_counter() - t0:.1f} s, "
        f"exit code {code} (1: a stand-in's gate failed)")
    if code not in (0, 1):
        fail(f"refcases: the battery exited {code}")
    with open(path) as f:
        rep = json.load(f)
    steps = {"xiaocase1": REFCASE_XIAOCASE1_STEPS,
             "expMueller06": REFCASE_STEPS,
             "expMueller09": REFCASE_STEPS, "expWachem_PCM": REFCASE_STEPS,
             "BL24-TH1": REFCASE_BL24_STEPS,
             "multiParticlesCollide": 2 * int(round(REFCASE_COLLIDE_END
                                                    / 1e-3))}
    out = {"cases": {}, "shapes": [], "launches": 0, "ran_at": [],
           "max_abs_err": 0.0}
    for name in REFCASE_NAMES:
        entry = rep["cases"].get(name, {})
        if "not_run" in entry or "error" in entry or name not in counts:
            fail(f"refcases [{name}]: did not run: "
                 f"{json.dumps(entry)[:2000]}")
        if entry["passed"] != battery.judge(name, entry, True):
            fail(f"refcases [{name}]: stored verdict is not the judge's")
        c = counts[name]
        ms = c["seconds"] / steps[name] * 1e3
        gates = entry.get("gates") or {k: entry[k] for k in (
            "ramp_max_rel_err", "plateau_rel_err", "dp_vs_bed_weight_rel_err",
            "continuity_err", "alpha_min", "dp_vs_baseline_rel_err",
            "seedmean_lineY3_uy_rms_err", "seedmean_lineY3_uy_corr",
            "y_max_dev", "vy_max_dev") if k in entry}
        say(f"refcases [{name}]: {'PASS' if entry['passed'] else 'FAIL'} "
            f"(a stand-in: no physics judged) in {c['seconds']:.1f} s, "
            f"{ms:.2f} ms per step of the run incl. its load and capture; "
            f"keys {sorted(entry)}; gates a cut run evaluates "
            f"{json.dumps(gates)}; launches {c['launches']} by N "
            f"{c['by_n']} ({c['in_graphs']} inside replays, "
            f"{c['captures']} captures)")
        out["cases"][name] = {"passed": entry["passed"],
                              "seconds": c["seconds"], "ms_per_step": ms,
                              "launches": c["launches"]}
    # the launches of the binned cases' runs, and the chain at their shapes
    for name, capacity in (("xiaocase1", None), ("expMueller06", None),
                           ("expMueller09", None), ("expWachem_PCM", None),
                           ("BL24-TH1", bl24.CAPACITY)):
        case = os.path.join(root, battery.REF_CASES[name][0][0])
        cfg, fluid, particles, _ = load_case(
            case, backend="binned", dtype=torch.float32, capacity=capacity,
            device=dev)
        if name in ("expWachem_PCM", "BL24-TH1"):     # as their validators
            cfg = semi_implicit(cfg)
        sub = cfg.cloud.sub_cycles * cfg.cloud.sub_steps
        c = counts[name]
        expected = 1 + (steps[name] + c["captures"] + 6) * sub
        say(f"refcases [{name}]: contact_chain launches {c['launches']} (1 "
            f"setup + ({steps[name]} steps + {c['captures']} capture "
            f"warm-ups + 6 evolves of the timing split) x {sub} substeps = "
            f"{expected})")
        if c["launches"] != expected or c["in_graphs"] == 0:
            fail(f"refcases [{name}]: kernel launched {c['launches']} times "
                 f"({c['in_graphs']} inside replays), expected {expected}")
        K = particles.nbr_idx.shape[0]
        out["launches"] += c["launches"]
        out["ran_at"] += [{"N": n, "K": K, "launches": v, "path": "refcases"}
                          for n, v in sorted(c["by_n"].items())]
        if name == "expMueller09":
            continue                  # the shape of expMueller06's stand-in
        counted = launch_snapshot()
        sim = Simulation(cfg, initialize(fluid, particles, cfg),
                         steps_per_host_visit=REFCASE_SETTLE, device=dev)
        sim.run((REFCASE_SETTLE - 0.5) * dt)
        p = tree_map(torch.clone, sim.state.particles)
        launch_restore(counted)
        del sim
        label = f"{name} stand-in after {REFCASE_SETTLE} steps"
        got = compare_chain(label, p, cfg.dem, True, 1e-5, timing=True,
                            may_be_zero=("torque", "wall_shear"))
        out["max_abs_err"] = max(out["max_abs_err"], got["max_abs_err"])
        shape = measure_chain(f"refcases {name}", p, cfg.dem, floor)
        shape.update(plain_ms=got["plain_ms"], wrapper_ms=got["ms"],
                     launches=c["launches"])
        out["shapes"].append(shape)
    if counts["multiParticlesCollide"]["launches"] != 0:
        fail("refcases [multiParticlesCollide]: the dense cases launched the "
             "binned chain")
    res = report.main(["--report", path, "--cases-dir", root,
                       "--out", os.path.join(root, "torch_report.md"),
                       "--plots", os.path.join(root, "torch_plots")])
    with open(res["out"]) as f:
        text = f.read()
    rows = [ln for ln in text.splitlines() if ln.startswith("| ")
            and not ln.startswith("| case")]
    say(f"refcases: report {len(rows)} rows, plots drawn "
        f"{res['plots_drawn']} ({len(res['plots'])})")
    for ln in rows:
        say(f"refcases report: {ln[:300]}")
    if len(rows) != len(REFCASE_NAMES):
        fail(f"refcases: the report has {len(rows)} rows")
    return out


def main():
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    smi = phase_environment()
    marks = [time.perf_counter()]
    names = []

    def mark(name):
        names.append(name)
        marks.append(time.perf_counter())

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    mark("build")
    k = phase_kernel(dev)
    mark("kernel")
    launches = phase_main_path(dev)
    mark("main_path")
    graph_ran = phase_graph(dev)
    mark("graph")
    launches += phase_runner(dev)
    mark("runner")
    inject_launches, by_n = phase_inject(dev)
    mark("inject")
    launches += inject_launches
    phase_dense(dev)
    mark("dense")
    case = phase_case(dev)
    mark("case")
    launches += case["launches"]
    phase_case_jetflow(dev)
    mark("case_jetflow")
    phase_entry(dev)
    mark("entry")
    clumps = phase_clumps(dev)
    mark("clumps")
    extras = phase_extras(dev)
    mark("extras")
    phase_dns(dev)
    mark("dns")
    bench = phase_bench(dev, k["floor_us"])
    mark("bench")
    lattice = phase_lattice(dev)
    mark("lattice")
    phase_physics()
    mark("physics")
    sharded = phase_sharded(dev, k, smi)
    mark("sharded")
    validate = phase_validate(dev)
    mark("validate")
    refcases = phase_refcases(dev, k["floor_us"])
    mark("refcases")
    say(f"chip_smoke: every phase passed in "
        f"{time.perf_counter() - t_start:.1f} s (" + ", ".join(
            f"{n} {b - a:.1f}" for n, a, b in zip(names, marks, marks[1:]))
        + " s)")
    say(smi)
    ran_at = [{"N": 131072, "K": 8, "launches": launches - inject_launches
               - case["launches"]}]
    ran_at += [{"N": n, "K": 8, "launches": c} for n, c in by_n.items()]
    ran_at += graph_ran
    launches += sum(r["launches"] for r in graph_ran)
    # the split step's ranks: launches on their own rows, in their
    # processes, by the rows each launch computed (as the ranks counted)
    ran_at += sharded["ran_at"]
    launches += sharded["launches"]
    paths = (case, clumps, extras, bench) + tuple(validate.values())
    for path in paths:
        ran_at += [{"N": n, "K": path["K"], "launches": c}
                   for n, c in sorted(path["by_n"].items())]
    launches += sum(path["launches"] for path in paths[1:])
    ran_at += refcases["ran_at"]
    launches += refcases["launches"]
    k["shapes"] += bench["shapes"] + refcases["shapes"]
    bench_rates, bench = bench["rates"], k["shapes"][0]
    say(json.dumps({"kernels": [{
        "name": "contact_chain", "route": "cuda",
        "source": "sedifoam_tpu_torch/csrc/contact_chain.cu",
        "replaces": "sedifoam_tpu/dem/fused.py:33",
        "launches": launches, "max_abs_err": max(
            k["max_abs_err"], case["max_abs_err"], paths[3]["max_abs_err"],
            refcases["max_abs_err"]),
        "ms": bench["device_ms"], "plain_ms": k["plain_ms"],
        "bound_ms": bench["bound_ms"], "bound_by": bench["bound_by"],
        "library_ms": None, "wrapper_ms": k["ms"],
        "case_wrapper_ms": case["ms"], "case_plain_ms": case["plain_ms"],
        "bench_rates": bench_rates, "lattice": lattice,
        "rows_ms": sharded["rows_ms"],
        "rows_bound_ms": sharded["rows_bound_ms"],
        "sharded": {key: sharded[key] for key in (
            "gloo", "nccl", "rebuilt", "channel", "ref_ms",
            "channel_ref_ms", "slab_ops_parting", "configs", "own_rows",
            "probe", "graphed")},
        "refcases": refcases["cases"],
        "shapes": k["shapes"],
        "graphs": GRAPHS, "ran_at": ran_at}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
