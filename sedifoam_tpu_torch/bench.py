"""Headline benchmark of the port: coupled CFD-DEM throughput on one
CUDA card (the counterpart of the repository's ``bench.py::main``).

Runs the coupled bed case of ``bench_case`` (dense-contact DEM + PISO
fluid + diffusion-smoothed coupling, f32) and reports particle DEM
substeps per second.

  python -m sedifoam_tpu_torch.bench [--small]
        [--backend=dense|binned|lattice]
        [--device cpu] [--repeats N] [--sort-on-rebuild]

On the card the step is the captured CUDA graph (solver.GraphedStep),
as the reference's bench times its jitted step: one warm-up step, which
includes the capture, then 10 timed replays (3 with --small) that end in
a real device-to-host fetch. On the CPU the same loop runs the eager
step. --repeats N times that block N times on the same state, prints
each repeat's rate on a line of its own and reports the median. Runs on
the CUDA card unless --device names another device, and raises where
there is no card.

Prints ONE JSON line last: {"metric", "value", "unit", "vs_baseline"}.
A run whose neighbor table ever dropped an in-ring partner (K too small
for the bed) exits nonzero with the audit's message and prints no result.

vs_baseline divides by a CPU measurement, as the reference's bench does:
native/dem_baseline.cpp (the reference's DEM hot loop in -O3 C++) on the
same just-touching 131k-particle bed runs 4.57e6 particle-substeps/s on
one core of an Intel Xeon at 2.1 GHz. It compares the full coupled step
on the card with a DEM-only inner loop on one CPU core. No floor file is
read: the repository's BENCH_floor.json holds a number of another
accelerator and is no number of this package.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import List, NamedTuple

import torch

from sedifoam_tpu_torch import bench_case, default_device

# measured on a CPU core: native/dem_baseline.cpp, 100 steps (BASELINE.md)
REFERENCE_MEASURED_PSTEPS_PER_CORE = 4.57e6

SMALL = dict(n_particles=256, nx=8, ny=16, nz=8)
METRIC = "particle_dem_substeps_per_sec_coupled"


class BenchRun(NamedTuple):
    cfg: object            # SimConfig of the case
    step: object           # the step that was timed: a GraphedStep on
    #                        the card (its .step is the CoupledStep)
    state: object          # SimState after the last timed step
    n_timed: int           # coupled steps per timed block
    walls: List[float]     # seconds of each timed block
    rates: List[float]     # particle-substeps/s of each timed block

    @property
    def value(self) -> float:
        """The median rate over the repeats."""
        return statistics.median(self.rates)


def fetch(state) -> float:
    """A real device-to-host fetch that depends on the whole step: the
    timed block ends here, not at an asynchronous launch."""
    return float(torch.sum(state.particles.vel[:, 1]))


def check_audit(state, cfg) -> None:
    """Fail hard if any rebuild dropped an in-ring partner: the
    density-sized K of the case is verified, not assumed."""
    dropped = int(state.particles.nbr_dropped)
    if dropped:
        raise SystemExit(
            f"NEIGHBOR AUDIT FAILED: {dropped} in-ring partners dropped "
            f"by the K={cfg.dem.nbr_k} table — benchmark result invalid")


def run(small: bool = False, backend: str = None, device=None,
        repeats: int = 1, sort_on_rebuild: bool = False,
        report=None) -> BenchRun:
    """Build the case, take one warm-up step and time `repeats` blocks of
    10 coupled steps (3 when small) on the same state.
    `report(i, wall, rate)` is called after each block. Raises SystemExit
    when the neighbor audit failed."""
    from sedifoam_tpu_torch.solver import CoupledStep, GraphedStep

    device = default_device(device)
    size = SMALL if small else bench_case.FULL
    backend = backend or ("dense" if small else "binned")
    cfg = bench_case.build_config(**size, backend=backend,
                                  sort_on_rebuild=sort_on_rebuild)
    n = size["n_particles"]
    sub = cfg.cloud.sub_cycles * cfg.cloud.sub_steps
    fluid, particles = bench_case.build_state(cfg, n, torch.float32, device)
    eager = CoupledStep(cfg, dtype=torch.float32, device=device)
    state = eager.initialize(fluid, particles)
    step = GraphedStep(eager) if device.type == "cuda" else eager

    state = step(state)                          # warm-up (and capture)
    fetch(state)

    n_timed = 3 if small else 10
    walls, rates = [], []
    for i in range(repeats):
        t0 = time.perf_counter()
        for _ in range(n_timed):
            state = step(state)
        fetch(state)
        walls.append(time.perf_counter() - t0)
        rates.append(n * sub * n_timed / walls[-1])
        if report is not None:
            report(i, walls[-1], rates[-1])
    check_audit(state, cfg)
    return BenchRun(cfg, step, state, n_timed, walls, rates)


def result_line(value: float) -> dict:
    """The one JSON object of the reference's bench, same four keys."""
    return {
        "metric": METRIC,
        "value": round(value, 1),
        "unit": "particle-substeps/s",
        "vs_baseline": round(value / REFERENCE_MEASURED_PSTEPS_PER_CORE, 4),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="256 particles on 8x16x8 cells, 3 timed steps")
    ap.add_argument("--backend", default=None,
                    choices=("dense", "binned", "lattice"),
                    help="default: dense with --small, else binned")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; cpu to run "
                         "on the CPU)")
    ap.add_argument("--repeats", type=int, default=1,
                    help="timed blocks on the same state; the median is "
                         "reported")
    ap.add_argument("--sort-on-rebuild", action="store_true",
                    help="bin-sort the particle rows at every rebuild")
    args = ap.parse_args(argv)
    if args.repeats < 1:
        ap.error("--repeats must be at least 1")

    def report(i, wall, rate):
        if args.repeats > 1:
            print(f"repeat {i + 1}/{args.repeats}: {wall:.4f} s, "
                  f"{rate:.1f} particle-substeps/s", flush=True)

    res = run(small=args.small, backend=args.backend, device=args.device,
              repeats=args.repeats, sort_on_rebuild=args.sort_on_rebuild,
              report=report)
    line = result_line(res.value)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
