"""Simulation runner: the time loop around the coupled step (port of
``sedifoam_tpu/runtime/runner.py``).

The lammpsFoam main-loop services (lammpsFoam.C:74-129): stepping to
endTime, probe sampling, periodic field/checkpoint writes, per-phase
timing splits (writeCPUTime.H analogue), and diagnostics logging.

The step is one `solver.CoupledStep` module on an explicit device. On a
CUDA device the Simulation replays it as a captured CUDA graph
(`solver.GraphedStep`): `steps_per_host_visit` replays, one launch each
and no host sync inside, between two visits. The host reads the device
only at a visit: the simulated time (the loop test), the window's
high-water mark when windowed (a grown window captures the step anew),
one probe sample and one diagnostics dict when due. On the CPU the step
runs eagerly. With telemetry on, each visit and each of its parts is a
span (telemetry.span: ``run.visit``; ``run.replay``, ``run.time_read``,
``run.window``, ``run.probes``, ``run.on_sample``, ``run.diagnostics``,
``run.write``).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from sedifoam_tpu_torch import default_device, telemetry
from sedifoam_tpu_torch.runtime import checkpoint as _ckpt
from sedifoam_tpu_torch.runtime import diagnostics as _diag
from sedifoam_tpu_torch.runtime.probes import Probes
from sedifoam_tpu_torch.solver import (CoupledStep, GraphedStep, SimConfig,
                                       SimState)


def _tree_map(fn, obj):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if hasattr(obj, "_fields"):
        return type(obj)(*(_tree_map(fn, v) for v in obj))
    return obj


def _np(t):
    return t.detach().cpu().numpy()


class Simulation:
    """The coupled step's time loop on `device` (default: the state's).

    The contact-chain kernel updates the contact history in place, so
    the Simulation keeps a private copy of the state's shear history:
    two Simulations built from one state step independently. On the card
    `state` is then the captured graph's buffers, which the next step
    overwrites: clone what must outlive it."""

    def __init__(self, cfg: SimConfig, state: SimState,
                 probe_locations: Optional[Sequence] = None,
                 steps_per_host_visit: int = 1,
                 active_window: Optional[bool] = None,
                 device=None):
        self.cfg = cfg
        self.device = torch.device(device) if device is not None \
            else state.fluid.p.device
        state = _tree_map(lambda t: t.to(self.device), state)
        ps = state.particles
        self.state = state._replace(particles=ps._replace(
            shear=ps.shear.clone(), wall_shear=ps.wall_shear.clone()))
        self.step_fn = CoupledStep(cfg, state.fluid.p.dtype, self.device)
        # the step the loop takes: the captured graph on the card
        self.advance = (GraphedStep(self.step_fn)
                        if self.device.type == "cuda" else self.step_fn)
        self.steps_per_visit = steps_per_host_visit
        # Active-window stepping (runtime/window.py): auto-on for binned
        # injection cases without rigid clumps; every per-substep cost
        # then scales with the live population, and the kernel runs at
        # each window size
        if active_window is None:
            active_window = (cfg.cloud.add_particle > 0
                             and cfg.dem.backend == "binned"
                             and ps.rigid is None)
        self.full_capacity = ps.n_capacity
        self.windowed = bool(active_window
                             and cfg.dem.backend == "binned"
                             and ps.rigid is None
                             and ps.nbr_idx.shape[0] > 0)
        if self.windowed:
            self._apply_window(first=True)
        self.probes = (Probes(cfg.grid, probe_locations)
                       if probe_locations else None)
        self.diag_fn = lambda s: _diag.compute(s, cfg.grid, cfg.fluid,
                                               cfg.dem)
        self.foam_output = False
        self.wall_time = 0.0
        self.log = []

    @classmethod
    def from_case(cls, case_dir: str, device=None, **kw):
        """A Simulation of a case directory with the loader's defaults
        (dense DEM, f64), its state on `device` (by default the CUDA card;
        device="cpu" for the CPU); `controls` holds the case's
        CaseControls."""
        from sedifoam_tpu_torch.io.case import load_case
        from sedifoam_tpu_torch.solver import initialize
        device = default_device(device)
        cfg, fluid, particles, controls = load_case(case_dir, device=device)
        sim = cls(cfg, initialize(fluid, particles, cfg), device=device,
                  **kw)
        sim.controls = controls
        return sim

    @property
    def t(self) -> float:
        return float(self.state.fluid.time)            # host sync

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _apply_window(self, first: bool = False) -> None:
        """Grow (or on first call, shrink) the particle window so the
        live population keeps >= 50% headroom — injection between host
        visits must never saturate the table (window.py soundness)."""
        from sedifoam_tpu_torch.runtime import window as _win
        ps = self.state.particles
        n_hi = int(_win.high_water(ps))                # host sync
        w = _win.next_window(n_hi, 0 if first else ps.n_capacity,
                             self.full_capacity)
        if first and w < ps.n_capacity:
            ps = _win.window_slice(ps, w)
        elif w > ps.n_capacity:
            ps = _win.window_grow(ps, w)
        else:
            return
        print(f"[window] t={self.t:.4g}s active<={n_hi} table "
              f"{ps.n_capacity} (capacity {self.full_capacity})", flush=True)
        self.state = self.state._replace(particles=ps)

    def run(self, t_end: float,
            probe_every: int = 1,
            log_every: int = 0,
            write_dir: Optional[str] = None,
            write_interval: Optional[float] = None,
            on_sample: Optional[Callable] = None) -> SimState:
        t = self.t
        next_write = (t + write_interval) if write_interval else None
        visit = 0
        t0 = time.perf_counter()
        span = telemetry.span
        while t < t_end - 1e-12:
            with span("run.visit"):
                with span("run.replay"):
                    for _ in range(self.steps_per_visit):
                        self.state = self.advance(self.state)
                visit += 1
                with span("run.time_read"):
                    t = self.t                         # one read per visit
                if self.windowed:
                    with span("run.window"):
                        self._apply_window()
                if self.probes is not None and visit % probe_every == 0:
                    with span("run.probes"):
                        fs = self.state.fluid
                        self.probes.sample(t, p=fs.p, Ub=fs.Ub,
                                           alpha=fs.alpha, Ua=fs.Ua)
                if on_sample is not None:
                    with span("run.on_sample"):
                        on_sample(self)
                if log_every and visit % log_every == 0:
                    with span("run.diagnostics"):
                        d = _diag.to_host(self.diag_fn(self.state))
                        d["t"] = t
                        self.log.append(d)
                if write_dir and next_write is not None and \
                        t >= next_write - 1e-12:
                    with span("run.write"):
                        self.write(write_dir)
                    next_write += write_interval
        self._sync()
        self.wall_time += time.perf_counter() - t0
        return self.state

    def write(self, out_dir: str) -> str:
        """Write a time directory: fields + full checkpoint."""
        tdir = os.path.join(out_dir, f"{self.t:.6g}")
        os.makedirs(tdir, exist_ok=True)
        fs, ps = self.state.fluid, self.state.particles
        from sedifoam_tpu_torch.fluid import turbulence as _turb
        B = _turb.reynolds_stress(fs, self.cfg.grid, self.cfg.bcs,
                                  self.cfg.fluid)
        np.savez_compressed(
            os.path.join(tdir, "fields.npz"),
            alpha=_np(fs.alpha), p=_np(fs.p), Ub=_np(fs.Ub), Ua=_np(fs.Ua),
            Asrc=_np(fs.Asrc), k=_np(fs.k), nut=_np(fs.nut), B=_np(B))
        np.savez_compressed(
            os.path.join(tdir, "particles.npz"),
            pos=_np(ps.pos), vel=_np(ps.vel), omega=_np(ps.omega),
            radius=_np(ps.radius), tag=_np(ps.tag), active=_np(ps.active))
        _ckpt.save(os.path.join(tdir, "checkpoint.npz"),
                   self._full_capacity_state())
        if self.foam_output:
            # OpenFOAM-ASCII export: readable by the reference's own
            # post-processing tools
            from sedifoam_tpu_torch.io import foamwrite
            foamwrite.write_time_dir(
                out_dir, f"{self.t:.6g}", self.cfg.grid,
                p=_np(fs.p), alpha=_np(fs.alpha), Ub=_np(fs.Ub),
                Ua=_np(fs.Ua), k=_np(fs.k), nut=_np(fs.nut))
        if self.log:
            with open(os.path.join(tdir, "diagnostics.jsonl"), "w") as f:
                for d in self.log:
                    f.write(json.dumps(d) + "\n")
        return tdir

    def _full_capacity_state(self) -> SimState:
        """The state at full capacity (checkpoints are always written
        window-independent so any later run can resume them)."""
        ps = self.state.particles
        if ps.n_capacity >= self.full_capacity:
            return self.state
        from sedifoam_tpu_torch.runtime import window as _win
        return self.state._replace(
            particles=_win.window_grow(ps, self.full_capacity))

    def save_checkpoint(self, path: str) -> str:
        """Atomic full-state checkpoint + probe-series sidecar.

        `startFrom latestTime` semantics: the DEM contact history rides
        the state, and the probe series rides a sidecar so a resumed
        validator sees one continuous series."""
        _ckpt.save(path, self._full_capacity_state())
        if self.probes is not None:
            self.probes.save(path + ".probes.npz")
        return path

    def resume(self, checkpoint_path: str) -> None:
        full = self._full_capacity_state()
        self.state = _ckpt.load(checkpoint_path, full)
        if self.windowed:
            self._apply_window(first=True)
        sidecar = checkpoint_path + ".probes.npz"
        if self.probes is not None and os.path.exists(sidecar):
            self.probes.load(sidecar)

    def _seconds(self, fn) -> float:
        """Time of fn(): CUDA events on a CUDA device, the host clock
        on the CPU."""
        if self.device.type == "cuda":
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            fn()
            t1.record()
            t1.synchronize()
            return t0.elapsed_time(t1) / 1e3
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    def timing_split(self, n: int = 5) -> dict:
        """Per-phase time split in seconds (the writeCPUTime.H
        instrumentation: fluid solve / particle evolve / coupling
        source), each phase run n times from the current state, after
        one warm-up."""
        from sedifoam_tpu_torch.coupling import cloud as _cloud
        from sedifoam_tpu_torch.fluid.step import advance_time, fluid_step
        from sedifoam_tpu_torch.solver import need_ddtu

        cfg, step, s = self.cfg, self.step_fn, self.state

        def f_fluid():
            fluid_step(advance_time(s.fluid, cfg.fluid), cfg.grid, cfg.bcs,
                       cfg.fluid, advance=False, need_ddtu=need_ddtu(cfg),
                       pprecond=step.pprecond)

        def f_evolve(particles):
            _cloud.evolve(s.fluid, particles, s.uf_smoothed, cfg.grid,
                          cfg.bcs, cfg.cloud, cfg.dem, cfg.fluid,
                          step.smoother)

        def f_source():
            _cloud.lift_drag_coeffs(s.fluid, s.particles, s.uf_smoothed,
                                    cfg.grid, cfg.bcs, cfg.cloud, cfg.fluid,
                                    step.smoother)

        def private():
            # evolve updates the contact history in place on CUDA
            ps = s.particles
            return ps._replace(shear=ps.shear.clone(),
                               wall_shear=ps.wall_shear.clone())

        f_fluid()
        f_evolve(private())
        f_source()
        self._sync()
        split = {"fluid": 0.0, "evolve": 0.0, "coupling_source": 0.0}
        for _ in range(n):
            split["fluid"] += self._seconds(f_fluid)
            ps = private()
            split["evolve"] += self._seconds(lambda: f_evolve(ps))
            split["coupling_source"] += self._seconds(f_source)
        return {k: v / n for k, v in split.items()}
