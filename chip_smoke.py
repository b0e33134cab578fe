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
   output's scale <= 1e-5 (f32) and 1e-12 (f64), also periodic and
   shearupdate=False; both timed with CUDA events;
4. main path: initialize, 1 warm-up and 10 timed coupled steps
   (particle-substeps/s), a per-phase split over 3 more steps; the state
   must be finite, nbr_dropped 0, alpha in [0, max_possible_alpha] up to
   f32 round-off of the smoothing transform (1e-6), the
   kernel's launch count must equal the setups + substeps run, and one
   coupled step through the kernel must agree with one through the plain
   chain (<= 1e-3 of each field's scale, f32);
5. output: nvidia-smi's name/power line, a JSON line with the kernel
   table, and last {"ok": true, "device": {...}}.

Imports nothing of JAX. Needs one card; builds into build/kernels/.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time
import warnings

REPO = os.path.dirname(os.path.abspath(__file__))
N_TIMED = 10
N_SPLIT = 3
KERNEL_SUBSTEPS = 20
ALPHA_ROUNDOFF = 1e-6


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
    for line in log.read_text().splitlines() if log.exists() else ():
        if "registers" in line or "spill" in line:
            say(f"  ptxas: {line.strip()}")
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


def compare_chain(label, p, cfg_dem, shearupdate, tol, timing=False):
    """Kernel vs contact_chain_reference on clones of p."""
    import torch
    from sedifoam_tpu_torch.dem import fused
    walls = cfg_dem.walls if fused.walls_fusible(cfg_dem.walls) else ()
    args = (cfg_dem.pair, cfg_dem.dt, p.nbr_idx, shearupdate,
            cfg_dem.periodic_len(), walls)
    pa = tree_map(torch.clone, p)
    pb = tree_map(torch.clone, p)
    ref = fused.contact_chain_reference(pa, *args)
    launches = fused.LAUNCHES
    got = fused._launch(pb, *args)
    torch.cuda.synchronize()
    errs, abs_err = {}, 0.0
    for name, a, b in zip(("force", "torque", "shear", "wall_shear"),
                          ref, got):
        if a is None:
            continue
        if not bool(torch.any(a != 0)):
            fail(f"{label}: {name} is all zero: no contacts to compare")
        errs[name] = rel_err(a, b)
        abs_err = max(abs_err, float((a.double() - b.double()).abs().max()))
    worst = max(errs.values())
    say(f"kernel vs plain [{label}]: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()) + f" (tol {tol:.0e})")
    if worst > tol:
        fail(f"{label}: kernel disagrees with the plain chain: {errs}")
    out = {"max_abs_err": abs_err}
    if timing:
        out["ms"] = cuda_ms(lambda: fused._launch(pb, *args), 50)
        out["plain_ms"] = cuda_ms(
            lambda: fused.contact_chain_reference(pa, *args), 10)
        say(f"contact chain at N={p.n_capacity} K={p.nbr_idx.shape[0]} "
            f"W={len(walls)}: kernel {out['ms']:.4f} ms, plain "
            f"{out['plain_ms']:.4f} ms (CUDA events)")
    fused.LAUNCHES = launches          # comparison launches do not count
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
    return res


def phase_main_path(dev):
    import torch
    from sedifoam_tpu_torch import bench_case
    from sedifoam_tpu_torch.coupling import cloud
    from sedifoam_tpu_torch.dem import fused
    from sedifoam_tpu_torch.fluid.step import advance_time, fluid_step
    from sedifoam_tpu_torch.solver import CoupledStep, need_ddtu
    cfg = bench_case.build_config(**bench_case.FULL)
    n = bench_case.FULL["n_particles"]
    sub = cfg.cloud.sub_steps
    fluid, particles = bench_case.build_state(cfg, n, torch.float32, dev)
    step = CoupledStep(cfg, dtype=torch.float32, device=dev)

    fused.LAUNCHES = 0
    state = step.initialize(fluid, particles)
    state = step(state)                                    # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N_TIMED):
        state = step(state)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rate = n * sub * N_TIMED / wall
    say(f"main path: {N_TIMED} coupled steps in {wall:.4f} s = "
        f"{wall / N_TIMED * 1e3:.3f} ms/step, {rate:.1f} "
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

    launches = fused.LAUNCHES
    n_steps = 1 + N_TIMED + N_SPLIT

    # host syncs of one coupled step, as torch's sync debug mode reports
    # them (outside the counted and timed runs: same path, same count)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            probe = step(tree_map(torch.clone, state))
        finally:
            torch.cuda.set_sync_debug_mode("default")
    n_sync = sum("synchroniz" in str(w.message) for w in seen)
    say(f"host syncs in one coupled step: {n_sync} (torch sync debug mode;"
        f" {cfg.cloud.sub_steps} Verlet rebuild tests + PCG stop tests)")
    del probe
    expected = 1 + n_steps * cfg.cloud.sub_cycles * sub
    say(f"contact_chain launches: {launches} (1 setup + {n_steps} steps x "
        f"{sub} substeps = {expected})")
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
    a = step(tree_map(torch.clone, state))
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


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not importable")
    smi = phase_environment()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    k = phase_kernel(dev)
    launches = phase_main_path(dev)
    say(smi)
    say(json.dumps({"kernels": [{
        "name": "contact_chain", "route": "cuda",
        "source": "sedifoam_tpu_torch/csrc/contact_chain.cu",
        "replaces": "sedifoam_tpu/dem/fused.py:33",
        "launches": launches, "max_abs_err": k["max_abs_err"],
        "ms": k["ms"], "plain_ms": k["plain_ms"]}]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
