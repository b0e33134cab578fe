"""multiParticlesCollide validation on the port: settling and collision
of four particles against the reference's traces (the trace check of
``tests/test_golden_collide.py`` as a validator).

Reference: cases/auto-testing/test-cases/multiParticlesCollideDia and
-Rho — four sand particles (2.0-3.5 mm, or of unequal density) settle in
water in a 0.2 x 0.1 m quasi-2D tank. Each case loads as the reference
test loads it (dense DEM, f64), steps to its endTime and records the
particles every 0.01 s (in.lammps dumps every 1,000 DEM steps of 1e-5
s); y and vy of each particle are compared with the repository's traces
tests/golden_data/<case>/p<i>.dat (columns id type d m x y z vx vy vz)
over the frames both hold. The bounds are the test's: y within 4 mm and
vy within 0.03 m/s of the traces.

Run: python -m sedifoam_tpu_torch.validate.collide [--cases DIR]
     [--end-time T] [--out FILE.npz] [--device cpu]
Prints one JSON line; --out is written under a torch_-prefixed name.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from sedifoam_tpu_torch.validate import (REPO, TEST_CASES, ref_case,
                                         torch_out)

CASES = ("multiParticlesCollideDia", "multiParticlesCollideRho")
CASE_ROOT = ref_case(TEST_CASES)
GOLDEN = os.path.join(REPO, "tests", "golden_data")
FRAME_DT = 0.01
Y_TOL = 4e-3
VY_TOL = 0.03
N_TRACED = 4


def trace(case_dir, end_time=None, device=None):
    """(times, pos (T, N, 3), vel (T, N, 3), seconds) of the case stepped
    to its endTime (or `end_time`), a frame every FRAME_DT from t = 0."""
    import numpy as np
    import torch

    from sedifoam_tpu_torch import default_device
    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.solver import initialize, make_step_fn

    device = default_device(device)
    cfg, fluid, particles, controls = load_case(case_dir, device=device)
    state = initialize(fluid, particles, cfg)
    step = make_step_fn(cfg, dtype=torch.float64, device=device)
    t_end = controls.end_time if end_time is None else end_time
    n_steps = int(round(t_end / controls.dt))
    per_frame = int(round(FRAME_DT / controls.dt))

    def frame():
        ps = state.particles
        return ps.pos.cpu().numpy().copy(), ps.vel.cpu().numpy().copy()

    t0 = time.perf_counter()
    frames, times = [frame()], [0.0]
    for i in range(n_steps):
        state = step(state)
        if (i + 1) % per_frame == 0:
            frames.append(frame())
            times.append((i + 1) * controls.dt)
    secs = time.perf_counter() - t0
    pos = np.stack([f[0] for f in frames])
    vel = np.stack([f[1] for f in frames])
    return np.asarray(times), pos, vel, secs


def compare(pos, vel, golden_dir, n=N_TRACED) -> dict:
    """Per particle, the largest |y - y_trace| and |vy - vy_trace| over
    the frames both hold."""
    import numpy as np
    y_dev, vy_dev, frames = [], [], len(pos)
    for i in range(n):
        bench = np.loadtxt(os.path.join(golden_dir, f"p{i + 1}.dat"))
        nt = min(len(bench), len(pos))
        frames = min(frames, nt)
        y_dev.append(float(np.max(np.abs(pos[:nt, i, 1] - bench[:nt, 5]))))
        vy_dev.append(float(np.max(np.abs(vel[:nt, i, 1] - bench[:nt, 8]))))
    return {"frames_compared": frames, "y_max_dev": y_dev,
            "vy_max_dev": vy_dev}


def run(case_root, end_time=None, out="", device=None) -> dict:
    """Both cases traced and compared; `passed` when every particle of
    each keeps within the bounds."""
    import numpy as np
    result = {"cases": {}}
    arrays = {}
    for name in CASES:
        times, pos, vel, secs = trace(os.path.join(case_root, name),
                                      end_time, device)
        entry = {"t_end": float(times[-1]), "frames": int(len(times)),
                 "wall_time_s": round(secs, 2)}
        entry.update(compare(pos, vel, os.path.join(GOLDEN, name)))
        result["cases"][name] = entry
        arrays.update({f"{name}_times": times, f"{name}_pos": pos,
                       f"{name}_vel": vel})
    result["y_max_dev"] = max(max(c["y_max_dev"])
                              for c in result["cases"].values())
    result["vy_max_dev"] = max(max(c["vy_max_dev"])
                               for c in result["cases"].values())
    result["y_tol"], result["vy_tol"] = Y_TOL, VY_TOL
    result["passed"] = bool(result["y_max_dev"] < Y_TOL
                            and result["vy_max_dev"] < VY_TOL)
    if out:
        np.savez(torch_out(out), **arrays)
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", default=CASE_ROOT, required=CASE_ROOT is None,
                    help="the directory holding both case directories")
    ap.add_argument("--end-time", type=float, default=None)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    result = run(args.cases, args.end_time, args.out, args.device)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
