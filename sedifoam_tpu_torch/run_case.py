"""Generic case runner on the port (the counterpart of
``scripts/run_case.py``).

Runs any sediFoam-format case directory end to end: loads it unmodified,
steps to endTime (or --t-end), samples the probes declared in the case's
own system/controlDict functions block, writes time directories at
writeInterval, and prints a one-line JSON summary with the reference
script's keys.

  python -m sedifoam_tpu_torch.run_case CASE_DIR [--t-end T]
        [--out-dir DIR] [--backend dense|binned] [--f64]
        [--dump snapshot.dump] [--device cpu]

Runs on the CUDA card unless --device names another device.
"""

import argparse
import dataclasses
import json
import os


def probe_locations_from_controldict(case_dir):
    from sedifoam_tpu_torch.io import foamdict
    cd = foamdict.parse_file(os.path.join(case_dir, "system", "controlDict"))
    funcs = cd.get("functions", {})
    if not isinstance(funcs, dict):
        return []
    for spec in funcs.values():
        if isinstance(spec, dict) and spec.get("type") == "probes":
            locs = spec.get("probeLocations", [])
            return [tuple(float(x) for x in p) for p in locs
                    if isinstance(p, list) and len(p) == 3]
    return []


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("case_dir")
    ap.add_argument("--t-end", type=float, default=None)
    ap.add_argument("--out-dir", default="")
    ap.add_argument("--backend", default="binned")
    ap.add_argument("--f64", action="store_true")
    ap.add_argument("--dump", default="")
    ap.add_argument("--dump-every", type=int, default=50)
    ap.add_argument("--semi-implicit-drag", action="store_true",
                    help="enable the semi-implicit fluid-side drag "
                         "(stiff gas-solid beds, e.g. expWachem_PCM)")
    ap.add_argument("--foam-output", action="store_true",
                    help="also write OpenFOAM-ASCII field files into the "
                         "time directories (readable by the reference's "
                         "own post-processing)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the state and the step "
                         "(default cuda; cpu to run on the CPU)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from sedifoam_tpu_torch.io.case import load_case
    from sedifoam_tpu_torch.runtime.runner import Simulation
    from sedifoam_tpu_torch.solver import initialize

    dtype = torch.float64 if args.f64 else torch.float32
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")
    cfg, fluid, particles, controls = load_case(args.case_dir,
                                                backend=args.backend,
                                                dtype=dtype, device=device)
    if args.semi_implicit_drag:
        cfg = dataclasses.replace(cfg, cloud=dataclasses.replace(
            cfg.cloud, semi_implicit_drag=True))
    state = initialize(fluid, particles, cfg)

    probes = probe_locations_from_controldict(args.case_dir)
    sim = Simulation(cfg, state, probe_locations=probes or None,
                     steps_per_host_visit=20, device=device)
    sim.foam_output = args.foam_output

    dump = None
    on_sample = None
    if args.dump:
        from sedifoam_tpu_torch.io.dump import DumpWriter
        box = (cfg.dem.domain_lo[0], cfg.dem.domain_hi[0],
               cfg.dem.domain_lo[1], cfg.dem.domain_hi[1],
               cfg.dem.domain_lo[2], cfg.dem.domain_hi[2])
        dump = DumpWriter(args.dump, box=box)
        visits = [0]

        def on_sample(s):
            visits[0] += 1
            if visits[0] % args.dump_every == 0:
                dump.write(int(s.state.fluid.step), s.state.particles)

    t_end = args.t_end if args.t_end is not None else controls.end_time
    try:
        sim.run(t_end, probe_every=1, log_every=50,
                write_dir=args.out_dir or None,
                write_interval=controls.write_interval if args.out_dir
                else None,
                on_sample=on_sample)
    finally:
        if dump is not None:
            dump.close()

    summary = {
        "case": os.path.basename(os.path.normpath(args.case_dir)),
        "t_end": t_end,
        "n_particles": int(sim.state.particles.active.sum()),
        "wall_time_s": round(sim.wall_time, 2),
        "steps_per_s": round(t_end / cfg.fluid.dt / max(sim.wall_time, 1e-9),
                             2),
    }
    if sim.log:
        summary["final_diagnostics"] = sim.log[-1]
    if sim.probes is not None and args.out_dir:
        t, p = sim.probes.series("p")
        np.savez(os.path.join(args.out_dir, "probes.npz"), times=t, p=p)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
