"""Readings that the limits of a cell are set from, on the CUDA card:
for each seed, one run of the cell (set-up and a window of `--seconds`),
the reference's three checks on what the program produced (the lower
readings), and with --control the same checks with the control in the
program's place: the reference computed with TF32 matrix products, the
precision just below the configuration's float32 with TF32 off (the
upper readings). All seeds run in one process.

    python3 port_bench/calibrate.py --workload <cell> --seeds 1,2,3
        --seconds 5 [--control]

Prints one JSON line per seed. The benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _readings(checks):
    """Each number in both norms: the worst of the checks, and the
    checks' own readings with their worst fields."""
    from pbench import check
    out = {norm: check.numbers(checks, {k: norm for k in check.NUMBERS})
           for norm in ("max", "l2")}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(HERE), str(ROOT)]

    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    from pbench import check, harness, spec
    dev = torch.device("cuda")
    cell = spec.find_cell(args.workload, ROOT)
    spv = cell.workload["steps_per_host_visit"]
    t_start = T_START
    for seed in (int(s) for s in args.seeds.split(",")):
        m = harness.measure(cell, seed, args.seconds, False, dev, t_start)
        try:
            t0 = time.perf_counter()
            ref = check.Reference(cell.case, cell.config, m.inputs, dev)
            R = check.reference_states(ref, spv, m.before_check)
            ref_s = time.perf_counter() - t0
            sound = check.run_checks(m.got, R, m.before_check)
            line = {"workload": args.workload, "seed": seed,
                    "metrics": {k: v["value"] for k, v in m.metrics.items()},
                    "steps": m.steps, "failed": m.failed,
                    "dropped": m.dropped, "thirds_ms": m.step_ms_thirds,
                    "reference_s": ref_s,
                    "program": _readings(sound)}
            if args.control:
                ctl = check.Reference(cell.case, cell.config, m.inputs,
                                      dev, tf32=True)
                C = check.reference_states(ctl, spv, m.before_check)
                control = check.run_checks(C, R, m.before_check)
                line["control"] = _readings(control)
                del ctl, C
            del ref, R
        finally:
            shutil.rmtree(m.workdir, ignore_errors=True)
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()
        t_start = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
