"""Run one cell of the port's benchmark once, on the CUDA card.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout that holds BENCHMARK.json and
sedifoam_tpu_torch. Prints the run's notes and, last on standard error,
each number compared with its limit; the last line of standard output is
one JSON object: correct, attempted, failed, metrics, device (and
breakdown with --trace 1), then checks. Exits nonzero, printing no
result, without a CUDA card, or where the process has loaded JAX or the
JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # every build and kernel cache at a fixed path inside the checkout
    cache = ROOT / "build" / "port_bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    sys.path[:0] = [str(HERE), str(ROOT)]

    import torch
    torch.set_num_threads(4)
    from pbench import harness, spec
    chips = spec.find_cell(args.workload, ROOT).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell needs {chips} CUDA card(s): the benchmark runs on "
              "the card only", file=sys.stderr)
        return 2

    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", ROOT, T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"the process loaded {', '.join(found)}: no result",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
