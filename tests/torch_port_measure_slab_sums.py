"""Whether a slab's plane sums equal the whole grid's on the card, and
whether the split step at R ranks does, R gloo ranks sharing card 0.

    python3 tests/torch_port_measure_slab_sums.py [--ranks 2,4]

1. torch.sum over the last two axes of an x-slab (planes [r*nx/R,
   (r+1)*nx/R) of a seeded field) against the same planes of the sum of
   the whole field, bit for bit, at the bench grid (32x64x32) and the
   channel's (140x65x60), f32 and f64, one and three components: on the
   card a reduction's order within each sum depends on how many sums it
   makes; and the same with the slab padded with zero planes to the
   whole grid's count (grid.SlabGrid.plane_sums);
2. tests/torch_port_slabs.slab_ops_job at both shapes (f32) over R gloo
   ranks on the card: the operations whose joined slabs part from the
   whole grid's call;
3. one eager ShardedStep step of the bench bed (131,072 particles,
   sort_on_rebuild) over R gloo ranks on the card against CoupledStep
   here: the fields that part.

Prints the card's name and power limit, then one JSON line per part.
Imports nothing of JAX.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

from sedifoam_tpu_torch import bench_case, bridge, graphs  # noqa: E402
from sedifoam_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from sedifoam_tpu_torch.parallel.step import run_steps  # noqa: E402
from sedifoam_tpu_torch.solver import CoupledStep  # noqa: E402
from torch_port_slabs import slab_ops_job  # noqa: E402

SHAPES = {"bench": (32, 64, 32), "channel": (140, 65, 60)}


def sums(ranks, dev):
    """Part 1: {shape/dtype/components: [R, slab parts, padded parts]}."""
    out = {}
    rng = np.random.RandomState(3)
    for label, shape in SHAPES.items():
        for dtype in (torch.float32, torch.float64):
            for lead in ((), (3,)):
                x = torch.as_tensor(rng.normal(size=lead + shape),
                                    dtype=dtype, device=dev)
                whole = torch.sum(x.contiguous(), dim=(-2, -1))
                nx = shape[0]
                for r in ranks:
                    n = nx // r
                    plain = padded = 0
                    for k in range(r):
                        s = x.narrow(-3, k * n, n)
                        ref = whole.narrow(-1, k * n, n)
                        got = torch.sum(s.contiguous(), dim=(-2, -1))
                        plain += not torch.equal(got, ref)
                        y = torch.nn.functional.pad(
                            s, (0, 0, 0, 0, 0, nx - n))
                        got = torch.sum(y.contiguous(),
                                        dim=(-2, -1)).narrow(-1, 0, n)
                        padded += not torch.equal(got, ref)
                    out[f"{label} {str(dtype)[6:]} {lead or ''} R={r}"] = {
                        "slabs_parting": plain,
                        "padded_slabs_parting": padded}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", default="2,4")
    args = ap.parse_args()
    ranks = [int(r) for r in args.ranks.split(",")]
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"part": "sums", "card": smi,
                      "result": sums(ranks, dev)}), flush=True)
    for r in ranks:
        for label, shape in SHAPES.items():
            res = run_ranks(slab_ops_job, r, args=(5, shape, torch.float32),
                            backend="gloo", device=dev, timeout=600)[0]
            parting = {kind: [op for op, ok in ops.items()
                              if op != "iterations" and not ok]
                       for kind, ops in res.items() if kind != "bytes"}
            print(json.dumps({"part": "slab_ops", "ranks": r,
                              "shape": shape, "card": smi,
                              "parting": parting}), flush=True)
    cfg = bench_case.build_config(**bench_case.FULL, sort_on_rebuild=True)
    fluid, parts = bench_case.build_state(cfg, bench_case.FULL["n_particles"],
                                          torch.float32, dev)
    step = CoupledStep(cfg, torch.float32, dev)
    state = step.initialize(fluid, parts)
    snp = bridge.sim_state_to_numpy(state)
    ref = bridge.sim_state_to_numpy(step(graphs.tree_map(torch.clone,
                                                         state)))
    from torch_port_measure_split_graph import parted
    for r in ranks:
        res = run_ranks(run_steps, r, args=(cfg, snp, 1), backend="gloo",
                        device=dev, timeout=600)
        print(json.dumps({"part": "bench step", "ranks": r, "card": smi,
                          "parted": parted(ref, res[0]["states"][1])}),
              flush=True)


if __name__ == "__main__":
    main()
