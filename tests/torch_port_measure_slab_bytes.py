"""The split step's collective bytes by kind at the JAX package's own
multi-device dry run's case, beside that run's record.

    JAX_PLATFORMS=cpu python3 tests/torch_port_measure_slab_bytes.py

builds `__graft_entry__.py multichip 8`'s case (`_tiny_case(nx=32,
ny=16, nz=8, n_particles=512, sub_steps=2, backend="binned",
dtype=float64)`), steps it once on 8 gloo ranks of the port on the CPU
(parallel/step.run_steps: the fluid split into slabs of 4 planes) and
prints one JSON line: the port's bytes per rank by kind in that step
(`Comm.bytes`: what the collectives returned on the rank, counted at
every call) and `MULTICHIP_r05.json`'s `collective_bytes_per_step_est`
(the result shapes of the collectives in the compiled program, each op
once: a collective inside a while loop's body counts once there).
"""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]

from sedifoam_tpu_torch import bridge  # noqa: E402
from sedifoam_tpu_torch.parallel.launch import run_ranks  # noqa: E402
from sedifoam_tpu_torch.parallel.step import run_steps  # noqa: E402
from torch_port_cases import port_config  # noqa: E402

RANKS = 8


def main():
    jax.config.update("jax_enable_x64", True)   # as the dry run does
    ge = importlib.import_module("__graft_entry__")
    cfg_j, st_j = ge._tiny_case(nx=4 * RANKS, ny=16, nz=8,
                                n_particles=64 * RANKS, sub_steps=2,
                                backend="binned", dtype=jnp.float64)
    res = run_ranks(run_steps, RANKS,
                    args=(port_config(cfg_j), bridge.sim_state_to_numpy(st_j),
                          1, ()), device="cpu", timeout=600)
    with open(os.path.join(REPO, "MULTICHIP_r05.json")) as f:
        tail = json.load(f)["tail"]
    line = next(x for x in tail.splitlines()
                if x.startswith("multichip stats: "))
    jax_est = json.loads(line[len("multichip stats: "):])[
        "collective_bytes_per_step_est"]
    print(json.dumps({
        "case": "__graft_entry__ multichip 8: 32x16x8, 512 particles, "
                "binned, f64, 2 substeps",
        "port_fluid": res[0]["fluid"],
        "port_bytes_per_rank": [r["comm"][0] for r in res],
        "port_fields_per_rank": res[0]["fields"],
        "jax_dry_run_est": jax_est}))


if __name__ == "__main__":
    main()
