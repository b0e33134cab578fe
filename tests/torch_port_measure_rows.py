"""On the card: a whole-table launch of the contact chain (rows=None) and
the eager coupled step of this tree against another tree's, bit for bit.

    git archive <commit> sedifoam_tpu_torch | tar -x -C build/parent
    python3 tests/torch_port_measure_rows.py build/parent

Each tree runs in a process of its own, on the bench case: the kernel
through setup_forces and 20 substeps of a jittered bed with random
velocities (f32), 5 more substeps in f64, and 3 eager CoupledSteps from
the initialized bench state (f32). The states are compared field by
field; the script exits nonzero if any differs. Made to show that the
kernel's row range (rows=(row0, n_rows)) left the whole launch as it
was.
"""

import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dump(root, out):
    """Run the tree at `root` and save its states to `out`."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    from sedifoam_tpu_torch import bench_case, bridge
    from sedifoam_tpu_torch.dem import integrate
    from sedifoam_tpu_torch.solver import CoupledStep
    dev = torch.device("cuda", 0)
    cfg = bench_case.build_config(**bench_case.FULL)
    fluid, p = bench_case.build_state(cfg, bench_case.FULL["n_particles"],
                                      dtype=torch.float32, device=dev)
    rng = np.random.RandomState(7)
    n = p.n_capacity

    def rand(scale):
        return torch.as_tensor(scale * rng.randn(n, 3), dtype=torch.float32,
                               device=dev)
    q = p._replace(pos=p.pos - 1.02 * 5e-4, vel=rand(0.05),
                   omega=rand(20.0))
    q = q._replace(pos_at_build=q.pos)
    q = integrate.run_dem(integrate.setup_forces(q, cfg.dem), cfg.dem, 20)
    q64 = q._replace(**{k: v.double() for k, v in q._asdict().items()
                        if isinstance(v, torch.Tensor)
                        and v.is_floating_point()})
    q64 = integrate.run_dem(q64, cfg.dem, 5)
    step = CoupledStep(cfg, dtype=torch.float32, device=dev)
    st = step.initialize(fluid, p)
    for _ in range(3):
        st = step(st)
    torch.save({"dem f32": bridge.tree_to_numpy(q),
                "dem f64": bridge.tree_to_numpy(q64),
                "coupled steps": bridge.sim_state_to_numpy(st)}, out)


def differ(a, b, path=""):
    import numpy as np
    if isinstance(a, dict):
        return [p for k in a for p in differ(a[k], b[k], f"{path}.{k}")]
    if a is None or np.array_equal(a, b, equal_nan=True):
        return []
    return [path]


def main():
    if sys.argv[1] == "--dump":
        dump(sys.argv[2], sys.argv[3])
        return 0
    import torch
    states = {}
    with tempfile.TemporaryDirectory() as tmp:
        for label, root in (("other", os.path.abspath(sys.argv[1])),
                            ("this", REPO)):
            out = os.path.join(tmp, f"{label}.pt")
            subprocess.run([sys.executable, __file__, "--dump", root, out],
                           check=True)
            states[label] = torch.load(out, weights_only=False)
    bad = differ(states["other"], states["this"])
    print(f"{torch.cuda.get_device_name(0)}: this tree against "
          f"{sys.argv[1]}: " + (f"{len(bad)} fields differ: {bad}" if bad
                                else "every field equal bit for bit"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
