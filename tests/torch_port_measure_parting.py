"""How far the port and the JAX package part in f64 on xiaocase1
stand-ins (tests/torch_port_refcases.py) whose beds make contacts, and
how the gap grows.

    JAX_PLATFORMS=cpu python3 tests/torch_port_measure_parting.py [BED ...]

For each bed: one layer of 40 spheres resting on the floor (floor
contacts only), two layers of 100 and three of 200 (the layers collide),
and 40 spheres pressed 0.1% of d into each other and the floor. Each is
run two ways, 200 steps in f64 on the CPU:

- `scripts/validate_xiaocase1.py --f64` as a subprocess against the
  port's `validate.xiaocase1.run`, as tests/test_torch_refcases.py runs
  them: the probe dp series' largest gap over its scale;
- both packages' `Simulation` stepped in-process one step a host visit:
  the particles' largest velocity gap (m/s) after steps 1, 25, 50, 100,
  150 and 200, and its largest growth in one step once it is past
  1e-12 m/s (a gap grown from round-off by the collisions rises by
  modest factors; a step that lifts it from round-off to the percent
  would point at a difference of the port);
- the port against itself with every particle's height nudged by one
  unit in the last place, up on even rows and down on odd ones: the
  same velocity gaps, which say how fast round-off alone grows on that
  bed.

Prints one JSON line per bed.
"""

import json
import os
import subprocess
import sys
import tempfile

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path[:0] = [REPO, HERE]

import torch_port_refcases as rc  # noqa: E402
from sedifoam_tpu.io.case import load_case as jload  # noqa: E402
from sedifoam_tpu.runtime.runner import Simulation as JSimulation  # noqa: E402
from sedifoam_tpu.solver import initialize as jinitialize  # noqa: E402
from sedifoam_tpu_torch.io.case import load_case as tload  # noqa: E402
from sedifoam_tpu_torch.runtime.runner import Simulation  # noqa: E402
from sedifoam_tpu_torch.solver import initialize  # noqa: E402
from sedifoam_tpu_torch.validate import xiaocase1  # noqa: E402

T_END = 0.0195          # 200 steps, as the test
STEPS = 200
REPORT_AT = (1, 25, 50, 100, 150, 200)
BEDS = {"one_layer": dict(n=40), "two_layers": dict(n=100),
        "three_layers": dict(n=200), "pressed": dict(n=40, pitch=0.999)}


def dp_gap(case, tmp):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "scripts", "validate_xiaocase1.py"), "--f64",
         "--case", case, "--t-end", str(T_END),
         "--out", os.path.join(tmp, "ref.npz")],
        cwd=REPO, env=env, capture_output=True, text=True, check=True)
    json.loads(out.stdout.strip().splitlines()[-1])
    xiaocase1.run(case, T_END, torch.float64, out=os.path.join(tmp, "dp.npz"),
                  device="cpu", timing_reps=1)
    a = np.load(os.path.join(tmp, "ref.npz"))["dp"]
    b = np.load(os.path.join(tmp, "torch_dp.npz"))["dp"]
    return float(np.abs(a - b).max() / np.abs(a).max())


def _port(case, nudge=False):
    cfg, fluid, particles, _ = tload(case, backend="binned",
                                     dtype=torch.float64, device="cpu")
    if nudge:
        pos = particles.pos.clone()
        way = torch.where(torch.arange(len(pos)) % 2 == 0, 1.0, -1.0)
        pos[:, 1] = torch.nextafter(pos[:, 1], pos[:, 1] + way.double())
        particles = particles._replace(pos=pos)
    return Simulation(cfg, initialize(fluid, particles, cfg),
                      steps_per_host_visit=1, device="cpu")


def velocity_gaps(case, against_port=False):
    """The gaps between the port and the JAX package (or the port with
    its x nudged)."""
    ts = _port(case)
    if against_port:
        other = _port(case, nudge=True)
        vel = lambda: other.state.particles.vel.numpy()  # noqa: E731
    else:
        cfg, fluid, particles, _ = jload(case, backend="binned",
                                         dtype=jnp.float64)
        other = JSimulation(cfg, jinitialize(fluid, particles, cfg),
                            steps_per_host_visit=1)
        vel = lambda: np.asarray(other.state.particles.vel)  # noqa: E731
    dt = ts.cfg.fluid.dt
    gaps, growth, prev = {}, 1.0, 0.0
    for k in range(1, STEPS + 1):
        other.run((k - 0.5) * dt)
        ts.run((k - 0.5) * dt)
        gap = float(np.abs(vel() - ts.state.particles.vel.numpy()).max())
        if gap > 1e-12 and prev > 0.0:
            growth = max(growth, gap / prev)
        prev = gap
        if k in REPORT_AT:
            gaps[str(k)] = gap
    return gaps, growth


def main():
    torch.set_num_threads(2)
    for name in sys.argv[1:] or BEDS:
        kw = BEDS[name]
        with tempfile.TemporaryDirectory(prefix="parting_") as tmp:
            case = rc.write_xiaocase1(os.path.join(tmp, "xiaocase1"), **kw)
            gaps, growth = velocity_gaps(case)
            self_gaps, self_growth = velocity_gaps(case, against_port=True)
            print(json.dumps({"bed": name, **kw,
                              "dp_gap_of_scale": dp_gap(case, tmp),
                              "vel_gap_after_step": gaps,
                              "max_step_growth_past_1e-12": growth,
                              "nudged_port_vel_gap_after_step": self_gaps,
                              "nudged_max_step_growth_past_1e-12":
                                  self_growth}), flush=True)


if __name__ == "__main__":
    main()
