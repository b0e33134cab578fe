"""Which kernel records does torch.profiler drop, and when? (needs the
CUDA card; not a pytest file)

  python tests/torch_port_profiler_probe.py [seconds to idle, default 45]

Profiles 100 launches of the contact-chain kernel at the bench shape in a
fresh process, again after idling, and again after as many seconds of
tiny kernels. Each profile is exported as a chrome trace and read back:
every cudaLaunchKernel record is matched to its kernel record by
correlation id, and the positions of the launches without one are
printed, beside chip_smoke.device_us's reading of the same launches
(which puts PROFILE_LEAD launches before those it counts).

On an NVIDIA H100 80GB HBM3 (700.00 W; CUPTI 26): no record lost at 14
s of process age, those of launches 0-3 at 59 s (idle until then), of
0-6 at 104 s, three times over; never a later one, never a launch
record; device_us read 20.469, 20.477 and 20.377-20.462 us.
"""

import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as smoke  # noqa: E402


def lost_records(launch, reps=100):
    """Positions (in launch order) of the launches whose kernel record
    the profile lacks."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    launch(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for r in range(reps):
            launch(r)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    launches = sorted(e["args"]["correlation"] for e in events
                      if e.get("name") == "cudaLaunchKernel")
    kernels = {e["args"]["correlation"] for e in events
               if e.get("cat") == "kernel"}
    return len(launches), [i for i, c in enumerate(launches)
                           if c not in kernels]


def main(idle=45.0):
    import torch
    t0 = time.time()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    smoke.phase_build()
    cfg, p = smoke.kernel_case(dev)
    launch = smoke.chain_launcher(p, cfg.dem)

    def report(label):
        n, lost = lost_records(launch)
        us, how, _ = smoke.device_us(launch)
        smoke.say(f"[{time.time() - t0:6.1f} s] {label}: {n} launch "
                  f"records, kernel records lost at {lost}; device_us "
                  f"{us:.3f} us ({how})")

    report("fresh")
    time.sleep(idle)
    report(f"after {idle:.0f} s idle")
    x = torch.zeros(1024, device=dev)
    t, n = time.time(), 0
    while time.time() - t < idle:
        for _ in range(1000):
            x.add_(1.0)
        n += 1000
    torch.cuda.synchronize()
    for _ in range(3):
        report(f"after {n} tiny kernels")


if __name__ == "__main__":
    main(*(float(a) for a in sys.argv[1:2]))
