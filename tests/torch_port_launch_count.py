"""pytest plugin (`-p torch_port_launch_count`, with tests/ on the
Python path): at the end of the session, writes the contact-chain
kernel's launches made in the pytest process (dem.fused.launches():
eager, and inside replayed graphs as counted on the device) as one JSON
object {"launches": N} to the file named by the environment variable
CHAIN_LAUNCHES_OUT. chip_smoke.py's physics phase runs the port's
physics tests on the card with it."""

import json
import os


def pytest_sessionfinish(session, exitstatus):
    path = os.environ.get("CHAIN_LAUNCHES_OUT")
    if not path:
        return
    from sedifoam_tpu_torch.dem import fused
    with open(path, "w") as f:
        json.dump({"launches": fused.launches()}, f)
