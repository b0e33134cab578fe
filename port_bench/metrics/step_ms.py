"""step_ms: the window's wall time on the host clock, ending in a device
synchronize, over the coupled steps it completed."""


def read(rec):
    return rec["wall_s"] * 1e3 / rec["steps"] if rec["steps"] else None
