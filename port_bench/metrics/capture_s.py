"""capture_s: seconds of the window's one capture of the coupled step as
a CUDA graph (solver.GraphedStep.capture_seconds)."""


def read(rec):
    return rec.get("capture_s")
