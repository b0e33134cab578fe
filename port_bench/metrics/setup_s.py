"""setup_s: seconds from the process's start to the window's first
timed step (imports, kernel libraries, inputs, load, initialize, the
capture, the warm-up visits)."""


def read(rec):
    return rec["setup_s"]
