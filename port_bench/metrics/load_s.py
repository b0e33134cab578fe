"""load_s: host seconds to make the configuration's inputs from the seed
and load them into a state on the device (ending in a synchronize)."""


def read(rec):
    return rec["load_s"]
