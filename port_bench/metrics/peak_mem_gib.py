"""peak_mem_gib: torch.cuda.max_memory_allocated over set-up and the
window, reset at the run's start and read before the reference runs."""


def read(rec):
    b = rec.get("peak_bytes")
    return None if b is None else b / 2 ** 30
