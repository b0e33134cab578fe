"""kernels_per_step: device kernels (not copies or fills) that started in
the traced span, over the span's steps."""


def read(rec):
    ops = rec.get("ops")
    if not ops or not rec["span_steps"]:
        return None
    n = sum(not n.startswith(("Memcpy", "Memset")) for n, _, _ in ops)
    return n / rec["span_steps"]
