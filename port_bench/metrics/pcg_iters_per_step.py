"""pcg_iters_per_step: PCG iterations of the traced span, from the
program's device counter (linsolve.STATS "pcg"), over the span's
steps."""


def read(rec):
    if "pcg_iters" not in rec or not rec["span_steps"]:
        return None
    return rec["pcg_iters"] / rec["span_steps"]
