"""host_syncs_per_step: host syncs in the traced span, as torch's sync
debug mode reports them, over the span's steps."""


def read(rec):
    if "syncs" not in rec or not rec["span_steps"]:
        return None
    return rec["syncs"] / rec["span_steps"]
