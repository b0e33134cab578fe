"""device_idle_pct: the share of an untraced step in which the device
runs nothing: 100 x (1 - device busy seconds per step / device seconds
per step), both on the device's clock. Busy is the union of the
device's operation intervals in the traced span, over its steps; the
step's time is the device's, from CUDA events on the stream around the
same number of untraced visits just before the profiler starts
(trace.Tracer). Under the profiler a replayed graph runs far slower, so
the span's own length is not a step's."""


def read(rec):
    if not rec.get("ops") or not rec.get("untraced_device_s"):
        return None
    busy = rec["busy_s"] / rec["span_steps"]
    return 100.0 * (1.0 - busy / (rec["untraced_device_s"]
                                  / rec["span_steps"]))
