"""Percent of the profiled span in which no operation ran on the device:
1 - (union of the device operations' intervals) / the span, both on the
trace's own clock, between the mark kernels at the span's ends, with the
profiler's start and flush outside it (benchmark/trace.py)."""


def read(rec):
    t = rec.trace
    if not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
