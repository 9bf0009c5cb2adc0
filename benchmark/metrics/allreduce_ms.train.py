"""Device milliseconds of the NCCL kernels (the gradient mean across
ranks) in one optimizer step: the median over the profiled span's steps
of each step's least NCCL time over the ranks.  The rank that reaches the
exchange last waits for no other, so its kernels time the exchange alone
and not the ranks' skew (benchmark/trace.py)."""
import statistics


def read(rec):
    t = rec.trace
    if not t or not any(t["nccl_unit_s"]):
        return None
    return 1e3 * statistics.median(t["nccl_unit_s"])
