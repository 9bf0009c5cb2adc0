"""Gigabytes a second of the gradient mean across ranks: the bytes the
program's `comm.bytes` counter adds in an optimizer step of the fourth
segment (what `apply_step` hands to NCCL) over that step's least NCCL
kernel time over the ranks; the median over the steps
(benchmark/spans.py, benchmark/trace.py)."""
import statistics


def read(rec):
    s = rec.spans
    if not s:
        return None
    rates = [b / t * 1e-9 for b, t in zip(s["counts"].get("comm.bytes", []),
                                          s["nccl_unit_s"])
             if b > 0 and t > 0]
    return statistics.median(rates) if rates else None
