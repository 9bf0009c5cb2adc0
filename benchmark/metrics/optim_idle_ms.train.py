"""Median over the fourth segment's optimizer steps of the device's idle
milliseconds under the program's `train.apply_step` span: the gradient
mean across ranks, the clip and AdamW (benchmark/spans.py)."""
from benchmark.spans import idle_ms


def read(rec):
    return idle_ms(rec.spans, "train.apply_step")
