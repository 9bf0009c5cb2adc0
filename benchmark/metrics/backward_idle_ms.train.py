"""Median over the fourth segment's optimizer steps of the device's idle
milliseconds under the program's `train.backward` spans, the fused
sub-layers' backward on autograd's thread included (benchmark/spans.py)."""
from benchmark.spans import idle_ms


def read(rec):
    return idle_ms(rec.spans, "train.backward")
