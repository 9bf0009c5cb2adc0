"""Median over the fourth segment's UNet calls of the device's idle
milliseconds while the program's `sampler.step` span was open (the
sampler's update between two UNet calls; benchmark/spans.py)."""
from benchmark.spans import idle_ms


def read(rec):
    return idle_ms(rec.spans, "sampler.step")
