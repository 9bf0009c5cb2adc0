"""Median over the fourth segment's UNet calls of the device's idle
milliseconds while the program's `unet.call` span was open, its children
included: the time a call's card waits for its host (benchmark/spans.py)."""
from benchmark.spans import idle_ms


def read(rec):
    return idle_ms(rec.spans, "unet.call")
