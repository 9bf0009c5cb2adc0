"""Median over the fourth segment's optimizer steps of the device's idle
milliseconds under the program's `train.grad_step` spans outside their
`train.backward`: the draws, the frozen encoders, the UNet's forward and
the loss (benchmark/spans.py)."""
from benchmark.spans import idle_ms


def read(rec):
    return idle_ms(rec.spans, "train.grad_step", less="train.backward")
