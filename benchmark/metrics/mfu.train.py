"""Percent of the cards' dense bf16 peak (989 TFLOP/s each) that the
steps' model FLOPs (benchmark/work.py: forward, backward to the
trainable parameters and the frozen encoders, no recompute, all ranks)
make over the window's seconds."""
from benchmark.work import model_share


def read(rec):
    flops, n = rec.values.get("step_flops"), rec.values.get("steps")
    if not flops or not n:
        return None
    return model_share(flops * n, rec.values["window_s"], rec.values["cards"])
