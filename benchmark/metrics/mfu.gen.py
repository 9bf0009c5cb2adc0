"""Percent of the cards' dense bf16 peak (989 TFLOP/s each) that the
requests' model FLOPs (benchmark/work.py, counted on the plain reference
at the cell's shapes) make over the untraced-stretch window's seconds."""
from benchmark.work import model_share


def read(rec):
    flops, n = rec.values.get("request_flops"), rec.values.get("requests")
    if not flops or not n:
        return None
    return model_share(flops * n, rec.values["window_s"], rec.values["cards"])
