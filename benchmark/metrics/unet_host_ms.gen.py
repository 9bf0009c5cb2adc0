"""Median host milliseconds of one UNet call in the profiled stretch's
fourth segment: each `unet.call` span of the program (the denoise loop of
pipelines/animation.py) that starts in the segment's span, on the
trace's clock (benchmark/spans.py).  Under unet_call_ms.gen, the card's
time a call, the host keeps ahead of the card."""
import statistics


def read(rec):
    calls = rec.spans["host_s"].get("unet.call") if rec.spans else None
    return 1e3 * statistics.median(calls) if calls else None
