"""Mean milliseconds of one call of the UNet (CUDA events from forward
pre- and post-hooks on the program's AudioUNet3D)."""


def read(rec):
    calls = rec.events.get("unet_call", [])
    return sum(calls) / len(calls) if calls else None
