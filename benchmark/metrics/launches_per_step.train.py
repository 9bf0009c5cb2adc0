"""Device kernels in the profiled span per optimizer step in it."""


def read(rec):
    t = rec.trace
    if not t or not t["launches"]:
        return None
    return t["launches"] / t["units"]
