"""Percent of the fused sub-layers' bound (benchmark/sublayers.py: each
call's bytes and operations from its shapes, forward and, where a
gradient is due, backward) in the device time of the kernels launched
under their ranges and their autograd backward nodes, in the profiled
stretch.  Nothing is read unless every call and every backward was
found in the trace."""


def read(rec):
    t = rec.trace
    if not t:
        return None
    time_s = t["sublayer_fwd_s"] + t["sublayer_bwd_s"]
    if (time_s <= 0 or t["sublayer_fwd_ranges"] != t["sublayer_calls"]
            or t["sublayer_bwd_ranges"] != t["sublayer_graphs"]):
        return None
    return 100.0 * t["sublayer_bound_s"] / time_s
