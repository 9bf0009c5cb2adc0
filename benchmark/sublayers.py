"""Spans around the program's fused sub-layers (`ops/fused.py`:
fused_ln_attn B1, fused_ln_attn3 B2, fused_ln_geglu B3) and the bound of
each call, from its shapes.

While a `Sublayers` is active, each call runs inside a profiler range
"bench.sublayer.<B>" and adds its forward bound; a call that builds a
graph (gradient enabled, outside the backward, an input that requires a
gradient) adds the bound of its backward, whose kernels run under the
autograd node of the call; a backward reads the call's inputs and the
output's gradient once and writes each due input gradient once.  A call
inside the backward is a remat recompute: its forward is counted, its
backward is not (it has none).
"""
from __future__ import annotations

import torch

from . import work

ENTRIES = {"fused_ln_attn": "B1", "fused_ln_attn3": "B2",
           "fused_ln_geglu": "B3"}


def _in_backward() -> bool:
    return torch._C._current_graph_task_id() != -1


def _needs_graph(*tensors) -> bool:
    return (torch.is_grad_enabled() and not _in_backward()
            and any(t.requires_grad for t in tensors
                    if isinstance(t, torch.Tensor)))


def _grad_bytes(*tensors) -> int:
    """The gradients a backward writes: one per input that needs one."""
    return work.nbytes(*[t for t in tensors if t.requires_grad])


def _b1(args, out):
    x, ls, lb, wq, wo, bo, k, v = args[:8]
    g, m, c = x.shape
    sk = k.shape[1]
    fwd = work.bound_s(work.attn_flops(g, m, sk, c),
                       work.nbytes(x, ls, lb, wq, wo, bo, k, v, out))
    bwd = 0.0
    if _needs_graph(*args[:8]):
        bwd = work.bound_s(
            work.attn_bwd_flops(g, m, sk, c, wq.requires_grad,
                                wo.requires_grad),
            work.nbytes(x, ls, lb, wq, wo, bo, k, v, out)
            + _grad_bytes(x, ls, lb, wq, wo, bo, k, v))
    return fwd, bwd


def _b2(args, out):
    x = args[0]
    b, f, n, c = x.shape
    k1, ka, kt = args[6], args[13], args[20]
    flops = (work.attn_flops(b, f * n, k1.shape[1], c)
             + work.attn_flops(b * f, n, ka.shape[2], c)
             + work.attn_flops(b, f * n, kt.shape[1], c))
    if _needs_graph(*args[:22]):
        raise NotImplementedError("B2 runs without a graph (generation)")
    return work.bound_s(flops, work.nbytes(*args[:22], out)), 0.0


def _b3(args, out):
    x, ls, lb, wi, bi, wo, bo = args[:7]
    m, c = x.shape
    fwd = work.bound_s(work.geglu_flops(m, c),
                       work.nbytes(x, ls, lb, wi, bi, wo, bo, out))
    bwd = 0.0
    if _needs_graph(*args[:7]):
        bwd = work.bound_s(
            work.geglu_bwd_flops(m, c, wi.requires_grad, wo.requires_grad),
            work.nbytes(x, ls, lb, wi, bi, wo, bo, out)
            + _grad_bytes(x, ls, lb, wi, bi, wo, bo))
    return fwd, bwd


BOUNDS = {"B1": _b1, "B2": _b2, "B3": _b3}


class Sublayers:
    """Patches the fused entry points for its lifetime (`with`); counts and
    bounds accumulate while `recording` is True."""

    def __init__(self, fused_module):
        self.fused = fused_module
        self.recording = False
        self.calls = {k: 0 for k in BOUNDS}
        self.fwd_s = 0.0
        self.bwd_s = 0.0
        self.graphs = 0       # calls whose backward is due
        self._saved = {}

    def _wrap(self, fn, tag):
        def call(*args, **kw):
            if not self.recording:
                return fn(*args, **kw)
            with torch.profiler.record_function(f"bench.sublayer.{tag}"):
                out = fn(*args, **kw)
            fwd, bwd = BOUNDS[tag](args, out)
            self.calls[tag] += 1
            self.fwd_s += fwd
            self.bwd_s += bwd
            self.graphs += bwd > 0
            return out
        return call

    def __enter__(self):
        for name, tag in ENTRIES.items():
            self._saved[name] = getattr(self.fused, name)
            setattr(self.fused, name, self._wrap(self._saved[name], tag))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self.fused, name, fn)
        self._saved.clear()
