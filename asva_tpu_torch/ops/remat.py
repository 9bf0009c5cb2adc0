"""Named saves inside rematerialised units: asva_tpu's `checkpoint_name`
and `save_only_these_names` (jax.ad_checkpoint) for torch.utils.checkpoint.

A rematerialised UNet unit runs under the non-reentrant
`torch.utils.checkpoint`: its forward keeps none of its activations and the
backward runs the unit again to get them back.  `policy(names)` is the
`context_fn` that makes such a unit keep some values all the same: code
tagged with one of `names` (`checkpoint_name`) runs in the first forward and
its output is stored; in the recompute the stored output is returned and the
code does not run again.  A name outside the unit's policy, or no policy,
leaves the code as it is.

The names the UNet tags, as asva_tpu does:
  conv_out    the 2D convolution's output in FFInflatedConv
  sublayer_x  each residual sub-layer's input in a transformer block (the
              outputs of proj_in, of each fused attention sub-layer and of
              the temporal attention's residual)
  attn_res    the flash forward's o and lse inside the fused attention
              sub-layer (B4), which its backward (B5) reads
  block_out   the transformer block's output (the fused FF, B3)
  dot         a product without batch dimensions: F.linear (the 1x1 convs
              proj_in / proj_out among them) and K-gemm's products inside
              B1 (q, the output projection) and B3 (its output)

Tagged code is of two kinds, told apart by the grad mode it runs in:
  - code that records no graph (a `torch.autograd.Function`'s forward,
    where the fused sub-layers launch their kernels): its value is stored
    and returned as is.  The Function saves the same tensors for its
    backward in both runs, so the unit's saved tensors pair up.
  - code that records a graph (F.linear, a convolution, an add): in the
    recompute it runs again under a dispatch mode that hands each of its
    operations the output that the first forward stored, in order, in place
    of computing it; views run.  Autograd records the same nodes as in a
    full recompute, so the gradients are the same bits.  Such code may
    launch no hand-written kernel (a dispatch mode cannot see one) and may
    hold no in-place operation (refused).

Tags nest.  A replayed value skips the tags inside its code; inside a graph
region that is stored or replayed, inner tags are plain code.  A tag whose
stored value is missing, or does not match, in the recompute raises: nothing
is recomputed quietly.

torch's own selective checkpoint (`create_selective_checkpoint_contexts`)
is the same dispatch mode applied to every operation of a unit and chosen
by operation, not by name: it cannot see the kernels, which are ctypes
launches inside Functions, and it would keep every matmul of a unit, the
plain CPU versions inside the Functions among them.
"""
from __future__ import annotations

import threading
from typing import Callable, Iterable, Sequence, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_map

CONV_OUT, SUBLAYER_X, ATTN_RES, BLOCK_OUT, DOT = (
    "conv_out", "sublayer_x", "attn_res", "block_out", "dot")
NAMES = frozenset((CONV_OUT, SUBLAYER_X, ATTN_RES, BLOCK_OUT, DOT))

_local = threading.local()


class _Frame:
    """One rematerialised unit's stored values, in the order of the first
    forward.  entries[i] = (names, graph, value, end): `value` a Function's
    output or, for graph code, the list of its operations' outputs; `end`
    the index after the entries of the tags nested in it."""

    def __init__(self, names: frozenset):
        self.names = names
        self.entries: list = []
        self.replaying = False
        self.cursor = 0
        self.graph_depth = 0


class _Phase:
    """Makes `frame` the current one, in its first forward or a recompute
    (re-entered for each recompute)."""

    def __init__(self, frame: _Frame, replaying: bool):
        self.frame, self.replaying = frame, replaying

    def __enter__(self):
        self.frame.replaying, self.frame.cursor = self.replaying, 0
        self.frame.graph_depth = 0
        _stack().append(self.frame)

    def __exit__(self, *exc):
        _stack().pop()
        return False


def _stack() -> list:
    if not hasattr(_local, "frames"):
        _local.frames = []
    return _local.frames


def policy(names: Iterable[str]) -> Callable:
    """The `context_fn` of a `torch.utils.checkpoint(..., use_reentrant=
    False)` unit that keeps the values tagged with `names`."""
    names = frozenset(names)
    if names - NAMES:
        raise ValueError(f"unknown saved names {sorted(names - NAMES)}; "
                         f"known: {sorted(NAMES)}")

    def context_fn():
        frame = _Frame(names)
        return _Phase(frame, False), _Phase(frame, True)
    return context_fn


def _detach(value):
    return tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                    else t, value)


def _refuse_mutation(func):
    if func._schema.is_mutable:
        raise RuntimeError(f"remat: {func} mutates a tensor inside tagged "
                           "code; tag code without in-place operations")


class _Record(TorchDispatchMode):
    """Runs every operation and keeps each non-view output (detached)."""

    def __init__(self):
        super().__init__()
        self.outputs = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        _refuse_mutation(func)
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.outputs.append((func, _detach(out)))
        return out


class _Replay(TorchDispatchMode):
    """Hands each non-view operation the output `_Record` kept for it."""

    def __init__(self, outputs, names, fn):
        super().__init__()
        self.outputs, self.names, self.fn, self.i = outputs, names, fn, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        _refuse_mutation(func)
        if func.is_view:
            return func(*args, **(kwargs or {}))
        if self.i >= len(self.outputs) or self.outputs[self.i][0] is not func:
            ran = (self.outputs[self.i][0] if self.i < len(self.outputs)
                   else "nothing more")
            raise RuntimeError(f"remat: the recompute of "
                               f"{_where(self.names, self.fn)} runs {func} "
                               f"where the first forward ran {ran}")
        out = self.outputs[self.i][1]
        self.i += 1
        return _detach(out)


def _where(names, fn) -> str:
    return f"{'/'.join(sorted(names))} ({getattr(fn, '__qualname__', fn)})"


def checkpoint_name(names: Union[str, Sequence[str]], fn: Callable, *args):
    """fn(*args), whose output is tagged with `names` (one name or several):
    inside a rematerialised unit whose policy keeps one of them, stored in
    the first forward and returned in the recompute without running fn.
    Unlike jax.ad_checkpoint.checkpoint_name it takes the code that makes
    the value, so that the recompute can skip it."""
    stack = getattr(_local, "frames", None)
    if not stack:
        return fn(*args)
    frame = stack[-1]
    names = frozenset((names,) if isinstance(names, str) else names)
    if frame.graph_depth or not (frame.names & names):
        return fn(*args)
    graph = torch.is_grad_enabled()
    if not frame.replaying:
        index = len(frame.entries)
        frame.entries.append(None)
        if graph:
            frame.graph_depth += 1
            try:
                with _Record() as rec:
                    value = fn(*args)
            finally:
                frame.graph_depth -= 1
            stored = rec.outputs
        else:
            value = fn(*args)
            stored = _detach(value)
        frame.entries[index] = (names, graph, stored, len(frame.entries))
        return value
    if frame.cursor >= len(frame.entries):
        raise RuntimeError(f"remat: no stored value for {_where(names, fn)} "
                           "in the recompute")
    want, was_graph, stored, end = frame.entries[frame.cursor]
    if want != names or was_graph != graph:
        raise RuntimeError(f"remat: the recompute reached {_where(names, fn)}"
                           f" where the first forward stored "
                           f"{'/'.join(sorted(want))}")
    frame.cursor = end
    if not graph:
        return _detach(stored)
    frame.graph_depth += 1
    try:
        with _Replay(stored, names, fn) as rep:
            value = fn(*args)
    finally:
        frame.graph_depth -= 1
    if rep.i != len(stored):
        raise RuntimeError(f"remat: the recompute of {_where(names, fn)} ran "
                           f"{rep.i} of the {len(stored)} stored operations")
    return value
