"""The UNet calls of one sampler loop, replayed as CUDA-graph segments.

A generation request calls the UNet once a sampler step, every call with
the same shapes and the same conditioning tensors.  At the recipes' shapes
the host's launches (thousands a call at full SD1.5 width) take longer
than the card's work at the low-resolution levels, so the host sets the
pace.  `segmented(unet, calls)` takes the host off that path for a loop of
`calls` UNet calls:

  * call 1 runs eagerly on a side stream: the capture's warm-up, so that
    per-stream workspaces and autotuned algorithms are made outside it;
  * call 2 is captured on the side stream into one private memory pool.
    Each call into a fused sub-layer (`ops/fused.py`'s `fused_ln_attn3`,
    `fused_ln_geglu`, `fused_ln_attn`) is a boundary: its output is
    allocated empty inside the graph before it (no kernel), that graph
    ends, the call is recorded (entry, arguments, output) and not run,
    and the next graph begins.  The full SD1.5 UNet makes 32 such calls,
    so a call is 33 graphs;
  * from call 2 on, the call's sample and timesteps are copied into the
    static inputs, graph 0 is replayed, the first recorded entry is called
    through the `fused` module attribute with its recorded arguments and
    `out=` its recorded output, graph 1 is replayed, and so on.  The output
    is a copy of the last graph's, so no later replay overwrites it.

The fused sub-layers stay eager calls: whatever stands in the module
attribute at the time (a wrapper that times or counts them, a test double)
sees every call with its real arguments, and the kernels keep their own
launches and `fused.LAUNCHES`.  An entry without an `out=` argument (a plain
stand-in) is called without it and its result copied into the output.

The loop is graphed only where every call can be: CUDA tensors, gradients
off, no frame context (`frames`), and at least 2 calls.  Any other call runs
eagerly, as before, and so does a call from another thread than the
loop's.  Within the loop the conditioning tensors, `fuse_blocks` and the
shapes may not change (a call that differs raises).

When the loop ends, its graphs, every recorded tensor and the cuBLAS
workspaces (the side stream's is baked into the graphs) are dropped, so
nothing of the capture stays allocated through the VAE decode.  The pool is
one a device, kept (`_pool`): its free blocks stay reserved for the next
loop's capture (none of them allocated) instead of being taken from the
device anew each loop.  Graphs still in flight when dropped are freed by
CUDA on completion.

Spans and counters (`observability`): the span "unet.capture" around the
capture; the counters "unet.graph.captures" (1 a graphed loop),
"unet.graph.eager_calls" (the graphed loop's first call, and every call on
the eager path), "unet.graph.replays" (graphs replayed: 33 a call at full
width) and "unet.graph.held_bytes" (the device memory the capture keeps
allocated: the static inputs, the recorded tensors and the output).  While
a call is replayed, no span of the UNet's blocks opens; the fused
sub-layers' spans ("fused.B*") do.
"""
from __future__ import annotations

import contextlib
import functools
import inspect
import threading

import torch

from ...observability import count, span
from ...ops import fused

# the fused sub-layers: the boundaries between graphs
ENTRIES = ("fused_ln_attn3", "fused_ln_geglu", "fused_ln_attn")

_SIDE = {}      # device index -> the side stream of warm-up and capture
_POOLS = {}     # device index -> (the capture pool's id, its kept graph)


@contextlib.contextmanager
def boundaries(between=None):
    """For the extent of the block, calls into the fused entries on this
    thread are recorded instead of run: each returns an empty tensor shaped
    like its output, and `between()` (when given) is called after that
    tensor is made.  Yields the list of (entry name, args, kwargs, output)
    in call order.  Other threads' calls run as they did."""
    calls = []
    saved = {name: getattr(fused, name) for name in ENTRIES}
    owner = threading.get_ident()

    def boundary(name):
        run = saved[name]

        def call(*args, **kwargs):
            if threading.get_ident() != owner:
                return run(*args, **kwargs)
            x = args[0]
            out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            calls.append((name, args, kwargs, out))
            if between is not None:
                between()
            return out
        return call

    for name in ENTRIES:
        setattr(fused, name, boundary(name))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(fused, name, fn)


@functools.lru_cache(maxsize=64)
def _takes_out(fn) -> bool:
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return False
    return any(p.name == "out" or p.kind is p.VAR_KEYWORD for p in params)


def _call_into(name, args, kwargs, out):
    """The recorded call through the `fused` module attribute, its result
    in `out`."""
    fn = getattr(fused, name)
    if _takes_out(fn):
        got = fn(*args, out=out, **kwargs)
    else:
        got = fn(*args, **kwargs)
    if got.data_ptr() != out.data_ptr():
        out.copy_(got)


def _side_stream(device: torch.device):
    if device.index not in _SIDE:
        _SIDE[device.index] = torch.cuda.Stream(device)
    return _SIDE[device.index]


def _pool(device: torch.device):
    """The id of `device`'s capture pool.  It is made once, with a graph of
    one kernel that is kept: the pool lives while any graph captured into
    it does, so the kept graph lets each loop's capture reuse the blocks
    that the last loop's graphs freed."""
    if device.index not in _POOLS:
        pool, keep = torch.cuda.graph_pool_handle(), torch.cuda.CUDAGraph()
        with torch.cuda.stream(_side_stream(device)):
            keep.capture_begin(pool=pool, capture_error_mode="thread_local")
            torch.zeros(1, device=device)
            keep.capture_end()
        _POOLS[device.index] = (pool, keep)
    return _POOLS[device.index][0]


def graphable(calls: int, sample: torch.Tensor, frames=None) -> bool:
    """Whether a loop of `calls` UNet calls on `sample` is replayed."""
    return (calls >= 2 and sample.device.type == "cuda" and frames is None
            and not torch.is_grad_enabled())


class LoopGraphs:
    """The graphs of one loop of `calls` UNet calls (module docstring);
    called by AudioUNet3D.forward with its body and its arguments."""

    def __init__(self, calls: int):
        self.calls = calls
        self.owner = threading.get_ident()   # the loop's thread
        self.made = 0                 # graphed calls so far
        self.graphs = self.recorded = self.out = None
        self.static = None            # (sample, timesteps)
        self.conditioning = None

    def __call__(self, forward, sample, timesteps, *conditioning):
        if (threading.get_ident() != self.owner
                or not graphable(self.calls, sample, conditioning[-1])):
            count("unet.graph.eager_calls")
            return forward(sample, timesteps, *conditioning)
        self.made += 1
        if self.made == 1:
            count("unet.graph.eager_calls")
            return self._warm_up(forward, sample, timesteps, *conditioning)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if self.made == 2:
            self._capture(forward, sample, timesteps, conditioning)
        else:
            self._check(sample, timesteps, conditioning)
        return self._replay(sample, timesteps)

    def _warm_up(self, forward, *args):
        device = args[0].device
        current, side = torch.cuda.current_stream(device), _side_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            out = forward(*args)
        current.wait_stream(side)
        out.record_stream(current)
        return out

    def _capture(self, forward, sample, timesteps, conditioning):
        device = sample.device
        before = torch.cuda.memory_allocated(device)
        self.static = (sample.clone(), timesteps.clone())
        self.conditioning = conditioning
        pool, graphs = _pool(device), []

        def begin():
            graphs.append(torch.cuda.CUDAGraph())
            graphs[-1].capture_begin(pool=pool,
                                     capture_error_mode="thread_local")

        def between():
            graphs[-1].capture_end()
            begin()

        with span("unet.capture"), torch.cuda.stream(_side_stream(device)):
            begin()
            try:
                with boundaries(between) as recorded:
                    out = forward(*self.static, *conditioning)
            except BaseException:
                if torch.cuda.is_current_stream_capturing():
                    with contextlib.suppress(RuntimeError):
                        graphs[-1].capture_end()
                raise
            graphs[-1].capture_end()
        self.graphs, self.recorded, self.out = graphs, recorded, out
        count("unet.graph.captures")
        count("unet.graph.held_bytes",
              torch.cuda.memory_allocated(device) - before)

    def _check(self, sample, timesteps, conditioning):
        s, t = self.static
        same = (sample.shape == s.shape and sample.dtype == s.dtype
                and timesteps.shape == t.shape
                and len(conditioning) == len(self.conditioning)
                and all(a is b or (isinstance(a, (bool, int, float, str))
                                   and a == b)
                        for a, b in zip(conditioning, self.conditioning)))
        if not same:
            raise RuntimeError(
                "a graphed loop's UNet calls share their shapes and their "
                "conditioning tensors; this call differs from the captured "
                "one")

    def _replay(self, sample, timesteps):
        s, t = self.static
        s.copy_(sample)
        t.copy_(timesteps)
        last = len(self.recorded)
        for i, graph in enumerate(self.graphs):
            graph.replay()
            if i < last:
                _call_into(*self.recorded[i])
        count("unet.graph.replays", len(self.graphs))
        return self.out.clone()

    def close(self):
        """Drop the graphs and every tensor they hold, and the cuBLAS
        workspaces, the side stream's among them (made by the warm-up,
        baked into the graphs), so that none stays allocated through the
        decode; the next cuBLAS call on a stream makes its own again."""
        self.graphs = self.recorded = self.out = None
        self.static = self.conditioning = None
        clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
        if self.made and clear is not None:
            clear()


@contextlib.contextmanager
def segmented(unet, calls: int):
    """Replay the UNet calls made inside the block as CUDA-graph segments
    (module docstring), for a loop of `calls` calls.  A module without the
    hook (not an AudioUNet3D) is called as it is."""
    if not hasattr(unet, "_graphs"):
        yield
        return
    previous, loop = unet._graphs, LoopGraphs(calls)
    unet._graphs = loop
    try:
        yield
    finally:
        unet._graphs = previous
        loop.close()
