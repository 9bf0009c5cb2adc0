"""First-frame ("FF") inflation primitives on channels-last video.

Port of asva_tpu/models/unet3d/primitives.py.  Public layout is the JAX
package's (b, f, h, w, c); convolutions run on a channels_last view of it
(no copy).  TPU-only rewrites are not ported: the split-concat convs, the
upsample fold (here nearest-up then conv), the temporal pair loop and the
VMEM gates.

The attention sub-layers (attn1, audio-x, text-x) called with their
LayerNorm `ln` run as fused residual sub-layers through ops/fused.py: K/V
projections, the frame-0 slice and the audio token gather stay plain torch
outside the kernels, as the JAX `prepare=True` bundles do
(primitives.py:308-323, :393-417).  Called with `ln=None` they return the
bare attention `_attend(x)` (no LayerNorm, no residual), which dispatches by
function as the JAX modules do (:347-365, :468-504): shared frame-0 K/V and
an unmasked 3-D context go to ops/flat_attention.py (kernel B6), a gathered,
masked or per-frame context to ops/attention.dot_product_attention.

The remat policies' tags (ops/remat.py) sit where asva_tpu puts them:
`conv_out` on FFInflatedConv's 2D convolution (primitives.py:122, 208) and
`dot` on every product without batch dimensions (the 1x1 convs and the
temporal mix's three taps); the fused sub-layers tag their own outputs
(ops/fused.py).

Frame-axis operations take `frames`, a `parallel.mesh.FrameShard`, where
the video's frames are sharded over the seq ranks of a generation mesh
(None: every frame is here).  Three operations reach across frames, and
each exchanges what it needs over the seq group, where asva_tpu's
partitioner inserts the collectives: the temporal mix's head tap reads
global frame 0 and its previous-frame tap the previous rank's last frame;
the first-frame attention's K/V come from global frame 0; temporal
attention attends over the K/V of every frame.  The exchanges have no
backward: frame sharding is for generation.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...ops import flat_attention, fused, remat
from ...ops.attention import dot_product_attention
from ...ops.linear import Linear
from ...parallel import reduce


def conv2d_channels_last(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor], stride: int,
                         padding: int) -> torch.Tensor:
    """(n, h, w, c) -> (n, h', w', o), torch layout weight (o, c, kh, kw)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


class Conv2d(nn.Module):
    """Conv2d on channels-last (n, h, w, c) input; torch weight layout.
    Its output carries the remat names `save_as` (ops/remat.py)."""

    save_as: tuple = ()

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1,
                 bias: bool = True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_channels)) if bias else None
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(
            in_channels * kernel_size * kernel_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return remat.checkpoint_name(self.save_as, conv2d_channels_last, x,
                                     self.weight.to(x.dtype), bias,
                                     self.stride, self.padding)


class Conv1x1(nn.Module):
    """1x1 conv held as (o, i, 1, 1) — the reference checkpoints' layout —
    and applied as a Linear over the channel axis."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(in_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return remat.checkpoint_name(remat.DOT, F.linear, x,
                                     self.weight.flatten(1).to(x.dtype),
                                     self.bias.to(x.dtype))


class InflatedConv(Conv2d):
    """Per-frame 2D convolution on (b, f, h, w, c)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f = x.shape[:2]
        y = super().forward(x.reshape((b * f,) + x.shape[2:]))
        return y.reshape((b, f) + y.shape[1:])


def _frame0(x: torch.Tensor, frames) -> torch.Tensor:
    """Global frame 0 of (b, f, ...) x, (b, 1, ...)."""
    if frames is None:
        return x[:, :1]
    return reduce.broadcast_frame0(x, frames.group)


def temporal_mix(y: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor, frames=None) -> torch.Tensor:
    """y + Linear([y_0 | y_{f-1} | y_f]) over the frame axis, with the
    previous frame of frame 0 being frame 0 (JAX primitives.py:128-141).
    weight (C, 3C) is the torch Linear(3C, C) of `conv_temp`; its input
    columns split as [head | prev | curr].  With `frames`, y_0 is seq
    index 0's first frame and a shard's first previous frame the previous
    rank's last one, except on seq index 0."""
    c = y.shape[-1]

    def tap(v, w):
        return remat.checkpoint_name(remat.DOT, F.linear, v, w)
    head = tap(_frame0(y, frames), weight[:, :c])
    zp = tap(y, weight[:, c:2 * c])
    first = zp[:, :1]
    if frames is not None:
        halo = reduce.prev_frame_halo(zp, frames.group)
        if frames.index > 0:
            first = halo
    prev = torch.cat([first, zp[:, :-1]], dim=1)
    mix = head + prev + tap(y, weight[:, 2 * c:])
    return y + mix + bias


class FFInflatedConv(InflatedConv):
    """Per-frame 2D conv + residual zero-init 3-tap temporal linear mix
    (`conv_temp`, a Linear(3C, C)).  The conv's output is `conv_out`."""

    save_as = (remat.CONV_OUT,)

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding)
        self.conv_temp = Linear(3 * out_channels, out_channels)
        nn.init.zeros_(self.conv_temp.weight)
        nn.init.zeros_(self.conv_temp.bias)

    def forward(self, x: torch.Tensor, frames=None) -> torch.Tensor:
        y = super().forward(x)
        return temporal_mix(y, self.conv_temp.weight.to(y.dtype),
                            self.conv_temp.bias.to(y.dtype), frames)


class FFInflatedUpsample2xConv(FFInflatedConv):
    """FFInflatedConv(3, 1, 1) of the nearest x2 upsample of x."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor, frames=None) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return super().forward(x, frames)


class MultiHeadProjections(nn.Module):
    """q/k/v/out projections in diffusers' layout (bias only on out)."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 kv_dim: Optional[int] = None):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = Linear(query_dim, inner, bias=False)
        self.to_k = Linear(kv_dim or query_dim, inner, bias=False)
        self.to_v = Linear(kv_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, inner)])

    def _bundle(self, ln, k, v):
        """(ls, lb, wq, wo, bo, k, v) for ops/fused.py."""
        out = self.to_out[0]
        if self.to_q.weight.shape[0] != self.to_q.weight.shape[1]:
            raise ValueError("the fused sub-layers need inner dim == dim")
        return (ln.weight, ln.bias, self.to_q.weight, out.weight, out.bias,
                k, v)

    def split(self, t: torch.Tensor) -> torch.Tensor:
        """(..., H*D) -> (..., H, D)."""
        return t.reshape(t.shape[:-1] + (self.num_heads, self.head_dim))

    def _flat_heads(self, t: torch.Tensor) -> torch.Tensor:
        """(b, s, H*D) -> (b*H, s, D), the layout of ops/flat_attention."""
        b, s, _ = t.shape
        return self.split(t).transpose(1, 2).reshape(
            b * self.num_heads, s, self.head_dim)

    def _attend_flat(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: Optional[int]) -> torch.Tensor:
        """q (b, f, n, H*D) over k/v (b, m, H*D) shared by every frame, as
        (b*H, f*n, D) against (b*H, m, D) -> (b, f, n, H*D)."""
        b, f, n, c = q.shape
        qf = self._flat_heads(q.reshape(b, f * n, c))
        kf, vf = self._flat_heads(k), self._flat_heads(v)
        if kv_len is None:
            of = flat_attention.vmem_attention(qf, kf, vf)
        else:
            of = flat_attention.vmem_cross_attention(qf, kf, vf, kv_len)
        return of.reshape(b, self.num_heads, f * n, self.head_dim).transpose(
            1, 2).reshape(b, f, n, c)


class FFSpatialAttention(MultiHeadProjections):
    """Spatial self-attention on (b, f, n, c) tokens with K/V from frame 0
    only, shared by every frame's queries.  With `ln` it is the residual
    sub-layer x + Attn(LN(x)) with K/V projected from the normed frame 0;
    with ln=None it returns the bare attention of x.  With `frames`, frame
    0's x comes from seq index 0 before the projections."""

    def prepare(self, x: torch.Tensor, ln, frames=None) -> tuple:
        h0 = ln(_frame0(x, frames)[:, 0])                # (b, n, c)
        return self._bundle(ln, self.to_k(h0), self.to_v(h0))

    def forward(self, x: torch.Tensor, ln=None, frames=None) -> torch.Tensor:
        if ln is None:
            return self._attend(x, frames)
        b, f, n, c = x.shape
        out = fused.fused_ln_attn(x.reshape(b, f * n, c),
                                  *self.prepare(x, ln, frames), ln.eps,
                                  self.num_heads)
        return out.reshape(b, f, n, c)

    def _attend(self, x: torch.Tensor, frames=None) -> torch.Tensor:
        first = _frame0(x, frames)[:, 0]                 # (b, n, c)
        out = self._attend_flat(self.to_q(x), self.to_k(first),
                                self.to_v(first), None)
        return self.to_out[0](out)


def mask_to_token_indices(mask) -> np.ndarray:
    """(f, m) token indices equal to boolean segment masks (b, f, n_ctx) or
    (f, n_ctx): the static gather that replaces the masked attention.
    Every batch element must share the masks and every frame must select
    the same number of tokens (true of the AVSyncD segment masks)."""
    mask = np.asarray(mask.cpu() if torch.is_tensor(mask) else mask, bool)
    if mask.ndim == 3:
        if not (mask == mask[:1]).all():
            raise ValueError("audio masks differ across the batch")
        mask = mask[0]
    counts = mask.sum(axis=1)
    if not (counts == counts[0]).all():
        raise ValueError(f"frames select different token counts: {counts}")
    return np.stack([np.nonzero(row)[0] for row in mask]).astype(np.int64)


@functools.lru_cache(maxsize=64)
def _indices_on(data: bytes, shape: tuple, device: torch.device):
    return torch.from_numpy(
        np.frombuffer(data, np.int64).reshape(shape).copy()).to(device)


def token_indices_on(indices, device) -> torch.Tensor:
    """The (f, m) token indices as a long tensor on `device`: a long tensor
    there is returned as it is; a numpy array or list is copied once per
    distinct value and device (cached), so that a forward that is handed
    host indices copies nothing to the device after its first (a copy from
    pageable memory waits for the stream, and cannot be captured in a
    CUDA graph)."""
    device = torch.device(device)
    if torch.is_tensor(indices):
        return indices.to(device=device, dtype=torch.long)
    idx = np.ascontiguousarray(indices, dtype=np.int64)
    return _indices_on(idx.tobytes(), idx.shape, device)


class CrossAttention(MultiHeadProjections):
    """Cross attention of (b, f, n, c) tokens over a context that is shared
    by the frames, (b, m, d), or per frame, (b, f, m, d).  With
    `context_indices` (f, m_tok), K/V of a shared context are projected once
    over all tokens and gathered per frame: frame i attends exactly context
    tokens context_indices[i] — equal to the boolean segment-mask attention
    of the reference.  `mask` (b, f, m), True = attend, masks context tokens
    per frame.

    With `ln` it is the fused residual sub-layer x + CrossAttn(LN(x),
    context), for a shared context that is unmasked or gathered; with
    ln=None it returns the bare attention of x, in every form."""

    def prepare(self, context: torch.Tensor, ln,
                context_indices=None) -> tuple:
        k, v = self.to_k(context), self.to_v(context)    # (b, m, c)
        if context_indices is not None:
            idx = token_indices_on(context_indices, context.device)
            k, v = k[:, idx], v[:, idx]                  # (b, f, m_tok, c)
        return self._bundle(ln, k, v)

    def forward(self, x: torch.Tensor, context: torch.Tensor, ln=None,
                mask: Optional[torch.Tensor] = None,
                context_indices=None) -> torch.Tensor:
        if ln is None:
            return self._attend(x, context, mask, context_indices)
        b, f, n, c = x.shape
        if context.dim() != 3 or (mask is not None
                                  and context_indices is None):
            raise ValueError(
                "the fused residual form takes a (b, m, d) context that is "
                "unmasked or gathered by context_indices; call with ln=None "
                "for a masked or per-frame context")
        ls, lb, wq, wo, bo, k, v = self.prepare(context, ln, context_indices)
        if context_indices is not None:
            out = fused.fused_ln_attn(
                x.reshape(b * f, n, c), ls, lb, wq, wo, bo,
                k.reshape((b * f,) + k.shape[2:]),
                v.reshape((b * f,) + v.shape[2:]), ln.eps, self.num_heads)
        else:
            out = fused.fused_ln_attn(x.reshape(b, f * n, c), ls, lb, wq, wo,
                                      bo, k, v, ln.eps, self.num_heads)
        return out.reshape(b, f, n, c)

    def _attend(self, x: torch.Tensor, context: torch.Tensor, mask,
                context_indices) -> torch.Tensor:
        q, k, v = self.to_q(x), self.to_k(context), self.to_v(context)
        shared = k.dim() == q.dim() - 1                  # (b, m, c)
        if context_indices is not None and shared:
            idx = token_indices_on(context_indices, context.device)
            k, v = k[:, idx], v[:, idx]                  # (b, f, m_tok, c)
            mask, shared = None, False
        elif mask is None and shared and q.dim() == 4:
            # unmasked shared context (the text path): the true token count,
            # never padded
            out = self._attend_flat(q, k, v, k.shape[1])
            return self.to_out[0](out)
        if shared:                          # broadcast context over frames
            k, v = k[:, None], v[:, None]
        if mask is not None:
            mask = mask[:, :, None, None, :]       # (b, f, 1(H), 1(n), m)
        out = dot_product_attention(self.split(q), self.split(k),
                                    self.split(v), mask=mask)
        return self.to_out[0](out.flatten(-2))


class TemporalAttention(nn.Module):
    """Self-attention over the frame axis for each spatial location of a
    (b, f, n, c) tensor.  `to_out` is zero-init in the reference.  The
    scale is computed with fp32 sqrt/divide (JAX primitives.py:617).  With
    `frames`, each rank keeps its queries and attends over the K/V of
    every frame, gathered over the seq group."""

    def __init__(self, dim: int, num_heads: int, head_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = Linear(dim, inner, bias=False)
        self.to_k = Linear(dim, inner, bias=False)
        self.to_v = Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([Linear(inner, inner)])
        nn.init.zeros_(self.to_out[0].weight)
        nn.init.zeros_(self.to_out[0].bias)

    def forward(self, x: torch.Tensor, frames=None) -> torch.Tensor:
        b, f, n, _ = x.shape
        h, d = self.num_heads, self.head_dim

        def heads(t):                                    # (b, n, h, f, d)
            return t.reshape(b, t.shape[1], n, h, d).permute(0, 2, 3, 1, 4)

        # q, k, v made in this order: autograd sums x's gradient in it
        q, k, v = self.to_q(x), self.to_k(x), self.to_v(x)
        if frames is not None:
            k = reduce.all_gather_frames(k, frames.group)
            v = reduce.all_gather_frames(v, frames.group)
        q, k, v = heads(q), heads(k), heads(v)
        scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
        logits = (q.float() @ k.float().transpose(-1, -2)) * scale
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (w.float() @ v.float()).to(q.dtype)        # (b, n, h, f, d)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, f, n, h * d)
        return self.to_out[0](out.to(x.dtype))
