"""First-frame ("FF") inflation primitives on channels-last video.

Port of asva_tpu/models/unet3d/primitives.py.  Public layout is the JAX
package's (b, f, h, w, c); convolutions run on a channels_last view of it
(no copy).  TPU-only rewrites are not ported: the split-concat convs, the
upsample fold (here nearest-up then conv), the temporal pair loop and the
VMEM gates.

The attention sub-layers (attn1, audio-x, text-x) always run as fused
residual sub-layers through ops/fused.py: K/V projections, the frame-0
slice and the audio token gather stay plain torch outside the kernels, as
the JAX `prepare=True` bundles do (primitives.py:308-323, :393-417).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ...ops import fused


def conv2d_channels_last(x: torch.Tensor, weight: torch.Tensor,
                         bias: Optional[torch.Tensor], stride: int,
                         padding: int) -> torch.Tensor:
    """(n, h, w, c) -> (n, h', w', o), torch layout weight (o, c, kh, kw)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), weight, bias, stride, padding)
    return y.permute(0, 2, 3, 1).contiguous()


class Conv2d(nn.Module):
    """Conv2d on channels-last (n, h, w, c) input; torch weight layout."""

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
        return conv2d_channels_last(x, self.weight, self.bias, self.stride,
                                    self.padding)


class Conv1x1(nn.Module):
    """1x1 conv held as (o, i, 1, 1) — the reference checkpoints' layout —
    and applied as a Linear over the channel axis."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels, 1, 1))
        self.bias = nn.Parameter(torch.zeros(out_channels))
        nn.init.normal_(self.weight, std=1.0 / math.sqrt(in_channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight.flatten(1), self.bias)


class InflatedConv(Conv2d):
    """Per-frame 2D convolution on (b, f, h, w, c)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f = x.shape[:2]
        y = super().forward(x.reshape((b * f,) + x.shape[2:]))
        return y.reshape((b, f) + y.shape[1:])


def temporal_mix(y: torch.Tensor, weight: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """y + Linear([y_0 | y_{f-1} | y_f]) over the frame axis, with the
    previous frame of frame 0 being frame 0 (JAX primitives.py:128-141).
    weight (C, 3C) is the torch Linear(3C, C) of `conv_temp`; its input
    columns split as [head | prev | curr]."""
    c = y.shape[-1]
    head = F.linear(y[:, :1], weight[:, :c])
    zp = F.linear(y, weight[:, c:2 * c])
    prev = torch.cat([zp[:, :1], zp[:, :-1]], dim=1)
    mix = head + prev + F.linear(y, weight[:, 2 * c:])
    return y + mix + bias


class FFInflatedConv(InflatedConv):
    """Per-frame 2D conv + residual zero-init 3-tap temporal linear mix
    (`conv_temp`, a Linear(3C, C))."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, padding: int = 1):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding)
        self.conv_temp = nn.Linear(3 * out_channels, out_channels)
        nn.init.zeros_(self.conv_temp.weight)
        nn.init.zeros_(self.conv_temp.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return temporal_mix(super().forward(x), self.conv_temp.weight,
                            self.conv_temp.bias)


class FFInflatedUpsample2xConv(FFInflatedConv):
    """FFInflatedConv(3, 1, 1) of the nearest x2 upsample of x."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__(in_channels, out_channels, 3, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return super().forward(x)


class MultiHeadProjections(nn.Module):
    """q/k/v/out projections in diffusers' layout (bias only on out)."""

    def __init__(self, query_dim: int, num_heads: int, head_dim: int,
                 kv_dim: Optional[int] = None):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(kv_dim or query_dim, inner, bias=False)
        self.to_v = nn.Linear(kv_dim or query_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, inner)])

    def _bundle(self, ln, k, v):
        """(ls, lb, wq, wo, bo, k, v) for ops/fused.py."""
        out = self.to_out[0]
        if self.to_q.weight.shape[0] != self.to_q.weight.shape[1]:
            raise ValueError("the fused sub-layers need inner dim == dim")
        return (ln.weight, ln.bias, self.to_q.weight, out.weight, out.bias,
                k, v)


class FFSpatialAttention(MultiHeadProjections):
    """Residual sub-layer x + Attn(LN(x)) on (b, f, n, c) tokens, where
    every frame's queries attend K/V projected from the normed frame 0."""

    def prepare(self, x: torch.Tensor, ln) -> tuple:
        h0 = ln(x[:, 0])                                 # (b, n, c)
        return self._bundle(ln, self.to_k(h0), self.to_v(h0))

    def forward(self, x: torch.Tensor, ln) -> torch.Tensor:
        b, f, n, c = x.shape
        out = fused.fused_ln_attn(x.reshape(b, f * n, c),
                                  *self.prepare(x, ln), ln.eps,
                                  self.num_heads)
        return out.reshape(b, f, n, c)


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


class CrossAttention(MultiHeadProjections):
    """Residual sub-layer x + CrossAttn(LN(x), context) for (b, f, n, c)
    tokens and a (b, m, d) context.  With `context_indices` (f, m_tok), K/V
    are projected once over all tokens and gathered per frame: frame i
    attends exactly context tokens context_indices[i] — equal to the
    boolean segment-mask attention of the reference."""

    def prepare(self, context: torch.Tensor, ln,
                context_indices=None) -> tuple:
        k, v = self.to_k(context), self.to_v(context)    # (b, m, c)
        if context_indices is not None:
            idx = torch.as_tensor(np.asarray(context_indices),
                                  dtype=torch.long, device=context.device)
            k, v = k[:, idx], v[:, idx]                  # (b, f, m_tok, c)
        return self._bundle(ln, k, v)

    def forward(self, x: torch.Tensor, context: torch.Tensor, ln,
                context_indices=None) -> torch.Tensor:
        b, f, n, c = x.shape
        if context.dim() != 3:
            raise ValueError("context must be (b, m, d)")
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


class TemporalAttention(nn.Module):
    """Self-attention over the frame axis for each spatial location of a
    (b, f, n, c) tensor.  `to_out` is zero-init in the reference.  The
    scale is computed with fp32 sqrt/divide (JAX primitives.py:617)."""

    def __init__(self, dim: int, num_heads: int, head_dim: int):
        super().__init__()
        inner = num_heads * head_dim
        self.num_heads, self.head_dim = num_heads, head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(dim, inner, bias=False)
        self.to_v = nn.Linear(dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, inner)])
        nn.init.zeros_(self.to_out[0].weight)
        nn.init.zeros_(self.to_out[0].bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, n, _ = x.shape
        h, d = self.num_heads, self.head_dim

        def heads(t):                                    # (b, n, h, f, d)
            return t.reshape(b, f, n, h, d).permute(0, 2, 3, 1, 4)

        q, k, v = heads(self.to_q(x)), heads(self.to_k(x)), heads(self.to_v(x))
        scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
        logits = (q.float() @ k.float().transpose(-1, -2)) * scale
        w = torch.softmax(logits, dim=-1).to(v.dtype)
        out = (w.float() @ v.float()).to(q.dtype)        # (b, n, h, f, d)
        out = out.permute(0, 3, 1, 2, 4).reshape(b, f, n, h * d)
        return self.to_out[0](out.to(x.dtype))
