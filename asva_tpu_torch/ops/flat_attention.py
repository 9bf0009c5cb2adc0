"""Flat one-head-per-group attention: kernel B6.

Port of asva_tpu/ops/pallas_attn.py (`_attention_flat` :45 with the body
`_attn_kernel` :25; public `vmem_attention` :79, `vmem_cross_attention` :99).
q (BH, Sq, D) attends k/v (BH, Sk, D): softmax(q k^T / sqrt(D)) v with fp32
logits, key columns >= `kv_len` masked to -1e9, P rounded to v.dtype, fp32
accumulation and one cast.

The kernel is `csrc/attn.cu`'s K-attn entered through `asva_flat_attn`: the
flat layout is K-attn's with G = BH groups of one head.  Where the Pallas
body keeps one head's whole K/V on chip, K-attn streams Sk in 64-row tiles
with an online softmax, so the kernel rounds P to v.dtype *before* it
normalises; the Pallas body, and `attention_flat_plain` here, normalise and
then round (`pallas_attn.py:38`).  In fp32 the two orders agree to rounding;
in bf16 they differ at the bf16 rounding level (tolerance stated where the
two are compared).  K/V are never padded: the kernel takes the true Sk and
`kv_len`, and a caller's zero-padded K/V is accepted as the JAX API accepts
it.  There is no shape gate: any Sq and Sk, head dims that are multiples of
8 up to 160.

Dispatch is by device, as in ops/fused.py: a CPU tensor gets the plain
version, a CUDA tensor the kernel or an error.  The backward differentiates
the plain version, masked where the forward was masked (pallas `_bwd` :88,
`_cbwd` :110).  Launches are counted in `fused.LAUNCHES["B6"]`.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import fused


def attention_flat_plain(q, k, v, kv_len: Optional[int] = None):
    """q (BH, Sq, D), k/v (BH, Sk, D) -> (BH, Sq, D) in q.dtype: the body of
    pallas `_attn_kernel` (normalise, then round P to v.dtype)."""
    sk = k.shape[1]
    s = (q.float() @ k.float().transpose(-1, -2)) * (
        1.0 / math.sqrt(q.shape[-1]))
    if kv_len is not None and kv_len < sk:
        cols = torch.arange(sk, device=q.device)
        s = torch.where(cols < kv_len, s, torch.full_like(s, -1e9))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = (p / p.sum(dim=-1, keepdim=True)).to(v.dtype)
    return (p.float() @ v.float()).to(q.dtype)


def _attention_flat(q, k, v, kv_len: Optional[int]):
    if q.device.type == "cpu":
        return attention_flat_plain(q, k, v, kv_len)
    if q.dim() != 3:
        raise ValueError(f"q must be (BH, Sq, D), got {tuple(q.shape)}")
    lib = fused._prepare(q, k, v)
    if kv_len is not None:
        kv_len = min(kv_len, k.shape[1])      # kv_len >= Sk masks nothing
    bh, sq, sk, d, kv_len = fused._attn_geometry(q, k, v, 1, kv_len)
    o = torch.empty_like(q)
    rc = lib.attn.asva_flat_attn(
        fused._DTYPES[q.dtype], bh, sq, sk, kv_len, d, 1.0 / math.sqrt(d),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        fused._stream(q))
    fused._raise_on(lib, rc, "flat attention")
    fused.LAUNCHES["B6"] += 1
    return o


class _FlatAttention(torch.autograd.Function):
    """Kernel forward, backward through the plain version with the same
    mask."""

    @staticmethod
    def forward(ctx, q, k, v, kv_len):
        ctx.save_for_backward(q, k, v)
        ctx.kv_len = kv_len
        return _attention_flat(q, k, v, kv_len)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        kv_len = ctx.kv_len
        return fused._plain_vjp(
            lambda q, k, v: attention_flat_plain(q, k, v, kv_len),
            ctx.saved_tensors, ctx.needs_input_grad[:3], g) + (None,)


def vmem_attention(q, k, v) -> torch.Tensor:
    """Attention of q (BH, Sq, D) over the whole of k/v (BH, Sk, D)."""
    return _FlatAttention.apply(q, k, v, None)


def vmem_cross_attention(q, k, v, kv_len: int) -> torch.Tensor:
    """Like vmem_attention, with key rows >= kv_len masked (a short context
    such as 77 text tokens, zero-padded by the caller or not)."""
    return _FlatAttention.apply(q, k, v, int(kv_len))
