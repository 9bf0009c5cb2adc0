"""Batched multi-head attention in plain PyTorch.

Port of asva_tpu/ops/attention.py:23.  It runs outside any Pallas kernel
in the JAX package, so plain torch is its counterpart here.  Logits and the
PV product accumulate in fp32 (the JAX `preferred_element_type`), the
softmax runs in fp32, and a boolean mask (True = attend) sets -1e9.
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (..., Lq, H, D); k, v (..., Lk, H, D) with leading axes that
    broadcast against q's; mask broadcastable to (..., H, Lq, Lk).
    Returns (..., Lq, H, D) in q.dtype."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qh = q.transpose(-3, -2).float()              # (..., H, Lq, D)
    kh = k.transpose(-3, -2).float()
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    weights = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.matmul(weights.float(), v.transpose(-3, -2).float())
    return out.transpose(-3, -2).to(q.dtype)
