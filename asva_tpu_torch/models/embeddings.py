"""Timestep / positional embeddings (port of asva_tpu/models/embeddings.py).

Numerics match diffusers' `get_timestep_embedding` and `TimestepEmbedding`.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.linear import Linear


@functools.lru_cache(maxsize=None)
def _frequencies(half_dim: int, downscale_freq_shift: float,
                 max_period: float, device: torch.device) -> torch.Tensor:
    """(half_dim,) float32 frequencies on `device`, folded in float64 on the
    host as the JAX version does; made once, so that the embedding copies
    nothing to the device (a copy from pageable memory waits for the
    stream, and cannot be captured in a CUDA graph)."""
    freqs = np.exp(-np.log(max_period) * np.arange(half_dim, dtype=np.float64)
                   / (half_dim - downscale_freq_shift)).astype(np.float32)
    return torch.from_numpy(freqs).to(device)


def sinusoidal_timestep_embedding(timesteps: torch.Tensor, dim: int,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0,
                                  max_period: float = 10000.0) -> torch.Tensor:
    """(N,) timesteps -> (N, dim) float32 sinusoidal embedding."""
    freqs = _frequencies(dim // 2, float(downscale_freq_shift),
                         float(max_period), timesteps.device)
    emb = freqs[None, :] * timesteps.float()[:, None]
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """2-layer SiLU MLP: in_dim -> time_embed_dim -> time_embed_dim."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = Linear(in_dim, time_embed_dim)
        self.linear_2 = Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))
