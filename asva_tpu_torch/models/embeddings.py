"""Timestep / positional embeddings (port of asva_tpu/models/embeddings.py).

Numerics match diffusers' `get_timestep_embedding` and `TimestepEmbedding`.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


def sinusoidal_timestep_embedding(timesteps: torch.Tensor, dim: int,
                                  flip_sin_to_cos: bool = True,
                                  downscale_freq_shift: float = 0.0,
                                  max_period: float = 10000.0) -> torch.Tensor:
    """(N,) timesteps -> (N, dim) float32 sinusoidal embedding."""
    half_dim = dim // 2
    # frequencies folded in float64 on the host, as the JAX version does
    freqs = np.exp(-np.log(max_period) * np.arange(half_dim, dtype=np.float64)
                   / (half_dim - downscale_freq_shift)).astype(np.float32)
    emb = (torch.from_numpy(freqs).to(timesteps.device)[None, :]
           * timesteps.float()[:, None])
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """2-layer SiLU MLP: in_dim -> time_embed_dim -> time_embed_dim."""

    def __init__(self, in_dim: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))
