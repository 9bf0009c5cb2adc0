"""FF spatio-temporal resnet blocks (port of asva_tpu/models/unet3d/resnet.py).

The GroupNorm here spans ALL frames (VideoGroupNorm): the reference applied
nn.GroupNorm to the 5-D (b, c, f, h, w) tensor.  `frames` (a
`parallel.mesh.FrameShard`) reaches the norms and the convs' temporal mix
of a frame-sharded video.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.linear import Linear
from ...ops.norms import VideoGroupNorm
from .primitives import FFInflatedConv, FFInflatedUpsample2xConv


class FFResnetBlock(nn.Module):
    """norm1 -> silu -> conv1 -> (+ per-frame temb) -> norm2 -> silu ->
    conv2 -> + shortcut.  temb is (b, f, temb_channels)."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = 1280, groups: int = 32,
                 eps: float = 1e-5):
        super().__init__()
        self.norm1 = VideoGroupNorm(groups, in_channels, eps)
        self.conv1 = FFInflatedConv(in_channels, out_channels)
        self.time_emb_proj = (Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = VideoGroupNorm(groups, out_channels, eps)
        self.conv2 = FFInflatedConv(out_channels, out_channels)
        self.conv_shortcut = (FFInflatedConv(in_channels, out_channels, 1, 1, 0)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: Optional[torch.Tensor] = None,
                frames=None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x, frames)), frames)
        if temb is not None and self.time_emb_proj is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None, :]
        h = self.conv2(F.silu(self.norm2(h, frames)), frames)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x, frames)
        return x + h


class FFDownsample(nn.Module):
    """Stride-2 FF conv (torch padding 1 on both sides)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = FFInflatedConv(channels, channels, 3, 2, 1)

    def forward(self, x: torch.Tensor, frames=None) -> torch.Tensor:
        return self.conv(x, frames)


class FFUpsample(nn.Module):
    """Nearest x2 spatial upsample + FF conv (frame axis untouched)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = FFInflatedUpsample2xConv(channels, channels)

    def forward(self, x: torch.Tensor, frames=None) -> torch.Tensor:
        return self.conv(x, frames)
