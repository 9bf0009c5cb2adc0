"""Normalization layers for channels-last video tensors.

Port of asva_tpu/ops/norms.py.  Two group-norm statistics conventions
exist in the AVSyncD UNet:

  * VideoGroupNorm pools (f, h, w, channel-group) — all frames together —
    and serves the resnet blocks and `conv_norm_out`;
  * SpatialGroupNorm pools (h, w, channel-group) per frame and serves the
    transformer input norm and the VAE.

Group statistics are E[x^2] - E[x]^2 in fp32 with the variance clamped at
0 (asva_tpu/ops/norms.py:78-81), not `F.group_norm`'s formula; the
normalized value is cast back to the input dtype before the affine.

With the video's frames sharded over ranks (a `parallel.mesh.FrameShard`),
VideoGroupNorm sums its groups' values and squares over the seq group
before the divide by the global count, where asva_tpu's partitioner
inserts that sum; SpatialGroupNorm is per frame and stays local.
"""
from __future__ import annotations

import torch
from torch import nn

from ..parallel.reduce import all_reduce_sum


def _group_normalize(x: torch.Tensor, num_groups: int, eps: float,
                     lead: int, frames=None) -> torch.Tensor:
    """Normalize x by group stats pooled over every axis after the first
    `lead` axes (channel axis last, split into `num_groups` groups), and
    over the ranks of `frames.group` where frames (a FrameShard) is
    given."""
    c = x.shape[-1]
    if c % num_groups:
        raise ValueError(f"{c} channels not divisible by {num_groups} groups")
    k = 1
    for s in x.shape[:lead]:
        k *= s
    xr = x.reshape(k, -1, num_groups, c // num_groups).float()
    n = xr.shape[1] * xr.shape[3]
    if frames is None:
        mean = xr.sum(dim=(1, 3), keepdim=True) / n
        msq = xr.square().sum(dim=(1, 3), keepdim=True) / n
    else:
        sums = all_reduce_sum(torch.stack(
            [xr.sum(dim=(1, 3), keepdim=True),
             xr.square().sum(dim=(1, 3), keepdim=True)]), frames.group)
        n *= frames.count
        mean, msq = sums[0] / n, sums[1] / n
    var = torch.clamp(msq - mean.square(), min=0.0)
    y = (xr - mean) * torch.rsqrt(var + eps)
    return y.reshape(x.shape).to(x.dtype)


class _GroupNormBase(nn.Module):
    def __init__(self, num_groups: int, num_channels: int, eps: float):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def _affine(self, y: torch.Tensor) -> torch.Tensor:
        return y * self.weight.to(y.dtype) + self.bias.to(y.dtype)


class VideoGroupNorm(_GroupNormBase):
    """GroupNorm over (frame, height, width, channel-group) of a
    (b, f, h, w, c) tensor — torch GroupNorm of the (b, c, f, h, w) view;
    with `frames` (a FrameShard), over the frames of every seq rank."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__(num_groups, num_channels, eps)

    def forward(self, x: torch.Tensor, frames=None) -> torch.Tensor:
        return self._affine(_group_normalize(x, self.num_groups, self.eps, 1,
                                             frames))


class SpatialGroupNorm(_GroupNormBase):
    """Per-frame GroupNorm: stats over (h, w, channel-group) only, for
    (b, f, h, w, c) or (n, h, w, c) input."""

    def __init__(self, num_groups: int, num_channels: int, eps: float = 1e-6):
        super().__init__(num_groups, num_channels, eps)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._affine(
            _group_normalize(x, self.num_groups, self.eps, x.dim() - 3))


def layer_norm_rows(x32: torch.Tensor, weight32: torch.Tensor,
                    bias32: torch.Tensor, eps: float) -> torch.Tensor:
    """LayerNorm over the last axis of an fp32 tensor (two-pass variance),
    the math of asva_tpu's LayerNormParams and pallas_fused._ln_rows."""
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * weight32 + bias32


class LayerNormParams(nn.Module):
    """LayerNorm with fp32 statistics whose `weight`/`bias` the fused
    kernels read directly; calling it runs the plain math."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm_rows(x.float(), self.weight.float(),
                               self.bias.float(), self.eps).to(x.dtype)


class AdaptiveOrLayerNorm(LayerNormParams):
    """Plain LayerNorm (fp32 stats).  The reference's AdaLayerNorm variants
    are never enabled in AVSyncD configs; the name records the role."""
