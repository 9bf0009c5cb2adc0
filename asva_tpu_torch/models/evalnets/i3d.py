"""Inception-I3D (Kinetics-400): the FVD feature extractor.

Port of asva_tpu/models/evalnets/i3d.py, in the key space of the public
pytorch-i3d state dicts (`i3d_key_map`'s first candidates: Unit3D children
`conv3d` + `bn`, branches b0 / b1a / b1b / b2a / b2b / b3b).  Unit3D =
conv3d with TF-"same" padding + BN + relu; input (b, f, 224, 224, 3) in
[-1, 1], channels-last; output the 400-d logits.  BN eps defaults to 1e-5;
pass `bn_eps` for a blob whose BN uses 1e-3.  Inference only.

TF-"same" padding is asymmetric at stride 2 (the extra row goes last), so it
is computed from the input extent and applied with `F.pad`; the max pools
pad with -inf, as flax `nn.max_pool` does (every pooled tensor follows a
relu, so zero padding, as the reference pads, gives the same maxima).

Head: `AvgPool3d([2, 7, 7], stride 1)`, a window sliding over the temporal
axis, then the 1x1x1 logits conv and a mean over what is left of (t, h, w).
Window sizes are clamped to the input extent so that tiny inputs still run.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
from torch.nn import functional as F


def _same_pad(kernel: Sequence[int], strides: Sequence[int],
              in_shape: Sequence[int]) -> Tuple[int, ...]:
    """TF-SAME padding of (t, h, w) as F.pad's argument (last axis first)."""
    pads = []
    for k, s, n in zip(kernel, strides, in_shape):
        out = -(-n // s)
        total = max((out - 1) * s + k - n, 0)
        pads.append((total // 2, total - total // 2))
    return tuple(p for pair in reversed(pads) for p in pair)


def _same_max_pool(x: torch.Tensor, kernel, strides) -> torch.Tensor:
    x = F.pad(x, _same_pad(kernel, strides, x.shape[2:]),
              value=float("-inf"))
    return F.max_pool3d(x, kernel, strides)


class Unit3D(nn.Module):
    def __init__(self, cin: int, cout: int, kernel=(1, 1, 1),
                 strides=(1, 1, 1), use_bn: bool = True,
                 activation: bool = True, use_bias: bool = False,
                 bn_eps: float = 1e-5):
        super().__init__()
        self.kernel, self.strides = tuple(kernel), tuple(strides)
        self.activation = activation
        self.conv3d = nn.Conv3d(cin, cout, self.kernel, self.strides,
                                bias=use_bias)
        self.bn = nn.BatchNorm3d(cout, eps=bn_eps) if use_bn else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, _same_pad(self.kernel, self.strides, x.shape[2:]))
        x = self.conv3d(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.activation else x


class InceptionModule(nn.Module):
    def __init__(self, cin: int, channels: Sequence[int],
                 bn_eps: float = 1e-5):
        super().__init__()
        c, u = channels, dict(bn_eps=bn_eps)  # b0, b1a, b1b, b2a, b2b, b3
        self.b0 = Unit3D(cin, c[0], **u)
        self.b1a = Unit3D(cin, c[1], **u)
        self.b1b = Unit3D(c[1], c[2], (3, 3, 3), **u)
        self.b2a = Unit3D(cin, c[3], **u)
        self.b2b = Unit3D(c[3], c[4], (3, 3, 3), **u)
        self.b3b = Unit3D(cin, c[5], **u)
        self.out_channels = c[0] + c[2] + c[4] + c[5]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b3 = self.b3b(_same_max_pool(x, (3, 3, 3), (1, 1, 1)))
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)),
                          self.b2b(self.b2a(x)), b3], dim=1)


_MIXED = (("Mixed_3b", (64, 96, 128, 16, 32, 32)),
          ("Mixed_3c", (128, 128, 192, 32, 96, 64)),
          ("Mixed_4b", (192, 96, 208, 16, 48, 64)),
          ("Mixed_4c", (160, 112, 224, 24, 64, 64)),
          ("Mixed_4d", (128, 128, 256, 24, 64, 64)),
          ("Mixed_4e", (112, 144, 288, 32, 64, 64)),
          ("Mixed_4f", (256, 160, 320, 32, 128, 128)),
          ("Mixed_5b", (256, 160, 320, 32, 128, 128)),
          ("Mixed_5c", (384, 192, 384, 48, 128, 128)))
# the same-padded max pool that precedes a mixed block
_POOL_BEFORE = {"Mixed_3b": ((1, 3, 3), (1, 2, 2)),
                "Mixed_4b": ((3, 3, 3), (2, 2, 2)),
                "Mixed_5b": ((2, 2, 2), (2, 2, 2))}


class InceptionI3D(nn.Module):
    """video (b, f, h, w, 3) in [-1, 1] -> (b, num_classes) logits."""

    def __init__(self, num_classes: int = 400, bn_eps: float = 1e-5):
        super().__init__()
        u = dict(bn_eps=bn_eps)
        self.Conv3d_1a_7x7 = Unit3D(3, 64, (7, 7, 7), (2, 2, 2), **u)
        self.Conv3d_2b_1x1 = Unit3D(64, 64, **u)
        self.Conv3d_2c_3x3 = Unit3D(64, 192, (3, 3, 3), **u)
        cin = 192
        for name, channels in _MIXED:
            block = InceptionModule(cin, channels, bn_eps)
            setattr(self, name, block)
            cin = block.out_channels
        self.logits = Unit3D(cin, num_classes, use_bn=False, activation=False,
                             use_bias=True)

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        x = video.to(self.logits.conv3d.weight.dtype).permute(0, 4, 1, 2, 3)
        x = self.Conv3d_1a_7x7(x)
        x = _same_max_pool(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        for name, _ in _MIXED:
            if name in _POOL_BEFORE:
                x = _same_max_pool(x, *_POOL_BEFORE[name])
            x = getattr(self, name)(x)
        t, h, w = x.shape[2:]
        x = F.avg_pool3d(x, (min(2, t), min(7, h), min(7, w)), stride=1)
        return self.logits(x).mean(dim=(2, 3, 4))
