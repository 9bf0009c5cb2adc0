"""AutoencoderKL (SD1.5 VAE), port of asva_tpu/models/vae.py:152.

Channels-last (n, h, w, c) throughout, as in the JAX package; convolutions
run on a channels_last view (no copy).  Frames are folded into the batch
axis by the caller.  Architecture: the stable-diffusion-v1-5 vae config —
block_out_channels (128, 256, 512, 512),
2 resnets per encoder block, 3 per decoder block, GroupNorm 32/1e-6, SiLU,
single-head mid attention, the encoder downsample's (0,1)x(0,1) padding,
scaling_factor 0.18215.  The decoder upsample is nearest-up then conv (the
JAX kernel fold is a TPU rewrite).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..ops.norms import SpatialGroupNorm
from .unet3d.primitives import Conv1x1, Conv2d


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    in_channels: int = 3
    out_channels: int = 3
    latent_channels: int = 4
    block_out_channels: Tuple[int, ...] = (128, 256, 512, 512)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    scaling_factor: float = 0.18215

    @classmethod
    def tiny(cls, **kw) -> "VAEConfig":
        d = dict(block_out_channels=(8, 16), layers_per_block=1,
                 norm_num_groups=4)
        d.update(kw)
        return cls(**d)


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, groups: int):
        super().__init__()
        self.norm1 = SpatialGroupNorm(groups, in_channels, 1e-6)
        self.conv1 = Conv2d(in_channels, out_channels)
        self.norm2 = SpatialGroupNorm(groups, out_channels, 1e-6)
        self.conv2 = Conv2d(out_channels, out_channels)
        self.conv_shortcut = (Conv2d(in_channels, out_channels, 1, 1, 0)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over spatial tokens with residual."""

    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.group_norm = SpatialGroupNorm(groups, channels, 1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        y = self.group_norm(x).reshape(n, h * w, c)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        logits = (q.float() @ k.float().transpose(1, 2)) * (1.0 / math.sqrt(c))
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        y = (attn.float() @ v.float()).to(x.dtype)
        return x + self.to_out[0](y).reshape(n, h, w, c)


class _Sampler(nn.Module):
    """A down/upsampler holding its conv as `.conv` (reference key space)."""

    def __init__(self, channels: int, stride: int, padding: int):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, stride, padding)


class _Block(nn.Module):
    def __init__(self, resnets, sampler: Optional[nn.Module], name: str):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if sampler is not None:
            setattr(self, name, nn.ModuleList([sampler]))


class _MidBlock(nn.Module):
    def __init__(self, channels: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(channels, channels, groups)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([VAEAttention(channels, groups)])

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g, ch = cfg.norm_num_groups, cfg.block_out_channels
        self.conv_in = Conv2d(cfg.in_channels, ch[0])
        blocks, prev = [], ch[0]
        for i, c in enumerate(ch):
            resnets = [VAEResnetBlock(prev if j == 0 else c, c, g)
                       for j in range(cfg.layers_per_block)]
            down = _Sampler(c, 2, 0) if i < len(ch) - 1 else None
            blocks.append(_Block(resnets, down, "downsamplers"))
            prev = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = _MidBlock(ch[-1], g)
        self.conv_norm_out = SpatialGroupNorm(g, ch[-1], 1e-6)
        self.conv_out = Conv2d(ch[-1], 2 * cfg.latent_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x)
        for block in self.down_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "downsamplers"):
                # asymmetric pad: right/bottom only (diffusers VAE)
                h = block.downsamplers[0].conv(F.pad(h, (0, 0, 0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        rev = tuple(reversed(cfg.block_out_channels))
        self.conv_in = Conv2d(cfg.latent_channels, rev[0])
        self.mid_block = _MidBlock(rev[0], g)
        blocks, prev = [], rev[0]
        for i, c in enumerate(rev):
            resnets = [VAEResnetBlock(prev if j == 0 else c, c, g)
                       for j in range(cfg.layers_per_block + 1)]
            up = _Sampler(c, 1, 1) if i < len(rev) - 1 else None
            blocks.append(_Block(resnets, up, "upsamplers"))
            prev = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = SpatialGroupNorm(g, rev[-1], 1e-6)
        self.conv_out = Conv2d(rev[-1], cfg.out_channels)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.mid_block(self.conv_in(z))
        for block in self.up_blocks:
            for resnet in block.resnets:
                h = resnet(h)
            if hasattr(block, "upsamplers"):
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = block.upsamplers[0].conv(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class AutoencoderKL(nn.Module):
    """encode() returns (mean, logvar) after quant_conv; decode() maps
    latents to images; scaling by `config.scaling_factor` is the caller's
    job, except in `sample_latents`.  All public tensors are NHWC."""

    def __init__(self, config: VAEConfig = VAEConfig()):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        lc = config.latent_channels
        self.quant_conv = Conv1x1(2 * lc, 2 * lc)
        self.post_quant_conv = Conv1x1(lc, lc)

    @property
    def scaling_factor(self) -> float:
        return self.config.scaling_factor

    @property
    def downscale(self) -> int:
        """Spatial factor between images and latents (8 for SD1.5)."""
        return 2 ** (len(self.config.block_out_channels) - 1)

    def encode(self, images: torch.Tensor):
        """images (n, h, w, 3) -> (mean, logvar), each (n, h/8, w/8, 4)."""
        moments = self.quant_conv(self.encoder(
            images.to(self.quant_conv.weight.dtype)))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, torch.clamp(logvar, -30.0, 20.0)

    def sample_latents(self, images: torch.Tensor, noise: torch.Tensor,
                       scale: bool = True) -> torch.Tensor:
        """mean + std * noise; noise broadcasts against (n, h', w', 4)."""
        mean, logvar = self.encode(images)
        z = mean + torch.exp(0.5 * logvar) * noise.to(mean.dtype)
        return z * self.scaling_factor if scale else z

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """latents (n, h', w', 4) -> images (n, h, w, 3)."""
        z = latents.to(self.post_quant_conv.weight.dtype)
        return self.decoder(self.post_quant_conv(z))
