"""The SD1.5 AutoencoderKL in plain PyTorch, float32, channels last
(n, h, w, c), with the parameter names of the system under test:
resnets of GroupNorm 32 / 1e-6 and SiLU, one single-head attention in each
mid block, the encoder's stride-2 convolutions on a right/bottom pad of
one, the decoder's nearest x2 upsampling, quant convs as 1x1 products.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.nn import functional as F

from .ops import Products, group_norm
from .unet import Conv1x1, Lin, Norm, _p


class Conv2d(nn.Module):
    def __init__(self, i, o, k=3, stride=1, pad=1):
        super().__init__()
        self.weight, self.bias = _p(o, i, k, k), _p(o)
        self.stride, self.pad = stride, pad

    def forward(self, x, P):
        y = P.conv2d(x.permute(0, 3, 1, 2), self.weight, self.bias,
                     self.stride, self.pad)
        return y.permute(0, 2, 3, 1)


def _gn(norm, x, groups):
    return group_norm(x, groups, norm.weight, norm.bias, 1e-6, 1)


class Resnet(nn.Module):
    def __init__(self, i, o, groups):
        super().__init__()
        self.groups = groups
        self.norm1, self.conv1 = Norm(i), Conv2d(i, o)
        self.norm2, self.conv2 = Norm(o), Conv2d(o, o)
        self.conv_shortcut = Conv2d(i, o, 1, 1, 0) if i != o else None

    def forward(self, x, P):
        h = self.conv1(F.silu(_gn(self.norm1, x, self.groups)), P)
        h = self.conv2(F.silu(_gn(self.norm2, h, self.groups)), P)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x, P)
        return x + h


class MidAttention(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.groups = groups
        self.group_norm = Norm(c)
        self.to_q, self.to_k, self.to_v = Lin(c, c), Lin(c, c), Lin(c, c)
        self.to_out = nn.ModuleList([Lin(c, c)])

    def forward(self, x, P):
        n, h, w, c = x.shape
        y = _gn(self.group_norm, x, self.groups).reshape(n, h * w, c)
        o = P.attention(self.to_q(y, P), self.to_k(y, P), self.to_v(y, P),
                        1.0 / math.sqrt(c))
        return x + self.to_out[0](o, P).reshape(x.shape)


class Mid(nn.Module):
    def __init__(self, c, groups):
        super().__init__()
        self.resnets = nn.ModuleList([Resnet(c, c, groups) for _ in range(2)])
        self.attentions = nn.ModuleList([MidAttention(c, groups)])

    def forward(self, x, P):
        x = self.resnets[0](x, P)
        return self.resnets[1](self.attentions[0](x, P), P)


class Holder(nn.Module):
    def __init__(self, conv):
        super().__init__()
        self.conv = conv


class Block(nn.Module):
    def __init__(self, resnets, sampler, name):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        self.sampler_name = name if sampler is not None else None
        if sampler is not None:
            setattr(self, name, nn.ModuleList([Holder(sampler)]))


class Encoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        g, ch = cfg["norm_num_groups"], list(cfg["block_out_channels"])
        self.groups = g
        self.conv_in = Conv2d(cfg["in_channels"], ch[0])
        blocks, prev = [], ch[0]
        for i, c in enumerate(ch):
            blocks.append(Block(
                [Resnet(prev if j == 0 else c, c, g)
                 for j in range(cfg["layers_per_block"])],
                Conv2d(c, c, 3, 2, 0) if i < len(ch) - 1 else None,
                "downsamplers"))
            prev = c
        self.down_blocks = nn.ModuleList(blocks)
        self.mid_block = Mid(ch[-1], g)
        self.conv_norm_out = Norm(ch[-1])
        self.conv_out = Conv2d(ch[-1], 2 * cfg["latent_channels"])

    def forward(self, x, P):
        h = self.conv_in(x, P)
        for block in self.down_blocks:
            for r in block.resnets:
                h = r(h, P)
            if block.sampler_name:
                h = block.downsamplers[0].conv(F.pad(h, (0, 0, 0, 1, 0, 1)),
                                               P)
        h = self.mid_block(h, P)
        return self.conv_out(F.silu(_gn(self.conv_norm_out, h, self.groups)),
                             P)


class Decoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        g = cfg["norm_num_groups"]
        rev = list(cfg["block_out_channels"])[::-1]
        self.groups = g
        self.conv_in = Conv2d(cfg["latent_channels"], rev[0])
        self.mid_block = Mid(rev[0], g)
        blocks, prev = [], rev[0]
        for i, c in enumerate(rev):
            blocks.append(Block(
                [Resnet(prev if j == 0 else c, c, g)
                 for j in range(cfg["layers_per_block"] + 1)],
                Conv2d(c, c, 3, 1, 1) if i < len(rev) - 1 else None,
                "upsamplers"))
            prev = c
        self.up_blocks = nn.ModuleList(blocks)
        self.conv_norm_out = Norm(rev[-1])
        self.conv_out = Conv2d(rev[-1], cfg["out_channels"])

    def forward(self, z, P):
        h = self.mid_block(self.conv_in(z, P), P)
        for block in self.up_blocks:
            for r in block.resnets:
                h = r(h, P)
            if block.sampler_name:
                h = h.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                h = block.upsamplers[0].conv(h, P)
        return self.conv_out(F.silu(_gn(self.conv_norm_out, h, self.groups)),
                             P)


class VAE(nn.Module):
    """config: the keys of the configuration file's "vae" group."""

    def __init__(self, config: dict, precision: str = "fp32"):
        super().__init__()
        self.config = dict(config)
        self.P = Products(precision)
        self.encoder, self.decoder = Encoder(config), Decoder(config)
        lc = config["latent_channels"]
        self.quant_conv = Conv1x1(2 * lc, 2 * lc)
        self.post_quant_conv = Conv1x1(lc, lc)

    @property
    def scaling_factor(self) -> float:
        return self.config["scaling_factor"]

    @property
    def downscale(self) -> int:
        return 2 ** (len(self.config["block_out_channels"]) - 1)

    def sample_latents(self, images, noise):
        """images (n, h, w, 3) in [-1, 1] -> scaled latents mean + std *
        noise."""
        moments = self.quant_conv(self.encoder(images.float(), self.P),
                                  self.P)
        mean, logvar = moments.chunk(2, dim=-1)
        logvar = torch.clamp(logvar, -30.0, 20.0)
        return (mean + torch.exp(0.5 * logvar) * noise.float()) \
            * self.scaling_factor

    def decode(self, latents):
        """scaled latents (n, h', w', 4) -> images (n, h, w, 3) in [0, 1]."""
        z = self.post_quant_conv(latents.float() / self.scaling_factor,
                                 self.P)
        return torch.clamp(self.decoder(z, self.P) / 2.0 + 0.5, 0.0, 1.0)
