"""The AVSyncD 3D UNet in plain PyTorch, float32.

A frozen copy of the module tree of the system under test (the same
parameter names and shapes, so one state dict loads strictly into both),
with every layer written out in plain torch from the published
description: first-frame-inflated convolutions with the zero-init 3-tap
temporal mix, resnets whose GroupNorm pools over all frames, and
transformer blocks of first-frame spatial attention, audio cross
attention (each frame attends to its segment of the ImageBind tokens,
as boolean masks), text cross attention, temporal attention with a
sinusoidal-MLP position embedding, and a GEGLU feed-forward.  No kernel,
no fused sub-layer, no cache.  Tensors are channels last,
(b, f, h, w, c).  `checkpoint=True` recomputes each down, mid and up block
in the backward (torch.utils.checkpoint), so that a full-size backward fits
on one card; it changes no value.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from .ops import Products, group_norm, layer_norm

AUDIO_BLOCKS = ("FFSpatioAudioTempCrossAttnDownBlock3D",
                "FFSpatioAudioTempCrossAttnUpBlock3D",
                "FFSpatioAudioTempCrossAttnUNetMidBlock3D")
TEXT_BLOCKS = ("FFSpatioTempCrossAttnDownBlock3D",
               "FFSpatioTempCrossAttnUpBlock3D",
               "FFSpatioTempCrossAttnUNetMidBlock3D")


def _p(*shape) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape))


class Lin(nn.Module):
    def __init__(self, i: int, o: int, bias: bool = True):
        super().__init__()
        self.weight = _p(o, i)
        self.bias = _p(o) if bias else None

    def forward(self, x, P: Products):
        return P.linear(x, self.weight, self.bias)


class Norm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight, self.bias = _p(c), _p(c)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """diffusers get_timestep_embedding, flip_sin_to_cos, shift 0."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    e = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(e), torch.sin(e)], dim=-1)


class TimeMLP(nn.Module):
    def __init__(self, i: int, o: int):
        super().__init__()
        self.linear_1, self.linear_2 = Lin(i, o), Lin(o, o)

    def forward(self, x, P):
        return self.linear_2(F.silu(self.linear_1(x, P)), P)


class Conv(nn.Module):
    """Per-frame 2D convolution + the residual temporal mix
    y + W [y_0 | y_{f-1} | y_f] + b (frame 0's previous frame is itself)."""

    def __init__(self, i: int, o: int, k: int = 3, stride: int = 1,
                 pad: int = 1, upsample: bool = False):
        super().__init__()
        self.weight, self.bias = _p(o, i, k, k), _p(o)
        self.conv_temp = Lin(3 * o, o)
        self.stride, self.pad, self.upsample = stride, pad, upsample

    def forward(self, x, P):
        b, f = x.shape[:2]
        x = x.reshape((b * f,) + x.shape[2:]).permute(0, 3, 1, 2)
        if self.upsample:
            x = F.interpolate(x, scale_factor=2.0, mode="nearest")
        y = P.conv2d(x, self.weight, self.bias, self.stride, self.pad)
        y = y.permute(0, 2, 3, 1).reshape((b, f) + (y.shape[2], y.shape[3],
                                                     y.shape[1]))
        prev = torch.cat([y[:, :1], y[:, :-1]], dim=1)
        taps = torch.cat([y[:, :1].expand_as(y), prev, y], dim=-1)
        return y + self.conv_temp(taps, P)


class Resnet(nn.Module):
    def __init__(self, i: int, o: int, temb: int, groups: int, eps: float):
        super().__init__()
        self.groups, self.eps = groups, eps
        self.norm1, self.conv1 = Norm(i), Conv(i, o)
        self.time_emb_proj = Lin(temb, o)
        self.norm2, self.conv2 = Norm(o), Conv(o, o)
        self.conv_shortcut = Conv(i, o, 1, 1, 0) if i != o else None

    def _gn(self, norm, x):
        return group_norm(x, self.groups, norm.weight, norm.bias, self.eps, 1)

    def forward(self, x, temb, P):
        h = self.conv1(F.silu(self._gn(self.norm1, x)), P)
        h = h + self.time_emb_proj(F.silu(temb), P)[:, :, None, None, :]
        h = self.conv2(F.silu(self._gn(self.norm2, h)), P)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x, P)
        return x + h


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, kv_dim: int = None):
        super().__init__()
        self.heads = heads
        self.to_q = Lin(dim, dim, bias=False)
        self.to_k = Lin(kv_dim or dim, dim, bias=False)
        self.to_v = Lin(kv_dim or dim, dim, bias=False)
        self.to_out = nn.ModuleList([Lin(dim, dim)])

    def split(self, t):
        """(..., s, H*D) -> (..., H, s, D)."""
        return t.reshape(t.shape[:-1] + (self.heads, -1)).transpose(-2, -3)

    def attend(self, q, k, v, P, mask=None):
        """q (..., s, C) over k, v (..., m, C) -> (..., s, C), projected
        out."""
        d = q.shape[-1] // self.heads
        o = P.attention(self.split(q), self.split(k), self.split(v),
                        1.0 / math.sqrt(d), mask)
        o = o.transpose(-2, -3).reshape(q.shape)
        return self.to_out[0](o, P)


class TemporalAttention(Attention):
    def forward(self, x, P):
        """x (b, f, n, c): each spatial position attends over the frames."""
        xt = x.transpose(1, 2)                               # (b, n, f, c)
        out = self.attend(self.to_q(xt, P), self.to_k(xt, P),
                          self.to_v(xt, P), P)
        return out.transpose(1, 2)


class GEGLUProj(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = Lin(dim, 2 * inner)


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([GEGLUProj(dim, dim * mult), nn.Identity(),
                                  Lin(dim * mult, dim)])

    def forward(self, x, P):
        value, gate = self.net[0].proj(x, P).chunk(2, dim=-1)
        return self.net[2](value * F.gelu(gate), P)


class Block(nn.Module):
    """One spatio(-audio)-temporal transformer block on (b, f, n, c)."""

    def __init__(self, dim, heads, text_dim, audio_dim, use_audio):
        super().__init__()
        self.use_audio = use_audio
        self.attn1, self.norm1 = Attention(dim, heads), Norm(dim)
        if use_audio:
            self.attn_audio = Attention(dim, heads, audio_dim)
            self.norm_audio = Norm(dim)
        self.attn2, self.norm2 = Attention(dim, heads, text_dim), Norm(dim)
        self.pos_embedding_temp = TimeMLP(dim, dim)
        self.norm_temp = Norm(dim)
        self.attn_temp = TemporalAttention(dim, heads)
        self.ff, self.norm3 = FeedForward(dim), Norm(dim)
        self.dim = dim

    @staticmethod
    def _ln(norm, x, eps=1e-5):
        return layer_norm(x, norm.weight, norm.bias, eps)

    def forward(self, x, text, audio, audio_mask, P):
        b, f, n, c = x.shape
        # first-frame attention: every frame's queries over frame 0's K/V
        h = self._ln(self.norm1, x)
        h0 = h[:, 0]
        q = self.attn1.to_q(h, P).reshape(b, f * n, c)
        x = x + self.attn1.attend(q, self.attn1.to_k(h0, P),
                                  self.attn1.to_v(h0, P), P).reshape(x.shape)
        if self.use_audio:
            # frame i attends to the audio tokens of its segment
            h = self._ln(self.norm_audio, x)
            k = self.attn_audio.to_k(audio, P)[:, None]     # (b, 1, m, c)
            v = self.attn_audio.to_v(audio, P)[:, None]
            mask = audio_mask[None, :, None, None, :]       # (1, f, 1, 1, m)
            x = x + self.attn_audio.attend(self.attn_audio.to_q(h, P), k, v,
                                           P, mask)
        if text is not None:
            h = self._ln(self.norm2, x)
            q = self.attn2.to_q(h, P).reshape(b, f * n, c)
            x = x + self.attn2.attend(q, self.attn2.to_k(text, P),
                                      self.attn2.to_v(text, P),
                                      P).reshape(x.shape)
        pos = self.pos_embedding_temp(timestep_embedding(
            torch.arange(f, device=x.device), self.dim), P)
        x = x + self.attn_temp(self._ln(self.norm_temp,
                                        x + pos[None, :, None, :]), P)
        return x + self.ff(self._ln(self.norm3, x), P)


class Transformer3D(nn.Module):
    def __init__(self, dim, heads, groups, text_dim, audio_dim, use_audio):
        super().__init__()
        self.groups = groups
        self.norm = Norm(dim)
        self.proj_in = Conv1x1(dim, dim)
        self.transformer_blocks = nn.ModuleList(
            [Block(dim, heads, text_dim, audio_dim, use_audio)])
        self.proj_out = Conv1x1(dim, dim)

    def forward(self, x, text, audio, audio_mask, P):
        b, f, hh, ww, c = x.shape
        h = group_norm(x, self.groups, self.norm.weight, self.norm.bias, 1e-6,
                       2)
        h = self.proj_in(h, P).reshape(b, f, hh * ww, c)
        for block in self.transformer_blocks:
            h = block(h, text, audio, audio_mask, P)
        return x + self.proj_out(h.reshape(x.shape), P)


class Conv1x1(nn.Module):
    def __init__(self, i, o):
        super().__init__()
        self.weight, self.bias = _p(o, i, 1, 1), _p(o)

    def forward(self, x, P):
        return P.linear(x, self.weight.flatten(1), self.bias)


class Sampler(nn.Module):
    def __init__(self, c, down: bool):
        super().__init__()
        self.down = down
        self.conv = (Conv(c, c, 3, 2, 1) if down
                     else Conv(c, c, 3, 1, 1, upsample=True))

    def forward(self, x, P):
        return self.conv(x, P)


class DownBlock(nn.Module):
    def __init__(self, i, o, temb, layers, down, attn, use_audio, common):
        super().__init__()
        g, eps = common["groups"], common["eps"]
        self.resnets = nn.ModuleList([Resnet(i if j == 0 else o, o, temb, g,
                                             eps) for j in range(layers)])
        self.attentions = nn.ModuleList([
            Transformer3D(o, common["heads"], g, common["text_dim"],
                          common["audio_dim"], use_audio)
            for _ in range(layers)]) if attn else None
        self.downsamplers = nn.ModuleList([Sampler(o, True)]) if down else None

    def forward(self, x, temb, text, audio, mask, P):
        res = []
        for j, resnet in enumerate(self.resnets):
            x = resnet(x, temb, P)
            if self.attentions is not None:
                x = self.attentions[j](x, text, audio, mask, P)
            res.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x, P)
            res.append(x)
        return (x, *res)


class MidBlock(nn.Module):
    def __init__(self, c, temb, use_audio, common):
        super().__init__()
        g, eps = common["groups"], common["eps"]
        self.resnets = nn.ModuleList([Resnet(c, c, temb, g, eps)
                                      for _ in range(2)])
        self.attentions = nn.ModuleList([Transformer3D(
            c, common["heads"], g, common["text_dim"], common["audio_dim"],
            use_audio)])

    def forward(self, x, temb, text, audio, mask, P):
        x = self.resnets[0](x, temb, P)
        x = self.attentions[0](x, text, audio, mask, P)
        return self.resnets[1](x, temb, P)


class UpBlock(nn.Module):
    def __init__(self, i, prev, o, temb, layers, up, attn, use_audio, common):
        super().__init__()
        g, eps = common["groups"], common["eps"]
        self.resnets = nn.ModuleList([
            Resnet((prev if j == 0 else o) + (i if j == layers - 1 else o), o,
                   temb, g, eps) for j in range(layers)])
        self.attentions = nn.ModuleList([
            Transformer3D(o, common["heads"], g, common["text_dim"],
                          common["audio_dim"], use_audio)
            for _ in range(layers)]) if attn else None
        self.upsamplers = nn.ModuleList([Sampler(o, False)]) if up else None

    def forward(self, x, temb, text, audio, mask, P, *skips):
        for j, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, skips[-1 - j]], dim=-1), temb, P)
            if self.attentions is not None:
                x = self.attentions[j](x, text, audio, mask, P)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, P)
        return x


class UNet3D(nn.Module):
    """config: the keys of the configuration file's "unet" group."""

    def __init__(self, config: dict, precision: str = "fp32",
                 checkpoint: bool = False):
        super().__init__()
        cfg = self.config = dict(config)
        self.P = Products(precision)
        self.use_checkpoint = checkpoint
        ch = list(cfg["block_out_channels"])
        temb = ch[0] * 4
        layers = cfg["layers_per_block"]
        common = dict(groups=cfg["norm_num_groups"], eps=cfg["norm_eps"],
                      heads=cfg["attention_head_dim"],
                      text_dim=cfg["cross_attention_dim"],
                      audio_dim=cfg["audio_cross_attention_dim"])
        self.time_embedding = TimeMLP(ch[0], temb)
        self.conv_in = Conv(cfg["in_channels"], ch[0])
        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, kind in enumerate(cfg["down_block_types"]):
            self.down_blocks.append(DownBlock(
                prev, ch[i], temb, layers, i < len(ch) - 1,
                kind in AUDIO_BLOCKS + TEXT_BLOCKS, kind in AUDIO_BLOCKS,
                common))
            prev = ch[i]
        self.mid_block = MidBlock(ch[-1], temb,
                                  cfg["mid_block_type"] in AUDIO_BLOCKS,
                                  common)
        rev = ch[::-1]
        self.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for i, kind in enumerate(cfg["up_block_types"]):
            self.up_blocks.append(UpBlock(
                rev[min(i + 1, len(ch) - 1)], prev, rev[i], temb, layers + 1,
                i < len(ch) - 1, kind in AUDIO_BLOCKS + TEXT_BLOCKS,
                kind in AUDIO_BLOCKS, common))
            prev = rev[i]
        self.conv_norm_out = Norm(ch[0])
        self.conv_out = Conv(ch[0], cfg["out_channels"])

    def _run(self, block, *args):
        if self.use_checkpoint and torch.is_grad_enabled():
            return checkpoint(block, *args, use_reentrant=False)
        return block(*args)

    def forward(self, sample, timesteps, text, audio, audio_mask):
        """sample (b, f, h, w, 4) -> eps; timesteps (b,); text (b, 77, d);
        audio (b, 229, d); audio_mask (f, 229) boolean, True = attend."""
        P, cfg = self.P, self.config
        b, f = sample.shape[:2]
        temb = self.time_embedding(timestep_embedding(
            timesteps, cfg["block_out_channels"][0]), P)
        temb = temb[:, None].expand(b, f, temb.shape[-1])
        text, audio = text.float(), audio.float()
        x = self.conv_in(sample.float(), P)
        stack = [x]
        for block in self.down_blocks:
            x, *res = self._run(block, x, temb, text, audio, audio_mask, P)
            stack.extend(res)
        x = self._run(self.mid_block, x, temb, text, audio, audio_mask, P)
        for block in self.up_blocks:
            n = len(block.resnets)
            skips = stack[-n:]
            del stack[-n:]
            x = self._run(block, x, temb, text, audio, audio_mask, P, *skips)
        x = group_norm(x, cfg["norm_num_groups"], self.conv_norm_out.weight,
                       self.conv_norm_out.bias, cfg["norm_eps"], 1)
        return self.conv_out(F.silu(x), P)


def segment_masks(n_segment: int, grid) -> np.ndarray:
    """(n_segment, 1 + gh*gw) AVSyncD audio segment masks: CLS always, and
    for frame i the time columns [s_i, s_i + ceil(gw / n)) of every mel
    row, s = round(linspace(0, gw - chunk, n))."""
    gh, gw = grid
    chunk = int(math.ceil(gw / n_segment))
    starts = np.round(np.linspace(0, gw - chunk, n_segment)).astype(np.int64)
    cols = np.zeros((n_segment, gw), bool)
    for i, s in enumerate(starts):
        cols[i, s:s + chunk] = True
    full = np.repeat(cols[:, None, :], gh, axis=1).reshape(n_segment, -1)
    return np.concatenate([np.ones((n_segment, 1), bool), full], axis=1)
