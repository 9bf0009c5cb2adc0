"""The ImageBind-huge audio tower and AVSyncD's final LayerNorm in plain
PyTorch, float32, with the parameter names of the system under test, and
the Kaldi log-mel front end (16 kHz, 25 ms Hann window, 10 ms shift, 128
bins from 20 Hz, 204 frames, mean -4.268, std 9.138) written from its
published parameters.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from .ops import Products, layer_norm
from .unet import Lin, Norm, _p


def _mel_scale(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


def mel_banks(bins: int = 128, n_fft: int = 512, sr: float = 16000.0,
              low: float = 20.0) -> np.ndarray:
    """(bins, n_fft // 2 + 1) Kaldi triangular filters; the Nyquist column
    is zero."""
    high = sr / 2
    lo, hi = _mel_scale(low), _mel_scale(high)
    delta = (hi - lo) / (bins + 1)
    left = lo + np.arange(bins)[:, None] * delta
    centre, right = left + delta, left + 2 * delta
    f = _mel_scale(sr / n_fft * np.arange(n_fft // 2))[None, :]
    w = np.maximum(0.0, np.minimum((f - left) / (centre - left),
                                   (right - f) / (right - centre)))
    return np.concatenate([w, np.zeros((bins, 1))], axis=1).astype(np.float32)


def waveform_to_mel(wave: torch.Tensor) -> torch.Tensor:
    """(c, T) 16 kHz waveform of 2 s -> (128, 204, 1) normalised log mel
    (channel 0 after the mean over all channels is removed)."""
    wave = torch.as_tensor(wave).float()
    if wave.dim() == 1:
        wave = wave[None]
    n = 32000
    t = wave.shape[-1]
    if t > n:
        wave = wave[..., (t - n) // 2:(t - n) // 2 + n]
    elif t < n:
        wave = F.pad(wave, (0, n - t))
    x = (wave - wave.mean())[0]
    frames = x.unfold(0, 400, 160)                         # (198, 400)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[:, :1], frames[:, :-1]], dim=-1)
    frames = frames - 0.97 * prev
    window = torch.hann_window(400, periodic=False, dtype=torch.float32,
                               device=x.device)
    power = torch.fft.rfft(F.pad(frames * window, (0, 112))).abs() ** 2
    mel = power @ torch.from_numpy(mel_banks()).to(x.device).t()
    mel = torch.log(torch.clamp(mel, min=1.1920928955078125e-07)).t()
    mel = F.pad(mel, (0, 204 - mel.shape[-1]))
    return ((mel + 4.268) / 9.138)[..., None]


class Stem(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        e, k = cfg["embed_dim"], cfg["kernel_size"]
        self.proj = nn.ModuleList([nn.Module()])
        self.proj[0].weight = _p(e, 1, k, k)
        self.norm_layer = Norm(e)


class PosEmbed(nn.Module):
    def __init__(self, cfg, tokens):
        super().__init__()
        self.pos_embed = _p(1, tokens, cfg["embed_dim"])


class Preprocessor(nn.Module):
    def __init__(self, cfg, tokens):
        super().__init__()
        self.rgbt_stem = Stem(cfg)
        self.cls_token = _p(1, 1, cfg["embed_dim"])
        self.pos_embedding_helper = PosEmbed(cfg, tokens)


class MHA(nn.Module):
    def __init__(self, e, heads):
        super().__init__()
        self.heads = heads
        self.in_proj_weight, self.in_proj_bias = _p(3 * e, e), _p(3 * e)
        self.out_proj = Lin(e, e)
        self.bias_k, self.bias_v = _p(1, 1, e), _p(1, 1, e)

    def forward(self, y, P):
        b, n, e = y.shape
        q, k, v = P.linear(y, self.in_proj_weight,
                           self.in_proj_bias).chunk(3, dim=-1)
        k = torch.cat([k, self.bias_k.float().expand(b, 1, e)], dim=1)
        v = torch.cat([v, self.bias_v.float().expand(b, 1, e)], dim=1)

        def heads(t):
            return t.reshape(b, -1, self.heads, e // self.heads).transpose(1,
                                                                           2)
        o = P.attention(heads(q), heads(k), heads(v),
                        1.0 / math.sqrt(e // self.heads))
        return self.out_proj(o.transpose(1, 2).reshape(b, n, e), P)


class Mlp(nn.Module):
    def __init__(self, e, hidden):
        super().__init__()
        self.fc1, self.fc2 = Lin(e, hidden), Lin(hidden, e)


class TrunkBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        e = cfg["embed_dim"]
        self.norm_1, self.norm_2 = Norm(e), Norm(e)
        self.attn = MHA(e, cfg["num_heads"])
        self.mlp = Mlp(e, int(e * cfg["mlp_ratio"]))

    def forward(self, x, P):
        x = x + self.attn(layer_norm(x, self.norm_1.weight, self.norm_1.bias,
                                     1e-6), P)
        h = layer_norm(x, self.norm_2.weight, self.norm_2.bias, 1e-6)
        return x + self.mlp.fc2(F.gelu(self.mlp.fc1(h, P)), P)


class Trunk(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.blocks = nn.ModuleList([TrunkBlock(cfg)
                                     for _ in range(cfg["num_blocks"])])


class Head(nn.Module):
    def __init__(self, e, out):
        super().__init__()
        self.weight = _p(out, e)


class AudioTower(nn.Module):
    """mel (b, 128, 204, 1) -> the token encodings (b, 1 + gh*gw, e) after
    the final LayerNorm.  config: the configuration file's "audio" group."""

    def __init__(self, config: dict, precision: str = "fp32"):
        super().__init__()
        cfg = self.config = dict(config)
        self.P = Products(precision)
        k, s = cfg["kernel_size"], cfg["stride"]
        self.grid = ((cfg["mel_bins"] - k) // s + 1,
                     (cfg["mel_frames"] - k) // s + 1)
        e = cfg["embed_dim"]
        self.preprocessor = Preprocessor(cfg, self.grid[0] * self.grid[1] + 1)
        self.trunk = Trunk(cfg)
        self.head = nn.ModuleList([Norm(e), nn.Identity(),
                                   Head(e, cfg["out_embed_dim"])])
        self.final_layer_norm = Norm(e)

    def forward(self, mel):
        P, pre = self.P, self.preprocessor
        b, e = mel.shape[0], self.config["embed_dim"]
        x = P.conv2d(mel.float().permute(0, 3, 1, 2),
                     pre.rgbt_stem.proj[0].weight, None,
                     self.config["stride"])
        x = x.flatten(2).transpose(1, 2)
        x = layer_norm(x, pre.rgbt_stem.norm_layer.weight,
                       pre.rgbt_stem.norm_layer.bias, 1e-5)
        x = torch.cat([pre.cls_token.float().expand(b, 1, e), x], dim=1)
        x = x + pre.pos_embedding_helper.pos_embed.float()
        for block in self.trunk.blocks:
            x = block(x, P)
        return layer_norm(x, self.final_layer_norm.weight,
                          self.final_layer_norm.bias, 1e-6)
