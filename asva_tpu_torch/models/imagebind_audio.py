"""ImageBind-huge audio tower + AVSyncD segment masks.

Port of asva_tpu/models/imagebind_audio.py (`SegmaskAudioEncoder` :191,
`segment_masks` :72, `segment_token_indices` :92).  Keys follow the
reference's audio_encoder export (preprocessor / trunk / head /
final_layer_norm), the first candidates of `imagebind_audio_key_map`.

  preprocessor: Conv2d(1 -> e, kernel 16, stride 10, no bias) on the
    (128, 204) mel -> 12x19 = 228 patches, LayerNorm, CLS prepended,
    learnable positional embedding (1, 229, e).
  trunk: pre-norm ViT blocks, torch MultiheadAttention layout (fused
    in_proj, out_proj) with bias_k / bias_v appended as an extra KV token.
  head: LayerNorm -> CLS -> Linear(e -> out, no bias).
  final_layer_norm: ASVA's trainable LayerNorm on the trunk tokens.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.attention import dot_product_attention
from ..ops.norms import AdaptiveOrLayerNorm


@dataclasses.dataclass(frozen=True)
class ImageBindAudioConfig:
    embed_dim: int = 768
    out_embed_dim: int = 1024
    num_blocks: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    kernel_size: int = 16
    stride: int = 10
    mel_bins: int = 128
    mel_frames: int = 204
    add_bias_kv: bool = True
    pre_trunk_norm: bool = False

    @property
    def patch_grid(self) -> Tuple[int, int]:
        g = lambda n: (n - self.kernel_size) // self.stride + 1  # noqa: E731
        return g(self.mel_bins), g(self.mel_frames)  # (12, 19)

    @property
    def num_tokens(self) -> int:
        gh, gw = self.patch_grid
        return gh * gw + 1

    @classmethod
    def tiny(cls, **kw) -> "ImageBindAudioConfig":
        d = dict(embed_dim=32, out_embed_dim=16, num_blocks=2, num_heads=2)
        d.update(kw)
        return cls(**d)


def segment_masks(n_segment: int, patch_grid: Tuple[int, int]) -> np.ndarray:
    """(n_segment, 1 + gh*gw) boolean masks; True = attend.  Chunk starts
    are round(linspace(0, gw - chunk, n)) over the time columns; CLS is
    always visible."""
    gh, gw = patch_grid
    chunk = int(math.ceil(gw / n_segment))
    starts = np.round(np.linspace(0, gw - chunk, n_segment,
                                  endpoint=True)).astype(np.int64)
    time_mask = np.zeros((n_segment, gw), dtype=bool)
    for i, s in enumerate(starts):
        time_mask[i, s:s + chunk] = True
    full = np.repeat(time_mask[:, None, :], gh, axis=1).reshape(
        n_segment, gh * gw)
    return np.concatenate([np.ones((n_segment, 1), dtype=bool), full], axis=1)


def segment_token_indices(n_segment: int,
                          patch_grid: Tuple[int, int]) -> np.ndarray:
    """(n_segment, m) static token indices equal to `segment_masks`: every
    frame selects the same count, so the mask is a dense per-frame gather."""
    masks = segment_masks(n_segment, patch_grid)
    counts = masks.sum(axis=1)
    if not (counts == counts[0]).all():
        raise ValueError(f"segments select different counts: {counts}")
    return np.stack([np.nonzero(row)[0] for row in masks]).astype(np.int32)


class _Stem(nn.Module):
    def __init__(self, cfg: ImageBindAudioConfig):
        super().__init__()
        self.proj = nn.ModuleList([nn.Conv2d(
            1, cfg.embed_dim, cfg.kernel_size, stride=cfg.stride, bias=False)])
        self.norm_layer = AdaptiveOrLayerNorm(cfg.embed_dim, 1e-5)


class _PosEmbed(nn.Module):
    def __init__(self, cfg: ImageBindAudioConfig):
        super().__init__()
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.num_tokens,
                                                  cfg.embed_dim))


class _Preprocessor(nn.Module):
    def __init__(self, cfg: ImageBindAudioConfig):
        super().__init__()
        self.rgbt_stem = _Stem(cfg)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.embed_dim))
        self.pos_embedding_helper = _PosEmbed(cfg)


class _MultiheadAttention(nn.Module):
    """torch nn.MultiheadAttention's parameters (fused in_proj, out_proj,
    add_bias_kv's bias_k / bias_v)."""

    def __init__(self, e: int, num_heads: int, add_bias_kv: bool):
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.zeros(3 * e, e))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * e))
        self.out_proj = nn.Linear(e, e)
        if add_bias_kv:
            self.bias_k = nn.Parameter(torch.zeros(1, 1, e))
            self.bias_v = nn.Parameter(torch.zeros(1, 1, e))
        else:
            self.bias_k = self.bias_v = None

    def forward(self, y: torch.Tensor, mask=None) -> torch.Tensor:
        """mask: boolean, broadcastable to (b, H, n, n_kv), True = attend."""
        b, n, e = y.shape
        q, k, v = F.linear(y, self.in_proj_weight, self.in_proj_bias).chunk(
            3, dim=-1)
        if self.bias_k is not None:
            k = torch.cat([k, self.bias_k.to(k.dtype).expand(b, 1, e)], dim=1)
            v = torch.cat([v, self.bias_v.to(v.dtype).expand(b, 1, e)], dim=1)
        h = self.num_heads
        attn = dot_product_attention(q.reshape(b, n, h, e // h),
                                     k.reshape(b, -1, h, e // h),
                                     v.reshape(b, -1, h, e // h), mask=mask)
        return self.out_proj(attn.reshape(b, n, e))


class _Mlp(nn.Module):
    def __init__(self, e: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(e, hidden)
        self.fc2 = nn.Linear(hidden, e)


class TrunkBlock(nn.Module):
    """Pre-norm ViT block (LayerNorm eps 1e-6, exact-erf GELU MLP), shared
    by the audio, vision and text trunks; `cfg` gives embed_dim, num_heads,
    mlp_ratio and add_bias_kv.  The text trunk passes its causal mask."""

    def __init__(self, cfg):
        super().__init__()
        e = cfg.embed_dim
        self.norm_1 = AdaptiveOrLayerNorm(e, 1e-6)
        self.attn = _MultiheadAttention(e, cfg.num_heads, cfg.add_bias_kv)
        self.norm_2 = AdaptiveOrLayerNorm(e, 1e-6)
        self.mlp = _Mlp(e, int(e * cfg.mlp_ratio))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        x = x + self.attn(self.norm_1(x), mask)
        y = self.mlp.fc2(F.gelu(self.mlp.fc1(self.norm_2(x))))
        return x + y


class _Trunk(nn.Module):
    def __init__(self, cfg: ImageBindAudioConfig):
        super().__init__()
        if cfg.pre_trunk_norm:
            raise NotImplementedError("the audio trunk has no pre-norm")
        self.blocks = nn.ModuleList([TrunkBlock(cfg)
                                     for _ in range(cfg.num_blocks)])


class ImageBindAudioEncoder(nn.Module):
    """mel (b, 128, 204, 1) -> (cls_embeds (b, out), tokens (b, 229, e))."""

    def __init__(self, config: ImageBindAudioConfig = ImageBindAudioConfig()):
        super().__init__()
        self.config = config
        e = config.embed_dim
        self.preprocessor = _Preprocessor(config)
        self.trunk = _Trunk(config)
        self.head = nn.ModuleList([AdaptiveOrLayerNorm(e, 1e-6), nn.Identity(),
                                   nn.Linear(e, config.out_embed_dim,
                                             bias=False)])

    def encode(self, mel: torch.Tensor, normalize: bool = False):
        cfg = self.config
        pre = self.preprocessor
        b = mel.shape[0]
        conv = pre.rgbt_stem.proj[0]
        x = conv(mel.to(conv.weight.dtype).permute(0, 3, 1, 2))  # (b, e, gh, gw)
        x = x.flatten(2).transpose(1, 2)                         # (b, gh*gw, e)
        x = pre.rgbt_stem.norm_layer(x)
        x = torch.cat([pre.cls_token.to(x.dtype).expand(b, 1, cfg.embed_dim),
                       x], dim=1)
        x = x + pre.pos_embedding_helper.pos_embed.to(x.dtype)
        for block in self.trunk.blocks:
            x = block(x)
        tokens = x  # pre-final-norm, as the reference returns them
        cls_embeds = self.head[2](self.head[0](tokens[:, 0]))
        if normalize:
            cls_embeds = cls_embeds / cls_embeds.norm(dim=-1, keepdim=True)
            cls_embeds = cls_embeds * 20.0  # LearnableLogitScaling(20, frozen)
        return cls_embeds, tokens


class SegmaskAudioEncoder(ImageBindAudioEncoder):
    """AVSyncD audio conditioner: ImageBind tower + trainable final
    LayerNorm + per-frame segment masks."""

    def __init__(self, config: ImageBindAudioConfig = ImageBindAudioConfig(),
                 n_segment: int = 12):
        super().__init__(config)
        self.n_segment = n_segment
        self.final_layer_norm = AdaptiveOrLayerNorm(config.embed_dim, 1e-6)

    def forward(self, mel: torch.Tensor, normalize: bool = False):
        """-> (cls_embeds, encodings (b, 229, e), masks (b, n_segment, 229))."""
        cls_embeds, tokens = self.encode(mel, normalize)
        encodings = self.final_layer_norm(tokens)
        masks = torch.from_numpy(segment_masks(
            self.n_segment, self.config.patch_grid)).to(mel.device)
        masks = masks[None].expand((mel.shape[0],) + masks.shape)
        return cls_embeds, encodings, masks
