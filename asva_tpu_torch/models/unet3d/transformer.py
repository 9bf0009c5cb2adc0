"""Spatio(-audio)-temporal transformer blocks.

Port of asva_tpu/models/unet3d/transformer.py.  Sub-layer order inside the
block:
  1. first-frame spatial attention  (attn1, K/V from frame 0)
  2. audio cross-attention          (attn_audio, per-frame token gather)
  3. text cross-attention           (attn2)
  4. temporal attention over frames (attn_temp; sinusoidal-MLP positional
                                     embedding added to the normed input only)
  5. GEGLU feed-forward             (ff)

Sub-layers 1-3 run as fused residual sub-layers: with fuse_blocks=True all
three through one B2 call (ops/fused.fused_ln_attn3), else each through B1
(fused_ln_attn).  The FF runs through B3 (fused_ln_geglu).

The remat tags (ops/remat.py) are asva_tpu's: each sub-layer's input is
`sublayer_x` (transformer.py:111-114: proj_in's output and the temporal
residual's here, the fused attention sub-layers' outputs in ops/fused.py)
and the FF's output `block_out` (:203, in ops/fused.py).

`frames` (a `parallel.mesh.FrameShard`) passes a sharded video's frame
context to the frame-axis sub-layers (primitives.py); the temporal
position embedding then takes the global indices of this rank's frames.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ...ops import fused, remat
from ...ops.linear import Linear
from ...ops.norms import AdaptiveOrLayerNorm, LayerNormParams, SpatialGroupNorm
from ..embeddings import TimestepEmbedding, sinusoidal_timestep_embedding
from .primitives import (Conv1x1, CrossAttention, FFSpatialAttention,
                         TemporalAttention)


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = Linear(dim, 2 * inner)


class GEGLUFeedForward(nn.Module):
    """Residual sub-layer x + FF(LN(x)): Linear(dim -> 8 dim) split as
    [value | gate], value * gelu_erf(gate), Linear(4 dim -> dim).  Keys
    follow diffusers FeedForward: net.0.proj and net.2."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        self.net = nn.ModuleList([_GEGLUProj(dim, dim * mult), nn.Identity(),
                                  Linear(dim * mult, dim)])

    def forward(self, x: torch.Tensor, ln: LayerNormParams) -> torch.Tensor:
        c = x.shape[-1]
        proj_in, proj_out = self.net[0].proj, self.net[2]
        out = fused.fused_ln_geglu(x.reshape(-1, c), ln.weight, ln.bias,
                                   proj_in.weight, proj_in.bias,
                                   proj_out.weight, proj_out.bias, ln.eps)
        return out.reshape(x.shape)


class SpatioAudioTempTransformerBlock(nn.Module):
    """One BasicTransformerBlock on (b, f, n, c) spatial-token tensors."""

    def __init__(self, dim: int, num_heads: int, head_dim: int,
                 cross_attention_dim: int = 768,
                 audio_cross_attention_dim: int = 768,
                 use_audio: bool = True):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.use_audio = use_audio
        self.attn1 = FFSpatialAttention(dim, num_heads, head_dim)
        self.norm1 = LayerNormParams(dim)
        if use_audio:
            self.attn_audio = CrossAttention(dim, num_heads, head_dim,
                                             audio_cross_attention_dim)
            self.norm_audio = LayerNormParams(dim)
        self.attn2 = CrossAttention(dim, num_heads, head_dim,
                                    cross_attention_dim)
        self.norm2 = LayerNormParams(dim)
        self.pos_embedding_temp = TimestepEmbedding(dim, dim)
        self.norm_temp = AdaptiveOrLayerNorm(dim)
        self.attn_temp = TemporalAttention(dim, num_heads, head_dim)
        self.ff = GEGLUFeedForward(dim)
        self.norm3 = LayerNormParams(dim)

    def forward(self, x: torch.Tensor, text_context: Optional[torch.Tensor],
                audio_context: Optional[torch.Tensor] = None,
                audio_token_indices=None, fuse_blocks: bool = False,
                frames=None) -> torch.Tensor:
        f = x.shape[1]
        # the JAX block-fusion conditions (transformer.py:121-125), minus
        # the VMEM gate
        if (fuse_blocks and self.use_audio
                and text_context is not None and text_context.dim() == 3
                and audio_context is not None and audio_context.dim() == 3
                and audio_token_indices is not None):
            x = fused.fused_ln_attn3(
                x, *self.attn1.prepare(x, self.norm1, frames),
                *self.attn_audio.prepare(audio_context, self.norm_audio,
                                         audio_token_indices),
                *self.attn2.prepare(text_context, self.norm2),
                (self.norm1.eps, self.norm_audio.eps, self.norm2.eps),
                self.num_heads)
        else:
            x = self.attn1(x, self.norm1, frames)
            if self.use_audio:
                x = self.attn_audio(x, audio_context, self.norm_audio,
                                    context_indices=audio_token_indices)
            if text_context is not None:
                x = self.attn2(x, text_context, self.norm2)

        first = 0 if frames is None else frames.offset
        pos = sinusoidal_timestep_embedding(
            torch.arange(first, first + f, device=x.device,
                         dtype=torch.float32), self.dim)
        pos = self.pos_embedding_temp(pos.to(x.dtype))[None, :, None, :]
        x = remat.checkpoint_name(remat.SUBLAYER_X, torch.add, x,
                                  self.attn_temp(self.norm_temp(x + pos),
                                                 frames))
        return self.ff(x, self.norm3)


class SpatioAudioTempTransformer3D(nn.Module):
    """GroupNorm -> proj_in -> N blocks -> proj_out -> +residual on
    (b, f, h, w, c).  The GroupNorm is per frame; proj_in/out are the
    reference's 1x1 convs."""

    def __init__(self, num_heads: int, head_dim: int, in_channels: int,
                 num_layers: int = 1, norm_num_groups: int = 32,
                 cross_attention_dim: int = 768,
                 audio_cross_attention_dim: int = 768,
                 use_audio: bool = True):
        super().__init__()
        inner = num_heads * head_dim
        self.norm = SpatialGroupNorm(norm_num_groups, in_channels, 1e-6)
        self.proj_in = Conv1x1(in_channels, inner)
        self.transformer_blocks = nn.ModuleList([
            SpatioAudioTempTransformerBlock(
                inner, num_heads, head_dim, cross_attention_dim,
                audio_cross_attention_dim, use_audio)
            for _ in range(num_layers)])
        self.proj_out = Conv1x1(inner, in_channels)

    def forward(self, x: torch.Tensor, text_context: Optional[torch.Tensor],
                audio_context: Optional[torch.Tensor] = None,
                audio_token_indices=None, fuse_blocks: bool = False,
                frames=None) -> torch.Tensor:
        b, f, hh, ww, _ = x.shape
        h = remat.checkpoint_name(remat.SUBLAYER_X, self.proj_in,
                                  self.norm(x))
        h = h.reshape(b, f, hh * ww, h.shape[-1])
        for block in self.transformer_blocks:
            h = block(h, text_context, audio_context, audio_token_indices,
                      fuse_blocks, frames)
        h = self.proj_out(h.reshape(b, f, hh, ww, h.shape[-1]))
        return h + x
