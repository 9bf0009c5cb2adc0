"""AudioUNet3D — first-frame-conditioned audio-driven video diffusion UNet.

Port of asva_tpu/models/unet3d/model.py:86.  Channels-last (b, f, h, w, c)
video, a per-frame time embedding, text context (b, 77, 768) and audio
context (b, 229, 768) broadcast over frames inside the attention, and the
audio segment masks as a static per-frame token gather (`audio_token_indices`
(f, m); a boolean `audio_mask` (b, f, 229) is converted to it).

`fuse_blocks` selects the generation variant (one B2 call per transformer
block for attn1 + audio-x + text-x) over three B1 calls; both variants
compute the same function.  Remat is not ported (generation only).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ...ops.norms import VideoGroupNorm
from ..embeddings import TimestepEmbedding, sinusoidal_timestep_embedding
from .blocks import DownBlock, MidBlock, UpBlock
from .primitives import FFInflatedConv, mask_to_token_indices

DOWN_AUDIO = "FFSpatioAudioTempCrossAttnDownBlock3D"
DOWN_TEXT = "FFSpatioTempCrossAttnDownBlock3D"
DOWN_RES = "FFSpatioTempResDownBlock3D"
UP_AUDIO = "FFSpatioAudioTempCrossAttnUpBlock3D"
UP_TEXT = "FFSpatioTempCrossAttnUpBlock3D"
UP_RES = "FFSpatioTempResUpBlock3D"
MID_AUDIO = "FFSpatioAudioTempCrossAttnUNetMidBlock3D"
MID_TEXT = "FFSpatioTempCrossAttnUNetMidBlock3D"


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    in_channels: int = 4
    out_channels: int = 4
    down_block_types: Tuple[str, ...] = (DOWN_AUDIO, DOWN_AUDIO, DOWN_AUDIO,
                                         DOWN_RES)
    mid_block_type: str = MID_AUDIO
    up_block_types: Tuple[str, ...] = (UP_RES, UP_AUDIO, UP_AUDIO, UP_AUDIO)
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    cross_attention_dim: int = 768
    audio_cross_attention_dim: int = 768
    attention_head_dim: int = 8  # == number of heads (diffusers SD1.5 naming)
    flip_sin_to_cos: bool = True
    freq_shift: float = 0.0

    @classmethod
    def tiny(cls, **kw) -> "UNet3DConfig":
        """Small config for unit tests (the JAX package's `tiny`)."""
        defaults = dict(block_out_channels=(32, 64), layers_per_block=1,
                        down_block_types=(DOWN_AUDIO, DOWN_RES),
                        up_block_types=(UP_RES, UP_AUDIO),
                        norm_num_groups=8, attention_head_dim=2)
        defaults.update(kw)
        return cls(**defaults)


class AudioUNet3D(nn.Module):
    def __init__(self, config: UNet3DConfig = UNet3DConfig()):
        super().__init__()
        cfg = self.config = config
        ch = cfg.block_out_channels
        temb = ch[0] * 4
        heads = cfg.attention_head_dim
        common = dict(groups=cfg.norm_num_groups, eps=cfg.norm_eps,
                      num_heads=heads,
                      cross_attention_dim=cfg.cross_attention_dim,
                      audio_cross_attention_dim=cfg.audio_cross_attention_dim)
        self.time_embedding = TimestepEmbedding(ch[0], temb)
        self.conv_in = FFInflatedConv(cfg.in_channels, ch[0])

        self.down_blocks = nn.ModuleList()
        prev = ch[0]
        for i, btype in enumerate(cfg.down_block_types):
            self.down_blocks.append(DownBlock(
                prev, ch[i], temb, cfg.layers_per_block,
                add_downsample=i < len(ch) - 1,
                has_attention=btype in (DOWN_AUDIO, DOWN_TEXT),
                use_audio=btype == DOWN_AUDIO, **common))
            prev = ch[i]

        self.mid_block = MidBlock(ch[-1], temb,
                                  use_audio=cfg.mid_block_type == MID_AUDIO,
                                  **common)

        rev = list(reversed(ch))
        self.up_blocks = nn.ModuleList()
        prev = ch[-1]
        for i, btype in enumerate(cfg.up_block_types):
            self.up_blocks.append(UpBlock(
                rev[min(i + 1, len(ch) - 1)], prev, rev[i], temb,
                cfg.layers_per_block + 1, add_upsample=i < len(ch) - 1,
                has_attention=btype in (UP_AUDIO, UP_TEXT),
                use_audio=btype == UP_AUDIO, **common))
            prev = rev[i]

        self.conv_norm_out = VideoGroupNorm(cfg.norm_num_groups, ch[0],
                                            cfg.norm_eps)
        self.conv_out = FFInflatedConv(ch[0], cfg.out_channels)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                text_context: Optional[torch.Tensor],
                audio_context: Optional[torch.Tensor] = None,
                audio_mask: Optional[torch.Tensor] = None,
                audio_token_indices=None,
                fuse_blocks: bool = False) -> torch.Tensor:
        """sample (b, f, h, w, c_in) -> eps (b, f, h, w, c_out).
        fuse_blocks=True is the generation variant (B2 per block)."""
        cfg = self.config
        b, f = sample.shape[:2]
        dtype = self.conv_in.weight.dtype
        if audio_token_indices is None and audio_mask is not None:
            audio_token_indices = mask_to_token_indices(audio_mask)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(b)

        t_emb = sinusoidal_timestep_embedding(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift).to(dtype)
        emb = self.time_embedding(t_emb)
        emb = emb[:, None, :].expand(b, f, emb.shape[-1])

        if text_context is not None:
            text_context = text_context.to(dtype)
        if audio_context is not None:
            audio_context = audio_context.to(dtype)
        ctx = (text_context, audio_context, audio_token_indices, fuse_blocks)

        x = self.conv_in(sample.to(dtype))
        res_stack = [x]
        for block in self.down_blocks:
            x, residuals = block(x, emb, *ctx)
            res_stack.extend(residuals)

        x = self.mid_block(x, emb, *ctx)

        for block in self.up_blocks:
            n = len(block.resnets)
            skips = res_stack[-n:]
            del res_stack[-n:]
            x = block(x, skips, emb, *ctx)

        x = F.silu(self.conv_norm_out(x))
        return self.conv_out(x)
