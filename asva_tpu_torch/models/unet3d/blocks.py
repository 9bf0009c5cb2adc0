"""UNet down / mid / up blocks (port of asva_tpu/models/unet3d/blocks.py).
`frames` (a `parallel.mesh.FrameShard`, or None) is passed down to every
resnet, transformer and resampler."""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn

from .resnet import FFDownsample, FFResnetBlock, FFUpsample
from .transformer import SpatioAudioTempTransformer3D


def _attention(out_channels, num_heads, groups, cross_dim, audio_dim,
               use_audio):
    return SpatioAudioTempTransformer3D(
        num_heads, out_channels // num_heads, out_channels,
        norm_num_groups=groups, cross_attention_dim=cross_dim,
        audio_cross_attention_dim=audio_dim, use_audio=use_audio)


class DownBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: int, num_layers: int = 2, groups: int = 32,
                 eps: float = 1e-5, add_downsample: bool = True,
                 has_attention: bool = False, use_audio: bool = False,
                 num_heads: int = 8, cross_attention_dim: int = 768,
                 audio_cross_attention_dim: int = 768):
        super().__init__()
        self.resnets = nn.ModuleList([
            FFResnetBlock(in_channels if i == 0 else out_channels,
                          out_channels, temb_channels, groups, eps)
            for i in range(num_layers)])
        self.attentions = nn.ModuleList([
            _attention(out_channels, num_heads, groups, cross_attention_dim,
                       audio_cross_attention_dim, use_audio)
            for _ in range(num_layers)]) if has_attention else None
        self.downsamplers = (nn.ModuleList([FFDownsample(out_channels)])
                             if add_downsample else None)

    def forward(self, x, temb, text_context=None, audio_context=None,
                audio_token_indices=None, fuse_blocks: bool = False,
                frames=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        residuals = []
        for i, resnet in enumerate(self.resnets):
            x = resnet(x, temb, frames)
            if self.attentions is not None:
                x = self.attentions[i](x, text_context, audio_context,
                                       audio_token_indices, fuse_blocks,
                                       frames)
            residuals.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x, frames)
            residuals.append(x)
        return x, residuals


class MidBlock(nn.Module):
    def __init__(self, channels: int, temb_channels: int, num_layers: int = 1,
                 groups: int = 32, eps: float = 1e-5, use_audio: bool = True,
                 num_heads: int = 8, cross_attention_dim: int = 768,
                 audio_cross_attention_dim: int = 768):
        super().__init__()
        self.resnets = nn.ModuleList([
            FFResnetBlock(channels, channels, temb_channels, groups, eps)
            for _ in range(num_layers + 1)])
        self.attentions = nn.ModuleList([
            _attention(channels, num_heads, groups, cross_attention_dim,
                       audio_cross_attention_dim, use_audio)
            for _ in range(num_layers)])

    def forward(self, x, temb, text_context=None, audio_context=None,
                audio_token_indices=None, fuse_blocks: bool = False,
                frames=None):
        x = self.resnets[0](x, temb, frames)
        for attn, resnet in zip(self.attentions, self.resnets[1:]):
            x = attn(x, text_context, audio_context, audio_token_indices,
                     fuse_blocks, frames)
            x = resnet(x, temb, frames)
        return x


class UpBlock(nn.Module):
    """Resnet j takes the previous output concatenated with one skip
    (diffusers' channel bookkeeping: the last skip has `in_channels`)."""

    def __init__(self, in_channels: int, prev_output_channels: int,
                 out_channels: int, temb_channels: int, num_layers: int = 3,
                 groups: int = 32, eps: float = 1e-5,
                 add_upsample: bool = True, has_attention: bool = False,
                 use_audio: bool = False, num_heads: int = 8,
                 cross_attention_dim: int = 768,
                 audio_cross_attention_dim: int = 768):
        super().__init__()
        resnets = []
        for j in range(num_layers):
            skip = in_channels if j == num_layers - 1 else out_channels
            prev = prev_output_channels if j == 0 else out_channels
            resnets.append(FFResnetBlock(prev + skip, out_channels,
                                         temb_channels, groups, eps))
        self.resnets = nn.ModuleList(resnets)
        self.attentions = nn.ModuleList([
            _attention(out_channels, num_heads, groups, cross_attention_dim,
                       audio_cross_attention_dim, use_audio)
            for _ in range(num_layers)]) if has_attention else None
        self.upsamplers = (nn.ModuleList([FFUpsample(out_channels)])
                           if add_upsample else None)

    def forward(self, x, res_states: Sequence[torch.Tensor], temb,
                text_context=None, audio_context=None,
                audio_token_indices=None, fuse_blocks: bool = False,
                frames=None):
        # read, never popped: a rematerialised block runs this twice
        for i, resnet in enumerate(self.resnets):
            x = resnet(torch.cat([x, res_states[-1 - i]], dim=-1), temb,
                       frames)
            if self.attentions is not None:
                x = self.attentions[i](x, text_context, audio_context,
                                       audio_token_indices, fuse_blocks,
                                       frames)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, frames)
        return x
