"""AudioUNet3D — first-frame-conditioned audio-driven video diffusion UNet.

Port of asva_tpu/models/unet3d/model.py:86.  Channels-last (b, f, h, w, c)
video, a per-frame time embedding, text context (b, 77, 768) and audio
context (b, 229, 768) broadcast over frames inside the attention, and the
audio segment masks as a static per-frame token gather (`audio_token_indices`
(f, m); a boolean `audio_mask` (b, f, 229) is converted to it).

`fuse_blocks` selects the generation variant (one B2 call per transformer
block for attn1 + audio-x + text-x) over three B1 calls; both variants
compute the same function.

Parameters are cast at use to the compute dtype (`compute_dtype`; None: the
dtype of `conv_in.weight`), so a training build may keep fp32 parameters
under bf16 activations.

Remat (`UNet3DConfig.remat`, `remat_policy`) is `torch.utils.checkpoint`
(non-reentrant) around whole down / mid / up blocks while gradients are
enabled, with asva_tpu's policies and level choices (its `maybe_remat`,
model.py:125-149; level 0 is the highest resolution, the mid block the
lowest):
  "full"       every level;
  "highres"    levels 0 and 1;
  "l0"         level 0 only;
  "saveconv"   levels 0 and 1, each keeping the values tagged conv_out,
               sublayer_x, attn_res and block_out (ops/remat.py): the recompute
               runs no tagged convolution, no fused attention or FF forward
               and no flash forward (B4), so B4 runs once a step and B5
               reads its saved o and lse;
  "saveconv0"  saveconv's saves at level 0, a full remat at level 1;
  "dots"       every level, keeping each product without batch dimensions
               (asva_tpu's dots_with_no_batch_dims_saveable): the outputs
               of F.linear, the 1x1 convs proj_in / proj_out among them, and
               K-gemm's products in the fused sub-layers (q and the output
               projection in B1, the FF's output in B3).  The 3x3
               convolutions, the flash forward and the temporal attention's
               batched products are recomputed, as in asva_tpu.
An unknown policy raises ValueError.  Remat changes no output and no
gradient: only what is kept and what runs again.

Frame sharding (generation across a seq axis, `pipelines/animation.py`):
`forward(..., frames=FrameShard)` runs this rank's frames and carries the
frame-shard context down to the norms, the temporal mixes and the
attentions that reach across frames; the audio token indices are this
rank's rows of the per-frame gather.  The frame exchanges have no
backward, so a frame-sharded forward refuses to build a graph.  With no
context the UNet computes what it always did, bit for bit.

FSDP (`parallel/sharding.py`): where parameters are split, each unit (the
stem: time embedding and conv_in; each down block, the mid block and each
up block; the head: conv_norm_out and conv_out) runs on its parameters
gathered for that unit alone, which are freed with the unit's outputs.
Under autograd every unit is rematerialised, so its backward gathers
again in the recompute: under FSDP remat covers every level, a level that
the policy rematerialises with its saves, any other in full.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ...observability import span
from ...ops import remat
from ...ops.norms import VideoGroupNorm
from ...parallel import sharding
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
    remat: bool = False
    remat_policy: str = "full"  # see the module docstring

    @classmethod
    def tiny(cls, **kw) -> "UNet3DConfig":
        """Small config for unit tests (the JAX package's `tiny`)."""
        defaults = dict(block_out_channels=(32, 64), layers_per_block=1,
                        down_block_types=(DOWN_AUDIO, DOWN_RES),
                        up_block_types=(UP_RES, UP_AUDIO),
                        norm_num_groups=8, attention_head_dim=2)
        defaults.update(kw)
        return cls(**defaults)


def _call(module, fsdp: bool, *args):
    """module(*args); under FSDP on its gathered parameters."""
    return sharding.call_gathered(module, *args) if fsdp else module(*args)


def _spanned(name: str, module, fsdp: bool, *args):
    """_call inside span(name): a block's forward, and its recompute where
    the block is rematerialised."""
    with span(name):
        return _call(module, fsdp, *args)


def _unit(fn, saves, *args):
    """fn(*args); rematerialised in the backward unless `saves` is None,
    keeping the values tagged with the names in `saves`."""
    if saves is None:
        return fn(*args)
    if not saves:
        return checkpoint(fn, *args, use_reentrant=False)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=remat.policy(saves))


REMAT_POLICIES = ("full", "highres", "l0", "saveconv", "saveconv0", "dots")
_SAVECONV = (remat.CONV_OUT, remat.SUBLAYER_X,
             remat.ATTN_RES, remat.BLOCK_OUT)


def remat_saves_at(policy: str, level: int):
    """What `policy` does at resolution `level` (asva_tpu's maybe_remat):
    None, no remat; (), a full remat; else the names the unit keeps."""
    if policy == "dots":
        return (remat.DOT,)
    if policy in ("highres", "saveconv", "saveconv0") and level >= 2:
        return None
    if policy == "l0" and level >= 1:
        return None
    if policy == "saveconv" or (policy == "saveconv0" and level == 0):
        return _SAVECONV
    return ()


class AudioUNet3D(nn.Module):
    def __init__(self, config: UNet3DConfig = UNet3DConfig(),
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        cfg = self.config = config
        if cfg.remat_policy not in REMAT_POLICIES:
            raise ValueError(f"unknown remat_policy {cfg.remat_policy!r}; "
                             f"known: {list(REMAT_POLICIES)}")
        self.compute_dtype = compute_dtype
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
        # the blocks' span names, made once (observability.span)
        self._down_spans = tuple(f"unet.down.{i}"
                                 for i in range(len(self.down_blocks)))
        self._up_spans = tuple(f"unet.up.{i}"
                               for i in range(len(self.up_blocks)))
        # the sampler loop's CUDA graphs while one is open (graphs.py)
        self._graphs = None

    def _run_block(self, block, level: int, *args, fsdp: bool = False,
                   name: str = "unet.block"):
        """block(*args) inside span(name), rematerialised in the backward
        as the config's policy has it at this resolution level; under FSDP
        on its gathered parameters, and always rematerialised."""
        saves = None
        if torch.is_grad_enabled():
            if self.config.remat:
                saves = remat_saves_at(self.config.remat_policy, level)
            if fsdp and saves is None:
                saves = ()
        return _unit(functools.partial(_spanned, name, block, fsdp), saves,
                     *args)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                text_context: Optional[torch.Tensor],
                audio_context: Optional[torch.Tensor] = None,
                audio_mask: Optional[torch.Tensor] = None,
                audio_token_indices=None, fuse_blocks: bool = False,
                frames=None) -> torch.Tensor:
        """sample (b, f, h, w, c_in) -> eps (b, f, h, w, c_out).
        fuse_blocks=True is the generation variant (B2 per block).  With
        `frames` (a FrameShard), sample holds this rank's f frames of the
        global video, and the audio mask or token indices are global.
        Inside `graphs.segmented(self, calls)` the call may be a replay of
        CUDA graphs (models/unet3d/graphs.py)."""
        args = (sample, timesteps, text_context, audio_context, audio_mask,
                audio_token_indices, fuse_blocks, frames)
        if self._graphs is not None:
            return self._graphs(self._forward, *args)
        return self._forward(*args)

    def _forward(self, sample, timesteps, text_context, audio_context,
                 audio_mask, audio_token_indices, fuse_blocks, frames):
        cfg = self.config
        b, f = sample.shape[:2]
        dtype = self.compute_dtype or self.conv_in.weight.dtype
        if audio_token_indices is None and audio_mask is not None:
            audio_token_indices = mask_to_token_indices(audio_mask)
        if frames is not None:
            if torch.is_grad_enabled():
                raise RuntimeError("a frame-sharded UNet forward runs "
                                   "without gradients (torch.no_grad())")
            if audio_token_indices is not None:
                audio_token_indices = audio_token_indices[
                    frames.offset:frames.offset + f]
        fsdp = sharding.sharded(self)
        timesteps = torch.as_tensor(timesteps, device=sample.device)
        if timesteps.dim() == 0:
            timesteps = timesteps.expand(b)

        t_emb = sinusoidal_timestep_embedding(
            timesteps, cfg.block_out_channels[0],
            flip_sin_to_cos=cfg.flip_sin_to_cos,
            downscale_freq_shift=cfg.freq_shift).to(dtype)
        if text_context is not None:
            text_context = text_context.to(dtype)
        if audio_context is not None:
            audio_context = audio_context.to(dtype)
        ctx = (text_context, audio_context, audio_token_indices, fuse_blocks,
               frames)
        top = len(cfg.block_out_channels) - 1
        run = functools.partial(self._run_block, fsdp=fsdp)
        edges = () if fsdp and torch.is_grad_enabled() else None

        def stem(sample, t_emb):
            return (_call(self.time_embedding, fsdp, t_emb),
                    _call(self.conv_in, fsdp, sample, frames))

        def head(x):
            x = F.silu(_call(self.conv_norm_out, fsdp, x, frames))
            return _call(self.conv_out, fsdp, x, frames)

        emb, x = _unit(stem, edges, sample.to(dtype), t_emb)
        emb = emb[:, None, :].expand(b, f, emb.shape[-1])
        res_stack = [x]
        for level, block in enumerate(self.down_blocks):
            x, residuals = run(block, level, x, emb, *ctx,
                               name=self._down_spans[level])
            res_stack.extend(residuals)

        x = run(self.mid_block, top, x, emb, *ctx, name="unet.mid")

        for i, block in enumerate(self.up_blocks):
            n = len(block.resnets)
            skips = tuple(res_stack[-n:])
            del res_stack[-n:]
            # up level i mirrors down level (top - i) in resolution
            x = run(block, top - i, x, skips, emb, *ctx,
                    name=self._up_spans[i])

        return _unit(head, edges, x)
