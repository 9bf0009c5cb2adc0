"""ImageBind-huge vision and text towers, for the CLIP-consistency metrics.

Port of asva_tpu/models/imagebind_extra.py, in imagebind_huge.pth's key
space (`imagebind_vision_key_map`, `imagebind_text_key_map`: modality_
preprocessors / modality_trunks / modality_heads).  The eval compares unit
embeddings: ia_sim = <vision, audio / 20>, it_sim = <vision, text>.

  vision: ViT-H.  The image is duplicated to a 2-frame clip and patchified
    by a (2, 14, 14) conv of stride (2, 14, 14) (224^2 -> 256 tokens) + CLS,
    learnable positions, a LayerNorm before the trunk, 32 blocks of width
    1280 / 16 heads; head = LayerNorm -> CLS -> Linear(1280 -> 1024, no
    bias); then L2 normalisation.
  text: CLIP-style.  77 tokens, width 1024, 24 blocks / 16 heads with a
    causal mask, token + position embeddings, final LayerNorm, pooling at
    the end-of-text token (the argmax of the ids), projection to 1024; then
    L2 normalisation.
Both trunks use the audio tower's TrunkBlock (LayerNorm eps 1e-6) without
bias_k / bias_v; called with a mask it is the JAX `_MaskedTrunkBlock`.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.norms import AdaptiveOrLayerNorm
from .clip_text import causal_mask
from .imagebind_audio import TrunkBlock


def _unit(emb: torch.Tensor) -> torch.Tensor:
    return emb / emb.norm(dim=-1, keepdim=True)


@dataclasses.dataclass(frozen=True)
class ImageBindVisionConfig:
    embed_dim: int = 1280
    out_embed_dim: int = 1024
    num_blocks: int = 32
    num_heads: int = 16
    image_size: int = 224
    patch_size: int = 14
    mlp_ratio: float = 4.0
    add_bias_kv: bool = False

    @classmethod
    def tiny(cls, **kw) -> "ImageBindVisionConfig":
        d = dict(embed_dim=32, out_embed_dim=16, num_blocks=2, num_heads=2,
                 image_size=28, patch_size=14)
        d.update(kw)
        return cls(**d)


class _Named(nn.Module):
    """A container whose children carry the checkpoint's key segments."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            if isinstance(child, nn.Parameter):
                self.register_parameter(name, child)
            else:
                self.add_module(name, child)


def _trunk(cfg, pre_ln: bool) -> _Named:
    children = dict(blocks=nn.ModuleList(
        [TrunkBlock(cfg) for _ in range(cfg.num_blocks)]))
    if pre_ln:
        children["pre_transformer_layer"] = nn.ModuleList(
            [AdaptiveOrLayerNorm(cfg.embed_dim, 1e-6)])
    return _Named(**children)


class ImageBindVisionEncoder(nn.Module):
    """images (b, 224, 224, 3), CLIP-normalised -> (b, 1024) unit
    embeddings."""

    def __init__(self, config: ImageBindVisionConfig = ImageBindVisionConfig()):
        super().__init__()
        self.config = cfg = config
        e, p = cfg.embed_dim, cfg.patch_size
        n = (cfg.image_size // p) ** 2
        # proj.0 is the checkpoint's PadIm2Video (no parameters)
        stem = _Named(proj=nn.ModuleList([
            nn.Identity(), nn.Conv3d(3, e, (2, p, p), (2, p, p), bias=False)]))
        self.modality_preprocessors = _Named(vision=_Named(
            cls_token=nn.Parameter(torch.zeros(1, 1, e)),
            rgbt_stem=stem,
            pos_embedding_helper=_Named(
                pos_embed=nn.Parameter(torch.zeros(1, n + 1, e)))))
        self.modality_trunks = _Named(vision=_trunk(cfg, pre_ln=True))
        self.modality_heads = _Named(vision=nn.ModuleList([
            AdaptiveOrLayerNorm(e, 1e-6), nn.Identity(),
            nn.Linear(e, cfg.out_embed_dim, bias=False)]))

    def forward(self, images: torch.Tensor,
                normalize: bool = True) -> torch.Tensor:
        pre = self.modality_preprocessors.vision
        trunk = self.modality_trunks.vision
        head = self.modality_heads.vision
        conv = pre.rgbt_stem.proj[1]
        b = images.shape[0]
        x = images.to(conv.weight.dtype).permute(0, 3, 1, 2)
        x = conv(x[:, :, None].expand(-1, -1, 2, -1, -1))  # (b, e, 1, gh, gw)
        x = x.flatten(2).transpose(1, 2)                    # (b, n, e)
        x = torch.cat([pre.cls_token.to(x.dtype).expand(b, -1, -1), x], dim=1)
        x = x + pre.pos_embedding_helper.pos_embed.to(x.dtype)
        x = trunk.pre_transformer_layer[0](x)
        for block in trunk.blocks:
            x = block(x)
        emb = head[2](head[0](x[:, 0]))
        return _unit(emb) if normalize else emb


@dataclasses.dataclass(frozen=True)
class ImageBindTextConfig:
    vocab_size: int = 49408
    embed_dim: int = 1024
    out_embed_dim: int = 1024
    num_blocks: int = 24
    num_heads: int = 16
    context_length: int = 77
    mlp_ratio: float = 4.0
    add_bias_kv: bool = False

    @classmethod
    def tiny(cls, **kw) -> "ImageBindTextConfig":
        d = dict(vocab_size=64, embed_dim=32, out_embed_dim=16, num_blocks=2,
                 num_heads=2, context_length=12)
        d.update(kw)
        return cls(**d)


class ImageBindTextEncoder(nn.Module):
    """input_ids (b, 77) -> (b, 1024) unit embeddings, pooled at the
    end-of-text token."""

    def __init__(self, config: ImageBindTextConfig = ImageBindTextConfig()):
        super().__init__()
        self.config = cfg = config
        e = cfg.embed_dim
        self.modality_preprocessors = _Named(text=_Named(
            token_embedding=nn.Embedding(cfg.vocab_size, e),
            pos_embed=nn.Parameter(torch.zeros(1, cfg.context_length, e))))
        self.modality_trunks = _Named(text=_trunk(cfg, pre_ln=False))
        self.modality_heads = _Named(text=_Named(proj=nn.ModuleList([
            AdaptiveOrLayerNorm(e, 1e-6),
            nn.Linear(e, cfg.out_embed_dim, bias=False)])))

    def forward(self, input_ids: torch.Tensor,
                normalize: bool = True) -> torch.Tensor:
        pre = self.modality_preprocessors.text
        proj = self.modality_heads.text.proj
        b, n = input_ids.shape
        ids = input_ids.long()
        x = pre.token_embedding(ids)
        x = x + pre.pos_embed[:, :n].to(x.dtype)
        mask = causal_mask(n, x.device)
        for block in self.modality_trunks.text.blocks:
            x = block(x, mask)
        x = proj[0](x)
        eos = ids.argmax(dim=-1)            # the highest id is end-of-text
        emb = proj[1](x[torch.arange(b, device=x.device), eos])
        return _unit(emb) if normalize else emb
