"""CLIP ViT-L/14 text encoder: SD1.5's frozen text conditioner.

Port of asva_tpu/models/clip_text.py, in HF CLIPTextModel's key space
(`clip_text_key_map`: text_model.embeddings / encoder.layers.N / final_
layer_norm).  Vocabulary 49408, width 768, 12 layers, 12 heads, 77
positions, quick-gelu, causal mask, final LayerNorm; the conditioning is the
full last_hidden_state (b, 77, 768).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.attention import dot_product_attention
from ..ops.norms import AdaptiveOrLayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_positions: int = 77
    intermediate_size: int = 3072

    @classmethod
    def tiny(cls, **kw) -> "CLIPTextConfig":
        d = dict(vocab_size=100, hidden_size=32, num_layers=2, num_heads=2,
                 max_positions=16, intermediate_size=64)
        d.update(kw)
        return cls(**d)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


def causal_mask(n: int, device) -> torch.Tensor:
    """(1, 1, n, n) boolean, True = attend: position i sees j <= i."""
    return torch.ones(n, n, dtype=torch.bool, device=device).tril()[None, None]


class _SelfAttention(nn.Module):
    def __init__(self, e: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.q_proj = nn.Linear(e, e)
        self.k_proj = nn.Linear(e, e)
        self.v_proj = nn.Linear(e, e)
        self.out_proj = nn.Linear(e, e)

    def forward(self, h: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        shape = h.shape[:-1] + (self.num_heads, h.shape[-1] // self.num_heads)
        attn = dot_product_attention(self.q_proj(h).reshape(shape),
                                     self.k_proj(h).reshape(shape),
                                     self.v_proj(h).reshape(shape), mask=mask)
        return self.out_proj(attn.reshape(h.shape))


class _Mlp(nn.Module):
    def __init__(self, e: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(e, hidden)
        self.fc2 = nn.Linear(hidden, e)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return self.fc2(quick_gelu(self.fc1(h)))


class CLIPTextBlock(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = AdaptiveOrLayerNorm(cfg.hidden_size, 1e-5)
        self.self_attn = _SelfAttention(cfg.hidden_size, cfg.num_heads)
        self.layer_norm2 = AdaptiveOrLayerNorm(cfg.hidden_size, 1e-5)
        self.mlp = _Mlp(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.layer_norm1(x), mask)
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_positions,
                                               cfg.hidden_size)


class _Encoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([CLIPTextBlock(cfg)
                                     for _ in range(cfg.num_layers)])


class _TextTransformer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.final_layer_norm = AdaptiveOrLayerNorm(cfg.hidden_size, 1e-5)


class CLIPTextModel(nn.Module):
    """input_ids (b, n <= 77) -> last_hidden_state (b, n, hidden)."""

    def __init__(self, config: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.config = config
        self.text_model = _TextTransformer(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tm = self.text_model
        n = input_ids.shape[1]
        x = tm.embeddings.token_embedding(input_ids.long())
        x = x + tm.embeddings.position_embedding.weight[None, :n].to(x.dtype)
        mask = causal_mask(n, x.device)
        for block in tm.encoder.layers:
            x = block(x, mask)
        return tm.final_layer_norm(x)


def tokenize(texts, max_length: int = 77,
             tokenizer_path: str = "pretrained/stable-diffusion-v1-5/tokenizer"
             ) -> torch.Tensor:
    """CLIP BPE tokenisation on the host -> (n, max_length) int64 ids,
    end-of-text padded (the SD1.5 text encoder consumes all 77 positions).
    `tokenizer_path` holds vocab.json + merges.txt or ImageBind's
    bpe_simple_vocab_16e6.txt.gz; see models/clip_bpe.py."""
    from .clip_bpe import ClipBPETokenizer
    tok = ClipBPETokenizer.from_pretrained(tokenizer_path)
    return torch.from_numpy(tok(texts, context_length=max_length,
                                pad="eot")).long()
