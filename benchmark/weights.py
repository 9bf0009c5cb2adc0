"""Seeded weights in the reference's torch key space, drawn on the card.

One `torch.randn` over all of a module's parameters, cut into views and
scaled in place by the rule the system's random init documents with every
parameter drawn ("randomize_all"), so that every sub-layer, the zero-init
temporal and audio layers included, carries signal and gradient: weights
normal with std 1/sqrt(fan_in); biases and other vectors 0.1 N; norm
scales 1 + 0.1 N; the audio tower's positional table, CLS token and
bias_k/v 0.02 N.  The same seed gives the same tensors, so the reference
re-draws them after the window instead of keeping a copy.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from .reference.audio import AudioTower
from .reference.unet import UNet3D
from .reference.vae import VAE

_SMALL = ("pos_embed", "bias_k", "bias_v", "cls_token")
MODULES = {"unet": UNet3D, "vae": VAE, "audio": AudioTower}
SEED_OFFSET = {"unet": 11, "vae": 12, "audio": 13}


def shapes(cfg: dict, name: str) -> Dict[str, torch.Size]:
    with torch.device("meta"):
        module = MODULES[name](cfg[name])
    return {n: p.shape for n, p in module.named_parameters()}


def _rule(name: str, shape) -> tuple:
    """(std, mean) of a parameter; a vector named `weight` is a norm's
    scale."""
    if any(s in name for s in _SMALL):
        return 0.02, 0.0
    if len(shape) >= 2:
        return 1.0 / math.sqrt(math.prod(shape[1:])), 0.0
    return (0.1, 1.0) if name.endswith(".weight") else (0.1, 0.0)


def draw(cfg: dict, name: str, seed: int, device) -> Dict[str, torch.Tensor]:
    """Module `name`'s state dict (float32, on `device`) for `seed`."""
    sh = shapes(cfg, name)
    total = sum(math.prod(s) for s in sh.values())
    gen = torch.Generator(device=device).manual_seed(
        (seed * 1_000_003 + SEED_OFFSET[name]) % (1 << 63))
    flat = torch.randn(total, generator=gen, device=device)
    out, i = {}, 0
    for n, s in sh.items():
        k = math.prod(s)
        std, mean = _rule(n, s)
        out[n] = flat[i:i + k].view(s).mul_(std).add_(mean)
        i += k
    return out


def draw_all(cfg: dict, seed: int, device) -> Dict[str, dict]:
    return {name: draw(cfg, name, seed, device) for name in MODULES}
