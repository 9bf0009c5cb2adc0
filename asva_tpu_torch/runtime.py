"""Model construction for the port (counterpart of asva_tpu/runtime.py).

Builders create the full-size modules with seeded random parameters drawn
from an explicit `torch.Generator` on the target device.  No released
weights ship with the repository; the modules use the reference's torch key
space, so such weights load later with `load_state_dict(strict=True)`.

Every `build_*` function and `load_animation_pipeline` runs on the CUDA card
unless the caller passes device="cpu".
An inference build stores every parameter in `dtype`, frozen, in eval mode.
A training build (`build_unet(..., train=True)`) keeps fp32 parameters with
`dtype` as the compute dtype (cast at use, as asva_tpu trains), leaves
`requires_grad` to `training.optim.apply_trainable_mask` and stays in train
mode.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Optional

import torch
from torch import nn

from .diffusion.schedules import DiffusionSchedule
from .models.imagebind_audio import ImageBindAudioConfig, SegmaskAudioEncoder
from .models.unet3d import AudioUNet3D, UNet3DConfig
from .models.vae import AutoencoderKL, VAEConfig
from .pipelines.animation import AnimationPipeline

# parameters the reference initialises to zero: the FF temporal mixes and
# the temporal attention's output projection
_ZERO_INIT = ("conv_temp.", "attn_temp.to_out.")
# parameters the reference draws from normal(0, 0.02)
_SMALL_NORMAL = ("pos_embed", "bias_k", "bias_v")


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator,
                     randomize_all: bool = False) -> nn.Module:
    """Seeded random init in the reference's scheme: fan-in normal
    (std 1/sqrt(fan_in)) for weights, zeros for biases and the zero-init
    temporal layers, ones/zeros for norms, normal(0.02) for the audio
    tower's positional table and bias_k/v.  randomize_all=True draws every
    parameter, the zero-init ones included (norm scales 1 + 0.1 N, biases
    and zero-init vectors 0.1 N), so that every sub-layer contributes."""
    for name, p in module.named_parameters():
        def normal_(std, mean=0.0):
            p.copy_(torch.randn(p.shape, generator=generator,
                                device=p.device, dtype=torch.float32)
                    * std + mean)
        leaf = name.rsplit(".", 1)[-1]
        if any(s in name for s in _SMALL_NORMAL):
            normal_(0.02)
        elif name.endswith("cls_token"):
            normal_(0.02) if randomize_all else p.zero_()
        elif p.dim() >= 2:
            zero = any(s in name for s in _ZERO_INIT)
            if zero and not randomize_all:
                p.zero_()
            else:
                normal_(1.0 / math.sqrt(p[0].numel()))
        elif leaf == "bias" or any(s in name for s in _ZERO_INIT):
            normal_(0.1) if randomize_all else p.zero_()
        else:  # norm scales
            normal_(0.1, 1.0) if randomize_all else p.fill_(1.0)
    return module


def _build(factory, device, dtype, seed: int, randomize_all: bool,
           train: bool = False):
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_parameters_(module, gen, randomize_all)
    if train:
        return module.train()
    return module.to(dtype).eval().requires_grad_(False)


def build_unet(config: UNet3DConfig = UNet3DConfig(), device="cuda",
               dtype=torch.bfloat16, seed: int = 0,
               randomize_all: bool = False,
               train: bool = False) -> AudioUNet3D:
    """train=True: fp32 parameters that all require grad, `dtype` as the
    compute dtype, train mode; the values are those of the inference build
    before its cast to `dtype`."""
    return _build(lambda: AudioUNet3D(config, compute_dtype=dtype), device,
                  dtype, seed, randomize_all, train)


def build_vae(config: VAEConfig = VAEConfig(), device="cuda",
              dtype=torch.bfloat16, seed: int = 1,
              randomize_all: bool = False) -> AutoencoderKL:
    return _build(lambda: AutoencoderKL(config), device, dtype, seed,
                  randomize_all)


def build_audio_encoder(n_segment: int = 12,
                        config: Optional[ImageBindAudioConfig] = None,
                        device="cuda", dtype=torch.bfloat16, seed: int = 2,
                        randomize_all: bool = False) -> SegmaskAudioEncoder:
    cfg = config or ImageBindAudioConfig()
    return _build(lambda: SegmaskAudioEncoder(cfg, n_segment), device, dtype,
                  seed, randomize_all)


def _config_from_dict(cls, d: dict):
    """Rebuild a config dataclass from a modules_config.json dict: unknown
    keys are dropped (forward compat), lists become tuples."""
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in d.items() if k in fields})


def load_module_configs(checkpoint_modules_dir: Optional[str]):
    """Read checkpoint-N/modules_config.json (written next to the module
    exports) if present; returns a dict or None."""
    if not checkpoint_modules_dir:
        return None
    path = os.path.join(os.path.dirname(
        os.path.abspath(checkpoint_modules_dir)), "modules_config.json")
    if not os.path.isfile(path):
        return None
    with open(path) as f:
        return json.load(f)


def load_animation_pipeline(
        checkpoint_modules_dir: Optional[str] = None,
        n_segment: int = 12, device="cuda", dtype=torch.bfloat16,
        unet_config: Optional[UNet3DConfig] = None,
        vae_config: Optional[VAEConfig] = None,
        seed: int = 0, randomize_all: bool = False,
        null_text_encoding: Optional[torch.Tensor] = None,
) -> AnimationPipeline:
    """The generation pipeline with seeded random weights.  unet_config
    None: the architecture recorded in the checkpoint's
    modules_config.json when present, else the full-size default."""
    mod_cfgs = load_module_configs(checkpoint_modules_dir) or {}
    audio_config = None
    if unet_config is None and "unet" in mod_cfgs:
        unet_config = _config_from_dict(UNet3DConfig, mod_cfgs["unet"])
    if "audio_encoder" in mod_cfgs:
        audio_config = _config_from_dict(ImageBindAudioConfig,
                                         mod_cfgs["audio_encoder"])
    unet = build_unet(unet_config or UNet3DConfig(), device, dtype, seed,
                      randomize_all)
    vae = build_vae(vae_config or VAEConfig(), device, dtype, seed + 1,
                    randomize_all)
    audio = build_audio_encoder(n_segment, audio_config, device, dtype,
                                seed + 2, randomize_all)
    return AnimationPipeline(unet=unet, vae=vae, audio_encoder=audio,
                             schedule=DiffusionSchedule(),
                             null_text_encoding=null_text_encoding)
