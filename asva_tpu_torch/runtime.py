"""Model construction for the port (counterpart of asva_tpu/runtime.py).

Builders create the full-size modules with seeded random parameters drawn
from an explicit `torch.Generator` on the target device, then load weights
when they are given (`weights_dir`): a module directory in the reference's
layout (`diffusion_pytorch_model.*`, `pytorch_model.*`, `model.safetensors`),
a weights file, or one of the port's own exports (`CheckpointManager` writes
`checkpoint-N/modules/<name>.pt`; `<dir>/<name>` finds `<dir>/<name>.pt`).
The modules use the reference's torch key space, so such weights load
strictly; a missing path keeps the seeded init with a warning, as in
asva_tpu.  No released weights ship with the repository.

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
import logging
import math
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from .convert import (load_exported, load_report, load_source_state,
                      to_port_keys)
from .diffusion.schedules import DiffusionSchedule
from .models.avsync import AVSyncClassifier
from .models.clip_text import CLIPTextConfig, CLIPTextModel
from .models.evalnets import InceptionI3D
from .models.imagebind_audio import ImageBindAudioConfig, SegmaskAudioEncoder
from .models.unet3d import AudioUNet3D, UNet3DConfig
from .models.vae import AutoencoderKL, VAEConfig
from .pipelines.animation import AnimationPipeline

log = logging.getLogger("asva_tpu_torch")

# parameters the reference initialises to zero: the FF temporal mixes and
# the temporal attention's output projection
_ZERO_INIT = ("conv_temp.", "attn_temp.to_out.")
# parameters the reference draws from normal(0, 0.02)
_SMALL_NORMAL = ("pos_embed", "bias_k", "bias_v")


@torch.no_grad()
def init_parameters_(module: nn.Module, generator: torch.Generator,
                     randomize_all: bool = False,
                     gain: float = 1.0) -> nn.Module:
    """Seeded random init in the reference's scheme: fan-in normal
    (std 1/sqrt(fan_in)) for weights, zeros for biases and the zero-init
    temporal layers, ones/zeros for norms, normal(0.02) for the audio
    tower's positional table and bias_k/v.  randomize_all=True draws every
    parameter, the zero-init ones included (norm scales 1 + 0.1 N, biases
    and zero-init vectors 0.1 N), so that every sub-layer contributes.
    `gain` scales the fan-in std of the weights: sqrt(2) keeps a signal's
    scale through the deep conv + ReLU metric networks."""
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
                normal_(gain / math.sqrt(p[0].numel()))
        elif leaf == "bias" or any(s in name for s in _ZERO_INIT):
            normal_(0.1) if randomize_all else p.zero_()
        else:  # norm scales
            normal_(0.1, 1.0) if randomize_all else p.fill_(1.0)
    # BatchNorm running statistics: identity (mean 0, variance 1), or with
    # randomize_all mean 0.1 N and variance 1 + 0.1 |N|
    for name, buf in module.named_buffers():
        leaf = name.rsplit(".", 1)[-1]
        noise = (torch.randn(buf.shape, generator=generator,
                             device=buf.device, dtype=torch.float32) * 0.1
                 if randomize_all and leaf.startswith("running_") else 0.0)
        if leaf == "running_mean":
            buf.copy_(torch.zeros_like(buf) + noise)
        elif leaf == "running_var":
            buf.copy_(torch.ones_like(buf) + abs(noise))
        elif leaf == "num_batches_tracked":
            buf.zero_()
        else:
            raise ValueError(f"no init rule for buffer {name}")
    return module


_RELU_GAIN = math.sqrt(2.0)


def _build(factory, device, dtype, seed: int, randomize_all: bool,
           train: bool = False, gain: float = 1.0,
           load: Optional[Callable[[nn.Module], None]] = None):
    """Seeded init, then `load` (weights, before the cast to `dtype`, so a
    bf16 build holds the file's values rounded once), then the cast."""
    with torch.device("meta"):
        module = factory()
    module = module.to_empty(device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    init_parameters_(module, gen, randomize_all, gain)
    if load is not None:
        load(module)
    if train:
        return module.train()
    return module.to(dtype).eval().requires_grad_(False)


def _weights(weights_dir: Optional[str], label: str, graft: bool = False,
             space: Optional[str] = None):
    """The `load` step of `_build` for `weights_dir` (None: no step)."""
    if not weights_dir:
        return None
    return lambda module: load_weights(module, weights_dir, label, graft,
                                       space)


def build_unet(config: UNet3DConfig = UNet3DConfig(), device="cuda",
               dtype=torch.bfloat16, seed: int = 0,
               randomize_all: bool = False, train: bool = False,
               weights_dir: Optional[str] = None) -> AudioUNet3D:
    """train=True: fp32 parameters that all require grad, `dtype` as the
    compute dtype, train mode; the values are those of the inference build
    before its cast to `dtype`.  `weights_dir` may hold a trained 3D UNet
    or 2D SD1.5 weights: the `from_pretrained_2d` graft, where the
    `_temp`/`_audio` parameters absent from the file keep their seeded
    (zero-init) values (asva_tpu/runtime.py:89-91)."""
    return _build(lambda: AudioUNet3D(config, compute_dtype=dtype), device,
                  dtype, seed, randomize_all, train,
                  load=_weights(weights_dir, "unet", graft=True))


def build_vae(config: VAEConfig = VAEConfig(), device="cuda",
              dtype=torch.bfloat16, seed: int = 1,
              randomize_all: bool = False,
              weights_dir: Optional[str] = None) -> AutoencoderKL:
    return _build(lambda: AutoencoderKL(config), device, dtype, seed,
                  randomize_all, load=_weights(weights_dir, "vae"))


def build_audio_encoder(n_segment: int = 12,
                        config: Optional[ImageBindAudioConfig] = None,
                        device="cuda", dtype=torch.bfloat16, seed: int = 2,
                        randomize_all: bool = False,
                        weights_dir: Optional[str] = None
                        ) -> SegmaskAudioEncoder:
    """The segment audio tower.  `weights_dir`: the reference's
    audio_encoder export (a directory, a file, or the port's `.pt`) or the
    raw `imagebind_huge.pth`, whose other modalities are dropped and whose
    missing final_layer_norm keeps its init (the reference initialises it
    fresh)."""
    cfg = config or ImageBindAudioConfig()
    return _build(lambda: SegmaskAudioEncoder(cfg, n_segment), device, dtype,
                  seed, randomize_all,
                  load=_weights(weights_dir, "audio_encoder",
                                space="imagebind_audio"))


def _find_weights(path: str) -> Optional[str]:
    """The weights file of a module directory in the reference's layout, a
    file path as it is, or None."""
    if os.path.isfile(path):
        return path
    for name in ("diffusion_pytorch_model.safetensors",
                 "diffusion_pytorch_model.bin", "pytorch_model.safetensors",
                 "pytorch_model.bin", "model.safetensors"):
        p = os.path.join(path, name)
        if os.path.isfile(p):
            return p
    return None


_ORBAX_MARKERS = {"_METADATA", "manifest.ocdbt", "_CHECKPOINT_METADATA", "d",
                  "ocdbt.process_0"}


def resolve_weights(weights_dir: str) -> Optional[str]:
    """The file that holds a module's weights: `weights_dir` itself when it
    is a file, the reference layout's file inside it when it is a
    directory, else the port's own export `<weights_dir>.pt`; None when
    there is none.  An orbax directory (asva_tpu's own module exports)
    raises ValueError: the port reads torch state dicts only."""
    if os.path.isdir(weights_dir) and _ORBAX_MARKERS & set(
            os.listdir(weights_dir)):
        raise ValueError(
            f"{weights_dir} is an orbax checkpoint of asva_tpu, which the "
            "port cannot read: export it to a torch state dict first with "
            "asva_tpu/convert/jax_to_torch.py export_state_dict(params, "
            "<the module's key map>, to_torch=True) and torch.save the "
            "result as <module>.pt or <dir>/pytorch_model.bin")
    path = _find_weights(weights_dir)
    if path is None and os.path.isfile(weights_dir.rstrip(os.sep) + ".pt"):
        path = weights_dir.rstrip(os.sep) + ".pt"
    return path


def load_weights(module: nn.Module, weights_dir: str, label: str,
                 graft: bool = False, space: Optional[str] = None) -> None:
    """Load the weights that `weights_dir` names into `module`, strictly.
    With `graft` (the UNet) a file may instead lack exactly the
    `_temp`/`_audio` keys, which keep the module's values; any other
    missing key, or any unexpected one, raises.  `space`: a second source
    key space the file may be in (`convert.SOURCE_SPACES`), renamed before
    the strict load.  A path that holds no weights keeps the module as it
    is, with a warning."""
    path = resolve_weights(weights_dir)
    if path is None:
        log.warning("%s: no weights under %s — seeded random init", label,
                    weights_dir)
        return
    state = load_torch_state(path)
    if space is not None:
        load_source_state(module, state, space)
        log.info("%s: loaded %s", label, path)
        return
    strict = True
    if graft:
        report = load_report(module, state, graft=True)
        if report.unexpected or report.missing:
            raise RuntimeError(
                f"{label}: {path} is neither the whole module nor its 2D "
                f"part: missing "
                f"{sorted(report.missing + report.missing_allowed)[:8]}, "
                f"unexpected {report.unexpected[:8]}")
        strict = not report.missing_allowed
        if report.missing_allowed:
            log.info("%s: 2D weights from %s; %d temporal/audio tensors keep "
                     "their init", label, path, len(report.missing_allowed))
    load_exported(module, state, strict=strict)
    log.info("%s: loaded %s", label, path)


def load_torch_state(path: str) -> Dict[str, torch.Tensor]:
    """A .bin / .pt / .safetensors state dict as CPU tensors."""
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file
        return load_file(path)
    state = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(state, dict) and "state_dict" in state:
        state = state["state_dict"]
    if isinstance(state, dict) and "model" in state and all(
            torch.is_tensor(v) for v in state["model"].values()):
        state = state["model"]
    return state


def build_text_encoder(config: CLIPTextConfig = CLIPTextConfig(),
                       device="cuda", dtype=torch.bfloat16, seed: int = 3,
                       randomize_all: bool = False,
                       weights_dir: Optional[str] = None) -> CLIPTextModel:
    """The SD1.5 CLIP text encoder.  `weights_dir`: the checkpoint's
    text_encoder/ directory (HF CLIPTextModel keys), loaded strictly."""
    model = _build(lambda: CLIPTextModel(config), device, dtype, seed,
                   randomize_all)
    path = _find_weights(weights_dir) if weights_dir else None
    if path:
        state = load_torch_state(path)
        state.pop("text_model.embeddings.position_ids", None)  # an index
        model.load_state_dict(state, strict=True)
    elif weights_dir:
        log.warning("text_encoder: no weights under %s — random init",
                    weights_dir)
    return model


def build_avsync_classifier(weights_dirs=None, device="cuda",
                            dtype=torch.float32, seed: int = 4,
                            randomize_all: bool = False,
                            train: bool = False) -> AVSyncClassifier:
    """The AVSync classifier: in eval mode with frozen parameters in `dtype`,
    or with `train=True` in training mode with fp32 parameters that require
    grad (`dtype` is then the trainer's business: pass it as
    `SyncContrastiveTrainer(compute_dtype=...)`).  `weights_dirs`:
    {'audio_encoder': path, 'video_encoder': path, 'head': path} (each a
    module directory in the reference's layout, a file, or the port's export
    `<path>.pt`) or one directory that holds the three, as directories,
    as `<module>.pt`, or under `modules/` (a `CheckpointManager` step); or
    the path of a whole-classifier export (`avsync_train`'s
    `checkpoint-N/modules/classifier`, which names its `classifier.pt`),
    loaded strictly.  A module whose weights are missing keeps its random
    init, with a warning."""
    whole = (resolve_weights(weights_dirs) if isinstance(weights_dirs, str)
             else None)
    if whole is not None:
        return _build(AVSyncClassifier, device, dtype, seed, randomize_all,
                      train=train, gain=_RELU_GAIN,
                      load=lambda model: load_exported(
                          model, load_torch_state(whole)))
    if isinstance(weights_dirs, str):
        root = weights_dirs
        weights_dirs = {}
        for mod in ("audio_encoder", "video_encoder", "head"):
            path = os.path.join(root, mod)
            if resolve_weights(path) is None:
                path = os.path.join(root, "modules", mod)
            weights_dirs[mod] = path
    files = {}
    for mod, d in (weights_dirs or {}).items():
        files[mod] = resolve_weights(d)
        if files[mod] is None:
            del files[mod]
            log.warning("avsync: no weights found for module %r under %s — "
                        "that module keeps RANDOM init (scores meaningless "
                        "for metrics)", mod, d)

    def load(model):
        for mod, path in files.items():
            load_exported(getattr(model, mod), load_torch_state(path))
    return _build(AVSyncClassifier, device, dtype, seed, randomize_all,
                  train=train, gain=_RELU_GAIN, load=load if files else None)


def init_avsync_from_avid_cma(classifier: AVSyncClassifier, path: str,
                              modules=("audio", "video")) -> dict:
    """Load the classifier's encoders from a raw AVID-CMA checkpoint
    (asva_tpu/runtime.py:168-189).  The reference loads the tar's "model"
    dict and strips the DDP prefixes `module.audio_model.` /
    `module.video_model.` (avsync/models/audio.py:63-71, video.py:84-91);
    the port's towers use the reference's key space, so each selected
    tower loads its renamed keys with `load_state_dict`.  `modules` selects
    the towers (the YAML has a pretrained flag per encoder); the head has
    no AVID-CMA source and keeps its init.  Returns {"loaded", "missing",
    "unused"}: the keys loaded and those of a selected tower that the file
    lacks (classifier keys), and the file's keys that were not loaded."""
    state = load_torch_state(path)
    prefixes = {"audio": ("module.audio_model.", "audio_encoder"),
                "video": ("module.video_model.", "video_encoder")}
    report = {"loaded": [], "missing": [], "unused": []}
    used = set()
    for name in modules:
        prefix, tower = prefixes[name]
        module = getattr(classifier, tower)
        own = module.state_dict()
        renamed = {k[len(prefix):]: v for k, v in state.items()
                   if k.startswith(prefix) and k[len(prefix):] in own}
        used.update(prefix + k for k in renamed)
        result = module.load_state_dict(
            {k: v.to(dtype=own[k].dtype, device=own[k].device)
             for k, v in renamed.items()}, strict=False)
        report["loaded"] += [f"{tower}.{k}" for k in renamed]
        report["missing"] += [f"{tower}.{k}" for k in result.missing_keys]
    report["unused"] = sorted(set(state) - used)
    log.info("avsync: AVID-CMA init loaded %d tensors (%d missing, %d "
             "unused) from %s", len(report["loaded"]),
             len(report["missing"]), len(report["unused"]), path)
    return report


def build_i3d_classifier(num_classes: int = 400,
                         weights_path: Optional[str] = None,
                         bn_eps: float = 1e-5, device="cuda",
                         dtype=torch.float32, seed: int = 5,
                         randomize_all: bool = False):
    """The Inception-v1 I3D, as the FVD feature net (400 logits) or with a
    classifier head of `num_classes`.  A raw `i3d_pretrained_400.pt` state
    dict loads strictly; when num_classes != 400 its logits head is dropped
    and the fresh one kept.  Returns (model, missing keys or None)."""
    model = _build(lambda: InceptionI3D(num_classes, bn_eps), device, dtype,
                   seed, randomize_all, gain=_RELU_GAIN)
    if not (weights_path and os.path.isfile(weights_path)):
        if weights_path:
            log.warning("i3d: %s missing — random init", weights_path)
        return model, None
    # pytorch-i3d's names, or the stylegan-v blob's
    state, _ = to_port_keys(load_torch_state(weights_path), "i3d")
    if num_classes != 400:
        state.pop("logits.conv3d.weight", None)
        state.pop("logits.conv3d.bias", None)
    result = model.load_state_dict(state, strict=False)
    missing = [k for k in result.missing_keys
               if not k.endswith("num_batches_tracked")]
    allowed = [] if num_classes == 400 else ["logits.conv3d.weight",
                                             "logits.conv3d.bias"]
    if sorted(missing) != sorted(allowed) or result.unexpected_keys:
        raise RuntimeError(
            f"i3d: {weights_path} does not match: missing {missing[:8]}, "
            f"unexpected {result.unexpected_keys[:8]}")
    return model, missing


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


def load_null_text_encoding(path: Optional[str],
                            device="cuda") -> Optional[torch.Tensor]:
    """The (1, 77, 768) fp32 encoding of the empty prompt on `device`, from
    the reference's `.pt` or a `.npy` file; either spelling of the path is
    accepted (asva_tpu/runtime.py:223-238).  None when neither file
    exists."""
    if path and not os.path.isfile(path):
        for alt in (path[:-3] + ".npy" if path.endswith(".pt") else None,
                    path[:-4] + ".pt" if path.endswith(".npy") else None):
            if alt and os.path.isfile(alt):
                path = alt
                break
    if not (path and os.path.isfile(path)):
        return None
    if path.endswith(".npy"):
        enc = torch.from_numpy(np.load(path))
    else:
        enc = torch.load(path, map_location="cpu", weights_only=True)
    return enc.float().reshape(1, 77, 768).to(device)


def load_animation_pipeline(
        checkpoint_modules_dir: Optional[str] = None,
        sd_root: Optional[str] = None,
        null_text_encoding_path: Optional[str] = None,
        n_segment: int = 12, device="cuda", dtype=torch.bfloat16,
        unet_config: Optional[UNet3DConfig] = None,
        vae_config: Optional[VAEConfig] = None,
        seed: int = 0, randomize_all: bool = False,
        null_text_encoding: Optional[torch.Tensor] = None,
) -> AnimationPipeline:
    """The generation pipeline, with the directory logic of
    asva_tpu/runtime.py:280-303: the UNet from `<checkpoint_modules_dir>/
    unet` (a trained export: the port's `unet.pt` or a reference-layout
    directory), else from `<sd_root>/unet` (2D SD1.5 weights, grafted); the
    audio tower from `<checkpoint_modules_dir>/audio_encoder`; the VAE from
    `<sd_root>/vae`; the null text encoding from `null_text_encoding_path`
    unless the tensor `null_text_encoding` is given.  A module without
    weights keeps its seeded random init (with a warning when a path was
    given).  unet_config None: the architecture recorded in the
    checkpoint's modules_config.json when present, else the full-size
    default.  sd_root and null_text_encoding_path default to None: no such
    files ship with the repository."""
    mods = checkpoint_modules_dir
    unet_dir = (os.path.join(mods, "unet") if mods else
                (os.path.join(sd_root, "unet") if sd_root else None))
    audio_dir = os.path.join(mods, "audio_encoder") if mods else None
    vae_dir = os.path.join(sd_root, "vae") if sd_root else None
    mod_cfgs = load_module_configs(mods) or {}
    audio_config = None
    if unet_config is None and "unet" in mod_cfgs:
        unet_config = _config_from_dict(UNet3DConfig, mod_cfgs["unet"])
    if "audio_encoder" in mod_cfgs:
        audio_config = _config_from_dict(ImageBindAudioConfig,
                                         mod_cfgs["audio_encoder"])
    unet = build_unet(unet_config or UNet3DConfig(), device, dtype, seed,
                      randomize_all, weights_dir=unet_dir)
    vae = build_vae(vae_config or VAEConfig(), device, dtype, seed + 1,
                    randomize_all, weights_dir=vae_dir)
    audio = build_audio_encoder(n_segment, audio_config, device, dtype,
                                seed + 2, randomize_all, weights_dir=audio_dir)
    if null_text_encoding is None:
        null_text_encoding = load_null_text_encoding(null_text_encoding_path,
                                                     device)
    return AnimationPipeline(unet=unet, vae=vae, audio_encoder=audio,
                             schedule=DiffusionSchedule(),
                             null_text_encoding=null_text_encoding)
