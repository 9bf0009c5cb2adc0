"""Write every published artifact of docs/REAL_WEIGHTS.md's inventory, in
its published format, file name and key space, from the port's own seeded
modules: the weights gate's dry run (`validate_weights --fabricate`) and
the card's full-size load test read such a tree.

Under `root`:
  pretrained/stable-diffusion-v1-5/unet/diffusion_pytorch_model.bin
      the 2D part of a 3D UNet: every key outside TRAINABLE_SEGMENTS;
  pretrained/stable-diffusion-v1-5/vae/diffusion_pytorch_model.bin;
  pretrained/stable-diffusion-v1-5/text_encoder/pytorch_model.bin
      HF CLIPTextModel keys with the `position_ids` index buffer;
  checkpoints/checkpoint-40/modules/{unet,audio_encoder}/ (the reference's
      module layout) and checkpoints/checkpoint-40/modules_config.json;
  pretrained/.checkpoints/imagebind_huge.pth
      the audio, vision and text towers in the raw `modality_*` key space,
      without the segment tower's final_layer_norm (the published file has
      none);
  pretrained/pt_inception-2015-12-05-6726825d.pth
      pytorch-fid's names, its 1008-way `fc.*` included;
  pretrained/i3d_torchscript.pt
      a TorchScript trace of the port's Inception-I3D with BatchNorm eps
      1e-3 (the value the stylegan-v blob may bake in), whose state_dict
      carries pytorch-i3d's names;
  checkpoints/avsync/modules/{audio_encoder,video_encoder,head}/
      pytorch_model.bin, the AVSync classifier's three modules;
  avid_cma.pth — {"model": {"module.audio_model.*", "module.video_model.*"}};
  pretrained/openai-clip-l_null_text_encoding.pt — (1, 77, 768) float32.

`full=False` writes the tiny configurations (the towers' `tiny()` forms;
the metric nets and the classifier have only their published widths);
`full=True` the published sizes, about 14 GB of fp32.  Every module is
drawn by `build(name, full, device, seed)` with every parameter randomised,
so that a caller can rebuild the exact module a file was written from.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time

import torch

from ..convert import from_port_keys, graft_keys
from ..models.clip_text import CLIPTextConfig
from ..models.imagebind_audio import ImageBindAudioConfig
from ..models.imagebind_extra import ImageBindTextConfig, ImageBindVisionConfig
from ..models.unet3d import UNet3DConfig
from ..models.vae import VAEConfig

I3D_EPS = 1e-3
CHECKPOINT_STEP = 40
SD = os.path.join("pretrained", "stable-diffusion-v1-5")
# artifact paths under the root
PATHS = {
    "sd15_unet": os.path.join(SD, "unet", "diffusion_pytorch_model.bin"),
    "sd15_vae": os.path.join(SD, "vae", "diffusion_pytorch_model.bin"),
    "sd15_text_encoder": os.path.join(SD, "text_encoder",
                                      "pytorch_model.bin"),
    "avsyncd_unet": os.path.join("checkpoints",
                                 f"checkpoint-{CHECKPOINT_STEP}", "modules",
                                 "unet", "diffusion_pytorch_model.bin"),
    "avsyncd_audio_encoder": os.path.join(
        "checkpoints", f"checkpoint-{CHECKPOINT_STEP}", "modules",
        "audio_encoder", "pytorch_model.bin"),
    "modules_config": os.path.join("checkpoints",
                                   f"checkpoint-{CHECKPOINT_STEP}",
                                   "modules_config.json"),
    "imagebind_huge": os.path.join("pretrained", ".checkpoints",
                                   "imagebind_huge.pth"),
    "fid_inception_v3": os.path.join("pretrained",
                                     "pt_inception-2015-12-05-6726825d.pth"),
    "fvd_i3d": os.path.join("pretrained", "i3d_torchscript.pt"),
    "avsync_classifier": os.path.join("checkpoints", "avsync", "modules"),
    "avid_cma": "avid_cma.pth",
    "null_text_encoding": os.path.join(
        "pretrained", "openai-clip-l_null_text_encoding.pt"),
}
# the modules the files are drawn from, each with its own seed offset
MODULES = ("unet", "vae", "text_encoder", "audio_encoder", "imagebind_audio",
           "imagebind_vision", "imagebind_text", "fid_inception_v3",
           "fvd_i3d", "avsync_classifier", "null_text_encoding",
           "inception_fc")


def configs(full: bool) -> dict:
    """The architectures of the tree: published, or the tiny test forms
    (the UNet's audio cross-attention at the tiny audio tower's width)."""
    if full:
        return dict(unet=UNet3DConfig(), vae=VAEConfig(),
                    text_encoder=CLIPTextConfig(),
                    audio=ImageBindAudioConfig(),
                    vision=ImageBindVisionConfig(),
                    imagebind_text=ImageBindTextConfig(), n_segment=12)
    return dict(unet=UNet3DConfig.tiny(audio_cross_attention_dim=32),
                vae=VAEConfig.tiny(),
                # 77 positions and room for a byte-level BPE vocabulary, so
                # that the empty prompt's 77 ids can be encoded
                text_encoder=CLIPTextConfig.tiny(vocab_size=1024,
                                                 max_positions=77),
                audio=ImageBindAudioConfig.tiny(),
                vision=ImageBindVisionConfig.tiny(),
                imagebind_text=ImageBindTextConfig.tiny(), n_segment=4)


def module_seed(name: str, seed: int) -> int:
    return 1000 * (seed + 1) + MODULES.index(name)


def build(name: str, full: bool, device="cpu", seed: int = 0,
          dtype=torch.float32):
    """The module (or tensor) the artifact `name` is written from, every
    parameter drawn in fp32 from its seed (randomize_all); with another
    `dtype` the module is built as the loaders build it in that dtype (cast
    after the draw, `dtype` the compute dtype)."""
    from .. import runtime
    from ..scripts.animation_eval import NETS
    cfg = configs(full)
    s = module_seed(name, seed)
    kw = dict(device=device, dtype=dtype, seed=s, randomize_all=True)
    if name == "unet":
        return runtime.build_unet(cfg["unet"], **kw)
    if name == "vae":
        return runtime.build_vae(cfg["vae"], **kw)
    if name == "text_encoder":
        return runtime.build_text_encoder(cfg["text_encoder"], **kw)
    if name == "audio_encoder":
        return runtime.build_audio_encoder(cfg["n_segment"], cfg["audio"],
                                           **kw)
    if name == "avsync_classifier":
        return runtime.build_avsync_classifier(None, **kw)
    if name in ("null_text_encoding", "inception_fc"):
        gen = torch.Generator().manual_seed(s)
        if name == "inception_fc":
            return {"fc.weight": torch.randn(1008, 2048, generator=gen)
                    / 2048 ** 0.5, "fc.bias": torch.zeros(1008)}
        return torch.randn(1, 77, 768, generator=gen)
    factory, _, gain = NETS[name]
    if name == "fvd_i3d":
        return runtime._build(lambda: factory(I3D_EPS), device, dtype, s,
                              True, gain=gain)
    if name.startswith("imagebind_"):   # the towers at the tree's widths
        from ..models.imagebind_audio import ImageBindAudioEncoder
        from ..models.imagebind_extra import (ImageBindTextEncoder,
                                              ImageBindVisionEncoder)
        factory = {"imagebind_audio": lambda: ImageBindAudioEncoder(
                       cfg["audio"]),
                   "imagebind_vision": lambda: ImageBindVisionEncoder(
                       cfg["vision"]),
                   "imagebind_text": lambda: ImageBindTextEncoder(
                       cfg["imagebind_text"])}[name]
    return runtime._build(factory, device, dtype, s, True, gain=gain)


def _cpu(state: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True).contiguous()
            for k, v in state.items()}


def _save(obj, root: str, rel: str) -> int:
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(obj, path)
    return os.path.getsize(path)


def _i3d_blob(net, root: str, rel: str) -> int:
    """A traced TorchScript copy of the I3D: its state_dict holds the
    module's (pytorch-i3d) names; eps is a constant of its graph."""
    net = net.to("cpu").eval()
    with torch.no_grad():
        blob = torch.jit.trace(net, torch.zeros(1, 8, 32, 32, 3),
                               check_trace=False)
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    blob.save(path)
    return os.path.getsize(path)


def fabricate(root: str, full: bool = False, seed: int = 0,
              device="cpu") -> dict:
    """Write the tree under `root` (modules drawn on `device`).  Returns
    {"root", "checkpoint_modules_dir", "avsync_modules_dir",
    "avid_cma_path", "bytes": {artifact: bytes}, "seconds"}."""
    t0 = time.perf_counter()
    sizes = {}

    unet = build("unet", full, device, seed)
    state = _cpu(unet.state_dict())
    del unet
    sizes["avsyncd_unet"] = _save(state, root, PATHS["avsyncd_unet"])
    grafted = graft_keys(state)
    sizes["sd15_unet"] = _save({k: v for k, v in state.items()
                                if k not in grafted}, root,
                               PATHS["sd15_unet"])
    del state

    sizes["sd15_vae"] = _save(_cpu(build("vae", full, device, seed)
                                   .state_dict()), root, PATHS["sd15_vae"])

    text = _cpu(build("text_encoder", full, device, seed).state_dict())
    positions = configs(full)["text_encoder"].max_positions
    text["text_model.embeddings.position_ids"] = torch.arange(
        positions)[None]
    sizes["sd15_text_encoder"] = _save(text, root,
                                       PATHS["sd15_text_encoder"])

    audio = build("audio_encoder", full, device, seed)
    sizes["avsyncd_audio_encoder"] = _save(
        _cpu(audio.state_dict()), root, PATHS["avsyncd_audio_encoder"])
    cfg = configs(full)
    mods_cfg = {"unet": dataclasses.asdict(cfg["unet"]),
                "audio_encoder": dict(dataclasses.asdict(audio.config),
                                      n_segment=cfg["n_segment"])}
    del audio
    path = os.path.join(root, PATHS["modules_config"])
    with open(path, "w") as f:
        json.dump(mods_cfg, f, indent=1)
    sizes["modules_config"] = os.path.getsize(path)

    huge = {}
    huge.update(from_port_keys(
        _cpu(build("imagebind_audio", full, device, seed).state_dict()),
        "imagebind_audio"))
    for tower in ("imagebind_vision", "imagebind_text"):
        huge.update(from_port_keys(
            _cpu(build(tower, full, device, seed).state_dict()), tower))
    sizes["imagebind_huge"] = _save(huge, root, PATHS["imagebind_huge"])
    del huge

    fid = _cpu(build("fid_inception_v3", full, device, seed).state_dict())
    fid.update(build("inception_fc", full, device, seed))
    sizes["fid_inception_v3"] = _save(fid, root, PATHS["fid_inception_v3"])
    del fid

    sizes["fvd_i3d"] = _i3d_blob(build("fvd_i3d", full, device, seed), root,
                                 PATHS["fvd_i3d"])

    classifier = _cpu(build("avsync_classifier", full, device,
                            seed).state_dict())
    sizes["avsync_classifier"] = 0
    for mod in ("audio_encoder", "video_encoder", "head"):
        sizes["avsync_classifier"] += _save(
            {k[len(mod) + 1:]: v for k, v in classifier.items()
             if k.startswith(mod + ".")}, root,
            os.path.join(PATHS["avsync_classifier"], mod,
                         "pytorch_model.bin"))
    avid = {}
    for tower in ("audio", "video"):
        prefix = f"{tower}_encoder."
        avid.update({f"module.{tower}_model.{k[len(prefix):]}": v
                     for k, v in classifier.items() if k.startswith(prefix)})
    sizes["avid_cma"] = _save({"model": avid}, root, PATHS["avid_cma"])
    del classifier, avid

    sizes["null_text_encoding"] = _save(
        build("null_text_encoding", full, device, seed), root,
        PATHS["null_text_encoding"])
    seconds = time.perf_counter() - t0
    return dict(root=root,
                checkpoint_modules_dir=os.path.dirname(os.path.dirname(
                    os.path.join(root, PATHS["avsyncd_unet"]))),
                avsync_modules_dir=os.path.join(root,
                                                PATHS["avsync_classifier"]),
                avid_cma_path=os.path.join(root, PATHS["avid_cma"]),
                bytes=sizes, seconds=seconds)
