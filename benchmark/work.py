"""The work a cell asks for, counted from the configuration and the call
shapes, never from the program's code.

Model FLOPs: `torch.utils.flop_counter.FlopCounterMode` over the plain
reference on the meta device at the cell's shapes (products and
convolutions; a backward counts the gradients the step needs, with no
recompute).  Sub-layer bounds: each input byte read once and each output
byte written once, the products' operations, at the H100's published
dense bf16 peak and HBM bandwidth (NVIDIA's data sheet, SXM, 700 W):
bound = max(bytes / 3.35 TB/s, operations / 989 TFLOP/s).
"""
from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.audio import AudioTower
from .reference.pipeline import plms_timesteps
from .reference.train import is_trainable
from .reference.unet import UNet3D, segment_masks
from .reference.vae import VAE

PEAK_FLOPS_BF16 = 989e12
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS_BF16)


def attn_flops(g: int, m: int, sk: int, c: int) -> int:
    """One attention sub-layer on x (g, m, c) over sk keys: the q and out
    projections and QK^T and PV."""
    return 4 * g * m * c * c + 4 * g * m * sk * c


def attn_bwd_flops(g, m, sk, c, dwq: bool, dwo: bool) -> int:
    """Its backward: dO through the out projection and dq through the q
    projection (each 2mc^2), the weight gradients that are needed, and
    dV, dP, dQ, dK (8 m sk c)."""
    return g * (4 * m * c * c + 2 * m * c * c * (dwq + dwo)
                + 8 * m * sk * c)


def geglu_flops(m: int, c: int) -> int:
    """LN + [v|g] = x Wi^T (c -> 8c), v gelu(g) Wo^T (4c -> c)."""
    return 24 * m * c * c


def _meta_unet(cfg, trainable: bool):
    with torch.device("meta"):
        unet = UNet3D(cfg["unet"])
    unet.requires_grad_(False)
    if trainable:
        for n, p in unet.named_parameters():
            p.requires_grad_(is_trainable(n))
    return unet


def _count(fn) -> int:
    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def _unet_inputs(cfg, rows: int):
    f, (h, w) = cfg["video_num_frame"], cfg["image_size"]
    s = 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
    m = cfg["unet"]
    grid = ((cfg["audio"]["mel_bins"] - cfg["audio"]["kernel_size"])
            // cfg["audio"]["stride"] + 1,
            (cfg["audio"]["mel_frames"] - cfg["audio"]["kernel_size"])
            // cfg["audio"]["stride"] + 1)
    return (torch.empty(rows, f, h // s, w // s, m["in_channels"],
                        device="meta"),
            torch.zeros(rows, dtype=torch.long, device="meta"),
            torch.empty(rows, cfg["text_tokens"], m["cross_attention_dim"], device="meta"),
            torch.empty(rows, grid[0] * grid[1] + 1,
                        m["audio_cross_attention_dim"], device="meta"),
            torch.from_numpy(segment_masks(f, grid)).to("meta"))


def _encoders(cfg, images: int, mels: int, decode: int) -> int:
    with torch.device("meta"):
        vae, audio = VAE(cfg["vae"]), AudioTower(cfg["audio"])
    h, w = cfg["image_size"]
    s = vae.downscale
    lc = cfg["vae"]["latent_channels"]
    a = cfg["audio"]
    total = 0
    if images:
        total += _count(lambda: vae.sample_latents(
            torch.empty(images, h, w, 3, device="meta"),
            torch.empty(1, h // s, w // s, lc, device="meta")))
    if decode:
        total += _count(lambda: vae.decode(
            torch.empty(decode, h // s, w // s, lc, device="meta")))
    if mels:
        total += _count(lambda: audio(torch.empty(
            mels, a["mel_bins"], a["mel_frames"], 1, device="meta")))
    return total


def request_flops(cfg: dict, traffic: dict) -> int:
    """Model FLOPs of one generation request: the UNet calls of the
    sampler over the guidance branches, the VAE encoding of the clips'
    image and the decoding of every frame, the audio tower on each clip."""
    n = traffic["num_clips_per_video"]
    branches = 1 + (traffic["audio_guidance_scale"] > 1.0) \
        + (traffic["text_guidance_scale"] > 1.0)
    unet = _meta_unet(cfg, trainable=False)
    per_call = _count(lambda: unet(*_unet_inputs(cfg, branches * n)))
    calls = len(plms_timesteps(traffic["num_inference_steps"])[0])
    return calls * per_call + _encoders(cfg, n, n, n * cfg["video_num_frame"])


def step_flops(cfg: dict, traffic: dict, world: int = 1) -> int:
    """Model FLOPs of one optimizer step over all ranks: per micro-batch the
    VAE encoding of every frame, the audio tower on each clip, the UNet's
    forward and its backward to the trainable parameters."""
    b = traffic["batch_size"]
    unet = _meta_unet(cfg, trainable=True)

    def fwd_bwd():
        unet(*_unet_inputs(cfg, b)).square().mean().backward()
    micro = _count(fwd_bwd) + _encoders(cfg, b * cfg["video_num_frame"], b, 0)
    return micro * traffic["gradient_accumulation_steps"] * world


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if isinstance(t, torch.Tensor))


def geglu_bwd_flops(m: int, c: int, dwi: bool, dwo: bool) -> int:
    """B3's backward: dx through both products (24 m c^2) and the weight
    gradients that are due (16 and 8 m c^2)."""
    return 24 * m * c * c + 16 * m * c * c * dwi + 8 * m * c * c * dwo


def model_share(flops: float, seconds: float, cards: int) -> float:
    """Percent of the cards' dense bf16 peak."""
    return 100.0 * flops / (seconds * PEAK_FLOPS_BF16 * cards)

