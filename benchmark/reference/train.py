"""AVSyncD fine-tuning steps in plain PyTorch, float32.

The published recipe (configs/audio-cond_animation/*.yaml and the
reference trainer): the parameters whose names contain "_temp" or
"_audio" train, the rest of the UNet, the VAE and the audio tower are
frozen; frames go through the VAE encoder (latents scaled by 0.18215),
each clip's waveform through the mel front end and the audio tower; per
clip the text and audio conditions drop to their null encodings with the
configured probabilities; DDPM noise at a uniform timestep corrupts
frames 1..f-1 while frame 0 stays clean; the loss is the float32 MSE of
the predicted noise over frames 1..f-1.  Gradients of the micro-batches of
one step are summed and divided by their count, then (across ranks) their
mean is taken, and optax's clip_by_global_norm + adamw applies them.

The random draws of one micro-batch, in the order the system under test
documents for its trainer: VAE noise (B*f, h/8, w/8, 4), timesteps (B,),
diffusion noise (B, f, h/8, w/8, 4), the text and the audio keep draws
(B, 1, 1), for the global batch B of all ranks, of which rank r keeps rows
[r*b, (r+1)*b).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from .audio import AudioTower, waveform_to_mel
from .pipeline import alphas_cumprod
from .unet import UNet3D, segment_masks
from .vae import VAE

TRAINABLE = ("_temp", "_audio")


def is_trainable(name: str) -> bool:
    return any(m in name for m in TRAINABLE)


def draws(shape, latent_hw, lc: int, generator, world: int, rank: int,
          device) -> Dict[str, torch.Tensor]:
    b, f = shape[:2]
    B = b * world

    def normal(*s):
        return torch.randn(s, generator=generator, device=device)

    def uniform(*s):
        return torch.rand(s, generator=generator, device=device)

    d = {"vae_noise": normal(B * f, *latent_hw, lc),
         "t": torch.randint(0, 1000, (B,), generator=generator,
                            device=device),
         "noise": normal(B, f, *latent_hw, lc),
         "text_keep": uniform(B, 1, 1), "audio_keep": uniform(B, 1, 1)}
    rows = slice(rank * b, (rank + 1) * b)
    return {k: v[slice(rows.start * f, rows.stop * f) if k == "vae_noise"
                 else rows] for k, v in d.items()}


class AdamW:
    """optax.chain(clip_by_global_norm(max_norm), adamw(lr, b1, b2, eps,
    weight_decay)) on float32 parameters."""

    def __init__(self, params: List[torch.Tensor], lr, max_norm, wd,
                 b1=0.9, b2=0.999, eps=1e-8):
        self.params = params
        self.lr, self.max_norm, self.wd = lr, max_norm, wd
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def step(self, grads) -> List[torch.Tensor]:
        """Apply; returns the clipped gradients."""
        norm = torch.sqrt(sum(g.double().square().sum() for g in grads))
        if norm >= self.max_norm:
            grads = [g / norm.float() * self.max_norm for g in grads]
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for i, (p, g) in enumerate(zip(self.params, grads)):
            self.mu[i] = self.b1 * self.mu[i] + (1 - self.b1) * g
            self.nu[i] = self.b2 * self.nu[i] + (1 - self.b2) * g.square()
            u = (self.mu[i] / c1) / (torch.sqrt(self.nu[i] / c2) + self.eps)
            p.sub_(self.lr * (u + self.wd * p))
        return grads


class Trainer:
    """The frozen encoders and the UNet on `device`, loaded strictly from
    the benchmark's state dicts; the UNet recomputes its blocks in the
    backward (`checkpoint`) so that a full-size step fits."""

    def __init__(self, cfg: dict, states: dict, traffic: dict, device,
                 precision: str = "fp32"):
        self.cfg, self.traffic = cfg, traffic
        self.unet = UNet3D(cfg["unet"], precision, checkpoint=True)
        self.vae = VAE(cfg["vae"], precision)
        self.audio = AudioTower(cfg["audio"], precision)
        for name, mod in (("unet", self.unet), ("vae", self.vae),
                          ("audio", self.audio)):
            mod.to_empty(device=device)
            mod.load_state_dict(states[name], strict=True)
            mod.requires_grad_(False)
        self.names = [n for n, _ in self.unet.named_parameters()
                      if is_trainable(n)]
        params = dict(self.unet.named_parameters())
        for n in self.names:
            params[n].requires_grad_(True)
        self.opt = AdamW([params[n] for n in self.names],
                         traffic["learning_rate"], traffic["max_grad_norm"],
                         traffic["weight_decay"])
        self.device = torch.device(device)
        self.mask = torch.from_numpy(segment_masks(
            cfg["video_num_frame"], self.audio.grid)).to(device)
        self.ac = torch.from_numpy(alphas_cumprod()).to(device)
        with torch.no_grad():
            self.null_audio = self.audio(torch.zeros(
                (1, cfg["audio"]["mel_bins"], cfg["audio"]["mel_frames"], 1),
                device=device))

    def loss(self, batch: dict, d: dict, null_text) -> torch.Tensor:
        videos = batch["videos"].float()
        b, f, h, w = videos.shape[:4]
        with torch.no_grad():
            lat = self.vae.sample_latents(
                (videos.reshape(b * f, h, w, 3) - 0.5) / 0.5, d["vae_noise"])
            lat = lat.reshape((b, f) + lat.shape[1:])
            mels = torch.stack([waveform_to_mel(x)
                                for x in batch["waveforms"]])
            audio = self.audio(mels)
        text = torch.where(
            d["text_keep"] >= self.traffic["text_cond_drop_prob"],
            batch["text_encodings"].float(), null_text.float())
        audio = torch.where(
            d["audio_keep"] >= self.traffic["audio_cond_drop_prob"], audio,
            self.null_audio)
        ac = self.ac[d["t"]].reshape(-1, 1, 1, 1, 1)
        noise = d["noise"].float()
        noisy = torch.sqrt(ac) * lat + torch.sqrt(1.0 - ac) * noise
        noisy = torch.cat([lat[:, :1], noisy[:, 1:]], dim=1)
        pred = self.unet(noisy, d["t"], text, audio, self.mask)
        return (pred[:, 1:] - noise[:, 1:]).square().mean()

    def steps(self, micro_batches: List[dict], generators: List[Callable],
              null_text, n_steps: int, world: int = 1, rank: int = 0,
              mean_across: Optional[Callable] = None) -> dict:
        """n_steps optimizer steps of `accumulation` micro-batches each;
        `generators[i]()` is micro-batch i's generator.  Returns each
        micro-batch's loss, the first step's clipped gradient by leaf and
        each leaf's change after the n steps."""
        accum = self.traffic["gradient_accumulation_steps"]
        s = self.vae.downscale
        first = [p.detach().clone() for p in self.opt.params]
        losses, first_grads = [], None
        for step in range(n_steps):
            acc = None
            for j in range(accum):
                i = step * accum + j
                batch = micro_batches[i]
                v = batch["videos"]
                d = draws(v.shape, (v.shape[2] // s, v.shape[3] // s),
                          self.cfg["vae"]["latent_channels"], generators[i](),
                          world, rank, self.device)
                loss = self.loss(batch, d, null_text)
                grads = torch.autograd.grad(loss, self.opt.params)
                losses.append(float(loss.detach()))
                acc = list(grads) if acc is None else [
                    a + g for a, g in zip(acc, grads)]
                del grads, loss
            acc = [g / accum for g in acc]
            if mean_across is not None:
                mean_across(acc)
            clipped = self.opt.step(acc)
            if step == 0:
                first_grads = {n: float(g.norm())
                               for n, g in zip(self.names, clipped)}
            del acc, clipped
        change = {n: float((p.detach() - p0).norm()) for n, p, p0 in
                  zip(self.names, self.opt.params, first)}
        return {"losses": losses, "first_grad": first_grads,
                "change": change}
