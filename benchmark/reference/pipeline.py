"""A generation request of AVSyncD in plain PyTorch, float32, from the
files of the request: the PNG and the wav are read and cut into clips,
each clip's mel goes through the audio tower, the image through the VAE
encoder, the PLMS sampler (diffusers' PNDM with skip_prk_steps, SD1.5's
scaled-linear schedule, "leading" spacing, offset 1) runs with the dual
classifier-free guidance eps = e_u + tg (e_t - e_u) + ag (e_ta - e_t) and
frame 0 pinned to the image latent, and the VAE decodes every frame; the
frames are cast to uint8 by truncation.  Noise is drawn as the system
documents it for a batched request: one VAE-sampling draw (1, h/8, w/8, 4)
and one latent draw (1, f - 1, h/8, w/8, 4), in that order, from a
generator seeded with the request's seed, shared by every clip.
"""
from __future__ import annotations

import numpy as np
import torch

from .audio import AudioTower, waveform_to_mel
from .unet import UNet3D, segment_masks
from .vae import VAE


def alphas_cumprod(n: int = 1000, start: float = 0.00085,
                   end: float = 0.012) -> np.ndarray:
    betas = np.linspace(start ** 0.5, end ** 0.5, n, dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas).astype(np.float32)


def plms_timesteps(steps: int, n_train: int = 1000, offset: int = 1):
    ratio = n_train // steps
    base = np.arange(steps) * ratio + offset
    return np.concatenate([base[:-1], base[-2:-1], base[-1:]])[::-1], ratio


class PLMS:
    """diffusers PNDMScheduler.step_plms (skip_prk_steps), float32."""

    def __init__(self, steps: int):
        self.timesteps, self.ratio = plms_timesteps(steps)
        self.ac = alphas_cumprod()
        self.ets, self.counter, self.cur = [], 0, None

    def _prev_sample(self, sample, t, t_prev, eps):
        a = float(self.ac[t])
        a_prev = float(self.ac[t_prev]) if t_prev >= 0 else float(self.ac[0])
        b, b_prev = 1.0 - a, 1.0 - a_prev
        coeff = (a_prev / a) ** 0.5
        denom = a * b_prev ** 0.5 + (a * b * a_prev) ** 0.5
        return coeff * sample - (a_prev - a) * eps / denom

    def step(self, eps, t, sample):
        t_prev = t - self.ratio
        if self.counter != 1:
            self.ets = self.ets[-3:] + [eps]
        else:
            t_prev, t = t, t + self.ratio
        ets = self.ets
        if len(ets) == 1 and self.counter == 0:
            self.cur = sample
        elif len(ets) == 1 and self.counter == 1:
            eps = (eps + ets[-1]) / 2
            sample, self.cur = self.cur, None
        elif len(ets) == 2:
            eps = (3 * ets[-1] - ets[-2]) / 2
        elif len(ets) == 3:
            eps = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
        else:
            eps = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3]
                   - 9 * ets[-4]) / 24
        self.counter += 1
        return self._prev_sample(sample, t, t_prev, eps)


def read_image(path: str, size) -> torch.Tensor:
    """(h, w, 3) in [0, 1] of a PNG already at `size` (h, w)."""
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    if img.shape[:2] != tuple(size):
        raise ValueError(f"{path}: {img.shape[:2]} is not {tuple(size)}")
    return torch.from_numpy(img)


def read_audio_clips(path: str, clip_seconds: float, n: int) -> list:
    """n (c, T) 16 kHz float waveforms spread uniformly over a 16 kHz int16
    wav: the clip starts are linspace(0, duration - clip, n)."""
    from scipy.io import wavfile
    sr, data = wavfile.read(path)
    if sr != 16000 or data.dtype != np.int16:
        raise ValueError(f"{path}: the reference reads 16 kHz int16 wavs")
    wav = data.astype(np.float32) / np.iinfo(np.int16).max
    wav = wav.T if wav.ndim == 2 else wav[None]
    duration, size = wav.shape[-1] / sr, int(clip_seconds * sr)
    starts = ([(duration - clip_seconds) / 2.0] if n == 1 else
              np.linspace(0.0, duration - clip_seconds, n))
    out = []
    for s in starts:
        i0 = max(int(s * sr), 0)
        seg = wav[:, i0:i0 + size]
        out.append(np.pad(seg, ((0, 0), (0, size - seg.shape[-1]))))
    return out


class Generator:
    """The three modules of generation on `device` in `precision`, loaded
    strictly from the benchmark's state dicts."""

    def __init__(self, cfg: dict, states: dict, device, precision="fp32"):
        self.cfg = cfg
        self.unet = UNet3D(cfg["unet"], precision)
        self.vae = VAE(cfg["vae"], precision)
        self.audio = AudioTower(cfg["audio"], precision)
        for name, mod in (("unet", self.unet), ("vae", self.vae),
                          ("audio", self.audio)):
            mod.to_empty(device=device)
            mod.load_state_dict(states[name], strict=True)
            mod.requires_grad_(False)
        self.device = torch.device(device)
        self.mask = torch.from_numpy(segment_masks(
            cfg["video_num_frame"], self.audio.grid)).to(device)

    @torch.no_grad()
    def request(self, image_path, audio_path, text, null_text, seed: int,
                traffic: dict, decode_chunk: int = 12) -> np.ndarray:
        """(clips, f, h, w, 3) uint8 frames of one batched request."""
        cfg, dev = self.cfg, self.device
        n, f = traffic["num_clips_per_video"], cfg["video_num_frame"]
        image = read_image(image_path, cfg["image_size"]).to(dev)
        waves = read_audio_clips(audio_path, f / cfg["video_fps"], n)
        mels = torch.stack([waveform_to_mel(torch.from_numpy(w).to(dev))
                            for w in waves])
        gen = torch.Generator(device=dev).manual_seed(seed)
        s = self.vae.downscale
        hh, ww = image.shape[0] // s, image.shape[1] // s
        lc = cfg["vae"]["latent_channels"]
        vae_noise = torch.randn((1, hh, ww, lc), generator=gen, device=dev)
        noise = torch.randn((1, f - 1, hh, ww, lc), generator=gen, device=dev)
        z0 = self.vae.sample_latents(image[None].expand(n, -1, -1, -1) * 2.0
                                     - 1.0, vae_noise)
        latents = torch.cat([z0[:, None], noise.expand(n, -1, -1, -1, -1)],
                            dim=1)
        audio = self.audio(mels)
        null_audio = self.audio(torch.zeros((1,) + mels.shape[1:],
                                            device=dev))
        text = text.to(dev).float().expand(n, -1, -1)
        null_text = null_text.to(dev).float().expand(n, -1, -1)
        null_audio = null_audio.expand(n, -1, -1)
        ag = traffic["audio_guidance_scale"]
        tg = traffic["text_guidance_scale"]
        # the published branches: a guidance scale of 1 drops its
        # unconditional branch
        if tg > 1.0 and ag > 1.0:
            rows = [(null_text, null_audio), (text, null_audio), (text, audio)]
        elif ag > 1.0:
            rows = [(text, null_audio), (text, audio)]
        elif tg > 1.0:
            rows = [(null_text, audio), (text, audio)]
        else:
            rows = [(text, audio)]
        ctx_t = torch.cat([r[0] for r in rows])
        ctx_a = torch.cat([r[1] for r in rows])
        sampler = PLMS(traffic["num_inference_steps"])
        for t in sampler.timesteps:
            ts = torch.full((len(rows) * n,), int(t), dtype=torch.long,
                            device=dev)
            e = self.unet(torch.cat([latents] * len(rows)), ts, ctx_t, ctx_a,
                          self.mask).chunk(len(rows))
            if len(rows) == 3:
                eps = e[0] + tg * (e[1] - e[0]) + ag * (e[2] - e[1])
            elif len(rows) == 2:
                eps = e[0] + (ag if ag > 1.0 else tg) * (e[1] - e[0])
            else:
                eps = e[0]
            stepped = sampler.step(eps[:, 1:], int(t), latents[:, 1:])
            latents = torch.cat([latents[:, :1], stepped], dim=1)
        flat = latents.reshape((n * f,) + latents.shape[2:])
        frames = torch.cat([self.vae.decode(c)
                            for c in flat.split(decode_chunk)])
        frames = frames.reshape((n, f) + frames.shape[1:])
        return torch.clamp(frames * 255.0, 0, 255).to(torch.uint8).cpu() \
            .numpy()
