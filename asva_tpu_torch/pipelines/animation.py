"""Audio-conditioned animation pipeline (port of asva_tpu/pipelines/animation.py).

  * conditioning: Kaldi mel -> ImageBind audio tower (segment tokens), VAE
    encode of the first frame;
  * a DDIM/PLMS denoise loop over `AudioUNet3D` (generation variant,
    fuse_blocks=True) with classifier-free guidance stacking
    {uncond, text, text+audio} along the batch axis (k in {1, 2, 3}) and
    the dual-CFG combine
        eps = uncond + tg*(text - uncond) + ag*(text_audio - text);
  * frame 0 of the latent video is the clean image latent and is pinned:
    the sampler steps frames 1..f-1 only;
  * VAE decode.

The denoise loop's UNet calls on a card are replayed as CUDA-graph segments
between the fused sub-layers (`models/unet3d/graphs.py`), for the loop's
extent only: where the tensors are on CUDA, gradients are off, no frame
context is given and the loop makes 2 calls or more; else they run eagerly.

Randomness comes from an explicit `torch.Generator`, or is handed in as
`vae_noise` / `latent_noise` (parity tests feed the JAX draws); nothing is
drawn when both are given.

Across processes (`mesh`, from `parallel.make_gen_mesh`; asva_tpu's
`_shard_batch`, `_seq_constraint`, `_ctx_constraint` and `_replicate`,
animation.py:46-108): every rank is handed the global batch, draws the
noise of the global batch and every frame from the same generator, and
keeps its rows (the data axis) and its frames (the seq axis), so the
result does not depend on the mesh.  Weights and the null contexts are
replicas; the CFG stack is built from each rank's rows.  Frame 0 is
pinned on seq index 0 only; the UNet exchanges what its frame-axis
operations need over the seq group.  Each rank decodes its frames, and
the videos (or latents) are gathered, so every rank returns the global
result.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence

import torch

from ..diffusion.samplers import (ddim_plan, init_state, plan_row_arrays,
                                  plms_plan, sampler_step)
from ..diffusion.schedules import DiffusionSchedule
from ..models.imagebind_audio import segment_token_indices
from ..models.unet3d import graphs
from ..models.unet3d.primitives import token_indices_on
from ..observability import span, traced
from ..ops.mel import waveform_to_mel
from ..parallel.reduce import all_gather_frames, all_gather_shards


class AnimationPipeline:
    def __init__(self, unet, vae, audio_encoder,
                 schedule: DiffusionSchedule = DiffusionSchedule(),
                 null_text_encoding: Optional[torch.Tensor] = None,
                 mesh=None):
        self.unet = unet
        self.vae = vae
        self.audio_encoder = audio_encoder
        self.schedule = schedule
        self.null_text_encoding = null_text_encoding  # (1, 77, 768)
        if mesh is not None and mesh.size("fsdp") > 1:
            raise ValueError("AnimationPipeline shards over make_gen_mesh's "
                             "(data, seq) mesh; its weights are replicas")
        self.mesh = mesh
        self._null_audio = None

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    # ---------------- conditioning ----------------

    def encode_audio_waveform(self, waveforms: Sequence) -> torch.Tensor:
        """(c, T) 16 kHz waveforms -> (b, 128, 204, 1) mels."""
        return torch.stack([waveform_to_mel(torch.as_tensor(w))
                            for w in waveforms])

    @torch.no_grad()
    def null_audio_encoding(self) -> torch.Tensor:
        """Encoding of a zero mel — a constant of the frozen tower, cached
        across calls (JAX animation.py:125-134)."""
        if self._null_audio is None:
            cfg = self.audio_encoder.config
            zero = torch.zeros((1, cfg.mel_bins, cfg.mel_frames, 1),
                               device=self.device)
            _, enc, _ = self.audio_encoder(zero)
            self._null_audio = enc
        return self._null_audio

    @traced("pipe.encode_audio")
    @torch.no_grad()
    def encode_audio(self, mels: torch.Tensor):
        """mels (b, 128, 204, 1) -> (encodings (b, 229, e),
        masks (b, s, 229), null encodings (1, 229, e))."""
        _, enc, masks = self.audio_encoder(mels.to(self.device))
        return enc, masks, self.null_audio_encoding()

    def _latent_shape(self, images: torch.Tensor):
        b, h, w, _ = images.shape
        s = self.vae.downscale
        return b, h // s, w // s, self.vae.config.latent_channels

    @traced("pipe.encode_image")
    @torch.no_grad()
    def encode_image(self, images: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     broadcast: bool = False,
                     noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """images (b, h, w, 3) in [0, 1] -> sampled, scaled latents.
        broadcast: one noise draw (batch 1) shared by every clip."""
        images = images.to(self.device)
        if noise is None:
            b, hh, ww, c = self._latent_shape(images)
            noise = torch.randn((1 if broadcast else b, hh, ww, c),
                                generator=generator, device=self.device)
        return self.vae.sample_latents(images * 2.0 - 1.0,
                                       noise.to(self.device))

    @traced("pipe.decode_latents")
    @torch.no_grad()
    def decode_latents(self, latents: torch.Tensor) -> torch.Tensor:
        """(b, f, hh, ww, 4) scaled latents -> (b, f, h, w, 3) in [0, 1]."""
        b, f = latents.shape[:2]
        flat = latents.reshape((b * f,) + latents.shape[2:])
        imgs = self.vae.decode(flat / self.vae.scaling_factor)
        imgs = torch.clamp(imgs / 2.0 + 0.5, 0.0, 1.0)
        return imgs.reshape((b, f) + imgs.shape[1:])

    # ---------------- denoise loop ----------------

    @traced("pipe.denoise")
    @torch.no_grad()
    def denoise(self, latents, text_ctx, null_text_ctx, audio_ctx,
                null_audio_ctx, audio_token_indices, num_steps: int,
                sampler: str, text_gs: float, audio_gs: float, frames=None):
        """The sampler over `latents` (this rank's frames of the global
        video under `frames`, a FrameShard); frame 0 stays pinned."""
        plan = (plms_plan if sampler == "plms" else ddim_plan)(
            self.schedule, num_steps)
        do_text, do_audio = text_gs > 1.0, audio_gs > 1.0
        # frame 0 pinned: only seq index 0 holds it
        sl = slice(1 if frames is None or frames.index == 0 else 0, None)
        b = latents.shape[0]

        def rep(x):
            return x.expand((b,) + x.shape[1:])

        # CFG stacking, in the reference's encode_text/audio order
        if do_text and do_audio:
            text_stack = torch.cat([rep(null_text_ctx), text_ctx, text_ctx])
            audio_stack = torch.cat([rep(null_audio_ctx), rep(null_audio_ctx),
                                     audio_ctx])
            k = 3
        elif do_text:
            text_stack = torch.cat([rep(null_text_ctx), text_ctx])
            audio_stack = torch.cat([audio_ctx, audio_ctx])
            k = 2
        elif do_audio:
            text_stack = torch.cat([text_ctx, text_ctx])
            audio_stack = torch.cat([rep(null_audio_ctx), audio_ctx])
            k = 2
        else:
            text_stack, audio_stack, k = text_ctx, audio_ctx, 1

        state = init_state(plan, latents, step_slice=sl)
        rows = plan_row_arrays(plan)
        # every line of the loop lies in a span: the UNet call or the
        # sampler's work around it
        with graphs.segmented(self.unet, len(rows)):
            for row in rows:
                with span("sampler.step"):
                    x = torch.cat([state.latents] * k)
                    t = torch.full((k * b,), int(row["t_model"]),
                                   dtype=torch.long, device=latents.device)
                with span("unet.call"):
                    eps = self.unet(x, t, text_stack, audio_stack,
                                    audio_token_indices=audio_token_indices,
                                    fuse_blocks=True, frames=frames)
                with span("sampler.step"):
                    if do_text and do_audio:
                        e_u, e_t, e_ta = eps.chunk(3)
                        eps = (e_u + text_gs * (e_t - e_u)
                               + audio_gs * (e_ta - e_t))
                    elif do_text:
                        e_a, e_ta = eps.chunk(2)
                        eps = e_a + text_gs * (e_ta - e_a)
                    elif do_audio:
                        e_t, e_ta = eps.chunk(2)
                        eps = e_t + audio_gs * (e_ta - e_t)
                    state = sampler_step(
                        plan.kind, row, state, eps[:, sl], step_slice=sl,
                        prediction_type=self.schedule.prediction_type)
        return state.latents

    # ---------------- main entry ----------------

    @torch.no_grad()
    def __call__(self, images: torch.Tensor, audio_mels: torch.Tensor,
                 text_encodings: torch.Tensor, video_length: int = 12,
                 num_inference_steps: int = 20,
                 audio_guidance_scale: float = 4.0,
                 text_guidance_scale: float = 1.0, sampler: str = "plms",
                 generator: Optional[torch.Generator] = None,
                 decode: bool = True, broadcast_rng: bool = False,
                 vae_noise: Optional[torch.Tensor] = None,
                 latent_noise: Optional[torch.Tensor] = None):
        """images (b, h, w, 3) in [0, 1], audio_mels (b, 128, 204, 1),
        text_encodings (b, 77, 768) -> videos (b, f, h, w, 3) in [0, 1]
        (or the latents when decode=False).

        broadcast_rng: draw the VAE-sampling and initial-latent noise once
        (batch 1) and share it over the batch, so a batched call equals
        per-clip calls with the same seed.  vae_noise / latent_noise, when
        given, replace the draws (shapes (1 or b, h/8, w/8, 4) and
        (1 or b, f-1, h/8, w/8, 4)).

        Under `mesh` every rank passes the global batch (and any given
        noise for it) and returns the global result; b must divide by the
        mesh's data size and video_length by its seq size."""
        dev = self.device
        b = images.shape[0]
        rows, frames = slice(None), None
        if self.mesh is not None:
            data, seq = self.mesh.size("data"), self.mesh.size("seq")
            if b % data or video_length % seq:
                raise ValueError(
                    f"batch {b} must divide by the mesh's data size {data} "
                    f"and video_length {video_length} by its seq size {seq}")
            i = self.mesh.index("data")
            rows = slice(i * b // data, (i + 1) * b // data)
            frames = self.mesh.frame_shard(video_length)
        _, hh, ww, c = self._latent_shape(images)
        nb = 1 if broadcast_rng else b
        # the global draws, in the one-process order; each rank its rows
        if vae_noise is None:
            vae_noise = torch.randn((nb, hh, ww, c), generator=generator,
                                    device=dev)
        if latent_noise is None:
            latent_noise = torch.randn((nb, video_length - 1, hh, ww, c),
                                       generator=generator, device=dev)
        # a batch-1 draw is shared by every clip
        vae_noise, latent_noise = (n if n.shape[0] == 1 else n[rows]
                                   for n in (vae_noise, latent_noise))
        images, audio_mels = images[rows].to(dev), audio_mels[rows]
        text_encodings = text_encodings[rows]
        image_latents = self.encode_image(images, noise=vae_noise)
        b = image_latents.shape[0]
        noise = latent_noise.to(device=dev, dtype=image_latents.dtype)
        noise = noise.expand((b,) + noise.shape[1:])
        latents = torch.cat([image_latents[:, None], noise], dim=1)
        if frames is not None:
            f = video_length // frames.count
            latents = latents[:, frames.offset:frames.offset + f]

        audio_ctx, audio_masks, null_audio_ctx = self.encode_audio(audio_mels)
        if audio_masks.shape[1] != video_length:
            raise ValueError(
                f"audio encoder n_segment={audio_masks.shape[1]} must equal "
                f"video_length={video_length}")
        # the static per-frame token gather equals the boolean segment masks
        token_idx = token_indices_on(segment_token_indices(
            video_length, self.audio_encoder.config.patch_grid), dev)
        text_encodings = text_encodings.to(dev)
        if self.null_text_encoding is not None:
            null_text = self.null_text_encoding.to(dev)
        else:
            warnings.warn(
                "AnimationPipeline: null_text_encoding missing — the uncond "
                "CFG branch uses a ZEROS text context instead of the "
                "empty-string CLIP encoding; reference numerics will differ")
            null_text = torch.zeros_like(text_encodings[:1])

        out = self.denoise(latents, text_encodings, null_text, audio_ctx,
                           null_audio_ctx, token_idx, num_inference_steps,
                           sampler, float(text_guidance_scale),
                           float(audio_guidance_scale), frames)
        if decode:
            out = self.decode_latents(out)
        return out if self.mesh is None else self._gather(out, frames)

    def _gather(self, out: torch.Tensor, frames) -> torch.Tensor:
        """This rank's (rows, frames) block -> the global result."""
        if frames is not None:
            out = all_gather_frames(out, frames.group)
        if self.mesh.size("data") > 1:
            out = all_gather_shards(out, self.mesh.group("data"))
        return out
