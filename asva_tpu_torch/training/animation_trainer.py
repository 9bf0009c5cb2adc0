"""AVSyncD diffusion training: loss, train state and train step.

Port of asva_tpu/training/animation_trainer.py.  Behavioural contract:
  * VAE-encode frames without gradients; latents scaled by 0.18215,
  * the audio tower runs frozen; null audio encodings come from a zero mel
    and are computed once,
  * per-sample Bernoulli condition dropout swaps text -> null text encoding
    (prob text_cond_drop_prob) and audio -> null audio (audio_cond_drop_prob),
  * uniform random train timestep per sample; DDPM add_noise; frame-0 latent
    re-pinned clean; epsilon (or v) target,
  * MSE in fp32 over frames 1..f-1 (frame 0 excluded unless
    loss_on_first_frame).

Every random number comes from an explicit `torch.Generator` (`draw`), or is
handed in as a tensor (`loss_fn(..., draws=...)`), so a test can feed the
draws of another implementation.  Only the UNet parameters that the
optimizer holds receive gradients; gradient accumulation is a caller's loop
of `grad_step` followed by `apply_step`.

Under FSDP (a UNet split by parallel/sharding.py over a (data, fsdp)
mesh) the gradients of split parameters reach their shards already
averaged over every rank (the gather's backward); `apply_step` averages
the replicated ones, and the train state's dict is that of one process.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..diffusion.schedules import DiffusionSchedule
from ..models.imagebind_audio import segment_token_indices
from ..observability import count, span, traced
from ..parallel.reduce import all_reduce_mean_
from ..parallel.sharding import (full_state_dict, is_sharded,
                                 load_full_state_dict)
from .optim import AdamW


@dataclasses.dataclass(frozen=True)
class AnimationTrainConfig:
    text_cond_drop_prob: float = 0.0
    audio_cond_drop_prob: float = 0.2
    loss_on_first_frame: bool = False
    prediction_type: str = "epsilon"  # or "v_prediction"


@dataclasses.dataclass
class TrainState:
    """Step count, the UNet (the only trained module) and its optimizer.
    Its state dict is one process's at any fsdp size: split parameters and
    moments are gathered (on every rank), and a load takes each shard's
    block."""
    step: int
    unet: nn.Module
    optimizer: AdamW

    def state_dict(self) -> dict:
        return {"step": self.step, "unet": full_state_dict(self.unet),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        load_full_state_dict(self.unet, state["unet"])
        self.optimizer.load_state_dict(state["optimizer"])


@dataclasses.dataclass(eq=False)
class AnimationTrainer:
    unet: nn.Module
    vae: nn.Module
    audio_encoder: nn.Module
    null_text_encoding: torch.Tensor      # (1, 77, 768)
    schedule: DiffusionSchedule = DiffusionSchedule()
    config: AnimationTrainConfig = AnimationTrainConfig()
    _null_audio: Optional[torch.Tensor] = dataclasses.field(
        default=None, init=False, repr=False)

    @torch.no_grad()
    def null_audio_encoding(self) -> torch.Tensor:
        """Encoding of a zero mel — constant while the audio tower is
        frozen, so it is computed once instead of once per step."""
        if self._null_audio is None:
            cfg = self.audio_encoder.config
            p = next(self.audio_encoder.parameters())
            zero = torch.zeros((1, cfg.mel_bins, cfg.mel_frames, 1),
                               device=p.device, dtype=p.dtype)
            self._null_audio = self.audio_encoder(zero)[1]
        return self._null_audio

    def draw(self, batch: dict, generator: torch.Generator, mesh=None
             ) -> Dict[str, torch.Tensor]:
        """The five random draws of one loss evaluation: VAE sampling noise
        (b*f, h/8, w/8, 4), timesteps t (b,) in [0, num_train_timesteps),
        diffusion noise (b, f, h/8, w/8, 4) and the two uniform (b, 1, 1)
        dropout draws (a condition is kept where its draw >= the
        probability).

        Across the ranks of `mesh` each draw is made for the global batch
        (b * world rows, from the same generator on every rank) and this
        rank keeps its rows [rank * b, (rank + 1) * b) — b * f rows for the
        VAE noise — as asva_tpu's rows are slices of one global draw; the
        result does not depend on the number of ranks."""
        videos = batch["videos"]
        b, f, h, w = videos.shape[:4]
        s, lc = self.vae.downscale, self.vae.config.latent_channels
        dev = videos.device
        world, rank = (1, 0) if mesh is None else (mesh.world, mesh.rank)
        mine = slice(rank * b, (rank + 1) * b)
        b *= world

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        draws = {
            "vae_noise": normal(b * f, h // s, w // s, lc),
            "t": torch.randint(0, self.schedule.num_train_timesteps, (b,),
                               generator=generator, device=dev),
            "noise": normal(b, f, h // s, w // s, lc),
            "text_keep": uniform(b, 1, 1),
            "audio_keep": uniform(b, 1, 1),
        }
        if world == 1:
            return draws
        frames = slice(mine.start * f, mine.stop * f)
        return {k: v[frames if k == "vae_noise" else mine]
                for k, v in draws.items()}

    def loss_fn(self, batch: dict,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                mesh=None) -> torch.Tensor:
        """batch: videos (b, f, h, w, 3) in [0, 1], mels (b, 128, 204, 1) or
        waveforms (b, 1, samples) at 16 kHz, text_encodings (b, 77, 768).
        Randomness: `draws` (see `draw`) or, when None, `generator` (this
        rank's rows of the global draw under `mesh`)."""
        videos = batch["videos"]
        b, f = videos.shape[:2]
        if draws is None:
            if generator is None:
                raise ValueError("loss_fn needs a generator or the draws")
            with span("train.draw"):
                draws = self.draw(batch, generator, mesh)
        with span("train.encode"):
            mels = batch.get("mels")
            if mels is None:  # on-device mel from raw 16 kHz waveforms
                from ..ops.mel import waveform_to_mel
                mels = torch.stack([waveform_to_mel(w)
                                    for w in batch["waveforms"]])
            # 1. frozen encoders
            with torch.no_grad():
                frames = (videos.reshape((b * f,) + videos.shape[2:])
                          - 0.5) / 0.5
                latents = self.vae.sample_latents(frames, draws["vae_noise"])
                latents = latents.reshape((b, f) + latents.shape[1:])
                audio_enc = self.audio_encoder(mels)[1]
                null_audio = self.null_audio_encoding()
        with span("train.forward"):
            return self._loss(batch, draws, latents, audio_enc, null_audio)

    def _loss(self, batch, draws, latents, audio_enc, null_audio):
        """loss_fn's part after the frozen encoders: the UNet and the
        loss."""
        cfg = self.config
        # static per-frame token gather (equal to the boolean segment masks)
        token_idx = segment_token_indices(
            self.audio_encoder.n_segment,
            self.audio_encoder.config.patch_grid)

        # 2. per-sample condition dropout
        text_keep = draws["text_keep"] >= cfg.text_cond_drop_prob
        audio_keep = draws["audio_keep"] >= cfg.audio_cond_drop_prob
        text_enc = torch.where(
            text_keep, batch["text_encodings"],
            self.null_text_encoding.to(batch["text_encodings"].dtype))
        audio_enc = torch.where(audio_keep, audio_enc, null_audio)

        # 3. diffusion corruption with frame 0 pinned clean
        t = draws["t"]
        noise = draws["noise"].to(latents.dtype)
        noisy = self.schedule.add_noise(latents, noise, t)
        noisy = torch.cat([latents[:, 0:1], noisy[:, 1:]], dim=1)
        if cfg.prediction_type == "epsilon":
            target = noise
        elif cfg.prediction_type == "v_prediction":
            target = self.schedule.velocity(latents, noise, t)
        else:
            raise ValueError(cfg.prediction_type)

        pred = self.unet(noisy, t, text_enc, audio_enc,
                         audio_token_indices=token_idx)
        if not cfg.loss_on_first_frame:
            pred, target = pred[:, 1:], target[:, 1:]
        return (pred.float() - target.float()).square().mean()

    # ---------------- steps ----------------

    @traced("train.grad_step")
    def grad_step(self, state: TrainState, batch: dict,
                  generator: Optional[torch.Generator] = None,
                  draws: Optional[Dict[str, torch.Tensor]] = None,
                  mesh=None) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """(loss, gradients of the optimizer's parameters, in its order) —
        trainable-sized, for gradient accumulation; this rank's own under
        `mesh` (`apply_step` takes their mean)."""
        loss = self.loss_fn(batch, generator, draws, mesh)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, state.optimizer.params)
        return loss.detach(), list(grads)

    @traced("train.apply_step")
    def apply_step(self, state: TrainState, grads: List[torch.Tensor],
                   mesh=None) -> None:
        """One optimizer step.  Across the ranks of `mesh` the gradients
        are first replaced by their mean, once per step and before the
        optimizer's global-norm clip, as the global batch's gradient is
        (an FSDP shard's gradient already is that mean)."""
        count("comm.bytes", all_reduce_mean_(
            [g for g, p in zip(grads, state.optimizer.params)
             if not is_sharded(p)], mesh))
        state.optimizer.step(grads)
        state.step += 1

    def train_step(self, state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None,
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   mesh=None) -> torch.Tensor:
        """One optimizer step on one batch; returns this rank's loss."""
        loss, grads = self.grad_step(state, batch, generator, draws, mesh)
        self.apply_step(state, grads, mesh)
        return loss
