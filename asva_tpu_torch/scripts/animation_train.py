"""AVSyncD diffusion fine-tuning.  Port of scripts/animation_train.py (the
reference's animation_train), plus `--device`:

    python3 -m asva_tpu_torch.scripts.animation_train --config_file \
        configs/audio-cond_animation/avsync15_audio-cond_cfg.yaml \
        [--max_steps_override N] [--device cpu]
    torchrun --nproc_per_node 2 -m asva_tpu_torch.scripts.animation_train \
        --config_file ... --device cuda     # data parallel over 2 ranks
    torchrun --nproc_per_node 2 -m asva_tpu_torch.scripts.animation_train \
        --config_file ... --fsdp 2          # the UNet split over 2 ranks

One YAML config drives the job (the reference's files parse unchanged).
`main` parses the flags and builds the dataset; `train` holds the loop:
frozen VAE and audio tower, the UNet's `_temp`/`_audio` parameters trained
by masked AdamW, gradient accumulation as a loop of micro-batches, losses
kept on the device until a log boundary, checkpoints at `should_save` with
the `unet` and `audio_encoder` exports and the loader's state, resume from
the latest checkpoint (the loader's state included), a last checkpoint on
SIGTERM/SIGINT and a final forced one.

Across processes (torchrun's environment, `parallel.multihost`) each rank
trains a replica on its shard of every epoch (`batch_size` items a rank),
draws its rows of one global draw, and takes the ranks' mean gradient once
per optimizer step: the step of one process on the global batch.  Rank 0's
replica is broadcast after the build and after a restore; rank 0 alone
writes checkpoints and metrics; the logged loss is the ranks' mean.
With `--fsdp N` the ranks form a (data, fsdp) mesh: the UNet's parameters
of at least 2**16 elements (frozen ones too) and their moments are split
over each fsdp group and gathered one UNet unit at a time
(parallel/sharding.py); the batch is still sharded over every rank, and
checkpoints hold the state of one process, so they resume at any fsdp
size.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

from .common import add_device_flag, compute_dtype


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", required=True)
    p.add_argument("--fsdp", type=int, default=1,
                   help="split the UNet and its optimizer state over this "
                        "many ranks (it must divide the process count)")
    p.add_argument("--max_steps_override", type=int, default=None)
    p.add_argument("--profile_dir", default=None,
                   help="capture a torch.profiler trace of steps 10-15 here")
    add_device_flag(p)
    return p


def build_dataset(cfg):
    from ..data.datasets import AudioVideoDataset
    d = cfg.dataset
    return AudioVideoDataset(
        d.example_list_path, d.data_root, mode="train",
        video_fps=d.video_fps, video_num_frame=d.video_num_frame,
        img_size=tuple(d.img_size), randflip=d.randflip,
        class_mapping_json=d.class_mapping_json,
        class_text_encoding_mapping_path=d.class_text_encoding_mapping_pt,
        seed=cfg.seed)


def micro_generator(seed: int, micro: int, device) -> "torch.Generator":
    """The noise, timestep and dropout stream of one micro-batch: a function
    of (seed, micro-batch counter) alone, so a resumed run draws what the
    uninterrupted run drew."""
    import torch
    return torch.Generator(device=device).manual_seed(
        seed * 1_000_003 + micro)


def train(cfg, dataset, device="cuda", max_steps=None, *,
          profile_dir=None, fsdp=1) -> dict:
    """Train the AVSyncD UNet of `cfg` (an AnimationJobConfig) on `dataset`
    until `max_steps` optimizer steps (default cfg.optim.max_train_steps),
    through a DataLoader of 8 threads.  Under a process group `device` is
    resolved to this local rank's (`parallel.make_mesh`), and `fsdp` ranks
    share each split of the UNet.  Returns {"state":
    TrainState, "losses": [the last micro-batch's loss of each step taken
    here, the ranks' mean],
    "step_times": [time.perf_counter() after each step], "loader": the
    loader's state at the end, "resumed_from": a step or None}."""
    import torch

    from ..data.loader import DataLoader
    from ..observability import (GracefulShutdown, MetricsLogger,
                                 profile_steps)
    from ..parallel import batch_sharding, make_mesh, replicate
    from ..parallel.multihost import globalize_host_local, make_global_batch
    from ..parallel.reduce import all_reduce_mean_
    from ..parallel.sharding import fsdp_shardings, is_sharded, shard_module
    from ..runtime import (build_audio_encoder, build_unet, build_vae,
                           load_null_text_encoding)
    from ..training import (AnimationTrainConfig, AnimationTrainer,
                            TrainState, build_optimizer, trainable_mask)
    from ..training.checkpoint import CheckpointManager
    from ..training.optim import (apply_trainable_mask,
                                  segments_for_trainable_modules)
    from ..utils import AverageMeter, StepTimer, setup_logging

    max_steps = max_steps or cfg.optim.max_train_steps
    log = setup_logging(os.path.join(cfg.output_dir, "train.log"))
    log.info("config: %s", cfg)
    mesh = make_mesh(device, fsdp)
    device = mesh.device
    log.info("mesh: rank %d of %d on %s %s, fsdp %d", mesh.rank, mesh.world,
             device, mesh.backend, fsdp)
    dtype = compute_dtype(device)

    # models: the UNet grafted from SD1.5 2D weights when they are present
    pretrained = cfg.pretrained_unet_path
    unet = build_unet(cfg.unet, device, dtype, train=True,
                      weights_dir=(os.path.join(pretrained, "unet")
                                   if pretrained else None))
    mask = (trainable_mask(unet, ()) if cfg.train_image_modules else
            trainable_mask(unet, segments_for_trainable_modules(
                cfg.trainable_modules)))
    apply_trainable_mask(unet, mask, frozen_dtype=dtype)
    vae = build_vae(device=device, dtype=dtype,
                    weights_dir=(os.path.join(pretrained, "vae")
                                 if pretrained else None))
    audio = build_audio_encoder(cfg.n_segment, device=device, dtype=dtype)
    for module in (unet, vae, audio):
        replicate(mesh, module)
    shard_module(unet, fsdp_shardings(unet, mesh), mesh)
    null_text = load_null_text_encoding(cfg.null_text_encoding_path, device)
    if null_text is None:
        null_text = torch.zeros((1, 77, 768), device=device)
    trainer = AnimationTrainer(
        unet=unet, vae=vae, audio_encoder=audio, null_text_encoding=null_text,
        schedule=cfg.schedule,
        config=AnimationTrainConfig(
            text_cond_drop_prob=cfg.text_cond_drop_prob,
            audio_cond_drop_prob=cfg.audio_cond_drop_prob,
            loss_on_first_frame=cfg.loss_on_first_frame,
            # the target must follow the schedule the sampler reads
            prediction_type=cfg.schedule.prediction_type))
    o = cfg.optim
    optimizer = build_optimizer(
        unet, o.learning_rate, mask=mask, max_grad_norm=o.max_grad_norm,
        adam_beta1=o.adam_beta1, adam_beta2=o.adam_beta2,
        adam_eps=o.adam_epsilon, weight_decay=o.adam_weight_decay,
        warmup_steps=(o.lr_warmup_steps
                      if o.lr_scheduler == "constant_with_warmup" else 0))
    state = globalize_host_local(TrainState(0, unet, optimizer))

    ckpt = CheckpointManager(
        os.path.join(cfg.output_dir, "ckpts"), o.checkpointing_steps,
        o.checkpointing_milestones,
        module_configs={"unet": dataclasses.asdict(cfg.unet),
                        "audio_encoder": dict(dataclasses.asdict(
                            audio.config), n_segment=cfg.n_segment)})
    resumed_extra = resumed_from = None
    if o.resume_from_checkpoint == "latest":
        # onto the host: a rank's device holds only its share of the state
        restored = ckpt.restore_latest(map_location="cpu")
        if restored is not None:
            resumed_from, saved = restored
            state.load_state_dict(saved)
            del saved
            replicate(mesh, unet)
            replicate(mesh, [m for p, mu, nu in zip(
                optimizer.params, optimizer.mu, optimizer.nu)
                if not is_sharded(p) for m in (mu, nu)])
            resumed_extra = ckpt.restore_extra(resumed_from)
            log.info("resumed from step %d", resumed_from)

    loader = DataLoader(dataset, cfg.batch_size, shuffle=True,
                        num_workers=8, seed=cfg.seed,
                        shard=batch_sharding(mesh))
    if resumed_extra and "loader" in resumed_extra:
        loader.load_state_dict(resumed_extra["loader"])
        log.info("data order resumed at epoch %d batch %d", loader.epoch,
                 loader._cursor)
    if len(loader) == 0:
        raise ValueError("dataset smaller than the batch "
                         f"({len(loader.dataset)} examples)")

    def save(step, force=False):
        full = state.state_dict()    # every rank gathers its splits
        return ckpt.save(step, full, force=force,
                         modules={"unet": full["unet"],
                                  "audio_encoder": audio.state_dict()},
                         extra={"loader": loader.state_dict()})

    accum = o.gradient_accumulation_steps
    meter, timer = AverageMeter(window=cfg.log_steps), StepTimer()
    metrics = MetricsLogger(os.path.join(cfg.output_dir, "metrics.jsonl"),
                            log_with=cfg.log_with,
                            run_name=os.path.basename(cfg.output_dir))
    shutdown = GracefulShutdown()
    step = timed = state.step   # timed: the last step the timer counted
    micro = step * accum     # the micro-batch counter behind the draws
    acc_grads, acc_count = None, 0
    prof = None
    pending = []             # device losses, read at the log boundaries
    losses, step_times = [], []

    def flush():
        """The pending losses, the ranks' mean, in one reduction."""
        if pending:
            mean = torch.stack(pending)
            all_reduce_mean_([mean], mesh)
            for loss in mean.tolist():
                losses.append(loss)
                meter.update(loss)
        pending.clear()

    stop = False
    try:
        while step < max_steps and not stop:
            for batch in loader:
                gen = micro_generator(cfg.seed, micro, device)
                micro += 1
                dev_batch = make_global_batch(
                    {"videos": batch["video"],
                     "waveforms": batch["waveform"],
                     "text_encodings": batch["text_encoding"]}, device)
                loss, grads = trainer.grad_step(state, dev_batch, gen,
                                                mesh=mesh)
                del dev_batch
                if accum > 1:
                    acc_grads = grads if acc_grads is None else [
                        a + g for a, g in zip(acc_grads, grads)]
                    acc_count += 1
                    if acc_count < accum:
                        continue
                    grads = [g / accum for g in acc_grads]
                    acc_grads, acc_count = None, 0
                trainer.apply_step(state, grads, mesh)
                del grads
                step = state.step
                pending.append(loss)
                step_times.append(time.perf_counter())
                if step % cfg.log_steps == 0:
                    flush()      # reads the losses back: the steps are done
                    timer.tick(step - timed)
                    timed = step
                    log.info("step %d loss %.4f %.2f steps/s", step,
                             meter.avg, timer.steps_per_sec)
                    metrics.log(step, loss=meter.avg,
                                steps_per_sec=timer.steps_per_sec)
                if profile_dir and step == 10:
                    prof = profile_steps(profile_dir)
                    prof.__enter__()
                if profile_dir and step == 15 and prof is not None:
                    # None when resumed from a step-10..14 checkpoint
                    prof.__exit__(None, None, None)
                    prof = None
                if ckpt.should_save(step):
                    save(step)
                    log.info("saved checkpoint-%d", step)
                if shutdown.poll(step % cfg.log_steps == 0):
                    log.info("shutdown requested: checkpointing at %d", step)
                    stop = True
                # stop before fetching a batch that no step would use: the
                # loader's cursor then counts exactly the batches trained on
                if stop or step >= max_steps:
                    break
        if not ckpt.should_save(step):   # else saved just now
            save(step, force=True)
        ckpt.close()
        flush()
        log.info("done at step %d", step)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        metrics.close()
        shutdown.restore()
        loader.close()
    return dict(state=state, losses=losses, step_times=step_times,
                loader=loader.state_dict(), resumed_from=resumed_from)


def main(argv=None):
    args = parser().parse_args(argv)
    from ..config import AnimationJobConfig
    from ..parallel.multihost import maybe_initialize_distributed
    maybe_initialize_distributed(args.device)
    cfg = AnimationJobConfig.from_yaml(args.config_file)
    return train(cfg, build_dataset(cfg), args.device,
                 args.max_steps_override or cfg.optim.max_train_steps,
                 profile_dir=args.profile_dir, fsdp=args.fsdp)


if __name__ == "__main__":
    main()
