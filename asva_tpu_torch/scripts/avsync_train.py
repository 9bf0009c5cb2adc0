"""AVSync classifier contrastive training.  Port of scripts/avsync_train.py
(the reference's avsync_train), plus `--device`:

    python3 -m asva_tpu_torch.scripts.avsync_train --config_file \
        configs/avsync/vggss_sync_contrast.yaml [--max_steps_override N] \
        [--device cpu]
    torchrun --nproc_per_node 2 -m asva_tpu_torch.scripts.avsync_train \
        --config_file ... --device cuda     # data parallel over 2 ranks

k=21 time-shifted clips per video, symmetric InfoNCE over the k x k pair
score matrix, a periodic in-train eval over the test loader, step and
milestone checkpoints with the `classifier` export and the loader's state,
resume from the latest checkpoint, a last checkpoint on SIGTERM/SIGINT and
a final forced one.  The training items come through the loader's process
workers: a 21-clip item holds the interpreter lock for most of its decode,
so threads cannot feed a step.

Across processes each rank trains a replica on its shard of the train and
test loaders; BatchNorm normalises by the global batch's statistics, the
gradients and the logged metrics are the ranks' means (one reduction a
step), `evaluate` sums every rank's batches, rank 0's replica is broadcast
after the build and after a restore, and rank 0 alone writes checkpoints.
"""
from __future__ import annotations

import argparse
import os
import time

from .common import add_device_flag, compute_dtype

METRICS = ("av_loss", "va_loss", "av_acc", "va_acc")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--config_file", required=True)
    p.add_argument("--max_steps_override", type=int, default=None)
    add_device_flag(p)
    return p


def build_dataset(cfg, dcfg, mode: str):
    from ..data.multipair import MultiPairAVDataset
    return MultiPairAVDataset(
        dcfg.example_list_path, dcfg.data_root, mode=mode,
        image_size=dcfg.image_size, video_fps=dcfg.video_fps,
        video_num_frames=dcfg.video_num_frames, randflip=dcfg.randflip,
        shift_time=dcfg.shift_time, num_clips=dcfg.num_clips,
        sampling_type=dcfg.sampling_type, seed=cfg.seed)


def mels_of(waveforms):
    """(..., samples) waveforms on the device -> (..., 128, 204, 1) mels."""
    import torch

    from ..ops.mel import waveform_to_mel
    flat = waveforms.reshape(-1, waveforms.shape[-1])
    mels = torch.stack([waveform_to_mel(w) for w in flat])
    return mels.reshape(waveforms.shape[:-1] + mels.shape[1:])


def train(cfg, train_dataset, test_dataset, device="cuda",
          max_steps=None) -> dict:
    """Train the AVSync classifier of `cfg` (a SyncJobConfig) on
    `train_dataset`, evaluating on `test_dataset` every cfg.test_steps,
    until `max_steps` steps (default cfg.optim.max_train_steps).  The train
    loader forks one worker process per CPU core.  Under a process group
    `device` is resolved to this local rank's.  Returns
    {"state", "trainer", "test_loader", "metrics": [per step],
    "step_times", "loader", "resumed_from"}."""
    from ..data.loader import DataLoader
    from ..observability import GracefulShutdown
    from ..parallel import batch_sharding, make_mesh, replicate
    from ..parallel.multihost import globalize_host_local, make_global_batch
    from ..runtime import build_avsync_classifier, init_avsync_from_avid_cma
    from ..training import (SyncContrastiveTrainer, SyncTrainState,
                            build_optimizer)
    from ..training.checkpoint import CheckpointManager
    from ..utils import AverageMeter, StepTimer, setup_logging

    max_steps = max_steps or cfg.optim.max_train_steps
    log = setup_logging(os.path.join(cfg.output_dir, "train.log"))
    mesh = make_mesh(device)
    device = mesh.device
    log.info("mesh: rank %d of %d on %s %s", mesh.rank, mesh.world, device,
             mesh.backend)

    clf = build_avsync_classifier(device=device, seed=cfg.seed, train=True)
    wanted = tuple(m for m, on in (("audio", cfg.audio_pretrained),
                                   ("video", cfg.video_pretrained)) if on)
    if wanted:
        if os.path.isfile(cfg.avid_cma_path):
            init_avsync_from_avid_cma(clf, cfg.avid_cma_path, modules=wanted)
        else:
            log.warning(
                "config requests AVID-CMA pretrained encoders but %s is "
                "missing — training from scratch will NOT reproduce the "
                "reference protocol", cfg.avid_cma_path)
    replicate(mesh, clf)

    trainer = SyncContrastiveTrainer(clf, tau=cfg.tau,
                                     compute_dtype=compute_dtype(device))
    o = cfg.optim
    optimizer = build_optimizer(
        clf, o.learning_rate, max_grad_norm=o.max_grad_norm,
        adam_beta1=o.adam_beta1, adam_beta2=o.adam_beta2,
        adam_eps=o.adam_epsilon, weight_decay=o.adam_weight_decay,
        warmup_steps=(o.lr_warmup_steps
                      if o.lr_scheduler == "constant_with_warmup" else 0))
    state = globalize_host_local(SyncTrainState(0, clf, optimizer))

    ckpt = CheckpointManager(os.path.join(cfg.output_dir, "ckpts"),
                             o.checkpointing_steps,
                             o.checkpointing_milestones)
    resumed_extra = resumed_from = None
    restored = ckpt.restore_latest(map_location=device)
    if restored is not None:
        resumed_from, saved = restored
        state.load_state_dict(saved)
        replicate(mesh, clf)
        replicate(mesh, optimizer.mu + optimizer.nu)
        resumed_extra = ckpt.restore_extra(resumed_from)
        log.info("resumed from step %d", resumed_from)

    train_loader = DataLoader(train_dataset, cfg.batch_size, shuffle=True,
                              num_workers=os.cpu_count() or 8,
                              seed=cfg.seed, worker_mode="process",
                              shard=batch_sharding(mesh))
    if resumed_extra and "loader" in resumed_extra:
        train_loader.load_state_dict(resumed_extra["loader"])
        log.info("data order resumed at epoch %d batch %d",
                 train_loader.epoch, train_loader._cursor)
    test_loader = DataLoader(test_dataset, cfg.test_batch_size,
                             shuffle=False, num_workers=8, drop_last=False,
                             shard=batch_sharding(mesh))
    if len(train_loader) == 0:
        raise ValueError("dataset smaller than the batch "
                         f"({len(train_loader.dataset)} examples)")

    def save(step, force=False):
        return ckpt.save(step, state.state_dict(), force=force,
                         modules={"classifier": clf.state_dict()},
                         extra={"loader": train_loader.state_dict()})

    meter = {k: AverageMeter(window=cfg.log_steps) for k in METRICS}
    timer = StepTimer()
    shutdown = GracefulShutdown()
    step = state.step
    per_step, step_times = [], []
    stop = False
    try:
        while step < max_steps and not stop:
            for batch in train_loader:
                dev = make_global_batch({"waveforms": batch["waveforms"],
                                         "videos": batch["videos"]}, device)
                m = trainer.train_step(state, {"mels": mels_of(
                    dev["waveforms"]), "videos": dev["videos"]}, mesh)
                del dev
                step = state.step
                per_step.append({k: float(v) for k, v in m.items()})
                for name in meter:
                    meter[name].update(per_step[-1][name])
                timer.tick()
                step_times.append(time.perf_counter())
                if step % cfg.log_steps == 0:
                    log.info("step %d av %.3f/%.2f va %.3f/%.2f %.2f it/s",
                             step, meter["av_loss"].avg, meter["av_acc"].avg,
                             meter["va_loss"].avg, meter["va_acc"].avg,
                             timer.steps_per_sec)
                if cfg.test_steps and step % cfg.test_steps == 0:
                    evaluate(trainer, test_loader, device, log, step=step)
                if ckpt.should_save(step):
                    save(step)
                    log.info("saved checkpoint-%d", step)
                if shutdown.poll(step % cfg.log_steps == 0):
                    log.info("shutdown requested: checkpointing at %d", step)
                    stop = True
                # stop before fetching a batch that no step would use
                if stop or step >= max_steps:
                    break
        save(step, force=True)   # a no-op where should_save just saved
        ckpt.close()
    finally:
        shutdown.restore()
        train_loader.close()
    return dict(state=state, trainer=trainer, test_loader=test_loader,
                metrics=per_step, step_times=step_times,
                loader=train_loader.state_dict(), resumed_from=resumed_from)


def evaluate(trainer, test_loader, device, log, step=0,
             max_batches=50) -> dict:
    """In-train test pass (scripts/avsync_train.py:190-234): eval-mode
    BatchNorm, so accuracies do not depend on the test batch's
    composition; the metrics' batch-size-weighted mean over at most
    `max_batches` batches of every rank's shard (the sums and the count
    gathered over the ranks)."""
    import numpy as np

    from ..parallel.multihost import make_global_batch, process_allgather

    sums = {k: 0.0 for k in METRICS}
    count = 0
    # a stateless pass: without reset() the loader's resume cursor would
    # slide each pass's window (every pass stops at max_batches)
    test_loader.reset()
    for i, batch in enumerate(test_loader):
        if i >= max_batches:
            break
        dev = make_global_batch({"waveforms": batch["waveforms"],
                                 "videos": batch["videos"]}, device)
        metrics = trainer.eval_metrics({"mels": mels_of(dev["waveforms"]),
                                        "videos": dev["videos"]})
        bsz = len(batch["waveforms"])
        for name in sums:
            sums[name] += float(metrics[name]) * bsz
        count += bsz
    totals = process_allgather(
        np.array([[sums[k] for k in sorted(sums)] + [float(count)]]))
    totals = totals.sum(axis=0)
    n = max(totals[-1], 1.0)
    mean = dict(zip(sorted(sums), totals[:-1] / n))
    if count:
        log.info("eval step %d: test_loss %.4f av %.4f/%.4f va %.4f/%.4f",
                 step, (mean["av_loss"] + mean["va_loss"]) / 2.0,
                 mean["av_loss"], mean["av_acc"],
                 mean["va_loss"], mean["va_acc"])
    return mean


def main(argv=None):
    args = parser().parse_args(argv)
    from ..config import SyncJobConfig
    from ..parallel.multihost import maybe_initialize_distributed
    maybe_initialize_distributed(args.device)
    cfg = SyncJobConfig.from_yaml(args.config_file)
    return train(cfg, build_dataset(cfg, cfg.train_dataset, "train"),
                 build_dataset(cfg, cfg.test_dataset, "test"), args.device,
                 args.max_steps_override or cfg.optim.max_train_steps)


if __name__ == "__main__":
    main()
