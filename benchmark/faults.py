"""Faults planted in the program underneath a run, each of which has to
turn the run's `correct` false: the readings that bound a cell's limits
from above (with the control, control.py), and the CPU tests' faults.

    python3 benchmark/faults.py --workload <name> --fault <fault> \
        --seed <n> [--seed ...]

runs the cell with the fault planted and a one-second window for each
seed and prints one JSON line per seed with the compared numbers.  A cell
on several cards starts its ranks as run.py does; rank 0 prints.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness  # noqa: E402


def altered_answer(patch):
    """Generation: the first clip's frames inverted where they are
    decoded."""
    from asva_tpu_torch.pipelines.animation import AnimationPipeline
    decode = AnimationPipeline.decode_latents

    def altered(self, latents):
        out = decode(self, latents).clone()
        out[0] = 1.0 - out[0]
        return out
    patch(AnimationPipeline, "decode_latents", altered)


def half_clips(patch):
    """Generation: the first half of a request's clips computed and
    repeated in place of the rest."""
    from asva_tpu_torch.pipelines.animation import AnimationPipeline
    call = AnimationPipeline.__call__

    def half(self, images, mels, texts, **kw):
        h = max(1, images.shape[0] // 2)
        out = call(self, images[:h], mels[:h], texts[:h], **kw)
        return out[torch.arange(images.shape[0]) % h]
    patch(AnimationPipeline, "__call__", half)


def unchanged_state(patch):
    """Training: the optimizer step returns with the state unchanged."""
    from asva_tpu_torch.training import optim
    patch(optim.AdamW, "step", lambda self, grads: None)


def half_batch(patch):
    """Training: the loss is the mean over the first half of the batch."""
    from asva_tpu_torch.training.animation_trainer import AnimationTrainer
    loss_fn = AnimationTrainer.loss_fn

    def half(self, batch, generator=None, draws=None, mesh=None):
        h = batch["videos"].shape[0] // 2
        f = batch["videos"].shape[1]
        d = self.draw(batch, generator, mesh) if draws is None else draws
        return loss_fn(self, {k: v[:h] for k, v in batch.items()},
                       draws={k: v[:h * f] if k == "vae_noise" else v[:h]
                              for k, v in d.items()})
    patch(AnimationTrainer, "loss_fn", half)


def altered_update(patch):
    """Training: the first trainable leaf's update doubled where the
    optimizer produces it."""
    from asva_tpu_torch.training import optim
    step = optim.AdamW.step

    def doubled(self, grads):
        before = self.params[0].detach().clone()
        norm = step(self, grads)
        with torch.no_grad():
            self.params[0].add_(self.params[0] - before)
        return norm
    patch(optim.AdamW, "step", doubled)


def no_exchange(patch):
    """Training across ranks: the gradient mean across ranks left out."""
    from asva_tpu_torch.training import animation_trainer
    patch(animation_trainer, "all_reduce_mean_", lambda tensors, mesh: 0)


FAULTS = {f.__name__: f for f in (altered_answer, half_clips,
                                  unchanged_state, half_batch, altered_update,
                                  no_exchange)}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--fault", required=True, choices=sorted(FAULTS))
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    rank, device, procs = harness.start_ranks(
        cell, os.path.abspath(__file__), argv)
    FAULTS[args.fault](setattr)
    for seed in args.seed:
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory(prefix="asva_fault_") as tmp:
            run = harness.Run(cell=cell, seed=seed, seconds=1.0, trace=False,
                              device=device, t0=t0, tmpdir=tmp, rank=rank,
                              world=cell.chips)
            outcome = harness.kind_module(cell).run(run)
        if rank == 0:
            print(json.dumps({
                "workload": cell.name, "seed": seed, "fault": args.fault,
                "numbers": {k: v for k, (v, _) in outcome.checks.items()},
                "correct": harness.correct(outcome.checks),
                "seconds": time.perf_counter() - t0,
                "card": harness.power_limit()}), flush=True)
    harness.end_ranks(cell, procs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
