"""Fine-tuning traffic: optimizer steps of `gradient_accumulation_steps`
micro-batches of `batch_size` clips on each of `data_parallel` ranks, as
scripts/animation_train.train takes them: `AnimationTrainer.grad_step`
per micro-batch (its draws from a generator of the micro-batch's own
seed, the same on every rank), the gradients summed and divided by the
count, then `apply_step` (the ranks' mean over NCCL, the clip, masked
AdamW).  The UNet keeps fp32 trainables (the configuration's
`trainable_modules`) and frozen weights in its `dtype`, remat as the
traffic says; the VAE and the audio tower are in its `dtype`.

Set-up: the modules, the seeded weights loaded strictly, a pool of
micro-batches made on the card (uint8 frames, 16 kHz waveforms, text
encodings; distinct rows on every rank), and the first `checked_steps`
steps through the window's own step function, from which the losses, the
first step's clipped gradient (from AdamW's first moment) and each
trainable leaf's change are read.  Window: whole steps, started while the
window is open, each ending in a synchronize; train_clips_per_s counts
every rank's clips.  Check: the plain reference follows those first steps
on the same rows and draws.
"""
from __future__ import annotations

import gc
import itertools
import statistics
import time

import torch

from .. import sublayers, trace, weights, work
from ..harness import Outcome, Record, Run, Timer, dataclass_kwargs, sub_seed
from ..reference.ops import no_tf32
from ..reference.train import TRAINABLE, Trainer


def micro_batch(cfg: dict, tr: dict, seed: int, rank: int, i: int, device):
    """Rank `rank`'s rows of micro-batch i: uint8 frames, 0.1 N waveforms
    of a clip's seconds of audio and N(0, 1) text encodings."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 40, i,
                                                              rank))
    b, f = tr["batch_size"], cfg["video_num_frame"]
    h, w = cfg["image_size"]
    return {"videos": torch.randint(0, 256, (b, f, h, w, 3), generator=gen,
                                    device=device, dtype=torch.uint8),
            "waveforms": torch.randn(
                (b, 1, int(cfg["audio_sample_rate"]
                           * cfg["audio_seconds_per_clip"])),
                generator=gen, device=device) * 0.1,
            "text_encodings": torch.randn(
                (b, cfg["text_tokens"], cfg["unet"]["cross_attention_dim"]),
                generator=gen, device=device)}


def as_batch(mb: dict) -> dict:
    return dict(mb, videos=mb["videos"].float() / 255.0)


def draw_generator(seed: int, i: int, device) -> torch.Generator:
    """Micro-batch i's draws; the same on every rank (a global draw)."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, 50, i))


def null_text(cfg: dict, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 60))
    return torch.randn((1, cfg["text_tokens"],
                        cfg["unet"]["cross_attention_dim"]),
                       generator=gen, device=device)


def numbers(program: dict, reference: dict, accum: int) -> dict:
    """The readings of the checked steps; the cell's limits file names the
    ones compared.  Each leaf's gap is |program's norm - reference's norm|
    over max(the reference's norm of that leaf, the median leaf's).
    median_grad_gap: the median leaf's gap of the first clipped gradient
    (norms from AdamW's first moment).  change_gap: the worst leaf's gap of
    the change after the checked steps, leaving out leaves whose reference
    gradient is under a thousandth of the median leaf's (they move by
    round-off alone).  Read and not compared (PERF.md gives why):
    worst_grad_gap, the worst leaf's gap of the first clipped gradient;
    first_loss_gap, the worst relative gap of the first step's micro-batch
    losses; later_loss_gap, the same of the later steps'."""
    loss = [abs(p - r) / abs(r) for p, r in zip(program["losses"],
                                                reference["losses"])]
    g_ref, c_ref = reference["first_grad"], reference["change"]
    g_med = statistics.median(g_ref.values())
    grad = [abs(program["first_grad"][n] - g) / max(g, g_med)
            for n, g in g_ref.items()]
    moved = [n for n, g in g_ref.items() if g >= 1e-3 * g_med]
    c_med = statistics.median(c_ref[n] for n in moved)
    change = max(abs(program["change"][n] - c_ref[n]) / max(c_ref[n], c_med)
                 for n in moved)
    return {"median_grad_gap": statistics.median(grad), "change_gap": change,
            "worst_grad_gap": max(grad), "first_loss_gap": max(loss[:accum]),
            "later_loss_gap": max(loss[accum:])}


def build(R: Run, dtype=None):
    from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig
    from asva_tpu_torch.models.unet3d import UNet3DConfig
    from asva_tpu_torch.models.vae import VAEConfig
    from asva_tpu_torch.runtime import (build_audio_encoder, build_unet,
                                        build_vae)
    from asva_tpu_torch.training import (AnimationTrainConfig,
                                         AnimationTrainer, TrainState,
                                         build_optimizer, trainable_mask)
    from asva_tpu_torch.training.optim import apply_trainable_mask
    cfg, tr, dev = R.cell.config, R.cell.traffic, R.device
    dtype = dtype or getattr(torch, cfg["dtype"])
    if tuple(cfg["trainable_modules"]) != TRAINABLE:
        raise ValueError(f"the reference trains {TRAINABLE}; the "
                         f"configuration states {cfg['trainable_modules']}")
    unet = build_unet(UNet3DConfig(**dataclass_kwargs(cfg["unet"]),
                                   remat=True,
                                   remat_policy=tr["remat_policy"]),
                      device=dev, dtype=dtype, train=True)
    states = weights.draw_all(cfg, R.seed, dev)
    unet.load_state_dict(states["unet"], strict=True)
    mask = trainable_mask(unet)
    if {n for n, m in mask.items() if m} != {
            n for n in mask if any(t in n for t in TRAINABLE)}:
        raise ValueError("the port's trainable mask is not the parameters "
                         f"named by {TRAINABLE}")
    start = {n: states["unet"][n].clone() for n, m in mask.items() if m}
    apply_trainable_mask(unet, mask, frozen_dtype=dtype)
    vae = build_vae(VAEConfig(**dataclass_kwargs(cfg["vae"])), device=dev,
                    dtype=dtype)
    vae.load_state_dict(states["vae"], strict=True)
    audio = build_audio_encoder(
        cfg["video_num_frame"],
        ImageBindAudioConfig(**dataclass_kwargs(cfg["audio"])), device=dev,
        dtype=dtype)
    audio.load_state_dict(states["audio"], strict=True)
    del states
    trainer = AnimationTrainer(
        unet=unet, vae=vae, audio_encoder=audio,
        null_text_encoding=null_text(cfg, R.seed, dev),
        config=AnimationTrainConfig(
            text_cond_drop_prob=tr["text_cond_drop_prob"],
            audio_cond_drop_prob=tr["audio_cond_drop_prob"]))
    state = TrainState(0, unet, build_optimizer(
        unet, tr["learning_rate"], mask=mask,
        max_grad_norm=tr["max_grad_norm"],
        weight_decay=tr["weight_decay"]))
    return trainer, state, start


def _across(values, R: Run, op: str = "MAX"):
    """Each value's largest (or with op "MIN" least) over the ranks."""
    if R.world == 1:
        return values
    import torch.distributed as dist
    t = torch.tensor(values, dtype=torch.float64, device=R.device)
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
    return t.tolist()


def run(R: Run) -> Outcome:
    from asva_tpu_torch.ops import fused
    from asva_tpu_torch.parallel import mesh as meshlib
    from asva_tpu_torch.parallel import multihost
    cfg, tr, dev = R.cell.config, R.cell.traffic, R.device
    if tr["data_parallel"] != R.world:
        raise ValueError(f"the traffic trains data {tr['data_parallel']}, "
                         f"the run has {R.world} ranks")
    mesh = meshlib.make_mesh(device=dev) if R.world > 1 else None
    trainer, state, start = build(R)
    pool = [micro_batch(cfg, tr, R.seed, R.rank, i, dev)
            for i in range(tr["pool_micro_batches"])]
    accum = tr["gradient_accumulation_steps"]
    R.log("trainer, weights and micro-batches ready")
    micro = itertools.count()

    def step():
        acc, losses = None, []
        for _ in range(accum):
            i = next(micro)
            loss, grads = trainer.grad_step(
                state, as_batch(pool[i % len(pool)]),
                draw_generator(R.seed, i, dev), mesh=mesh)
            acc = grads if acc is None else [a + g for a, g in zip(acc,
                                                                   grads)]
            losses.append(loss)
        if accum > 1:
            acc = [g / accum for g in acc]
        trainer.apply_step(state, acc, mesh)
        R.sync()
        return losses

    opt = state.optimizer
    program = {"losses": []}
    for k in range(tr["checked_steps"]):
        program["losses"] += torch.stack(step()).tolist()
        if k == 0:
            norms = torch.stack([(m.float() / (1 - opt.b1)).norm()
                                 for m in opt.mu]).tolist()
            program["first_grad"] = dict(zip(opt.names, norms))
    norms = torch.stack([(p.detach().float() - start[n]).norm()
                         for n, p in zip(opt.names, opt.params)]).tolist()
    program["change"] = dict(zip(opt.names, norms))
    del start
    R.log(f"{tr['checked_steps']} checked steps: losses "
          f"{program['losses']}")

    rec = Record()
    timers = {k: Timer(dev) for k in ("grad_step", "apply_step")}
    if R.trace:
        rec.values["step_flops"] = work.step_flops(cfg, tr, R.world)
        for name, timer in timers.items():
            setattr(trainer, name, _timed(getattr(trainer, name), timer))
    if torch.device(dev).type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    R.sync()
    R.log("window opens")
    t_start = time.perf_counter()
    steps = 0
    while multihost.broadcast_object(
            time.perf_counter() - t_start < R.seconds):
        step()
        steps += 1
    t_end = time.perf_counter()
    setup_s = t_start - R.t0
    peak = (torch.cuda.max_memory_allocated(dev)
            if torch.device(dev).type == "cuda" else 0)
    clips = steps * accum * tr["batch_size"] * R.world
    R.log(f"window closed: {steps} steps in {t_end - t_start:.3f} s, peak "
          f"{peak / 2**30:.3f} GiB")
    rec.values.update(window_s=t_end - t_start, steps=steps, clips=clips,
                      cards=R.world)
    breakdown = None
    if R.trace:
        rec.events["grad_step"] = timers["grad_step"].ms()
        # each step's least over the ranks: the rank that reaches the
        # exchange last waits for no other
        rec.events["apply_step"] = _across(timers["apply_step"].ms(), R,
                                           "MIN")
        for name in timers:
            delattr(trainer, name)
        rec.trace, rec.spans, breakdown = stretch(R, fused, step,
                                                  tr["stretch_units"])
    peak = int(_across([float(peak)], R)[0])
    del trainer, state, pool
    gc.collect()
    if torch.device(dev).type == "cuda":
        torch.cuda.empty_cache()
    reference = reference_steps(R)
    got = numbers(program, reference, accum)
    worst = dict(zip(got, _across(list(got.values()), R)))
    R.log(f"readings not compared: "
          f"{ {k: v for k, v in worst.items() if k not in R.cell.limits} }")
    checks = {k: (worst[k], float(lim)) for k, lim in R.cell.limits.items()}
    return Outcome(
        end_to_end={"train_clips_per_s": clips / (t_end - t_start),
                    "peak_gib": peak / 2**30, "setup_s": setup_s},
        checks=checks, attempted=steps, failed=0, peak_bytes=peak,
        record=rec, breakdown=breakdown)


def _timed(fn, timer):
    def call(*a, **kw):
        timer.start()
        out = fn(*a, **kw)
        timer.stop()
        return out
    return call


def stretch(R: Run, fused, step, n: int):
    """A profiled stretch of n optimizer steps (trace.Stretch); a second
    where a profile read nothing."""
    for _ in range(2):
        with sublayers.Sublayers(fused) as subs:
            st = trace.Stretch(R, n, subs, "train")
            while not st.done:
                st.boundary()
                if not st.done:
                    step()
            got = st.result()
        if got[0] is not None:
            break
    return got


def reference_steps(R: Run) -> dict:
    cfg, tr, dev = R.cell.config, R.cell.traffic, R.device
    t0 = time.perf_counter()
    n = tr["checked_steps"] * tr["gradient_accumulation_steps"]
    mean_across = None
    if R.world > 1:
        import torch.distributed as dist

        def mean_across(tensors):
            for t in tensors:
                dist.all_reduce(t)
                t.div_(R.world)
    with no_tf32():
        ref = Trainer(cfg, weights.draw_all(cfg, R.seed, dev), tr, dev)
        out = ref.steps(
            [as_batch(micro_batch(cfg, tr, R.seed, R.rank, i, dev))
             for i in range(n)],
            [lambda i=i: draw_generator(R.seed, i, dev) for i in range(n)],
            null_text(cfg, R.seed, dev), tr["checked_steps"], R.world,
            R.rank, mean_across)
    R.log(f"reference steps in {time.perf_counter() - t0:.1f} s: losses "
          f"{out['losses']}")
    return out
