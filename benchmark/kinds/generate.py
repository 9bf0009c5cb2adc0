"""Generation traffic: closed-loop requests, one video in flight, each
`generate_videos` over a PNG and a wav of the seeded pool (cycled), a text
encoding of the pool and a seed of its own, on an `AnimationPipeline` from
`runtime.load_animation_pipeline` in the configuration's `dtype`.

Set-up: the pipeline, the seeded weights loaded strictly into it, the
pool's files, and one request at `warmup_steps` sampler steps (every shape
of the window, every kernel built).  Window: whole requests, started while
the window is open; gen_clips_per_s is their clips over the time from the
window's start to the end of the last.  Traced run: the window again with
CUDA events around every request, `denoise` and UNet call, then one more
request whose UNet calls from `stretch_first_call` on are the units
of a profiled stretch of `stretch_units` (trace.Stretch), and one more
whole request read with the program's spans (spans.request_segment).
Check: one request of the window, drawn from the seed, against the plain
reference run on the same files and seed.
"""
from __future__ import annotations

import dataclasses
import gc
import itertools
import random
import time

import numpy as np
import torch

from .. import media, spans, sublayers, trace, weights, work
from ..harness import Outcome, Record, Run, Timer, dataclass_kwargs, sub_seed
from ..reference.ops import no_tf32
from ..reference.pipeline import Generator


def conditions(cfg: dict, traffic: dict, seed: int, device):
    """(null text encoding (1, T, d), the pool's text encodings
    (pool, 1, T, d)), seeded stand-ins for CLIP's, which are absent."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 20))
    t, d = cfg["text_tokens"], cfg["unet"]["cross_attention_dim"]
    null = torch.randn((1, t, d), generator=gen, device=device)
    texts = torch.randn((traffic["pool"], 1, t, d), generator=gen,
                        device=device)
    return null, texts


def request_seed(seed: int, i: int) -> int:
    return sub_seed(seed, 30, i) % (1 << 31)


def worst_clip_rms(program: np.ndarray, reference: np.ndarray) -> float:
    """The largest over clips of the RMS gap in uint8 levels."""
    d = program.astype(np.float64) - reference.astype(np.float64)
    return float(np.sqrt((d ** 2).reshape(d.shape[0], -1).mean(1)).max())


def build(R: Run, dtype=None):
    from asva_tpu_torch import runtime
    from asva_tpu_torch.models.unet3d import UNet3DConfig
    from asva_tpu_torch.models.vae import VAEConfig
    cfg = R.cell.config
    dtype = dtype or getattr(torch, cfg["dtype"])
    if dataclass_kwargs(cfg["audio"]) != dataclasses.asdict(
            runtime.ImageBindAudioConfig()):
        raise ValueError("load_animation_pipeline builds its default audio "
                         "tower; the configuration's audio group differs")
    pipe = runtime.load_animation_pipeline(
        n_segment=cfg["video_num_frame"], device=R.device, dtype=dtype,
        unet_config=UNet3DConfig(**dataclass_kwargs(cfg["unet"])),
        vae_config=VAEConfig(**dataclass_kwargs(cfg["vae"])))
    states = weights.draw_all(cfg, R.seed, R.device)
    for name, module in (("unet", pipe.unet), ("vae", pipe.vae),
                         ("audio", pipe.audio_encoder)):
        module.load_state_dict(states[name], strict=True)
    return pipe


def run(R: Run) -> Outcome:
    from asva_tpu_torch.ops import fused
    from asva_tpu_torch.pipelines.generate import generate_videos
    cfg, tr = R.cell.config, R.cell.traffic
    if (tr["loop"], tr["in_flight"]) != ("closed", 1):
        raise ValueError("the generation kind offers closed-loop load with "
                         "one request in flight")
    pipe = build(R)
    null_text, texts = conditions(cfg, tr, R.seed, R.device)
    pipe.null_text_encoding = null_text
    files = media.write_pool(R.tmpdir, R.seed, tr["pool"], cfg["image_size"],
                             tr["audio_seconds"])
    R.log("pipeline, weights and files ready")

    def request(i: int, steps: int = None) -> np.ndarray:
        item = i % tr["pool"]
        png, wav = files[item]
        out = generate_videos(
            pipe, image_path=png, audio_path=wav,
            category_text_encoding=texts[item],
            image_size=tuple(cfg["image_size"]), video_fps=cfg["video_fps"],
            video_num_frame=cfg["video_num_frame"],
            num_clips_per_video=tr["num_clips_per_video"],
            audio_guidance_scale=tr["audio_guidance_scale"],
            text_guidance_scale=tr["text_guidance_scale"],
            num_inference_steps=steps or tr["num_inference_steps"],
            seed=request_seed(R.seed, i), sampler=tr["sampler"],
            batch_clips=tr["batch_clips"])
        return np.stack([frames for frames, _ in out])

    request(0, tr["warmup_steps"])
    R.sync()
    rec = Record()
    timers = {k: Timer(R.device) for k in ("request", "denoise", "unet_call")}
    hooks = []
    if R.trace:
        rec.values["request_flops"] = work.request_flops(cfg, tr)
        denoise = pipe.denoise

        def timed_denoise(*a, **kw):
            timers["denoise"].start()
            out = denoise(*a, **kw)
            timers["denoise"].stop()
            return out
        pipe.denoise = timed_denoise
        hooks = [pipe.unet.register_forward_pre_hook(
                     lambda *_: timers["unet_call"].start()),
                 pipe.unet.register_forward_hook(
                     lambda *_: timers["unet_call"].stop())]

    if torch.device(R.device).type == "cuda":
        torch.cuda.reset_peak_memory_stats(R.device)
    R.log("window opens")
    t_start = time.perf_counter()
    outputs = []
    while time.perf_counter() - t_start < R.seconds:
        if R.trace:
            timers["request"].start()
        outputs.append(request(len(outputs)))
        if R.trace:
            timers["request"].stop()
    t_end = time.perf_counter()
    setup_s = t_start - R.t0
    peak = (torch.cuda.max_memory_allocated(R.device)
            if torch.device(R.device).type == "cuda" else 0)
    clips = tr["num_clips_per_video"] * len(outputs)
    R.log(f"window closed: {len(outputs)} requests in "
          f"{t_end - t_start:.3f} s, peak {peak / 2**30:.3f} GiB")
    rec.values.update(window_s=t_end - t_start, requests=len(outputs),
                      clips=clips, cards=R.world)
    breakdown = None
    if R.trace:
        R.sync()
        for k, t in timers.items():
            rec.events[k] = t.ms()
        for h in hooks:
            h.remove()
        rec.trace, rec.spans, breakdown = stretch(
            R, pipe, fused, request, len(outputs), tr["stretch_first_call"],
            tr["stretch_units"])
        rec.request_spans = spans.request_segment(R, request, len(outputs))
        if breakdown is not None and rec.request_spans is not None:
            breakdown["request_idle_by_span"] = \
                rec.request_spans["idle_by_span"][:10]
    n = len(outputs)
    checked = random.Random(R.seed).randrange(n)
    program = outputs[checked]
    del pipe, outputs
    gc.collect()
    if torch.device(R.device).type == "cuda":
        torch.cuda.empty_cache()
    reference = reference_request(R, files, null_text, texts, checked)
    checks = {"worst_clip_rms": (worst_clip_rms(program, reference),
                                 float(R.cell.limits["worst_clip_rms"]))}
    return Outcome(
        end_to_end={"gen_clips_per_s": clips / (t_end - t_start),
                    "peak_gib": peak / 2**30, "setup_s": setup_s},
        checks=checks, attempted=n, failed=0, peak_bytes=peak,
        record=rec, breakdown=breakdown)


def stretch(R: Run, pipe, fused, request, index: int, first: int, n: int):
    """One more request, whose UNet calls from `first` on are the units of
    a profiled stretch of n units (trace.Stretch); a second where a
    profile read nothing."""
    for _ in range(2):
        with sublayers.Sublayers(fused) as subs:
            st = trace.Stretch(R, n, subs, "gen")
            calls = itertools.count()
            hook = pipe.unet.register_forward_pre_hook(
                lambda *_: st.boundary() if next(calls) >= first else None)
            try:
                request(index)
            finally:
                hook.remove()
            st.boundary()        # after the last unit, where it was the
            got = st.result()    # request's last UNet call
        if got[0] is not None:
            break
    return got


def reference_request(R: Run, files, null_text, texts, i: int) -> np.ndarray:
    cfg, tr = R.cell.config, R.cell.traffic
    t0 = time.perf_counter()
    with no_tf32():
        ref = Generator(cfg, weights.draw_all(cfg, R.seed, R.device),
                        R.device)
        png, wav = files[i % tr["pool"]]
        frames = ref.request(png, wav, texts[i % tr["pool"]], null_text,
                             request_seed(R.seed, i), tr)
    R.log(f"reference request {i} in {time.perf_counter() - t0:.1f} s")
    return frames
