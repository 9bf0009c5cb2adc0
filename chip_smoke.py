#!/usr/bin/env python3
"""Drive the PyTorch port (asva_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # needs one NVIDIA H100 (sm_90a)

Phases, in order; any failure exits non-zero and prints no result:
  1. build    — nvcc the kernels in asva_tpu_torch/csrc (one process per
                source, in parallel) into the git-ignored build directory;
  2. kernels  — each kernel (B1 fused_ln_attn, B2 fused_ln_attn3, B3
                fused_ln_geglu) against its plain PyTorch version on the
                card at every SD1.5 level's shapes, fp32 and bf16, with
                median times of both (CUDA events, after warm-up);
  3. unet     — the full-width UNet3DConfig() (seeded random weights, every
                parameter randomised), x (2, 12, 32, 32, 4): fuse_blocks=True
                (B2 + B3) vs fuse_blocks=False (B1 + B3) vs all-plain, in
                bf16 and fp32; the fuse_blocks=False run is the B1 path;
  4. pipeline — load_animation_pipeline() at full width (bf16, random
                weights) answers 3 requests (256x256 image + 2 s of 16 kHz
                audio, own seed, DDIM 5 steps, audio guidance 4.0, decode
                on): shape, finite, [0, 1], frame 0 pinned; this is the
                B2 + B3 path.  The first request's latents are then held
                against the plain sub-layers in bf16 and in fp32.
Launch counters are zeroed just before each path run and read just after.

Tolerances (max |kernel - plain| over the output):
  fp32  <= 1e-4 * max(1, max|plain|): fp32 products; only the summation
        order and the online-softmax normalisation differ;
  bf16  <= 2**-6 * max|plain|, i.e. two bf16 ulps at the output's largest
        magnitude: the kernels round q, P and h to bf16 where the Pallas
        kernels do, the plain versions where the JAX composites do, and
        the online softmax rounds P before normalising.
The UNet tolerances are stated beside its checks below.

Output: the kernels line, the card line (nvidia-smi name, power limit), and
last the device line {"ok": true, "device": {...}}.  Details go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SD_LEVELS = {"32x32": (1024, 320), "16x16": (256, 640), "8x8": (64, 1280),
             "4x4": (16, 1280)}
B, F, HEADS = 2, 12, 8          # 2 CFG clips of 12 frames, SD1.5 heads
AUDIO_TOKENS, TEXT_TOKENS = 25, 77
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
KERNELS = {
    "B1": ("asva_tpu/ops/pallas_fused.py:304", "pallas_fused._ln_attn_flat",
           ["asva_tpu_torch/csrc/attn.cu", "asva_tpu_torch/csrc/gemm.cu"]),
    "B2": ("asva_tpu/ops/pallas_fused.py:487", "pallas_fused._ln_attn3_flat",
           ["asva_tpu_torch/csrc/attn.cu", "asva_tpu_torch/csrc/gemm.cu"]),
    "B3": ("asva_tpu/ops/pallas_fused.py:123", "pallas_fused._ln_geglu_flat",
           ["asva_tpu_torch/csrc/gemm.cu"]),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def time_ms(fn, warmup: int = 2, iters: int = 7) -> float:
    """Median milliseconds of fn() on the current stream (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


# ------------------------------------------------------------- phase 2 ---

def _rand(gen, shape, dtype, scale=1.0, shift=0.0):
    import torch
    x = torch.randn(shape, generator=gen, device="cuda", dtype=torch.float32)
    return (x * scale + shift).to(dtype)


def _sub(gen, c, dtype):
    """One attention sub-layer's (ls, lb, wq, wo, bo), Linear layout."""
    return [_rand(gen, (c,), dtype, 0.1, 1.0), _rand(gen, (c,), dtype, 0.1),
            _rand(gen, (c, c), dtype, c ** -0.5),
            _rand(gen, (c, c), dtype, c ** -0.5), _rand(gen, (c,), dtype, 0.1)]


def kernel_cases(gen, dtype):
    """(kernel, label, wrapper args, plain fn) at the SD1.5 shapes."""
    from asva_tpu_torch.ops import fused
    cases = []
    for level in ("32x32", "16x16", "8x8"):          # FF at C = 320/640/1280
        n, c = SD_LEVELS[level]
        args = [_rand(gen, (B * F * n, c), dtype),
                _rand(gen, (c,), dtype, 0.1, 1.0), _rand(gen, (c,), dtype, 0.1),
                _rand(gen, (8 * c, c), dtype, c ** -0.5),
                _rand(gen, (8 * c,), dtype, 0.1),
                _rand(gen, (c, 4 * c), dtype, (4 * c) ** -0.5),
                _rand(gen, (c,), dtype, 0.1), 1e-5]
        cases.append(("B3", f"ff {level} C={c}", fused.fused_ln_geglu, args,
                      fused.ln_geglu_plain))
    for level in ("32x32", "8x8"):
        n, c = SD_LEVELS[level]
        for name, g, m, sk in (("attn1", B, F * n, n),
                               ("audio", B * F, n, AUDIO_TOKENS),
                               ("text", B, F * n, TEXT_TOKENS)):
            args = ([_rand(gen, (g, m, c), dtype)] + _sub(gen, c, dtype)
                    + [_rand(gen, (g, sk, c), dtype),
                       _rand(gen, (g, sk, c), dtype), 1e-5, HEADS])
            cases.append(("B1", f"{name} {level} C={c} Sk={sk}",
                          fused.fused_ln_attn, args, fused.ln_attn_plain))
    for level, (n, c) in SD_LEVELS.items():
        args = [_rand(gen, (B, F, n, c), dtype)]
        for kv_shape in ((B, n, c), (B, F, AUDIO_TOKENS, c),
                         (B, TEXT_TOKENS, c)):
            args += _sub(gen, c, dtype) + [_rand(gen, kv_shape, dtype),
                                           _rand(gen, kv_shape, dtype)]
        args += [(1e-5,) * 3, HEADS]
        cases.append(("B2", f"attn3 {level} C={c}", fused.fused_ln_attn3,
                      args, fused.ln_attn3_plain))
    return cases


def phase_kernels(report):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for kernel, label, wrapper, args, plain in kernel_cases(gen, dtype):
            out = wrapper(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            tol = TOL[dname] * (max(1.0, scale) if dname == "float32"
                                else scale)
            ok = bool(torch.isfinite(out).all().item()) and err <= tol
            ms = time_ms(lambda: wrapper(*args))
            plain_ms = time_ms(lambda: plain(*args))
            rows.append(dict(kernel=kernel, case=label, dtype=dname,
                             max_abs_err=err, tol=tol, max_abs_ref=scale,
                             ms=ms, plain_ms=plain_ms, ok=ok))
            log(f"  {kernel} {dname:8s} {label:28s} err {err:.3e} "
                f"(tol {tol:.3e})  kernel {ms:8.3f} ms  plain "
                f"{plain_ms:8.3f} ms  {'ok' if ok else 'FAIL'}")
            del out, ref
        torch.cuda.empty_cache()
    report["kernels"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        fail(f"{len(bad)} kernel comparisons out of tolerance: "
             f"{[(r['kernel'], r['dtype'], r['case']) for r in bad]}")
    return rows


# ------------------------------------------------------------- phase 3 ---

@contextlib.contextmanager
def plain_sublayers():
    """Route the UNet's fused sub-layers to their plain versions (the
    comparison run only)."""
    from asva_tpu_torch.ops import fused
    saved = (fused.fused_ln_attn, fused.fused_ln_attn3, fused.fused_ln_geglu)
    fused.fused_ln_attn = fused.ln_attn_plain
    fused.fused_ln_attn3 = fused.ln_attn3_plain
    fused.fused_ln_geglu = fused.ln_geglu_plain
    try:
        yield
    finally:
        (fused.fused_ln_attn, fused.fused_ln_attn3,
         fused.fused_ln_geglu) = saved


def reset_counts():
    from asva_tpu_torch.ops import fused
    for k in fused.LAUNCHES:
        fused.LAUNCHES[k] = 0


def read_counts():
    from asva_tpu_torch.ops import fused
    return dict(fused.LAUNCHES)


def phase_unet(report):
    import torch
    from asva_tpu_torch.models.imagebind_audio import segment_token_indices
    from asva_tpu_torch.models.unet3d import UNet3DConfig
    from asva_tpu_torch.runtime import build_unet
    idx = segment_token_indices(F, (12, 19))
    gen = torch.Generator(device="cuda").manual_seed(7)
    x = _rand(gen, (B, F, 32, 32, 4), torch.float32)
    ts = torch.tensor([500, 500], device="cuda")
    text = _rand(gen, (B, TEXT_TOKENS, 768), torch.float32)
    audio = _rand(gen, (B, 229, 768), torch.float32)
    out = {}
    fp32_ref = None
    # fp32: kernels vs plain within 1e-3 of the output scale (a deep fp32
    # network; the kernels differ from cuBLAS/torch only in summation
    # order).  Both dtypes: the fused and B1 variants launch identical
    # kernels on identical inputs (<= 1e-6 of scale, expected 0).  bf16:
    # the bf16 weights are the fp32 ones rounded, so the fp32 plain output
    # is the reference for both bf16 runs; the kernels' relative RMS error
    # against it must be within 1.5x the plain bf16 version's (the two
    # round at different points, so neither is exact; the margin covers
    # that their roundings fall differently).
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        unet = build_unet(UNet3DConfig(), device="cuda", dtype=dtype, seed=0,
                          randomize_all=True)
        res = {}
        with torch.no_grad():
            for variant, fuse in (("fused", True), ("b1", False)):
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = unet(x, ts, text, audio, audio_token_indices=idx,
                         fuse_blocks=fuse)
                torch.cuda.synchronize()
                res[variant] = (y.float(), time.perf_counter() - t0,
                                read_counts())
            with plain_sublayers():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                y = unet(x, ts, text, audio, audio_token_indices=idx)
                torch.cuda.synchronize()
                res["plain"] = (y.float(), time.perf_counter() - t0, None)
        ref = res["plain"][0]
        scale = ref.abs().max().item()

        def diff(a):
            d = res[a][0] - ref
            return (d.abs().max().item(),
                    (d.norm() / ref.norm()).item())
        fused_vs_b1 = (res["fused"][0] - res["b1"][0]).abs().max().item()
        e_fused, rms_fused = diff("fused")
        e_b1, rms_b1 = diff("b1")
        vs_fp32 = {}
        if dname == "float32":
            fp32_ref = ref
            ok = max(e_fused, e_b1) <= 1e-3 * max(1.0, scale)
        else:
            vs_fp32 = {k: ((v[0] - fp32_ref).norm() / fp32_ref.norm()).item()
                       for k, v in res.items()}
            ok = max(vs_fp32["fused"], vs_fp32["b1"]) <= 1.5 * vs_fp32["plain"]
        ok = ok and fused_vs_b1 <= 1e-6 * max(1.0, scale)
        ok = ok and all(bool(torch.isfinite(r[0]).all()) for r in res.values())
        c_fused, c_b1 = res["fused"][2], res["b1"][2]
        counts_ok = (c_fused["B2"] > 0 and c_fused["B3"] > 0
                     and c_fused["B1"] == 0 and c_b1["B1"] > 0
                     and c_b1["B3"] > 0 and c_b1["B2"] == 0)
        out[dname] = dict(max_abs_plain=scale, fused_vs_plain=e_fused,
                          fused_rel_rms=rms_fused, b1_vs_plain=e_b1,
                          b1_rel_rms=rms_b1, fused_vs_b1=fused_vs_b1,
                          rel_rms_vs_fp32=vs_fp32,
                          seconds={k: v[1] for k, v in res.items()},
                          launches_fused=c_fused, launches_b1=c_b1,
                          ok=ok, counts_ok=counts_ok)
        log(f"  unet {dname}: |plain|max {scale:.3f}  fused-plain {e_fused:.3e}"
            f" (rms {rms_fused:.2e})  b1-plain {e_b1:.3e} (rms {rms_b1:.2e})"
            f"  fused-b1 {fused_vs_b1:.3e}  rel rms vs fp32 {vs_fp32}  "
            f"launches fused {c_fused} b1 {c_b1}  "
            f"{'ok' if ok and counts_ok else 'FAIL'}")
        if not (ok and counts_ok):
            fail(f"UNet {dname} comparison: {out[dname]}")
        del unet, res
        torch.cuda.empty_cache()
    report["unet"] = out
    return out["bfloat16"]["launches_b1"]


# ------------------------------------------------------------- phase 4 ---

def phase_pipeline(report):
    import torch
    from asva_tpu_torch.runtime import load_animation_pipeline
    t0 = time.perf_counter()
    # no CLIP weights: a seeded stand-in for the empty-string encoding
    null_text = torch.randn((1, TEXT_TOKENS, 768), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(100))
    pipe = load_animation_pipeline(device="cuda", dtype=torch.bfloat16,
                                   seed=0, randomize_all=True,
                                   null_text_encoding=null_text)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    requests = []
    for seed in (101, 102, 103):
        g = torch.Generator(device="cuda").manual_seed(seed)
        image = torch.rand((1, 256, 256, 3), generator=g, device="cuda")
        wave = torch.randn((1, 32000), generator=g, device="cuda") * 0.1
        text = torch.randn((1, TEXT_TOKENS, 768), generator=g, device="cuda")
        requests.append((seed, image, wave, text))
    kw = dict(video_length=F, num_inference_steps=5, sampler="ddim",
              audio_guidance_scale=4.0, text_guidance_scale=1.0)

    def gen(seed):
        return torch.Generator(device="cuda").manual_seed(seed)

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    seconds, videos = [], []
    for seed, image, wave, text in requests:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mels = pipe.encode_audio_waveform([wave])
        video = pipe(image, mels, text, generator=gen(seed), **kw)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        videos.append(video)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    checks, lats = [], []
    for (seed, image, wave, text), video in zip(requests, videos):
        mels = pipe.encode_audio_waveform([wave])
        lat = pipe(image, mels, text, generator=gen(seed), decode=False, **kw)
        lats.append(lat)
        pinned = pipe.encode_image(image, generator=gen(seed))
        checks.append(dict(
            seed=seed, shape=list(video.shape),
            finite=bool(torch.isfinite(video).all()),
            in_range=bool(video.min() >= 0 and video.max() <= 1),
            frame0_pinned=bool(torch.equal(lat[:, 0], pinned)),
            std=video.float().std().item()))
    ok = all(c["shape"] == [1, F, 256, 256, 3] and c["finite"]
             and c["in_range"] and c["frame0_pinned"] for c in checks)
    counts_ok = counts["B2"] > 0 and counts["B3"] > 0

    # Reference: the first request's final latents again, through the plain
    # sub-layers, in bf16 and from an fp32 pipeline built from the same seed
    # (the bf16 weights are its weights rounded; the noise draws are equal).
    # fp32 kernels vs fp32 plain: max |diff| <= 1e-3 * max(1, max|plain|)
    # (fp32 products, summation order only, over 5 steps).  bf16: the
    # kernels' relative RMS distance from the fp32 plain latents must be
    # within 1.5x the plain bf16 version's (as in the UNet phase).
    seed, image, wave, text = requests[0]
    mels = pipe.encode_audio_waveform([wave])
    pipe32 = load_animation_pipeline(device="cuda", dtype=torch.float32,
                                     seed=0, randomize_all=True,
                                     null_text_encoding=null_text)
    lat_k32 = pipe32(image, mels, text, generator=gen(seed), decode=False,
                     **kw).float()
    with plain_sublayers():
        lat_p16 = pipe(image, mels, text, generator=gen(seed), decode=False,
                       **kw).float()
        lat_p32 = pipe32(image, mels, text, generator=gen(seed),
                         decode=False, **kw).float()
    del pipe32

    def rel_rms(a):
        return ((a - lat_p32).norm() / lat_p32.norm()).item()
    scale32 = lat_p32.abs().max().item()
    ref = dict(fp32_max_abs=(lat_k32 - lat_p32).abs().max().item(),
               fp32_tol=1e-3 * max(1.0, scale32),
               bf16_kernels_rel_rms=rel_rms(lats[0].float()),
               bf16_plain_rel_rms=rel_rms(lat_p16))
    ref_ok = (ref["fp32_max_abs"] <= ref["fp32_tol"]
              and ref["bf16_kernels_rel_rms"]
              <= 1.5 * ref["bf16_plain_rel_rms"]
              and bool(torch.isfinite(lat_k32).all()))
    report["pipeline"] = dict(load_seconds=load_s, seconds_per_clip=seconds,
                              max_memory_allocated=peak, launches=counts,
                              checks=checks, reference=ref, ok=ok,
                              ref_ok=ref_ok, counts_ok=counts_ok)
    log(f"  pipeline: load {load_s:.1f} s; seconds per clip "
        f"{[round(s, 3) for s in seconds]}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; launches {counts}; checks {checks}; "
        f"reference {ref}")
    if not (ok and ref_ok and counts_ok):
        fail(f"pipeline checks: {report['pipeline']}")
    return counts


# ---------------------------------------------------------------- main ---

def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from asva_tpu_torch.ops import cuda_build  # fails outside the repo
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}

    log("phase 1: build")
    t0 = time.perf_counter()
    built = cuda_build.build()
    report["build_seconds"] = time.perf_counter() - t0
    cuda_build.library()
    for name, (path, ptxas) in built.items():
        usage = [ln.strip() for ln in ptxas.splitlines()
                 if "registers" in ln or "spill" in ln]
        report[f"ptxas_{name}"] = usage
        log(f"  {name}: {os.path.relpath(path, ROOT)}; "
            f"{len(usage)} ptxas usage lines")
    log(f"  build {report['build_seconds']:.1f} s")

    log("phase 2: kernels vs plain")
    rows = phase_kernels(report)
    log("phase 3: unet")
    b1_counts = phase_unet(report)
    log("phase 4: pipeline")
    pipe_counts = phase_pipeline(report)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave no output"
    report["card"] = card

    launches = {"B1": b1_counts["B1"], "B2": pipe_counts["B2"],
                "B3": pipe_counts["B3"]}
    paths = {"B1": "unet fuse_blocks=False", "B2": "pipeline",
             "B3": "pipeline"}
    kernels = []
    for name, (replaces, tpu, sources) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name]
        main = next(r for r in mine if r["dtype"] == "bfloat16")
        err = max(r["max_abs_err"] for r in mine)
        kernels.append(dict(
            name=name, route="cuda", source=sources[0], sources=sources,
            replaces=replaces, tpu=tpu, launches=launches[name],
            path=paths[name], max_abs_err=err, max_abs_diff=err,
            ms=main["ms"], plain_ms=main["plain_ms"],
            timed_case=f"{main['case']} bf16"))
    if any(k["launches"] <= 0 for k in kernels):
        fail(f"a kernel was not launched on its path: {launches}")

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)

    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
