#!/usr/bin/env python3
"""Drive the PyTorch port (asva_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # needs one NVIDIA H100 (sm_90a)
    python3 chip_smoke.py --profile  # build + one generation request and one
                                     # training step under torch.profiler

Phases, in order; any failure exits non-zero and prints no result:
  1. build    — nvcc the kernels in asva_tpu_torch/csrc (one process per
                source, in parallel) into the git-ignored build directory;
                ptxas's warnings and its notes on serialized wgmma
                (C7511/C7512: too few registers, reported; C7514: a branch
                around a wgmma, fatal) and the HGMMA and HMMA instructions
                of each library's SASS (the toolkit's cuobjdump) are
                reported; a wgmma source (gemm, attn, attn_bwd,
                attn_grouped, attn_bwd_fused, mix, attn_variants) without
                HGMMA, with HMMA or whose SASS cannot be read fails;
  2. kernels  — each kernel against its plain PyTorch version on the card,
                fp32 and bf16, with median times of both (CUDA events, after
                warm-up): B1 fused_ln_attn, B2 fused_ln_attn3, B3
                fused_ln_geglu at every SD1.5 level's generation shapes
                (2 clips), their input and parameter gradients against
                autograd of the plain versions, and B4 mha_fwd (o, lse) and
                B5 mha_bwd (dq, dk, dv) at every level's training shapes
                (batch 4 of 12 frames: attn1, audio, text), beside one
                scaled_dot_product_attention call as a yardstick; B6
                vmem_attention / vmem_cross_attention at one request's flat
                shapes (16 batch-heads; every level's frame-0 self-attention,
                229 audio tokens padded to 256 and unpadded, 77 text tokens
                of 128) with its gradients and the same yardstick; B7
                fused_ff_mix at FFInflatedConv's shapes on the column blocks
                of one (C, 3C) weight, with its gradients, the loader of A
                its bf16 launch takes (fused.ff_mix_plan), its time as a
                CUDA-graph replay (graph_ms) beside every loader the shape
                admits (loader_ms) and torch.matmul of the pre-gathered (M,
                3C) A by W^T (a yardstick the port never calls); the tools'
                kernels:
                T1 ln_attn_variant, each of its ten names at the tool's shape
                (G 2, M 12288, Sk 1024, C 320, 64 rows a block) against
                ln_attn_variant_plain (v5_bf16exp in bf16: 0.05 absolute, the
                JAX tool's tolerance for it), beside B1 on the same inputs;
                in bf16 v2_postnorm and v3_both bit for bit B1's output, and
                in both dtypes every order of a class bit for bit its first
                name's (v0 = v1_phased = v6_stacksm = v8_pipe);
                T2f mha_fwd_grouped and T2b mha_bwd_ordered at the five
                training shapes of tools/mha_phase_bench.py, every supported
                group size and schedule (groups 1, 2 and b0, b1, b2 must
                be), against mha_fwd_plain / mha_bwd_plain; T2f's o and lse
                bit for bit B4's at every group (both run B4's statements
                per head), T2b's dK/dV bit for bit across its orders and, in
                bf16 where B5 runs its dK/dV kernel unsplit
                (fused.dkv_split 1: L0.attn1, L0.audio), B5's; beside B4 / B5
                and the scaled_dot_product_attention yardstick;
                K-gemm alone (fused.ln_gemm) in bf16: its four launches
                (KG.q: LN + q projection, KG.out: output projection + bias +
                residual, KG.ff1: LN + GEGLU, KG.ff2: the FF's second
                product + bias + residual) at every level's token count for
                one request and one training batch, against ln_gemm_plain,
                timed as CUDA-graph replays beside torch.matmul on the same
                bf16 product (cuBLAS without prologue or epilogue, a
                yardstick the port never calls) and achieved TFLOP/s;
  3. unet     — first the `ln=None` attention modules at full width
                (FFSpatialAttention; CrossAttention on text and on unmasked
                audio tokens; 32x32 and 16x16 levels) against
                dot_product_attention on the same projections, which must
                launch B6, and FFInflatedConv's own mix redone through
                fused_ff_mix on its conv output and conv_temp weight, which
                must launch B7 and agree with the module; then the
                full-width UNet3DConfig() (seeded random weights, every
                parameter randomised), x (2, 12, 32, 32, 4): fuse_blocks=True
                (B2 + B3) vs fuse_blocks=False (B1 + B3) vs all-plain, in
                bf16 and fp32; the fuse_blocks=False run is the B1 path;
  4. pipeline — load_animation_pipeline() at full width (bf16, random
                weights) answers 3 requests (256x256 image + 2 s of 16 kHz
                audio, own seed, DDIM 5 steps, audio guidance 4.0, decode
                on): shape, finite, [0, 1], frame 0 pinned; this is the
                B2 + B3 path.  The first request's latents are then held
                against the plain sub-layers in bf16 and in fp32;
  5. train    — AnimationTrainer at full width (SD1.5 UNet with remat as the
                training config has it, VAE, audio tower; fp32 trainable and
                bf16 frozen parameters, bf16 compute; AdamW lr 1e-4, weight
                decay 1e-2, clip 1.0) takes 4 steps on a seeded batch of 4
                clips of 12 256x256 frames with 2 s of audio: finite losses,
                a finite non-zero gradient for every trainable parameter,
                none for a frozen one, frozen parameters bit-identical
                after the steps, B4 and B5 launched at least 48 times a step
                and B2 never; this is the B4 + B5 path.  Then one save and
                restore_latest through the CheckpointManager, and at batch 1
                in fp32 the loss and the trainable gradients with kernels
                against those with the plain sub-layers.
  6. judge    — token ids made from a seed go through the full-width CLIP
                text encoder (12 layers, 768 wide); that encoding, not a
                random tensor, conditions 3 pipeline requests as in phase 4;
                the 3 generated clips and 3 seeded random "ground truth"
                clips go through the frame transforms and the five metric
                callables of build_eval_models at their published sizes
                (InceptionV3 on 229^2 frames, Inception-I3D on 12 x 224^2,
                the AVSync classifier on 12 x 224^2 and a 128 x 204 mel,
                ImageBind-huge vision, text and audio towers), then
                frechet_distance, compute_relsync and compute_alignsync:
                every output finite and of its shape, IA / IT cosines in
                [-1, 1], RelSync and AlignSync in [0, 1], and the bf16
                bundle's features within 0.1 relative RMS of the fp32 one's
                (some 50 to 90 conv layers deep, each rounding to bf16).
                Generation there must launch B2 + B3 and never B6.
  7. tools    — `asva_tpu_torch.tools.attn_experiments.main` and
                `asva_tpu_torch.tools.mha_phase_bench.main` with a small
                --n, as a user runs them: no parity row may fail, and T1,
                T2F and T2B must have launched exactly as often as the
                returned rows imply.
  8. sync     — the judge's trainer: build_avsync_classifier(train=True) on
                seeded weights, SyncContrastiveTrainer with tau and the
                optimizer of configs/avsync/vggss_sync_contrast.yaml (read by
                SyncJobConfig.from_yaml; AdamW lr 2e-4 after 100 warm-up
                steps, wd 1e-2, clip 1.0), bf16 autocast over fp32
                parameters, seeded random batches at the config's sizes: 21
                clips an item of 12 224x224 frames and a 128x204 mel, batch 4
                (or the largest that fits).  Four steps: finite losses within
                a factor 2 of ln 21, running statistics and parameters
                changed; eval_metrics afterwards leaves the state untouched
                and ignores the order of the batch; a checkpoint round trip
                restores parameters, buffers and optimizer state bit for
                bit; an fp32 step at batch 1, repeated from the same state,
                gives the same loss and parameters bit for bit.
  9. files    — generation and evaluation from files: a 256x256 PNG and a
                stereo 44.1 kHz int16 wav of 6.5 s written to a temporary
                directory; pipelines.generate.generate_videos (3 clips, DDIM
                5 steps, audio guidance 4.0) on the full-width pipeline of
                phase 4 in bf16 and in fp32, with batch_clips=True (one call,
                broadcast_rng) and False (a call per clip): every clip
                (12, 256, 256, 3) uint8, B2 and B3 launched exactly (UNet
                calls) x (audio / all transformer blocks) times; in fp32 the
                two modes within one uint8 level, in bf16 each mode's
                relative RMS distance from the fp32 video within 1.5x that of
                the plain sub-layers in bf16 (phase 4's rule); a
                save_template must raise where the media layer cannot be
                built (no libav on the card's machine) and write the clips
                where it can; the frames and the clips' mels then go through
                eval.harness.evaluate_arrays with phase 6's five nets: every
                metric finite, RelSync / AlignSync in [0, 1].  Seconds per
                clip through generate_videos are printed beside phase 4's
                pipeline call.
Launch counters are zeroed just before each path run and read just after.

Tolerances (max |kernel - plain| over an output):
  fp32  <= 1e-4 * max(1, max|plain|): fp32 products; only the summation
        order and the online-softmax normalisation differ;
  bf16  <= 2**-6 * max|plain|, i.e. two bf16 ulps at the output's largest
        magnitude: the kernels round q, P, dS and h to bf16 where the Pallas
        kernels do, the plain versions where the JAX composites do, and
        the online softmax rounds P before normalising;
  gradients through a whole wrapper in bf16 <= 2**-5 * max|plain gradient|
        (the forward's and the backward's roundings stack).
The UNet, pipeline and training tolerances are stated beside their checks.

bound_ms is the least time the card could take for the timed call: the
larger of its bytes (each input read once, each output written once) over
3.35 TB/s and its operations over the peak for its type (989 TFLOP/s bf16,
67 TFLOP/s fp32), the published rates of an H100 SXM at 700 W.

Output: the kernels line, the card line (nvidia-smi name, power limit), and
last the device line {"ok": true, "device": {...}}.  Details go to
chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SD_LEVELS = {"32x32": (1024, 320), "16x16": (256, 640), "8x8": (64, 1280),
             "4x4": (16, 1280)}
B, F, HEADS = 2, 12, 8          # 2 CFG clips of 12 frames, SD1.5 heads
AUDIO_TOKENS, TEXT_TOKENS = 25, 77
TRAIN_B = 4                     # clips per training batch
TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -6}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 2.0 ** -5}
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
KERNELS = {
    "B1": ("asva_tpu/ops/pallas_fused.py:304", "pallas_fused._ln_attn_flat",
           ["asva_tpu_torch/csrc/attn.cu", "asva_tpu_torch/csrc/gemm.cu"]),
    "B2": ("asva_tpu/ops/pallas_fused.py:487", "pallas_fused._ln_attn3_flat",
           ["asva_tpu_torch/csrc/attn.cu", "asva_tpu_torch/csrc/gemm.cu"]),
    "B3": ("asva_tpu/ops/pallas_fused.py:123", "pallas_fused._ln_geglu_flat",
           ["asva_tpu_torch/csrc/gemm.cu"]),
    "B4": ("asva_tpu/ops/pallas_fused.py:759", "pallas_fused._mha_fwd_flat",
           ["asva_tpu_torch/csrc/attn.cu"]),
    "B5": ("asva_tpu/ops/pallas_fused.py:785", "pallas_fused._mha_bwd_flat",
           ["asva_tpu_torch/csrc/attn_bwd.cu"]),
    "B6": ("asva_tpu/ops/pallas_attn.py:45", "pallas_attn._attention_flat",
           ["asva_tpu_torch/csrc/attn.cu"]),
    "B7": ("asva_tpu/ops/pallas_fused.py:923", "pallas_fused._ff_mix_flat",
           ["asva_tpu_torch/csrc/mix.cu", "asva_tpu_torch/csrc/hopper.cuh",
            "asva_tpu_torch/csrc/tma.cuh", "asva_tpu_torch/csrc/wgmma.cuh"]),
    "T1": ("tools/attn_experiments.py:310", "attn_experiments.run_variant",
           ["asva_tpu_torch/csrc/attn_variants.cu",
            "asva_tpu_torch/csrc/hopper.cuh", "asva_tpu_torch/csrc/tma.cuh",
            "asva_tpu_torch/csrc/wgmma.cuh"]),
    "T2F": ("tools/mha_phase_bench.py:82", "mha_phase_bench.fwd_flat",
            ["asva_tpu_torch/csrc/attn_grouped.cu",
             "asva_tpu_torch/csrc/hopper.cuh",
             "asva_tpu_torch/csrc/wgmma.cuh"]),
    "T2B": ("tools/mha_phase_bench.py:185", "mha_phase_bench.bwd_flat",
            ["asva_tpu_torch/csrc/attn_bwd_fused.cu",
             "asva_tpu_torch/csrc/hopper.cuh",
             "asva_tpu_torch/csrc/wgmma.cuh"]),
}
_GEMM_SOURCES = ["asva_tpu_torch/csrc/gemm.cu", "asva_tpu_torch/csrc/hopper.cuh",
                 "asva_tpu_torch/csrc/tma.cuh",
                 "asva_tpu_torch/csrc/wgmma.cuh"]
KERNELS.update({   # K-gemm's four launches inside B1/B2 and B3
    "KG.q": ("asva_tpu/ops/pallas_fused.py:304",
             "pallas_fused._ln_attn_flat: LN + q projection", _GEMM_SOURCES),
    "KG.out": ("asva_tpu/ops/pallas_fused.py:304",
               "pallas_fused._ln_attn_flat: output projection + bias + "
               "residual", _GEMM_SOURCES),
    "KG.ff1": ("asva_tpu/ops/pallas_fused.py:123",
               "pallas_fused._ln_geglu_flat: LN + GEGLU product",
               _GEMM_SOURCES),
    "KG.ff2": ("asva_tpu/ops/pallas_fused.py:123",
               "pallas_fused._ln_geglu_flat: second product + bias + "
               "residual", _GEMM_SOURCES)})
# the sources whose bf16 products are all wgmma (phase 1 holds their SASS
# to it): every source
WGMMA_SOURCES = ("gemm", "attn", "attn_bwd", "attn_grouped", "attn_bwd_fused",
                 "mix", "attn_variants")
# K-gemm's launches (fused._FORMS): weight rows and contraction per C, LN
GEMM_FORMS = (("q", 1, 1, True), ("out", 1, 1, False), ("ff1", 8, 1, True),
              ("ff2", 1, 4, False))
# the case whose bf16 times go into the kernels line
TIMED_CASE = {"B1": "attn1 32x32", "B2": "attn3 32x32", "B3": "ff 32x32",
              "B4": "attn1 32x32", "B5": "attn1 32x32", "B6": "attn1 32x32",
              "B7": "mix 32x32", "T1": "v0 ", "T2F": "L0.attn1 g1 ",
              "T2B": "L0.attn1 b0 ", "KG.q": "q 32x32", "KG.out": "out 32x32",
              "KG.ff1": "ff1 32x32", "KG.ff2": "ff2 32x32"}
# B1, B3 and K-gemm also run on the training path: their bf16 times at its
# shapes
TRAIN_TIMED_CASE = {"B1": "train attn1 32x32", "B3": "train ff 32x32",
                    "KG.q": "train q 32x32", "KG.out": "train out 32x32",
                    "KG.ff1": "train ff1 32x32", "KG.ff2": "train ff2 32x32"}


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


def graph_ms(fn, reps: int = 10) -> float:
    """Median milliseconds of one fn() replayed from a CUDA graph of `reps`
    calls: the device's time without the host's per-call overhead (30-60 us
    for a wrapper, more than a small kernel takes)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return time_ms(graph.replay) / reps


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


def _attn_flops(g, m, sk, c):
    """One attention sub-layer on x (g, m, c): q and out projections plus
    QK^T and PV."""
    return 4 * g * m * c * c + 4 * g * m * sk * c


def kernel_cases(gen, dtype):
    """(kernel, label, wrapper, args, plain fn, operations) for B1-B3 at
    the shapes the driven paths give them at the SD1.5 levels: generation
    (2 clips; B1, B2, B3) and training (batch 4; B1 and B3, labelled
    "train")."""
    from asva_tpu_torch.ops import fused
    cases = []
    for prefix, b in (("", B), ("train ", TRAIN_B)):
        for level in ("32x32", "16x16", "8x8"):      # FF at C = 320/640/1280
            n, c = SD_LEVELS[level]
            args = [_rand(gen, (b * F * n, c), dtype),
                    _rand(gen, (c,), dtype, 0.1, 1.0),
                    _rand(gen, (c,), dtype, 0.1),
                    _rand(gen, (8 * c, c), dtype, c ** -0.5),
                    _rand(gen, (8 * c,), dtype, 0.1),
                    _rand(gen, (c, 4 * c), dtype, (4 * c) ** -0.5),
                    _rand(gen, (c,), dtype, 0.1), 1e-5]
            cases.append(("B3", f"{prefix}ff {level} C={c} M={b * F * n}",
                          fused.fused_ln_geglu, args, fused.ln_geglu_plain,
                          24 * b * F * n * c * c))
        for level in ("32x32", "8x8"):
            n, c = SD_LEVELS[level]
            for name, g, m, sk in (("attn1", b, F * n, n),
                                   ("audio", b * F, n, AUDIO_TOKENS),
                                   ("text", b, F * n, TEXT_TOKENS)):
                args = ([_rand(gen, (g, m, c), dtype)] + _sub(gen, c, dtype)
                        + [_rand(gen, (g, sk, c), dtype),
                           _rand(gen, (g, sk, c), dtype), 1e-5, HEADS])
                cases.append(("B1", f"{prefix}{name} {level} C={c} G={g} "
                              f"Sk={sk}", fused.fused_ln_attn, args,
                              fused.ln_attn_plain, _attn_flops(g, m, sk, c)))
    for level, (n, c) in SD_LEVELS.items():
        args = [_rand(gen, (B, F, n, c), dtype)]
        for kv_shape in ((B, n, c), (B, F, AUDIO_TOKENS, c),
                         (B, TEXT_TOKENS, c)):
            args += _sub(gen, c, dtype) + [_rand(gen, kv_shape, dtype),
                                           _rand(gen, kv_shape, dtype)]
        args += [(1e-5,) * 3, HEADS]
        flops = (_attn_flops(B, F * n, n, c)
                 + _attn_flops(B * F, n, AUDIO_TOKENS, c)
                 + _attn_flops(B, F * n, TEXT_TOKENS, c))
        cases.append(("B2", f"attn3 {level} C={c}", fused.fused_ln_attn3,
                      args, fused.ln_attn3_plain, flops))
    return cases


def flash_cases(gen, dtype):
    """(kernel, label, wrapper, args, plain fn, operations) for B4 and B5
    at the training shapes of every SD1.5 level: batch 4 of 12 frames."""
    from asva_tpu_torch.ops import fused
    cases = []
    for level, (n, c) in SD_LEVELS.items():
        for name, g, m, sk in (("attn1", TRAIN_B, F * n, n),
                               ("audio", TRAIN_B * F, n, AUDIO_TOKENS),
                               ("text", TRAIN_B, F * n, TEXT_TOKENS)):
            scale = 1.0 / math.sqrt(c // HEADS)
            q, k, v, do = (_rand(gen, shape, dtype) for shape in
                           ((g, m, c), (g, sk, c), (g, sk, c), (g, m, c)))
            o, lse = fused.mha_fwd_plain(q, k, v, HEADS, None, scale)
            dd = fused._head_rowsum(do, o, HEADS)
            del o
            label = f"{name} {level} G={g} M={m} Sk={sk} d={c // HEADS}"
            cases.append(("B4", label, fused.mha_fwd,
                          [q, k, v, HEADS, None, scale], fused.mha_fwd_plain,
                          4 * g * m * sk * c))
            cases.append(("B5", label, fused.mha_bwd,
                          [q, k, v, do, lse, dd, HEADS, None, scale],
                          fused.mha_bwd_plain, 10 * g * m * sk * c))
    return cases


def _flat_attention(q, k, v, kv_len=None):
    from asva_tpu_torch.ops import flat_attention
    if kv_len is None:
        return flat_attention.vmem_attention(q, k, v)
    return flat_attention.vmem_cross_attention(q, k, v, kv_len)


def flat_cases(gen, dtype):
    """(kernel, label, wrapper, args, plain fn, operations, bytes) for B6 at
    the flat shapes of one request (2 clips x 8 heads = 16 batch-heads, 12
    frames) and B7 at FFInflatedConv's.  Operations and bytes count the
    kv_len rows that are attended, not a caller's padding."""
    import torch
    from asva_tpu_torch.ops import flat_attention, fused
    cases = []
    bh = B * HEADS
    item = torch.empty((), dtype=dtype).element_size()
    shapes = [(f"attn1 {level}", F * n, n, c // HEADS, None)
              for level, (n, c) in SD_LEVELS.items()]
    sq, d = F * SD_LEVELS["32x32"][0], SD_LEVELS["32x32"][1] // HEADS
    shapes += [("audio 32x32 padded", sq, 256, d, 229),
               ("audio 32x32 unpadded", sq, 229, d, 229),
               ("text 32x32 padded", sq, 128, d, TEXT_TOKENS)]
    for name, sq, sk, d, kv_len in shapes:
        q, k, v = (_rand(gen, (bh, s, d), dtype) for s in (sq, sk, sk))
        rows = sk if kv_len is None else kv_len
        k[:, rows:] = 0
        v[:, rows:] = 0
        cases.append(("B6", f"{name} BH={bh} Sq={sq} Sk={sk} kv={rows} d={d}",
                      _flat_attention, [q, k, v, kv_len],
                      flat_attention.attention_flat_plain,
                      4 * bh * sq * rows * d,
                      2 * bh * (sq + rows) * d * item))
    for level, (n, c) in SD_LEVELS.items():
        w = _rand(gen, (c, 3 * c), dtype, (3 * c) ** -0.5)
        args = [_rand(gen, (B, F, n, c), dtype), w[:, :c], w[:, c:2 * c],
                w[:, 2 * c:], _rand(gen, (1, c), dtype, 0.1)]
        cases.append(("B7", f"mix {level} C={c} M={B * F * n}",
                      fused.fused_ff_mix, args, fused.ff_mix_plain,
                      2 * B * F * n * 3 * c * c, None))
    return cases


T1_SHAPE = dict(g=2, m=12288, sk=1024, c=320)   # tools/attn_experiments.py
T1_BLOCK_M = 64
# tools/mha_phase_bench.py main: (tag, G, M, Sk, H*D, kv_len)
T2_SHAPES = (("L0.attn1", 4, 12288, 1024, 320, None),
             ("L0.audio", 48, 1024, 128, 320, 25),
             ("L0.text", 4, 12288, 128, 320, 77),
             ("L1.attn1", 4, 3072, 256, 640, None),
             ("L2.attn1", 4, 768, 128, 1280, 64))


def _bound(flops, nbytes, dname):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dname] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def tool_kernel_rows(gen, dtype):
    """T1, T2f and T2b against their plain versions (and T2f against B4) at
    the tools' shapes.  The bound of a row is that of the
    production kernel for the same work: the function is the same."""
    import torch
    from asva_tpu_torch.ops import fused, variants
    dname = str(dtype).split(".")[-1]
    rows = []

    def row(kernel, case, out, ref, ms_fn, plain_ms, flops, nbytes, prod_ms,
            library_ms=None, tol=None, **extra):
        err, rtol, scale = _compare(out, ref, dname)
        if tol is not None:
            rtol = tol
        bound_ms, bound_by = _bound(flops, nbytes, dname)
        r = dict(kernel=kernel, case=case, dtype=dname, max_abs_err=err,
                 tol=rtol, max_abs_ref=scale, ok=err <= rtol and
                 extra.get("equal_to_b4", True)
                 and extra.get("equal_to_b1", True)
                 and extra.get("equal_in_class", True)
                 and extra.get("dkdv_equal", True)
                 and (extra.get("dkdv_equal_to_b5", True)
                      or not extra.get("b5_unsplit", False)),
                 bytes=nbytes, operations=flops, bound_ms=bound_ms,
                 bound_by=bound_by, library_ms=library_ms,
                 production_ms=prod_ms, plain_ms=plain_ms,
                 ms=time_ms(ms_fn), **extra)
        rows.append(r)
        flags = "".join(f"  {k} {v}" for k, v in extra.items())
        lib = f"  sdpa {library_ms:.3f} ms" if library_ms is not None else ""
        log(f"  {kernel:3s} {dname:8s} {case:34s} err {err:.3e} (tol "
            f"{rtol:.3e}){flags}  kernel {r['ms']:8.3f} ms  production "
            f"{prod_ms:8.3f} ms  plain {plain_ms:8.3f} ms  bound "
            f"{bound_ms:.4f} ms ({bound_by}){lib}  "
            f"{'ok' if r['ok'] else 'FAIL'}")

    with torch.no_grad():
        # T1 at the tool's shape
        g, m, sk, c = (T1_SHAPE[k] for k in ("g", "m", "sk", "c"))
        args = ([_rand(gen, (g, m, c), dtype)] + _sub(gen, c, dtype)
                + [_rand(gen, (g, sk, c), dtype),
                   _rand(gen, (g, sk, c), dtype)])
        b1_ms = time_ms(lambda: fused.fused_ln_attn(*args, 1e-5, HEADS))
        b1_out = fused.fused_ln_attn(*args, 1e-5, HEADS)
        plain_ms, first = {}, {}
        for name, (cls, _) in variants.VARIANTS.items():
            out = variants.ln_attn_variant(name, *args, 1e-5, HEADS,
                                           T1_BLOCK_M)
            ref = variants.ln_attn_variant_plain(name, *args, 1e-5, HEADS)
            torch.cuda.synchronize()
            # the orders of a class run the same statements: their bits; the
            # POST class runs B1's (K-gemm q, B4, K-gemm out) in bf16
            first.setdefault(cls, out)
            gates = dict(equal_in_class=bool(torch.equal(out, first[cls])))
            if cls == variants.POST and dname == "bfloat16":
                gates["equal_to_b1"] = bool(torch.equal(out, b1_out))
            if cls not in plain_ms:     # one plain timing per class
                plain_ms[cls] = time_ms(
                    lambda: variants.ln_attn_variant_plain(
                        name, *args, 1e-5, HEADS), 1, 3)
            row("T1", f"{name} bm{T1_BLOCK_M}", out, ref,
                lambda: variants.ln_attn_variant(name, *args, 1e-5, HEADS,
                                                 T1_BLOCK_M),
                plain_ms[cls], _attn_flops(g, m, sk, c),
                _nbytes(*_tensors(args), out), b1_ms,
                tol=0.05 if (name, dname) == ("v5_bf16exp", "bfloat16")
                else None, **gates)
            del out, ref
        del args, b1_out, first
        torch.cuda.empty_cache()

        # T2f and T2b at the five training shapes
        for tag, g, m, sk, c, kv_len in T2_SHAPES:
            d = c // HEADS
            scale = 1.0 / math.sqrt(d)
            q, k, v, do = (_rand(gen, shape, dtype) for shape in
                           ((g, m, c), (g, sk, c), (g, sk, c), (g, m, c)))
            rows_kv = sk if kv_len is None else kv_len
            fwd = [q, k, v, HEADS, kv_len, scale]
            o4, lse4 = fused.mha_fwd(*fwd)
            ref = fused.mha_fwd_plain(*fwd)
            dd = fused._head_rowsum(do, o4, HEADS)
            bwd = [q, k, v, do, lse4, dd, HEADS, kv_len, scale]
            ref_b = fused.mha_bwd_plain(*bwd)
            b4_ms = time_ms(lambda: fused.mha_fwd(*fwd))
            b5_ms = time_ms(lambda: fused.mha_bwd(*bwd))
            plain_f = time_ms(lambda: fused.mha_fwd_plain(*fwd), 1, 3)
            plain_b = time_ms(lambda: fused.mha_bwd_plain(*bwd), 1, 3)
            lib_f = lib_b = None
            if dname == "bfloat16":
                # the yardstick sees the attended rows only
                kk, vv = (t[:, :rows_kv].contiguous() for t in (k, v))
                lib_f = sdpa_ms("B4", [q, kk, vv, scale])
                with torch.enable_grad():
                    lib_b = sdpa_ms("B5", [q.clone(), kk.clone(), vv.clone(),
                                           do, scale])
            ran = []
            # T2f runs B4's statements per head in B4's order: bit for bit
            # B4's o and lse at every group
            for group in (1, 2, 4, HEADS):
                why = variants.t2f_supported(d, group)
                if why:
                    log(f"  T2F {dname:8s} {tag} g{group}: unsupported "
                        f"({why})")
                    rows.append(dict(kernel="T2F", case=f"{tag} g{group}",
                                     dtype=dname, supported=False, why=why,
                                     ok=True))
                    continue
                out = variants.mha_fwd_grouped(*fwd, None, group)
                same = bool(torch.equal(out[0], o4)
                            and torch.equal(out[1], lse4))
                row("T2F", f"{tag} g{group} ", out, ref,
                    lambda: variants.mha_fwd_grouped(*fwd, None, group),
                    plain_f, 4 * g * m * rows_kv * c,
                    _nbytes(q, out[0], out[1]) + 2 * g * rows_kv * c
                    * q.element_size(), b4_ms, lib_f, equal_to_b4=same)
                ran.append(group)
            if ran[:2] != [1, 2]:
                fail(f"T2f: groups 1 and 2 must be supported at {tag}")
            # T2b's dK/dV: bit for bit across its orders and, where B5 runs
            # its dK/dV kernel unsplit (bf16, fused.dkv_split 1), B5's
            b5 = fused.mha_bwd(*bwd)
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            unsplit = (dname == "bfloat16" and fused.dkv_split(
                g, m, sk, HEADS, d, sms) == 1)
            ran, first = [], None
            for var in ("b0", "b1", "b2", "b4", "b3"):
                why = variants.t2b_supported(d, HEADS, var)
                if why:
                    log(f"  T2B {dname:8s} {tag} {var}: unsupported ({why})")
                    rows.append(dict(kernel="T2B", case=f"{tag} {var}",
                                     dtype=dname, supported=False, why=why,
                                     ok=True))
                    continue
                out = variants.mha_bwd_ordered(*bwd, None, var)
                first = first or out
                same = bool(torch.equal(out[1], first[1])
                            and torch.equal(out[2], first[2]))
                eq_b5 = bool(torch.equal(out[1], b5[1])
                             and torch.equal(out[2], b5[2]))
                row("T2B", f"{tag} {var} ", out, ref_b,
                    lambda: variants.mha_bwd_ordered(*bwd, None, var),
                    plain_b, 10 * g * m * rows_kv * c,
                    _nbytes(q, do, lse4, dd, out[0], out[1], out[2])
                    + 2 * g * rows_kv * c * q.element_size(), b5_ms, lib_b,
                    dkdv_equal=same, b5_unsplit=unsplit,
                    dkdv_equal_to_b5=eq_b5)
                ran.append(var)
            if ran[:3] != ["b0", "b1", "b2"]:
                fail(f"T2b: b0, b1 and b2 must be supported at {tag}")
            del q, k, v, do, o4, lse4, ref, ref_b, dd, first, b5
            torch.cuda.empty_cache()
    return rows


def gemm_rows(gen):
    """K-gemm alone in bf16: each of its four launches at every SD1.5
    level's token count for one request (2 clips) and one training batch
    (4 clips, "train"), held against ln_gemm_plain under the bf16 gate,
    beside its bound, achieved TFLOP/s and torch.matmul on the same (M, K) x
    (K, N) bf16 product: cuBLAS's product without the prologue or epilogue,
    a yardstick only (the port never calls it there).  Both are timed as
    CUDA-graph replays (graph_ms), the plain version as the other rows."""
    import torch
    from asva_tpu_torch.ops import fused
    dtype, dname = torch.bfloat16, "bfloat16"
    rows = []
    with torch.no_grad():
        for prefix, b in (("", B), ("train ", TRAIN_B)):
            for level, (n, c) in SD_LEVELS.items():
                m = b * F * n
                for form, wn, wk, with_ln in GEMM_FORMS:
                    k, nw = wk * c, wn * c
                    nout = nw // 2 if form == "ff1" else nw
                    a = _rand(gen, (m, k), dtype)
                    w = _rand(gen, (nw, k), dtype, k ** -0.5)
                    bias = res = ln = None
                    if form != "q":
                        bias = _rand(gen, (nw,), dtype, 0.1)
                    if form in ("out", "ff2"):
                        res = _rand(gen, (m, nout), dtype)
                    if with_ln:
                        ln = (_rand(gen, (k,), dtype, 0.1, 1.0),
                              _rand(gen, (k,), dtype, 0.1), 1e-5)
                    args = (form, a, w, bias, res, ln)
                    out = fused.ln_gemm(*args)
                    ref = fused.ln_gemm_plain(*args)
                    torch.cuda.synchronize()
                    err, tol, scale = _compare(out, ref, dname)
                    flops = 2 * m * nw * k
                    nbytes = _nbytes(a, w, out, *_tensors(
                        [bias, res] + list(ln[:2] if ln else [])))
                    del out, ref
                    bound_ms, bound_by = _bound(flops, nbytes, dname)
                    ms = graph_ms(lambda: fused.ln_gemm(*args))
                    wt = w.t()
                    row = dict(
                        kernel=f"KG.{form}", dtype=dname, max_abs_err=err,
                        case=f"{prefix}{form} {level} M={m} N={nout} K={k}",
                        tol=tol, max_abs_ref=scale, ok=err <= tol,
                        bytes=nbytes, operations=flops, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=None, ms=ms,
                        plain_ms=time_ms(lambda: fused.ln_gemm_plain(*args),
                                         1, 3),
                        matmul_ms=graph_ms(lambda: torch.matmul(a, wt)),
                        tflops=flops / ms / 1e9)
                    rows.append(row)
                    log(f"  {row['kernel']:6s} {dname:8s} {row['case']:40s} "
                        f"err {err:.3e} (tol {tol:.3e})  kernel {ms:8.4f} ms "
                        f"({row['tflops']:6.1f} TFLOP/s)  plain "
                        f"{row['plain_ms']:8.3f} ms  bound {bound_ms:.4f} ms "
                        f"({bound_by})  matmul {row['matmul_ms']:.4f} ms "
                        f"({row['matmul_ms'] / ms:.2f}x the kernel's "
                        f"speed)  {'ok' if row['ok'] else 'FAIL'}")
                    del a, w, bias, res, ln, args, wt
                torch.cuda.empty_cache()
    return rows


def mix_extra(args, dname):
    """B7's row fields beside `ms` (the wrapper's call between CUDA events,
    as every row): `graph_ms`, the same call as a CUDA-graph replay (the
    device's time); in bf16 the plan of its launch (fused.ff_mix_plan: the
    loader of A and the tile), every loader of A the shape admits timed as
    a graph replay on that plan (`loader_ms`), and torch.matmul of the
    pre-gathered (M, 3C) A [frame 0 | previous frame | frame] by W^T (C,
    3C)^T, also a graph replay: cuBLAS's bare product, a yardstick the port
    never calls (None in fp32)."""
    import torch
    from asva_tpu_torch.ops import fused
    y, kh, kp, kc, bias = args
    b, f, n, c = y.shape
    extra = dict(loader="fp32 FMA", matmul_ms=None)
    with torch.no_grad():
        extra["graph_ms"] = graph_ms(lambda: fused.fused_ff_mix(*args))
        if dname == "bfloat16":
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            plan = fused.ff_mix_plan(tuple(y.shape), sms)
            extra.update(loader=plan["path"], plan=plan, loader_ms={
                p: graph_ms(lambda: fused.ff_mix_launch(
                    *args, dict(plan, path=p)))
                for p in fused.ff_mix_loaders(n, plan["bm"])})
            a3 = torch.cat([y[:, :1].expand_as(y), torch.cat(
                [y[:, :1], y[:, :-1]], 1), y], -1).reshape(-1, 3 * c)
            wt = torch.cat([kh, kp, kc], 1).t()
            extra["matmul_ms"] = graph_ms(lambda: torch.matmul(a3, wt))
            del a3, wt
    return extra


def _tensors(x):
    import torch
    if torch.is_tensor(x):
        return [x]
    return [t for t in x if torch.is_tensor(t)]


def _compare(out, ref, dname, table=TOL):
    """Worst (error, tolerance, |ref|max) over the outputs, by error over
    tolerance; every output must also be finite."""
    import torch
    worst = None
    for a, b in zip(_tensors(out), _tensors(ref)):
        a, b = a.float(), b.float()
        scale = b.abs().max().item()
        tol = table[dname] * (max(1.0, scale) if dname == "float32" else scale)
        err = (a - b).abs().max().item()
        if not bool(torch.isfinite(a).all()):
            err = float("inf")
        if worst is None or err * worst[1] > worst[0] * tol:
            worst = (err, tol, scale)
    return worst


def sdpa_ms(kernel, args):
    """One scaled_dot_product_attention call (forward for B4, its autograd
    backward for B5) on the same q, k, v in its own (G, H, S, D) layout: a
    yardstick only, the port never calls it."""
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    if kernel == "B6":          # one head per batch-head, attended rows only
        q, k, v, kv_len = args
        with torch.no_grad():
            return time_ms(lambda: sdpa(q[None], k[None, :, :kv_len],
                                        v[None, :, :kv_len]))
    q, k, v = args[:3]
    scale = args[-1]

    def heads(t):
        g, s, c = t.shape
        return t.reshape(g, s, HEADS, c // HEADS).transpose(1, 2).contiguous()
    qh, kh, vh = heads(q), heads(k), heads(v)
    if kernel == "B4":
        with torch.no_grad():
            return time_ms(lambda: sdpa(qh, kh, vh, scale=scale))
    leaves = [t.requires_grad_(True) for t in (qh, kh, vh)]
    out = sdpa(*leaves, scale=scale)
    do = heads(args[3])
    return time_ms(lambda: torch.autograd.grad(out, leaves, do,
                                               retain_graph=True))


def gradient_check(wrapper, plain, args, dname):
    """The wrapper's input and parameter gradients against autograd of its
    plain version, for one random cotangent."""
    import torch
    leaves = [a.detach().requires_grad_(True) if torch.is_tensor(a) else a
              for a in args]
    inputs = _tensors(leaves)
    out = wrapper(*leaves)
    if out.grad_fn is None:
        fail("a wrapper returned a tensor without a grad_fn for inputs that "
             "require grad")
    w = torch.randn(out.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(5))
    got = torch.autograd.grad((out.float() * w).sum(), inputs)
    del out
    want = torch.autograd.grad((plain(*leaves).float() * w).sum(), inputs)
    return _compare(got, want, dname, GRAD_TOL)


def phase_kernels(report):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for make in (kernel_cases, flash_cases, flat_cases):
            for kernel, label, wrapper, args, plain, flops, *rest in make(
                    gen, dtype):
                with torch.no_grad():
                    out = wrapper(*args)
                    ref = plain(*args)
                torch.cuda.synchronize()
                err, tol, scale = _compare(out, ref, dname)
                nbytes = _nbytes(*_tensors(args), *_tensors(out))
                if rest and rest[0] is not None:
                    nbytes = rest[0]
                del out, ref
                bound_ms, bound_by = _bound(flops, nbytes, dname)
                row = dict(kernel=kernel, case=label, dtype=dname,
                           max_abs_err=err, tol=tol, max_abs_ref=scale,
                           ok=err <= tol, bytes=nbytes, operations=flops,
                           bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=None)
                with torch.no_grad():
                    row["ms"] = time_ms(lambda: wrapper(*args))
                    row["plain_ms"] = time_ms(lambda: plain(*args), 1, 3)
                if kernel in ("B4", "B5", "B6") and dname == "bfloat16":
                    row["library_ms"] = sdpa_ms(kernel, args)
                if kernel == "B7":
                    row.update(mix_extra(args, dname))
                if kernel not in ("B4", "B5"):
                    g_err, g_tol, _ = gradient_check(wrapper, plain, args,
                                                     dname)
                    row.update(grad_max_abs_err=g_err, grad_tol=g_tol)
                    row["ok"] = row["ok"] and g_err <= g_tol
                rows.append(row)
                grad = (f"  grad err {row['grad_max_abs_err']:.3e} (tol "
                        f"{row['grad_tol']:.3e})" if "grad_tol" in row else "")
                lib = (f"  sdpa {row['library_ms']:.3f} ms"
                       if row["library_ms"] is not None else "")
                if kernel == "B7":
                    lib += (f"  graph {row['graph_ms']:.4f} ms  loader "
                            f"{row['loader']}")
                    for p, t in row.get("loader_ms", {}).items():
                        lib += f"  {p} {t:.4f}"
                    if row["matmul_ms"] is not None:
                        lib += (f"  matmul {row['matmul_ms']:.4f} ms "
                                "(yardstick)")
                log(f"  {kernel} {dname:8s} {label:44s} err {err:.3e} (tol "
                    f"{tol:.3e}){grad}  kernel {row['ms']:8.4f} ms  plain "
                    f"{row['plain_ms']:8.3f} ms  bound {row['bound_ms']:.4f} "
                    f"ms ({row['bound_by']}){lib}  "
                    f"{'ok' if row['ok'] else 'FAIL'}")
            torch.cuda.empty_cache()
        rows += tool_kernel_rows(gen, dtype)
    rows += gemm_rows(gen)
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


def phase_attend(report):
    """The `ln=None` forms at full width: FFSpatialAttention and
    CrossAttention (77 text tokens, 229 unmasked audio tokens) at the 32x32
    and 16x16 levels against dot_product_attention on the same projections;
    then FFInflatedConv's temporal mix redone through fused_ff_mix.  The
    counters are zeroed before and read after: B6 and B7 must have launched,
    B1-B5 not.  Tolerances as in phase 2."""
    import torch
    from asva_tpu_torch.models.unet3d import primitives
    from asva_tpu_torch.ops import fused
    from asva_tpu_torch.ops.attention import dot_product_attention
    from asva_tpu_torch.runtime import _build
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, calls = [], 0
    reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for level in ("32x32", "16x16"):
            n, c = SD_LEVELS[level]
            x = _rand(gen, (B, F, n, c), dtype)
            spatial = _build(lambda: primitives.FFSpatialAttention(
                c, HEADS, c // HEADS), "cuda", dtype, 20, True)
            cross = _build(lambda: primitives.CrossAttention(
                c, HEADS, c // HEADS, 768), "cuda", dtype, 21, True)
            text = _rand(gen, (B, TEXT_TOKENS, 768), dtype)
            audio = _rand(gen, (B, 229, 768), dtype)
            with torch.no_grad():
                for name, mod, ctx in (("spatial", spatial, None),
                                       ("text", cross, text),
                                       ("audio", cross, audio)):
                    got = mod(x) if ctx is None else mod(x, ctx)
                    calls += 1
                    src = x[:, :1] if ctx is None else ctx[:, None]
                    ref = dot_product_attention(
                        mod.split(mod.to_q(x)), mod.split(mod.to_k(src)),
                        mod.split(mod.to_v(src)))
                    ref = mod.to_out[0](ref.flatten(-2))
                    err, tol, scale = _compare(got, ref, dname)
                    rows.append(dict(module=name, level=level, dtype=dname,
                                     max_abs_err=err, tol=tol, ok=err <= tol))
                    log(f"  ln=None {name:8s} {level} {dname:8s} err "
                        f"{err:.3e} (tol {tol:.3e})  "
                        f"{'ok' if err <= tol else 'FAIL'}")
    counts = read_counts()

    # FFInflatedConv at the 32x32 level: the module's own output against its
    # conv followed by fused_ff_mix on the blocks of conv_temp.weight
    reset_counts()
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        c = SD_LEVELS["32x32"][1]
        conv = _build(lambda: primitives.FFInflatedConv(c, c), "cuda", dtype,
                      22, True)
        x = _rand(gen, (B, F, 32, 32, c), dtype)
        with torch.no_grad():
            ref = conv(x)
            y = primitives.InflatedConv.forward(conv, x)
            w = conv.conv_temp.weight
            got = fused.fused_ff_mix(
                y.reshape(B, F, 32 * 32, c), w[:, :c], w[:, c:2 * c],
                w[:, 2 * c:], conv.conv_temp.bias).reshape(ref.shape)
        # bf16: the module rounds each of its three products and four sums,
        # the kernel sums in fp32 and rounds once: 2**-5 of max|module|
        err, tol, scale = _compare(got, ref, dname, GRAD_TOL)
        rows.append(dict(module="ff_inflated_conv mix", level="32x32",
                         dtype=dname, max_abs_err=err, tol=tol,
                         ok=err <= tol))
        log(f"  fused_ff_mix vs FFInflatedConv 32x32 {dname:8s} err "
            f"{err:.3e} (tol {tol:.3e})  {'ok' if err <= tol else 'FAIL'}")
    mix_counts = read_counts()
    report["attend"] = dict(rows=rows, launches=counts,
                            mix_launches=mix_counts)
    others = [k for k in counts if k != "B6" and counts[k]]
    if (not all(r["ok"] for r in rows) or counts["B6"] != calls or others
            or mix_counts["B7"] != 2):
        fail(f"ln=None modules / fused_ff_mix: {report['attend']}")
    torch.cuda.empty_cache()
    return counts["B6"], mix_counts["B7"]


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


# ------------------------------------------------------------- phase 5 ---

def build_trainer(dtype, batch_size):
    """(trainer, state, batch, mask): the full-width training set-up on the
    card.
    Seeded random weights with every parameter randomised, so that every
    sub-layer carries gradient; the trainable mask is the reference's
    (_temp / _audio); frozen parameters are stored in the compute dtype."""
    import torch
    from asva_tpu_torch.models.unet3d import UNet3DConfig
    from asva_tpu_torch.runtime import (build_audio_encoder, build_unet,
                                        build_vae)
    from asva_tpu_torch.training import (AnimationTrainConfig,
                                         AnimationTrainer, TrainState,
                                         build_optimizer, trainable_mask)
    from asva_tpu_torch.training.optim import apply_trainable_mask
    # remat as configs/audio-cond_animation/avsync15_audio-cond_cfg.yaml has
    # it: enable_gradient_checkpoint with the default "highres" policy
    cfg = UNet3DConfig(remat=True, remat_policy="highres")
    unet = build_unet(cfg, dtype=dtype, seed=0, randomize_all=True,
                      train=True)
    mask = trainable_mask(unet)
    apply_trainable_mask(unet, mask, frozen_dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(100)
    trainer = AnimationTrainer(
        unet=unet,
        vae=build_vae(dtype=dtype, seed=1, randomize_all=True),
        audio_encoder=build_audio_encoder(F, dtype=dtype, seed=2,
                                          randomize_all=True),
        # no CLIP weights: a seeded stand-in for the empty-string encoding
        null_text_encoding=torch.randn((1, TEXT_TOKENS, 768), device="cuda",
                                       generator=gen),
        config=AnimationTrainConfig(audio_cond_drop_prob=0.2))
    state = TrainState(0, unet, build_optimizer(
        unet, 1e-4, mask=mask, weight_decay=1e-2, max_grad_norm=1.0))
    batch = {
        "videos": torch.rand((batch_size, F, 256, 256, 3), generator=gen,
                             device="cuda"),
        "waveforms": torch.randn((batch_size, 1, 32000), generator=gen,
                                 device="cuda") * 0.1,
        "text_encodings": torch.randn((batch_size, TEXT_TOKENS, 768),
                                      generator=gen, device="cuda")}
    return trainer, state, batch, mask


def _gen(seed):
    import torch
    return torch.Generator(device="cuda").manual_seed(seed)


def train_steps(trainer, state, batch, n_steps, first_seed):
    """n_steps train steps, each with the counters zeroed just before and
    read just after; the first one's gradients are checked."""
    import torch
    losses, seconds, counts, grad_check = [], [], [], None
    for i in range(n_steps):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            loss, grads = trainer.grad_step(state, batch, _gen(first_seed))
            finite = all(bool(torch.isfinite(g).all()) for g in grads)
            zero = [n for n, g in zip(state.optimizer.names, grads)
                    if not bool(g.any())]
            grad_check = dict(n_trainable=len(grads), all_finite=finite,
                              all_zero=zero[:8])
            trainer.apply_step(state, grads)
            del grads
        else:
            loss = trainer.train_step(state, batch, _gen(first_seed + i))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        losses.append(loss.item())
        counts.append(read_counts())
    return losses, seconds, counts, grad_check


def phase_train(report):
    import torch
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    out = {"remat_policy": "highres"}
    n_steps = 4
    for batch_size in (TRAIN_B, 2, 1):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer, state, batch, mask = build_trainer(torch.bfloat16,
                                                        batch_size)
            # host copies: clones on the card would count in the peak
            frozen = {n: p.detach().cpu()
                      for n, p in state.unet.named_parameters()
                      if not mask[n]}
            losses, seconds, counts, grad_check = train_steps(
                trainer, state, batch, n_steps, 200)
            break
        except torch.cuda.OutOfMemoryError:
            log(f"  train: batch {batch_size} does not fit in device memory")
            trainer = state = batch = frozen = None
    else:
        fail("train: not even batch 1 fits in device memory")
    peak = torch.cuda.max_memory_allocated()
    params = list(state.unet.named_parameters())
    param_bytes = sum(p.numel() * p.element_size() for _, p in params)
    n_frozen = sum(p.numel() for n, p in params if not mask[n])
    n_train = sum(p.numel() for n, p in params if mask[n])
    frozen_same = all(torch.equal(p.cpu(), frozen[n]) and not p.requires_grad
                      and p.grad is None for n, p in params if not mask[n])
    del frozen
    out.update(batch_size=batch_size, losses=losses, seconds_per_step=seconds,
               launches_per_step=counts, max_memory_allocated=peak,
               grad_check=grad_check, frozen_unchanged=frozen_same,
               n_trainable_params=n_train, n_frozen_params=n_frozen,
               unet_param_bytes=param_bytes)
    log(f"  train: remat policy highres; batch {batch_size}; seconds per "
        f"step {[round(x, 3) for x in seconds]}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; UNet parameters {n_train / 1e6:.1f} M "
        f"trainable fp32 + {n_frozen / 1e6:.1f} M frozen bf16 = "
        f"{param_bytes / 2**30:.2f} GiB (all fp32 would be "
        f"{(n_train + n_frozen) * 4 / 2**30:.2f} GiB)")
    log(f"  train: losses {losses}; launches per step {counts}; gradients "
        f"{grad_check}; frozen unchanged {frozen_same}")
    ok = (all(math.isfinite(x) for x in losses) and frozen_same
          and grad_check["all_finite"] and not grad_check["all_zero"]
          and grad_check["n_trainable"] == len(state.optimizer.names)
          and state.step == n_steps)
    # 16 transformer blocks x 3 attention sub-layers, before any recompute
    counts_ok = all(c["B1"] >= 48 and c["B4"] >= 48 and c["B5"] >= 48
                    and c["B2"] == 0 and c["B3"] >= 16 for c in counts)
    if not (ok and counts_ok):
        fail(f"train checks: {out}")

    # one save and restore_latest of the trainer state
    def checksum(unet):
        return sum(p.detach().double().sum().item()
                   for p in unet.parameters())
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        mgr = CheckpointManager(tmp, checkpointing_steps=n_steps)
        saved = mgr.save(state.step, state.state_dict(), extra={"seed": 200})
        want = (state.step, checksum(state.unet), state.optimizer.count)
        with torch.no_grad():
            for p in state.optimizer.params:
                p.zero_()
        state.step, state.optimizer.count = 0, 0
        step, restored = CheckpointManager(tmp).restore_latest("cuda")
        state.load_state_dict(restored)
        del restored
        got = (state.step, checksum(state.unet), state.optimizer.count)
        out["checkpoint"] = dict(saved=saved, step=step, want=want, got=got,
                                 seconds=time.perf_counter() - t0)
    log(f"  train: checkpoint {out['checkpoint']}")
    if not (saved and step == n_steps and got == want):
        fail(f"checkpoint round trip: {out['checkpoint']}")
    launches = {k: sum(c[k] for c in counts) for k in counts[0]}
    del trainer, state, batch
    torch.cuda.empty_cache()

    # Batch 1 in fp32 at full width: kernels vs the plain sub-layers on the
    # same draws.  fp32 products throughout; the kernels differ from
    # torch's in summation order and in the online softmax, through some 100
    # layers forward and back: loss within 1e-4 relative, each trainable
    # gradient within 2e-3 of its largest entry.
    trainer, state, batch, _ = build_trainer(torch.float32, 1)
    draws = trainer.draw(batch, _gen(300))
    reset_counts()
    loss_k, grads_k = trainer.grad_step(state, batch, draws=draws)
    counts32 = read_counts()
    with plain_sublayers():
        loss_p, grads_p = trainer.grad_step(state, batch, draws=draws)
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                for a, b in zip(grads_k, grads_p))
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    out["fp32_batch1"] = dict(loss_kernels=loss_k.item(),
                              loss_plain=loss_p.item(), loss_rel=loss_rel,
                              worst_grad_rel_to_max=worst, launches=counts32)
    log(f"  train: fp32 batch 1 kernels vs plain {out['fp32_batch1']}")
    report["train"] = out
    if not (loss_rel <= 1e-4 and worst <= 2e-3 and counts32["B5"] >= 48):
        fail(f"fp32 batch-1 train comparison: {out['fp32_batch1']}")
    del trainer, state, batch, grads_k, grads_p
    torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- phase 6 ---

def _prompt_ids(seed, n_words):
    """(1, 77) CLIP token ids from a seed: start-of-text, n_words word ids,
    end-of-text padding (no vocabulary file ships with the repository)."""
    import torch
    ids = torch.full((1, TEXT_TOKENS), 49407, dtype=torch.long)
    ids[0, 0] = 49406
    ids[0, 1:1 + n_words] = torch.randint(
        256, 49000, (n_words,), generator=torch.Generator().manual_seed(seed))
    return ids.cuda()


def _judge(models, gen_videos, gt_videos, mels, ids):
    """Every metric of the bundle on (3, 12, 256, 256, 3) clips in [0, 1]:
    features, similarities, scores and the reducers."""
    import torch
    from asva_tpu_torch.data.transforms import (clip_frame_transform,
                                                fid_frame_transform,
                                                fvd_frame_transform)
    from asva_tpu_torch.eval.frechet import frechet_distance
    from asva_tpu_torch.eval.metrics import (compute_alignsync,
                                             compute_avsync_scores,
                                             compute_relsync)
    n, f = gen_videos.shape[:2]
    out = {}
    for name, videos in (("gen", gen_videos), ("gt", gt_videos)):
        fid = models.fid_features(fid_frame_transform(videos).flatten(0, 1))
        out[f"fid_{name}"] = fid.reshape(n, f, -1)
        out[f"fvd_{name}"] = models.fvd_features(fvd_frame_transform(videos))
    frames = clip_frame_transform(gen_videos).flatten(0, 1)
    out["ia"] = models.ia_sim(frames, mels.repeat_interleave(f, dim=0))
    out["it"] = models.it_sim(frames, ids.repeat_interleave(f, dim=0))
    out["sync_gen"] = torch.from_numpy(compute_avsync_scores(
        models.avsync_score, mels, gen_videos))
    reduced = dict(
        # FID leaves out frame 0, the conditioning frame
        FID=frechet_distance(out["fid_gt"][:, 1:].flatten(0, 1),
                             out["fid_gen"][:, 1:].flatten(0, 1)),
        FVD=frechet_distance(out["fvd_gt"], out["fvd_gen"]),
        IA=out["ia"].reshape(n, f)[:, 1:].mean().item(),
        IT=out["it"].reshape(n, f)[:, 1:].mean().item(),
        RelSync=compute_relsync(models.avsync_score, mels, gen_videos,
                                ref_videos=gt_videos).tolist(),
        AlignSync=compute_alignsync(models.avsync_score, models.ia_sim, mels,
                                    gen_videos, gt_videos).tolist())
    return out, reduced


def phase_judge(report):
    import torch
    from asva_tpu_torch.eval.harness import build_eval_models
    from asva_tpu_torch.runtime import (build_text_encoder,
                                        load_animation_pipeline)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_start = time.perf_counter()

    # prompt ids -> CLIP text encoder -> the (b, 77, 768) conditioning
    encoder = build_text_encoder(device="cuda", dtype=torch.bfloat16, seed=3,
                                 randomize_all=True)
    prompts = [_prompt_ids(600 + i, 4 + i) for i in range(3)]
    with torch.no_grad():
        encodings = [encoder(ids) for ids in prompts]
        null_text = encoder(_prompt_ids(0, 0))
    text_ok = all(tuple(e.shape) == (1, TEXT_TOKENS, 768)
                  and bool(torch.isfinite(e).all()) for e in encodings)
    del encoder

    pipe = load_animation_pipeline(device="cuda", dtype=torch.bfloat16,
                                   seed=0, randomize_all=True,
                                   null_text_encoding=null_text)
    reset_counts()
    videos, mels, seconds = [], [], []
    for i, text in enumerate(encodings):
        g = _gen(610 + i)
        image = torch.rand((1, 256, 256, 3), generator=g, device="cuda")
        wave = torch.randn((1, 32000), generator=g, device="cuda") * 0.1
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mel = pipe.encode_audio_waveform([wave])
        videos.append(pipe(image, mel, text, generator=_gen(620 + i),
                           video_length=F, num_inference_steps=5,
                           sampler="ddim", audio_guidance_scale=4.0,
                           text_guidance_scale=1.0))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        mels.append(mel)
    counts = read_counts()
    del pipe
    torch.cuda.empty_cache()
    gen_videos = torch.cat(videos).float()
    mels = torch.cat(mels).float()
    gt_videos = torch.rand(gen_videos.shape, generator=_gen(630),
                           device="cuda")
    ids = torch.cat(prompts)

    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        t0 = time.perf_counter()
        models = build_eval_models("cuda", dtype, seed=0, randomize_all=True)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        feats, reduced = _judge(models, gen_videos, gt_videos, mels, ids)
        torch.cuda.synchronize()
        results[dname] = (feats, reduced, build_s, time.perf_counter() - t0,
                          models.random_nets)
        del models
        torch.cuda.empty_cache()
    peak = torch.cuda.max_memory_allocated()

    feats, reduced, _, _, random_nets = results["float32"]
    n, f = gen_videos.shape[:2]
    shapes = dict(fid_gen=(n, f, 2048), fid_gt=(n, f, 2048), fvd_gen=(n, 400),
                  fvd_gt=(n, 400), ia=(n * f,), it=(n * f,), sync_gen=(n,))
    shape_ok = all(tuple(results[d][0][k].shape) == shape
                   and bool(torch.isfinite(results[d][0][k]).all())
                   for d in results for k, shape in shapes.items())
    reduced_ok = all(
        math.isfinite(r["FID"]) and math.isfinite(r["FVD"])
        and -1 - 1e-3 <= r["IA"] <= 1 + 1e-3
        and -1 - 1e-3 <= r["IT"] <= 1 + 1e-3
        and len(r["RelSync"]) == n and len(r["AlignSync"]) == n
        and all(0.0 <= x <= 1.0 for x in r["RelSync"] + r["AlignSync"])
        for r in (results[d][1] for d in results))
    # bf16 bundle vs fp32 bundle, same seeds (the bf16 weights are the fp32
    # ones rounded): relative RMS of each feature set
    rel_rms = {k: ((results["bfloat16"][0][k] - feats[k]).norm()
                   / feats[k].norm()).item() for k in shapes}
    rms_ok = all(rel_rms[k] <= 0.1 for k in ("fid_gen", "fid_gt", "fvd_gen",
                                             "fvd_gt"))
    counts_ok = counts["B2"] > 0 and counts["B3"] > 0 and counts["B6"] == 0
    report["judge"] = dict(
        seconds_total=time.perf_counter() - t_start,
        seconds_per_clip=seconds, launches=counts,
        build_seconds={d: results[d][2] for d in results},
        judge_seconds={d: results[d][3] for d in results},
        max_memory_allocated=peak, random_nets=random_nets,
        reduced={d: results[d][1] for d in results},
        bf16_rel_rms_vs_fp32=rel_rms, text_ok=text_ok, shape_ok=shape_ok,
        reduced_ok=reduced_ok, rms_ok=rms_ok, counts_ok=counts_ok)
    log(f"  judge: {report['judge']['seconds_total']:.1f} s in all; seconds "
        f"per clip {[round(x, 3) for x in seconds]}; bundle build "
        f"{report['judge']['build_seconds']} s, metrics "
        f"{report['judge']['judge_seconds']} s; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; launches {counts}")
    log(f"  judge: fp32 {reduced}")
    log(f"  judge: bf16 {results['bfloat16'][1]}")
    log(f"  judge: bf16 vs fp32 relative RMS {rel_rms}")
    if not (text_ok and shape_ok and reduced_ok and rms_ok and counts_ok):
        fail(f"judge checks: {report['judge']}")
    return counts


# ------------------------------------------------------------- phase 7 ---

def phase_tools(report):
    """Both kernel tools through their `main`, as `python3 -m
    asva_tpu_torch.tools.<name> --n 3` runs them.  Every call of a tool's
    timer is 2 warm-up launches and n timed ones."""
    from asva_tpu_torch.tools import attn_experiments, mha_phase_bench
    n = 3
    reset_counts()
    t0 = time.perf_counter()
    attn_rows = attn_experiments.main(["--n", str(n)], device="cuda")
    mha_rows = mha_phase_bench.main(["--n", str(n)], device="cuda")
    seconds = time.perf_counter() - t0
    counts = read_counts()
    per_timing = n + 2

    def timed(rows, kind, key):
        return sum(per_timing for r in rows if r["kind"] == kind
                   and r.get(key) is not None and r.get("supported", True))
    expect = {
        "T1": sum(r["kind"] == "parity" for r in attn_rows)
        + timed(attn_rows, "time", "block_m"),
        "T2F": sum(r["kind"] == "parity_fwd" and r["supported"]
                   for r in mha_rows) + timed(mha_rows, "time_fwd", "group"),
        "T2B": sum(r["kind"] == "parity_bwd" and r["supported"]
                   for r in mha_rows) + timed(mha_rows, "time_bwd", "variant")}
    failed = [r for r in attn_rows + mha_rows if not r.get("ok", True)]
    got = {k: counts[k] for k in expect}
    report["tools"] = dict(seconds=seconds, n=n, launches=counts,
                           expected=expect, attn_experiments=attn_rows,
                           mha_phase_bench=mha_rows,
                           failed=[str(r) for r in failed])
    log(f"  tools: {seconds:.1f} s; launches {got}, the rows imply {expect}; "
        f"{len(failed)} parity rows failed")
    if failed or got != expect or min(got.values()) <= 0:
        fail(f"tools: launches {got} vs {expect}; failed rows {failed}")
    return got


# ------------------------------------------------------------- phase 8 ---

SYNC_YAML = "configs/avsync/vggss_sync_contrast.yaml"


def build_sync_trainer(cfg, compute_dtype, batch_size, seed):
    """(trainer, state, batch): the judge's trainer at the config's sizes on
    the card, seeded weights and a seeded random batch."""
    import torch
    from asva_tpu_torch.runtime import build_avsync_classifier
    from asva_tpu_torch.training import (SyncContrastiveTrainer,
                                         SyncTrainState, build_optimizer)
    clf = build_avsync_classifier(device="cuda", seed=seed, train=True)
    o = cfg.optim
    optimizer = build_optimizer(
        clf, o.learning_rate, max_grad_norm=o.max_grad_norm,
        adam_beta1=o.adam_beta1, adam_beta2=o.adam_beta2,
        adam_eps=o.adam_epsilon, weight_decay=o.adam_weight_decay,
        warmup_steps=(o.lr_warmup_steps
                      if o.lr_scheduler == "constant_with_warmup" else 0))
    trainer = SyncContrastiveTrainer(clf, tau=cfg.tau,
                                     compute_dtype=compute_dtype)
    d = cfg.train_dataset
    gen = _gen(seed + 1)
    k, f, hw = d.num_clips, d.video_num_frames, d.image_size
    batch = {"mels": torch.randn((batch_size, k, 128, 204, 1), generator=gen,
                                 device="cuda"),
             "videos": torch.randn((batch_size, k, f, hw, hw, 3),
                                   generator=gen, device="cuda")}
    return trainer, SyncTrainState(0, clf, optimizer), batch


def phase_sync(report):
    import torch
    from asva_tpu_torch.config import SyncJobConfig
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    cfg = SyncJobConfig.from_yaml(os.path.join(ROOT, SYNC_YAML))
    k = cfg.train_dataset.num_clips
    out = {"config": SYNC_YAML, "num_clips": k, "tau": cfg.tau,
           "learning_rate": cfg.optim.learning_rate,
           "warmup_steps": cfg.optim.lr_warmup_steps}
    n_steps = 4

    def clone_state(clf):
        return {n: t.detach().clone() for n, t in clf.state_dict().items()}

    for batch_size in (cfg.batch_size, 2, 1):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        try:
            trainer, state, batch = build_sync_trainer(cfg, torch.bfloat16,
                                                       batch_size, 700)
            before = clone_state(state.classifier)
            metrics, seconds = [], []
            for _ in range(n_steps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                m = trainer.train_step(state, batch)
                torch.cuda.synchronize()
                seconds.append(time.perf_counter() - t0)
                metrics.append({key: v.item() for key, v in m.items()})
            break
        except torch.cuda.OutOfMemoryError:
            log(f"  sync: batch {batch_size} does not fit in device memory")
            trainer = state = batch = before = None
    else:
        fail("sync: not even batch 1 fits in device memory")
    peak = torch.cuda.max_memory_allocated()
    losses = [(m["av_loss"] + m["va_loss"]) / 2 for m in metrics]
    after = state.classifier.state_dict()
    stats_moved = all(not torch.equal(after[n], before[n]) for n in after
                      if "running_" in n)
    # the first warm-up step has lr 0 (the schedule is read before the
    # step): parameters move from the second step on
    params_moved = all(not torch.equal(p, before[n])
                       for n, p in state.classifier.named_parameters())
    near = all(math.isfinite(x) and 0.5 * math.log(k) <= x <= 2 * math.log(k)
               for x in losses)
    out.update(batch_size=batch_size, clips_per_step=batch_size * k,
               seconds_per_step=seconds, max_memory_allocated=peak,
               metrics=metrics, losses=losses, ln_k=math.log(k),
               running_statistics_changed=stats_moved,
               parameters_changed=params_moved)
    log(f"  sync: batch {batch_size} ({batch_size * k} clips a step); seconds "
        f"per step {[round(x, 3) for x in seconds]}; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; losses {losses} (ln {k} = "
        f"{math.log(k):.3f}); running statistics changed {stats_moved}; "
        f"parameters changed {params_moved}")
    if not (near and stats_moved and params_moved and state.step == n_steps
            and state.optimizer.count == n_steps):
        fail(f"sync trainer steps: {out}")

    # eval_metrics: no state change, no dependence on the batch's order
    snapshot = clone_state(state.classifier)
    ev = {key: v.item() for key, v in trainer.eval_metrics(batch).items()}
    perm = torch.randperm(batch_size, generator=torch.Generator().manual_seed(
        1)).cuda()
    if batch_size > 1 and perm.tolist() == list(range(batch_size)):
        perm = perm.flip(0)
    ev_perm = {key: v.item() for key, v in trainer.eval_metrics(
        {name: t[perm] for name, t in batch.items()}).items()}
    untouched = all(torch.equal(v, snapshot[n]) for n, v in
                    state.classifier.state_dict().items())
    # the per-item rows are the same up to the convolutions' batch position;
    # losses within 1e-3 relative, accuracies within one row of b * k
    same = all(abs(ev[key] - ev_perm[key]) <= (
        1e-3 * max(1.0, abs(ev[key])) if key.endswith("loss")
        else 1.0 / (batch_size * k) + 1e-6) for key in ev)
    out["eval"] = dict(metrics=ev, permuted=ev_perm, state_untouched=untouched,
                       order_invariant=same,
                       mode_restored=state.classifier.training)
    log(f"  sync: eval_metrics {ev}; permuted batch {ev_perm}; state "
        f"untouched {untouched}")
    if not (untouched and same and state.classifier.training
            and all(math.isfinite(x) for x in ev.values())):
        fail(f"sync eval_metrics: {out['eval']}")

    # checkpoint round trip: parameters, buffers, optimizer state, counters
    want = state.state_dict()
    want = dict(step=want["step"], classifier=clone_state(state.classifier),
                mu={n: t.clone() for n, t in want["optimizer"]["mu"].items()},
                nu={n: t.clone() for n, t in want["optimizer"]["nu"].items()})
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        saved = CheckpointManager(tmp, n_steps).save(state.step,
                                                     state.state_dict())
        with torch.no_grad():
            for t in state.classifier.state_dict().values():
                t.zero_()
        state.step, state.optimizer.count = 0, 0
        step, restored = CheckpointManager(tmp).restore_latest("cuda")
        state.load_state_dict(restored)
        del restored
        got = state.state_dict()
        exact = (all(torch.equal(v, want["classifier"][n])
                     for n, v in got["classifier"].items())
                 and all(torch.equal(v, want[kind][n]) for kind in ("mu", "nu")
                         for n, v in got["optimizer"][kind].items())
                 and got["step"] == want["step"] == step
                 and state.optimizer.count == n_steps)
        out["checkpoint"] = dict(saved=saved, step=step, bit_exact=exact,
                                 seconds=time.perf_counter() - t0)
    log(f"  sync: checkpoint {out['checkpoint']}")
    if not (saved and exact):
        fail(f"sync checkpoint round trip: {out['checkpoint']}")
    del trainer, state, batch, before, snapshot, want, got
    torch.cuda.empty_cache()

    # fp32 at batch 1, twice from the same seed: the same loss and the same
    # parameters, bit for bit
    runs = []
    cudnn_was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # no atomics in cuDNN's wgrad
    for _ in range(2):
        trainer, state, batch = build_sync_trainer(cfg, torch.float32, 1, 710)
        ms = [trainer.train_step(state, batch) for _ in range(3)]
        runs.append(([m["av_loss"].item() for m in ms],
                     clone_state(state.classifier)))
        del trainer, state, batch
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = cudnn_was
    deterministic = (runs[0][0] == runs[1][0]
                     and all(torch.equal(v, runs[1][1][n])
                             for n, v in runs[0][1].items()))
    out["fp32_batch1"] = dict(av_losses=runs[0][0], repeated=runs[1][0],
                              deterministic=deterministic)
    log(f"  sync: fp32 batch 1 twice: {out['fp32_batch1']}")
    report["sync"] = out
    if not (deterministic and all(math.isfinite(x) for x in runs[0][0])):
        fail(f"sync fp32 determinism: {out['fp32_batch1']}")
    del runs
    torch.cuda.empty_cache()


# ------------------------------------------------------------- phase 9 ---

def _write_conditioning(tmp):
    """A 256x256 PNG and 6.5 s of stereo 44.1 kHz int16 wav (a little more
    than three 2 s clips: the resampler and the all-channel mean run)."""
    import numpy as np
    from PIL import Image
    from scipy.io import wavfile
    rng = np.random.default_rng(900)
    yy, xx = np.mgrid[0:256, 0:256] / 255.0
    image = np.stack([xx, yy, 0.5 + 0.5 * np.sin(6 * xx + 4 * yy)], -1)
    image = np.clip(image + 0.05 * rng.standard_normal(image.shape), 0, 1)
    image_path = os.path.join(tmp, "cond.png")
    Image.fromarray((image * 255).astype(np.uint8)).save(image_path)
    t = np.arange(int(6.5 * 44100)) / 44100
    wave = np.stack([0.5 * np.sin(2 * np.pi * 440 * t),
                     0.3 * np.sin(2 * np.pi * 97 * t)
                     + 0.05 * rng.standard_normal(t.shape)], -1)
    audio_path = os.path.join(tmp, "cond.wav")
    wavfile.write(audio_path, 44100, (np.clip(wave, -1, 1) * 32767).astype(
        np.int16))
    return image_path, audio_path


class _Captured:
    """A pipeline whose float videos are kept (the comparisons are made
    before generate_videos' uint8 cast)."""

    def __init__(self, pipe):
        self.pipe, self.videos = pipe, []

    @property
    def device(self):
        return self.pipe.device

    def __call__(self, *args, **kw):
        out = self.pipe(*args, **kw)
        self.videos.append(out.float().clone())
        return out

    def video(self):
        import torch
        return torch.cat(self.videos)


def _unet_blocks(unet):
    """(audio transformer blocks, transformer blocks) of the UNet: B2 and
    B3 launches per UNet call on the generation path."""
    from asva_tpu_torch.models.unet3d.transformer import (
        SpatioAudioTempTransformerBlock)
    blocks = [m for m in unet.modules()
              if isinstance(m, SpatioAudioTempTransformerBlock)]
    return sum(b.use_audio for b in blocks), len(blocks)


def phase_files(report, pipeline_seconds):
    """generate_videos from a PNG and a wav at full width, both batch_clips
    modes, then the eval harness's metric step on the frames."""
    import numpy as np
    import torch
    from asva_tpu_torch.data import media
    from asva_tpu_torch.eval.harness import build_eval_models, evaluate_arrays
    from asva_tpu_torch.ops.mel import waveform_to_mel
    from asva_tpu_torch.pipelines.generate import (generate_videos,
                                                   load_audio_clips_uniformly)
    from asva_tpu_torch.runtime import load_animation_pipeline
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps, n_clips = 5, 3
    with tempfile.TemporaryDirectory() as tmp:
        image_path, audio_path = _write_conditioning(tmp)
        text = torch.randn((TEXT_TOKENS, 768), generator=_gen(901),
                           device="cuda")
        kw = dict(image_path=image_path, audio_path=audio_path,
                  category_text_encoding=text, image_size=(256, 256),
                  video_fps=6, video_num_frame=F,
                  num_clips_per_video=n_clips, num_inference_steps=steps,
                  sampler="ddim", audio_guidance_scale=4.0,
                  text_guidance_scale=1.0, seed=7, save_template="")
        null_text = torch.randn((1, TEXT_TOKENS, 768), device="cuda",
                                generator=_gen(100))
        pipes = {dtype: load_animation_pipeline(
            device="cuda", dtype=dtype, seed=0, randomize_all=True,
            null_text_encoding=null_text)
            for dtype in (torch.bfloat16, torch.float32)}
        n_audio, n_blocks = _unet_blocks(pipes[torch.bfloat16].unet)

        runs, seconds, counts = {}, {}, {}
        for dtype, pipe in pipes.items():
            dname = str(dtype).split(".")[-1]
            for batch in (True, False):
                mode = f"{dname} {'batched' if batch else 'per-clip'}"
                rec = _Captured(pipe)
                torch.cuda.synchronize()
                reset_counts()
                t0 = time.perf_counter()
                out = generate_videos(rec, batch_clips=batch, **kw)
                torch.cuda.synchronize()
                seconds[mode] = time.perf_counter() - t0
                counts[mode] = read_counts()
                runs[mode] = (out, rec.video())
        # the reference for the bf16 gate: the bf16 pipeline through the
        # plain sub-layers, batched
        rec = _Captured(pipes[torch.bfloat16])
        with plain_sublayers():
            generate_videos(rec, batch_clips=True, **kw)
        plain16 = rec.video()

        refused = None
        if not media.media_available():   # no libav: the write must refuse
            try:
                generate_videos(pipes[torch.bfloat16],
                                **dict(kw, save_template=os.path.join(
                                    tmp, "out", "gen")))
                refused = False
            except RuntimeError as e:
                refused = "save_template" in str(e)
        else:                             # libav here: the clips are written
            generate_videos(pipes[torch.bfloat16], **dict(
                kw, save_template=os.path.join(tmp, "out", "gen")))
            refused = all(os.path.isfile(os.path.join(
                tmp, "out", f"gen_clip-{k:02d}.mp4"))
                for k in range(n_clips))
        waves = load_audio_clips_uniformly(audio_path, F / 6, n_clips)
    del pipes
    torch.cuda.empty_cache()

    shape_ok = all(len(out) == n_clips and all(
        f.shape == (F, 256, 256, 3) and f.dtype == np.uint8
        and a.shape == (2, 32000) for f, a in out)
        for out, _ in runs.values())
    calls = {"batched": steps, "per-clip": steps * n_clips}
    expected = {mode: {"B2": calls[mode.split(" ", 1)[1]] * n_audio,
                       "B3": calls[mode.split(" ", 1)[1]] * n_blocks}
                for mode in runs}
    counts_ok = all(counts[m]["B2"] == expected[m]["B2"] > 0
                    and counts[m]["B3"] == expected[m]["B3"] > 0
                    and counts[m]["B6"] == 0 for m in runs)

    def frames(mode):
        return np.stack([f for f, _ in runs[mode][0]]).astype(np.int16)

    def agree(a, b):
        d = np.abs(frames(a) - frames(b))
        return dict(max_levels=int(d.max()), share_differing=float(
            (d > 0).mean()))
    fp32 = agree("float32 batched", "float32 per-clip")
    bf16 = agree("bfloat16 batched", "bfloat16 per-clip")
    ref32 = runs["float32 per-clip"][1]

    def rel_rms(v):
        return ((v - ref32).norm() / ref32.norm()).item()
    gate = dict(plain_bf16=rel_rms(plain16),
                batched_bf16=rel_rms(runs["bfloat16 batched"][1]),
                per_clip_bf16=rel_rms(runs["bfloat16 per-clip"][1]))
    # fp32: one uint8 level; bf16: phase 4's rule, each mode's relative RMS
    # distance from the fp32 video within 1.5x the plain bf16 version's
    agree_ok = (fp32["max_levels"] <= 1
                and gate["batched_bf16"] <= 1.5 * gate["plain_bf16"]
                and gate["per_clip_bf16"] <= 1.5 * gate["plain_bf16"])

    # the eval harness's metric step on the returned frames (phase 6's
    # models), seeded random clips as the ground truth
    gen = torch.from_numpy(frames("bfloat16 batched").astype(
        np.float32) / 255.0).cuda()
    mels = torch.stack([waveform_to_mel(torch.as_tensor(w, device="cuda"))
                        for w in waves])
    gt = torch.rand(gen.shape, generator=_gen(902), device="cuda")
    models = build_eval_models("cuda", torch.float32, seed=0,
                               randomize_all=True)
    t0 = time.perf_counter()
    metrics, per_clip = evaluate_arrays(
        models, [(gt, mels)], [(gen, mels)], ids=[_prompt_ids(903, 4)[0]],
        device="cuda")
    torch.cuda.synchronize()
    metric_s = time.perf_counter() - t0
    del models
    torch.cuda.empty_cache()
    metrics_ok = (
        sorted(metrics) == sorted(
            ["FID", "FVD", "IA_mean", "IA_std", "IT_mean", "IT_std",
             "RelSync_mean", "RelSync_std", "AlignSync_mean",
             "AlignSync_std"])
        and all(math.isfinite(v) for v in metrics.values())
        and all(len(v) == n_clips and np.isfinite(v).all()
                and ((v >= 0) & (v <= 1)).all()
                for k, v in per_clip.items() if k != "IA")
        and abs(metrics["IA_mean"]) <= 1 + 1e-3
        and abs(metrics["IT_mean"]) <= 1 + 1e-3)

    per_clip_s = {m: s / n_clips for m, s in seconds.items()}
    report["files"] = dict(
        seconds_per_clip=per_clip_s,
        pipeline_seconds_per_clip=pipeline_seconds, launches=counts,
        expected_launches=expected, fp32_batched_vs_per_clip=fp32,
        bf16_batched_vs_per_clip=bf16, bf16_gate=gate,
        save_template_refused_or_written=refused, metrics=metrics,
        metric_seconds=metric_s,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        shape_ok=shape_ok, counts_ok=counts_ok, agree_ok=agree_ok,
        metrics_ok=metrics_ok)
    log(f"  files: seconds per clip through generate_videos "
        f"{ {m: round(s, 3) for m, s in per_clip_s.items()} } beside the "
        f"pipeline call's {[round(s, 3) for s in pipeline_seconds]} "
        f"(phase 4); launches {counts}; expected {expected}")
    log(f"  files: fp32 batched vs per-clip {fp32}; bf16 {bf16}; "
        f"relative RMS from fp32 {gate}; save_template refused without "
        f"libav (or written with it): {refused}")
    log(f"  files: metrics {metrics} in {metric_s:.1f} s")
    if not (shape_ok and counts_ok and agree_ok and refused and metrics_ok):
        fail(f"files checks: {report['files']}")
    return counts["bfloat16 batched"], counts["bfloat16 per-clip"]


def _kernel_kind(name: str) -> str:
    """Coarse family of a device kernel, from its name."""
    if "(anonymous namespace)::gemm_" in name:
        return "port K-gemm"
    if "(anonymous namespace)::attn_" in name:
        return "port B4 (K-attn)"
    if "(anonymous namespace)::bwd_" in name:
        return "port B5"
    if "(anonymous namespace)::mix_" in name:
        return "port K-mix (B7)"
    if any(s in name for s in ("fprop", "dgrad", "wgrad", "cudnn")):
        return "cuDNN convolution"
    if any(s in name for s in ("xmma_gemm_f32f32", "sgemm", "gemmSN",
                               "gemv")):
        return "cuBLAS fp32 product"
    if any(s in name for s in ("nvjet", "xmma_gemm", "cutlass")):
        return "cuBLAS bf16 product"
    if "at::native" in name:
        return "torch elementwise / reduce / copy"
    return "other"


def _profile(label, fn, plain_s, report):
    """fn() once under torch.profiler: device time by kernel name and kind,
    device busy time, and the idle share against `plain_s`, the host-clock
    seconds of the same call unprofiled."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev = getattr(e, "self_device_time_total",
                      getattr(e, "self_cuda_time_total", 0))
        if dev > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            rows.append(dict(name=e.key[:120], count=e.count,
                             device_ms=dev / 1e3))
    if not rows:
        fail(f"profile {label}: the profiler saw no device time")
    rows.sort(key=lambda r: -r["device_ms"])
    busy = sum(r["device_ms"] for r in rows)
    kinds = {}
    for r in rows:
        k = kinds.setdefault(_kernel_kind(r["name"]),
                             dict(device_ms=0.0, launches=0))
        k["device_ms"] += r["device_ms"]
        k["launches"] += r["count"]
    out = report[f"profile_{label}"] = dict(
        seconds_unprofiled=plain_s, seconds_profiled=prof_s,
        device_busy_ms=busy, n_kernel_launches=sum(r["count"] for r in rows),
        idle_share_vs_unprofiled=1.0 - busy / 1e3 / plain_s,
        by_kind=kinds, top=rows[:60])
    log(f"  profile {label}: {plain_s:.3f} s unprofiled, {prof_s:.3f} s "
        f"profiled; device busy {busy:.1f} ms in {out['n_kernel_launches']} "
        f"launches; idle {out['idle_share_vs_unprofiled']:.1%} of the "
        f"unprofiled time")
    for kind, k in sorted(kinds.items(), key=lambda kv: -kv[1]["device_ms"]):
        log(f"    {k['device_ms']:9.2f} ms  x{k['launches']:<6d} {kind}")
    for r in rows[:25]:
        log(f"    {r['device_ms']:9.2f} ms  x{r['count']:<6d} {r['name']}")


def profile_train(report):
    """One steady training step (batch 4, bf16) under torch.profiler."""
    import torch
    trainer, state, batch, _ = build_trainer(torch.bfloat16, TRAIN_B)
    for i in range(2):
        trainer.train_step(state, batch, _gen(400 + i))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train_step(state, batch, _gen(402))
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _profile("train", lambda: trainer.train_step(state, batch, _gen(403)),
             plain_s, report)


def profile_request(report):
    """One warm generation request (as phase 4's) under torch.profiler."""
    import torch
    null_text = torch.randn((1, TEXT_TOKENS, 768), device="cuda",
                            generator=_gen(100))
    from asva_tpu_torch.runtime import load_animation_pipeline
    pipe = load_animation_pipeline(dtype=torch.bfloat16, seed=0,
                                   randomize_all=True,
                                   null_text_encoding=null_text)
    g = _gen(101)
    image = torch.rand((1, 256, 256, 3), generator=g, device="cuda")
    wave = torch.randn((1, 32000), generator=g, device="cuda") * 0.1
    text = torch.randn((1, TEXT_TOKENS, 768), generator=g, device="cuda")

    def request(seed):
        mels = pipe.encode_audio_waveform([wave])
        return pipe(image, mels, text, generator=_gen(seed), video_length=F,
                    num_inference_steps=5, sampler="ddim",
                    audio_guidance_scale=4.0, text_guidance_scale=1.0)

    seconds = []
    for seed in range(500, 505):      # the first two warm up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        request(seed)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    plain_s = sorted(seconds[2:])[1]
    _profile("request", lambda: request(505), plain_s, report)
    report["profile_request"]["seconds_all"] = seconds


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
    cuobjdump = os.path.join(os.path.dirname(cuda_build.nvcc_path()),
                             "cuobjdump")
    for name, (path, ptxas) in built.items():
        usage = [ln.strip() for ln in ptxas.splitlines()
                 if "registers" in ln or "spill" in ln]
        # warnings, and the notes on serialized wgmma (C7510-C7520)
        warnings = [ln.strip() for ln in ptxas.splitlines()
                    if "warning" in ln.lower() or "(C75" in ln]
        report[f"ptxas_{name}"] = usage
        report[f"ptxas_warnings_{name}"] = warnings
        sass = {}
        if os.path.isfile(cuobjdump):   # which tensor-core instructions
            text = subprocess.run([cuobjdump, "-sass", path],
                                  capture_output=True, text=True,
                                  timeout=300).stdout
            sass = {op: sum(f" {op}." in ln or f" {op} " in ln
                            for ln in text.splitlines())
                    for op in ("HGMMA", "HMMA")}
        report[f"sass_{name}"] = sass
        codes = {}
        for w in warnings:
            if "(C75" in w:
                code = w[w.index("(C75") + 1:w.index("(C75") + 6]
                codes[code] = codes.get(code, 0) + 1
        log(f"  {name}: {os.path.relpath(path, ROOT)}; "
            f"{len(usage)} ptxas usage lines; {len(warnings)} ptxas "
            f"warnings and notes {codes or ''}; "
            f"SASS {sass or 'not read (no cuobjdump)'}")
        if any("C7514" in w for w in warnings):
            fail(f"{name}: ptxas serialized wgmma around a branch (C7514)")
        if name in WGMMA_SOURCES and (not sass or sass["HGMMA"] == 0
                                      or sass["HMMA"] > 0):
            fail(f"{name}: its SASS must hold HGMMA and no HMMA, has "
                 f"{sass or 'none read'}")
    log(f"  build {report['build_seconds']:.1f} s")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi gave no output"
    report["card"] = card

    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    if "--profile" in sys.argv[1:]:
        log(f"profile: one generation request, one training step on {card}")
        profile_request(report)
        torch.cuda.empty_cache()
        profile_train(report)
        with open(os.path.join(out_dir, "profile.json"), "w") as f:
            json.dump(report, f, indent=1)
        return 0

    log("phase 2: kernels vs plain")
    rows = phase_kernels(report)
    log("phase 3: ln=None modules, fused_ff_mix, unet")
    b6_count, b7_count = phase_attend(report)
    b1_counts = phase_unet(report)
    log("phase 4: pipeline")
    pipe_counts = phase_pipeline(report)
    log("phase 5: train")
    train_counts = phase_train(report)
    log("phase 6: judge")
    judge_counts = phase_judge(report)
    if pipe_counts["B6"] or train_counts["B6"] or judge_counts["B6"]:
        fail("generation or training launched B6: they go through B1-B5")
    log("phase 7: tools")
    tool_counts = phase_tools(report)
    log("phase 8: sync trainer")
    phase_sync(report)
    log("phase 9: generation and evaluation from files")
    batched_counts, per_clip_counts = phase_files(
        report, report["pipeline"]["seconds_per_clip"])

    # launches on each driven path: B1 and B3 run in generation and training
    by_path = {
        "B1": {"unet fuse_blocks=False": b1_counts["B1"],
               "train, 4 steps": train_counts["B1"]},
        "B2": {"pipeline, 3 requests": pipe_counts["B2"],
               "judge, 3 requests": judge_counts["B2"],
               "generate_videos, 3 clips batched": batched_counts["B2"],
               "generate_videos, 3 clips per clip": per_clip_counts["B2"]},
        "B3": {"pipeline, 3 requests": pipe_counts["B3"],
               "train, 4 steps": train_counts["B3"],
               "judge, 3 requests": judge_counts["B3"],
               "generate_videos, 3 clips batched": batched_counts["B3"],
               "generate_videos, 3 clips per clip": per_clip_counts["B3"]},
        "B4": {"train, 4 steps": train_counts["B4"]},
        "B5": {"train, 4 steps": train_counts["B5"]},
        "B6": {"ln=None attention modules": b6_count},
        "B7": {"fused_ff_mix on FFInflatedConv's conv": b7_count},
        "T1": {"tools.attn_experiments main": tool_counts["T1"]},
        "T2F": {"tools.mha_phase_bench main": tool_counts["T2F"]},
        "T2B": {"tools.mha_phase_bench main": tool_counts["T2B"]}}
    for form in ("q", "out", "ff1", "ff2"):
        key = f"KG.{form}"
        by_path[key] = {"unet fuse_blocks=False": b1_counts[key],
                        "pipeline, 3 requests": pipe_counts[key],
                        "train, 4 steps": train_counts[key],
                        "judge, 3 requests": judge_counts[key],
                        "generate_videos, 3 clips batched":
                            batched_counts[key],
                        "generate_videos, 3 clips per clip":
                            per_clip_counts[key]}
    kernels = []
    for name, (replaces, tpu, sources) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name
                and r.get("supported", True)]

        def timed(prefix):
            return next(r for r in mine if r["dtype"] == "bfloat16"
                        and r["case"].startswith(prefix))
        main = timed(TIMED_CASE[name])
        err = max(r["max_abs_err"] for r in mine)
        entry = dict(
            name=name, route="cuda", source=sources[0], sources=sources,
            replaces=replaces, tpu=tpu, launches=sum(by_path[name].values()),
            launches_by_path=by_path[name], max_abs_err=err, ms=main["ms"],
            plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
            bound_by=main["bound_by"], library_ms=main["library_ms"],
            timed_case=f"{main['case']} bf16")
        if "matmul_ms" in main:          # K-gemm, B7: the product yardstick
            entry["matmul_ms"] = main["matmul_ms"]
            if "tflops" in main:
                entry["tflops"] = main["tflops"]
        if "loader" in main:             # B7: the loader of A, graph times
            entry.update(loader=main["loader"], graph_ms=main["graph_ms"],
                         loader_ms=main["loader_ms"])
        if "production_ms" in main:      # the tools' kernels: every variant
            entry["production_ms"] = main["production_ms"]
            entry["ms_by_case"] = {r["case"].strip(): r["ms"] for r in mine
                                   if r["dtype"] == "bfloat16"}
        if name in TRAIN_TIMED_CASE:
            train = timed(TRAIN_TIMED_CASE[name])
            entry["train_shape"] = dict(
                timed_case=f"{train['case']} bf16", ms=train["ms"],
                plain_ms=train["plain_ms"], bound_ms=train["bound_ms"],
                bound_by=train["bound_by"])
            if "matmul_ms" in train:
                entry["train_shape"].update(matmul_ms=train["matmul_ms"],
                                            tflops=train["tflops"])
        kernels.append(entry)
    if any(n <= 0 for paths in by_path.values() for n in paths.values()):
        fail(f"a kernel was not launched on one of its paths: {by_path}")

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
