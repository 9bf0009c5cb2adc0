#!/usr/bin/env python3
"""Drive the PyTorch port (asva_tpu_torch) on one CUDA card.

    python3 chip_smoke.py            # needs one NVIDIA H100 (sm_90a)
    python3 chip_smoke.py --profile  # build + one generation request and one
                                     # training step under torch.profiler
    python3 chip_smoke.py --ranks-only  # build + phases 11 and 12 alone
    python3 chip_smoke.py --remat-only  # build + phase 13 alone
    python3 chip_smoke.py --cards-only  # build + phase 14 alone (4 cards)
    python3 chip_smoke.py --weights-only  # build + phase 15 alone
    python3 chip_smoke.py --rect-only  # build + phase 16 alone

With four visible cards the default run ends with phase 14 (after phases
15 and 16); with fewer it says that phase 14 was not run and why.

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
 10. CLIs     — training and serving from the command-line modules, with
                the data from ChipClips / ChipPairs (in-memory items of
                AudioVideoDataset's and MultiPairAVDataset's keys, dtypes
                and full-size shapes, drawn with numpy from (seed, epoch,
                index): that machine has no libav; where libav exists,
                clips written by the port's writer go through the real
                datasets and the CLIs' main(argv) instead).
                animation_train.train on
                configs/audio-cond_animation/avsync15_audio-cond_cfg.yaml
                (only output_dir, the data paths and checkpointing_steps = 1
                replaced: 256x256, 12 frames, batch 4, accumulation 2, the
                default UNet3DConfig with remat "highres", seeded weights,
                bf16) for 3 steps through the thread DataLoader (8
                workers); then a resume from its checkpoint-2 (kept as a
                milestone) to 3: the step-3 loss and every trainable
                parameter must equal the uninterrupted run's bit for bit
                (cuDNN deterministic), and the loader cursors of
                checkpoint-2 / -3 and after the resume must be 4 / 6 / 6;
                seconds per step (each step ends at the synchronisation
                before its checkpoint), the saves and peak memory beside
                phase 5's.  avsync_train.train at the sizes of
                configs/avsync/vggss_sync_contrast.yaml (21 clips of
                12x224x224, batch 4, test batch 8): 2 steps through the
                process DataLoader with one forked worker a core, one
                evaluate over 2 test batches, a bit-exact checkpoint round
                trip with the loader's state and the classifier export;
                both loaders drained alone, in items a second, beside the
                steps'.  animation_serve.main in a thread at the
                full-width defaults (--port 0 --warmup --warmup_steps 5
                --warmup_clips 3): /healthz must say warm, one /generate
                from phase 9's PNG and wav must answer 500 with
                generate_videos' refusal to write mp4 without libav (and
                /healthz then 0 requests), or 200 with three mp4s where
                libav exists; the server is shut down and its thread
                joined.  avsync_eval.main on the written clips where libav
                exists;
  11. ranks   — training across 2 processes: this script again as each
                rank (--rank-job), with torchrun's variables on a free
                localhost port, joined through maybe_initialize_distributed;
                the ranks of phases 11 and 12 see the first card alone
                (CUDA_VISIBLE_DEVICES) and share it over gloo, on a machine
                of one card or of four; the kernels are already built.
                One pair: process_allgather and
                gather_metric_records against numpy, exactly; an fp32
                micro-step at full width, batch 1 a rank, against one
                process on both rows (gradients within 1e-4 relative L2,
                loss within 1e-5); animation_train.train at phase 10's
                width, batch 4 a rank x accumulation 2, for 3 steps: the
                replicas bit-equal after every step (per-tensor digests
                gathered from both ranks), the step-1 local gradients
                different, only rank 0's checkpoint files, each once, none
                temporary, checkpoint-2 kept as a milestone, one metrics
                record a step, each rank's cursor its own batches; the
                classifier step against one process on all the items: in
                fp32 on 2 items a rank (running statistics within 1e-4
                relative L2; the gradients' distance printed beside that of
                one process from itself with the items' halves swapped,
                about 1e-2: the video tower's BatchNorm backward cancels
                most of its gradient) and in fp64 on 1 item a rank
                (gradients and running statistics within 1e-4);
                avsync_train.train at the VGGSS
                sizes a rank, 2 steps, the replicas and running statistics
                bit-equal after each, and evaluate equal to the ranks'
                batch-weighted mean.  A fresh pair resumes animation_train
                from checkpoint-2 to 3: loss and parameter digests equal
                to the uninterrupted run's.  A rank that fails or hangs
                kills both and fails the phase with its output's end.
  12. meshes  — generation and FSDP training across 2 processes (the same
                rank mechanism).  One process first makes the references:
                each case's fp32 videos and latents through the kernels and
                the latents of the plain sub-layers in fp32 and bf16.  One
                pair runs the pipeline on make_gen_mesh at data 2 (two
                full-width requests, a clip a rank) and at seq 2 (one clip,
                6 of its 12 frames a rank), DDIM 5, audio guidance 4.0, in
                bf16 and fp32: a warm-up call, a timed call (B2 and B3 must
                be 80 a rank, one process's count), a call with the frame
                exchanges timed (count, seconds, bytes); the gathered
                results must be equal on both ranks, the fp32 videos within
                one uint8 level of one process, the fp32 latents within
                1e-4 * max(1, max|ref|), the bf16 latents within 1.5x the
                plain bf16 version's relative RMS from the fp32 plain ones.
                A pair runs animation_train.train at fsdp 2 for 3 steps at
                phase 11's sizes, writing checkpoint-2 alone (rank 0): the
                losses within 1e-6 relative of phase 11's (bit equality
                printed), each step's gathers and reduce-scatters (count,
                seconds, bytes) and each step's and save's peak memory.  A
                fresh pair resumes from that checkpoint-2 at fsdp 2, then at
                fsdp 1: each step-3 loss within 1e-6 relative of the
                uninterrupted run's.
 13. remat    — asva_tpu's six remat policies (full, highres, l0, saveconv,
                saveconv0, dots; then full again) on phase 5's full-width
                set-up (batch 4, bf16, cuDNN deterministic): from the same
                weights and batch, one gradient step (not applied) whose
                convolutions a dispatch mode counts, then 2 AdamW steps,
                timed, with their peak memory and each step's launches.
                Losses and both steps' gradients (by bit
                digest) must equal the first full run's, the repeat's too;
                under saveconv B4 must run once per attention sub-layer a
                step and the convolutions must be those of one forward
                without a graph (no tagged conv runs again).
 14. cards    — phases 11 and 12's meshes on 4 cards, one a rank over NCCL
                (4 rank processes with LOCAL_WORLD_SIZE 4, each seeing every
                card: multihost.local_layout gives rank r NCCL and cuda:r,
                the group bound to its card; each rank logs its backend,
                device and NCCL version).  One process's references first,
                on cuda:0, as phase 12's.  One group generates at data 4
                (four requests, a clip a rank), seq 4 (one clip, 3 of its
                12 frames a rank: ranks 1 and 2 take a halo and hand one
                on) and data 2 x seq 2 (two clips, 6 frames a rank), bf16
                and fp32, under phase 12's gates.  One group runs
                animation_train.train for 3 steps at data 4, at fsdp 4 and
                at data 2 x fsdp 2 (batch 4 a rank x accumulation 2, 24
                ChipClips a rank), each writing checkpoint-2 alone (rank
                0): the replicas bit-equal after every step (a split
                parameter's block on the ranks of its fsdp index), the FSDP
                losses within 1e-6 relative of data 4's (bit equality
                printed), seconds per step (saves excluded), peak per rank,
                the gradient all-reduce's (or the gathers' and
                reduce-scatters') count, seconds and bytes a step; then
                the classifier step in fp64, 1 item a rank, against one
                process on the 4 (gradients and running statistics within
                1e-4 relative L2), and avsync_train.train + evaluate at data
                4; first, the host gathers of phase 11 over the gloo host
                group that multihost makes beside NCCL.  A fresh group resumes fsdp 4's checkpoint-2 at fsdp 4
                and at fsdp 1: each step-3 loss within 1e-6 relative of the
                uninterrupted run's.
 15. weights  — the real-weights path at full size from files:
                asva_tpu_torch.tools.fabricate writes every published
                artifact (SD1.5 UNet 2D part, VAE and text encoder, a
                trained AVSyncD checkpoint, imagebind_huge.pth, the FID and
                I3D blobs (TorchScript, BatchNorm eps 1e-3), the classifier,
                AVID-CMA, the null text encoding: about 14 GB of fp32) from
                seeded modules into a temporary directory (bytes and
                seconds printed); tools.validate_weights runs in-process on
                the card: all 13 checks must PASS and the I3D eps read out
                of the blob must be 1e-3.  load_animation_pipeline from the
                checkpoint in bf16 answers phase 4's first request: its
                frames torch.equal to the same request through the seeded
                fp32 modules the files were written from, cast to bf16, and
                B2 = B3 = 80 (each module's load seconds, the time to the
                first clip and the peak printed).  load_animation_pipeline
                from sd_root alone is the 2D graft: every 2D tensor equal to
                the file's, every _temp/_audio one at its seeded init; then
                animation_train.train takes one step on the AVSync15 YAML
                with its pretrained paths at the tree (ChipClips items):
                finite loss, every frozen tensor still the file's (in
                bf16).  animation_eval.build_eval_models with all five
                metric flags and the tree's pretrained root: no random net,
                the blob's eps, and the fp32 features of the request's clip
                (FID, FVD, AVSync score, IA, IT) torch.equal to those of the
                seeded nets the files were written from.
 16. rect     — TheGreatestHits' rectangular configuration (128x256
                frames; configs/audio-cond_animation/
                thegreatesthits_audio-cond_cfg.yaml and
                scripts/animation_test_thegreatesthits.sh) at full width:
                (a) B2 and B3 at every latent level of a request (16x32,
                8x16, 4x8 and the mid block's 2x4: 512, 128, 32 and 8
                tokens; 3 clips under audio CFG, 6 rows of 12 frames) and
                B1, B3, B4 and B5 at every level of a training batch of 16
                (attn1, audio, text), against their plain versions in fp32
                and bf16 under phase 2's gates and gradient checks (phase
                2's cases at these levels and batches), the bf16 rows timed
                beside the SDPA yardstick for B4/B5; (b) the recipe's
                request: generate_videos from a 4:3 PNG and phase 9's wav
                at image_size (128, 256), 3 clips batched, PLMS 50, audio
                guidance 4.0, text guidance 1.0, on seeded full-size
                weights in bf16 and fp32, each also through the plain
                sub-layers: clips (3, 12, 128, 256, 3), B2 = B3 = 16 x the
                UNet calls (51), fp32 within one uint8 level of the plain
                sub-layers, bf16's relative RMS from the plain fp32 video
                within 1.5x the plain bf16 version's, seconds per clip and
                peak memory; (c) animation_train.train on the
                TheGreatestHits YAML itself (only output_dir, the encoding
                path and checkpoints every 2 steps replaced: batch 16 of
                12x128x256, accumulation 1, remat "highres") for 3 steps on
                in-memory items whose text encoding is the one tensor of a
                .pt (class_mapping_json ""), then a resume from its
                checkpoint-2 to 3 equal bit for bit (cuDNN deterministic),
                and an fp32 batch-1 step at 128x256 against the plain
                sub-layers (phase 5's gates); the launches of the 3 + 1
                steps exactly those that the blocks and the remat policy
                give (B1 = B4 = 78, B3 = 26, B5 = 48 a step at full width);
                an out-of-memory error at batch 16 fails; (d)
                evaluate_arrays on the three clips against three seeded
                128x256 clips with phase 6's five nets (phase 9's metric
                step and checks): finite metrics, RelSync and AlignSync in
                [0, 1].
Launch counters are zeroed just before each path run and read just after
(in each rank for phases 11, 12 and 14).

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


def kernel_cases(gen, dtype, levels=SD_LEVELS, b=B, train_b=TRAIN_B, tag="",
                 ff_levels=("32x32", "16x16", "8x8"),
                 b1_levels=(("", ("32x32", "8x8")),
                            ("train ", ("32x32", "8x8")))):
    """(kernel, label, wrapper, args, plain fn, operations) for B1-B3 at
    the shapes the driven paths give them at `levels` ({level: (tokens,
    C)}): generation (b clips; B2 at every level, B3 at `ff_levels`) and
    training (batch train_b; labelled "train"), B1 at the levels that
    `b1_levels` gives each of the two ((label prefix, levels) pairs).
    Labels start with `tag`."""
    from asva_tpu_torch.ops import fused
    cases = []
    for prefix, bb in (("", b), ("train ", train_b)):
        for level in ff_levels:
            n, c = levels[level]
            args = [_rand(gen, (bb * F * n, c), dtype),
                    _rand(gen, (c,), dtype, 0.1, 1.0),
                    _rand(gen, (c,), dtype, 0.1),
                    _rand(gen, (8 * c, c), dtype, c ** -0.5),
                    _rand(gen, (8 * c,), dtype, 0.1),
                    _rand(gen, (c, 4 * c), dtype, (4 * c) ** -0.5),
                    _rand(gen, (c,), dtype, 0.1), 1e-5]
            cases.append(("B3", f"{tag}{prefix}ff {level} C={c} "
                          f"M={bb * F * n}", fused.fused_ln_geglu, args,
                          fused.ln_geglu_plain, 24 * bb * F * n * c * c))
        for level in dict(b1_levels).get(prefix, ()):
            n, c = levels[level]
            for name, g, m, sk in (("attn1", bb, F * n, n),
                                   ("audio", bb * F, n, AUDIO_TOKENS),
                                   ("text", bb, F * n, TEXT_TOKENS)):
                args = ([_rand(gen, (g, m, c), dtype)] + _sub(gen, c, dtype)
                        + [_rand(gen, (g, sk, c), dtype),
                           _rand(gen, (g, sk, c), dtype), 1e-5, HEADS])
                cases.append(("B1", f"{tag}{prefix}{name} {level} C={c} "
                              f"G={g} Sk={sk}", fused.fused_ln_attn, args,
                              fused.ln_attn_plain, _attn_flops(g, m, sk, c)))
    for level, (n, c) in levels.items():
        args = [_rand(gen, (b, F, n, c), dtype)]
        for kv_shape in ((b, n, c), (b, F, AUDIO_TOKENS, c),
                         (b, TEXT_TOKENS, c)):
            args += _sub(gen, c, dtype) + [_rand(gen, kv_shape, dtype),
                                           _rand(gen, kv_shape, dtype)]
        args += [(1e-5,) * 3, HEADS]
        flops = (_attn_flops(b, F * n, n, c)
                 + _attn_flops(b * F, n, AUDIO_TOKENS, c)
                 + _attn_flops(b, F * n, TEXT_TOKENS, c))
        cases.append(("B2", f"{tag}attn3 {level} C={c}", fused.fused_ln_attn3,
                      args, fused.ln_attn3_plain, flops))
    return cases


def flash_cases(gen, dtype, levels=SD_LEVELS, train_b=TRAIN_B, tag=""):
    """(kernel, label, wrapper, args, plain fn, operations) for B4 and B5
    at the training shapes of every level of `levels`: batch train_b of 12
    frames.  Labels start with `tag`."""
    from asva_tpu_torch.ops import fused
    cases = []
    for level, (n, c) in levels.items():
        for name, g, m, sk in (("attn1", train_b, F * n, n),
                               ("audio", train_b * F, n, AUDIO_TOKENS),
                               ("text", train_b, F * n, TEXT_TOKENS)):
            scale = 1.0 / math.sqrt(c // HEADS)
            q, k, v, do = (_rand(gen, shape, dtype) for shape in
                           ((g, m, c), (g, sk, c), (g, sk, c), (g, m, c)))
            o, lse = fused.mha_fwd_plain(q, k, v, HEADS, None, scale)
            dd = fused._head_rowsum(do, o, HEADS)
            del o
            label = f"{tag}{name} {level} G={g} M={m} Sk={sk} d={c // HEADS}"
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


def kernel_row(kernel, label, wrapper, args, plain, flops, rest, dname,
               timed=True):
    """One comparison of phase 2 (and phase 16): the wrapper against its
    plain version on `args`, its bound, where `timed` CUDA-event medians of
    both and the SDPA yardstick for B4-B6 in bf16, and, but for B4/B5, the
    gradient check."""
    import torch
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
               library_ms=None, ms=None, plain_ms=None)
    if timed:
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
    times = (f"  kernel {row['ms']:8.4f} ms  plain {row['plain_ms']:8.3f} ms"
             if timed else "  untimed")
    log(f"  {kernel} {dname:8s} {label:44s} err {err:.3e} (tol "
        f"{tol:.3e}){grad}{times}  bound {row['bound_ms']:.4f} "
        f"ms ({row['bound_by']}){lib}  "
        f"{'ok' if row['ok'] else 'FAIL'}")
    return row


def timed_row(rows, prefix):
    """The bf16 row of `rows` whose case starts with `prefix`."""
    return next(r for r in rows if r["dtype"] == "bfloat16"
                and r["case"].startswith(prefix))


def time_fields(row):
    """A timed row's fields in the kernels line."""
    return dict(timed_case=f"{row['case']} bf16", ms=row["ms"],
                plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], library_ms=row["library_ms"])


def phase_kernels(report):
    import torch
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for make in (kernel_cases, flash_cases, flat_cases):
            for kernel, label, wrapper, args, plain, flops, *rest in make(
                    gen, dtype):
                rows.append(kernel_row(kernel, label, wrapper, args, plain,
                                       flops, rest, dname))
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

def build_trainer(dtype, batch_size, size=(256, 256)):
    """(trainer, state, batch, mask): the full-width training set-up on the
    card, on clips of `size` (h, w) frames.
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
        "videos": torch.rand((batch_size, F) + tuple(size) + (3,),
                             generator=gen, device="cuda"),
        "waveforms": torch.randn((batch_size, 1, 32000), generator=gen,
                                 device="cuda") * 0.1,
        "text_encodings": torch.randn((batch_size, TEXT_TOKENS, 768),
                                      generator=gen, device="cuda")}
    return trainer, state, batch, mask


def _gen(seed):
    import torch
    return torch.Generator(device=DEVICE).manual_seed(seed)


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

def _write_conditioning(tmp, hw=(256, 256)):
    """An hw (h, w) PNG and 6.5 s of stereo 44.1 kHz int16 wav (a little
    more than three 2 s clips: the resampler and the all-channel mean
    run)."""
    import numpy as np
    from PIL import Image
    from scipy.io import wavfile
    rng = np.random.default_rng(900)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w]
    yy, xx = yy / (h - 1.0), xx / (w - 1.0)
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


@contextlib.contextmanager
def _counted_calls(module, calls):
    """Count `module`'s forward calls into calls[0]."""
    handle = module.register_forward_pre_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))
    try:
        yield
    finally:
        handle.remove()


def _request(pipe, plain=False, **kw):
    """generate_videos(pipe, **kw), through the plain sub-layers where
    `plain`: (its clips, the float video before the uint8 cast, seconds,
    the launches counted from 0, the UNet's calls)."""
    from asva_tpu_torch.pipelines.generate import generate_videos
    rec, calls = _Captured(pipe), [0]
    with contextlib.ExitStack() as stack:
        stack.enter_context(_counted_calls(pipe.unet, calls))
        if plain:
            stack.enter_context(plain_sublayers())
        _sync()
        reset_counts()
        t0 = time.perf_counter()
        out = generate_videos(rec, **kw)
        _sync()
        seconds = time.perf_counter() - t0
    return out, rec.video(), seconds, read_counts(), calls[0]


def _judge_frames(frames, waves, seed):
    """The eval harness's metric step (phase 6's models, seeded) on uint8
    frames (clips, F, h, w, 3) with their clips' waveforms, against seeded
    random clips of the same shape as the ground truth: (metrics, seconds
    of evaluate_arrays, every metric finite and in its range)."""
    import numpy as np
    import torch
    from asva_tpu_torch.eval.harness import build_eval_models, evaluate_arrays
    from asva_tpu_torch.ops.mel import waveform_to_mel
    gen = torch.from_numpy(frames.astype(np.float32) / 255.0).to(DEVICE)
    mels = torch.stack([waveform_to_mel(torch.as_tensor(w, device=DEVICE))
                        for w in waves])
    gt = torch.rand(gen.shape, generator=_gen(seed), device=DEVICE)
    models = build_eval_models(DEVICE, torch.float32, seed=0,
                               randomize_all=True)
    t0 = time.perf_counter()
    metrics, per_clip = evaluate_arrays(
        models, [(gt, mels)], [(gen, mels)], ids=[_prompt_ids(seed + 1, 4)[0]],
        device=DEVICE)
    _sync()
    seconds = time.perf_counter() - t0
    del models
    torch.cuda.empty_cache()
    ok = (sorted(metrics) == sorted(
            ["FID", "FVD", "IA_mean", "IA_std", "IT_mean", "IT_std",
             "RelSync_mean", "RelSync_std", "AlignSync_mean",
             "AlignSync_std"])
          and all(math.isfinite(v) for v in metrics.values())
          and all(len(v) == len(frames) and np.isfinite(v).all()
                  and ((v >= 0) & (v <= 1)).all()
                  for k, v in per_clip.items() if k != "IA")
          and abs(metrics["IA_mean"]) <= 1 + 1e-3
          and abs(metrics["IT_mean"]) <= 1 + 1e-3)
    return metrics, seconds, ok


def phase_files(report, pipeline_seconds):
    """generate_videos from a PNG and a wav at full width, both batch_clips
    modes, then the eval harness's metric step on the frames."""
    import numpy as np
    import torch
    from asva_tpu_torch.data import media
    from asva_tpu_torch.pipelines.generate import (generate_videos,
                                                   load_audio_clips_uniformly)
    from asva_tpu_torch.runtime import load_animation_pipeline
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    steps, n_clips = 5, 3
    with tempfile.TemporaryDirectory() as tmp:
        image_path, audio_path = _write_conditioning(tmp)
        text = torch.randn((TEXT_TOKENS, 768), generator=_gen(901),
                           device=DEVICE)
        kw = dict(image_path=image_path, audio_path=audio_path,
                  category_text_encoding=text, image_size=(256, 256),
                  video_fps=6, video_num_frame=F,
                  num_clips_per_video=n_clips, num_inference_steps=steps,
                  sampler="ddim", audio_guidance_scale=4.0,
                  text_guidance_scale=1.0, seed=7, save_template="")
        null_text = torch.randn((1, TEXT_TOKENS, 768), device=DEVICE,
                                generator=_gen(100))
        pipes = {dtype: load_animation_pipeline(
            device=DEVICE, dtype=dtype, seed=0, randomize_all=True,
            null_text_encoding=null_text)
            for dtype in (torch.bfloat16, torch.float32)}
        n_audio, n_blocks = _unet_blocks(pipes[torch.bfloat16].unet)

        runs, seconds, counts = {}, {}, {}
        for dtype, pipe in pipes.items():
            dname = str(dtype).split(".")[-1]
            for batch in (True, False):
                mode = f"{dname} {'batched' if batch else 'per-clip'}"
                out, video, seconds[mode], counts[mode], _ = _request(
                    pipe, batch_clips=batch, **kw)
                runs[mode] = (out, video)
        # the reference for the bf16 gate: the bf16 pipeline through the
        # plain sub-layers, batched
        plain16 = _request(pipes[torch.bfloat16], plain=True,
                           batch_clips=True, **kw)[1]

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
    metrics, metric_s, metrics_ok = _judge_frames(
        frames("bfloat16 batched"), waves, 902)

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


# ------------------------------------------------------------ phase 10 ---

ANIMATION_YAML = "configs/audio-cond_animation/avsync15_audio-cond_cfg.yaml"
TRAIN_ITEMS = 24      # 6 batches of 4: 3 steps of 2 accumulated batches


class ChipClips:
    """AudioVideoDataset's items where the card's machine cannot decode
    video (no libav): its keys, dtypes and full-size shapes (video (f, h,
    w, 3) float32 in [0, 1], waveform (f / fps * 16 kHz,) float32,
    text_encoding (77, 768) float32), drawn with numpy from (seed, epoch,
    index) as the real dataset draws its clip starts."""

    def __init__(self, n, dataset_cfg, seed):
        d = dataset_cfg
        self.n, self.seed, self.epoch = n, seed, 0
        self.shape = (d.video_num_frame,) + tuple(d.img_size) + (3,)
        self.samples = int(d.video_num_frame / d.video_fps * 16000)

    def __len__(self):
        return self.n

    def set_epoch(self, epoch):
        self.epoch = epoch

    def __getitem__(self, index):
        import numpy as np
        rng = np.random.default_rng((self.seed, self.epoch, index))
        return {"video": rng.random(self.shape, dtype=np.float32),
                "waveform": rng.standard_normal(self.samples,
                                                dtype=np.float32) * 0.1,
                "text_encoding": rng.standard_normal((77, 768),
                                                     dtype=np.float32)}


class ChipPairs(ChipClips):
    """MultiPairAVDataset's items, likewise: index, videos (k, f, s, s, 3)
    float32 (CLIP-normalized values: about N(0, 1)), waveforms (k,
    samples) float32."""

    def __init__(self, n, dataset_cfg, seed):
        d = dataset_cfg
        self.n, self.seed, self.epoch = n, seed, 0
        self.shape = (d.num_clips, d.video_num_frames, d.image_size,
                      d.image_size, 3)
        self.samples = (d.num_clips,
                        int(d.video_num_frames / d.video_fps * 16000))

    def __getitem__(self, index):
        import numpy as np
        rng = np.random.default_rng((self.seed, self.epoch, index))
        return {"index": index,
                "videos": rng.standard_normal(self.shape, dtype=np.float32),
                "waveforms": rng.standard_normal(self.samples,
                                                 dtype=np.float32) * 0.1}


def _write_media_tree(root, n_clips, seconds):
    """Clips the real datasets can read (64x64, 12 fps, 16 kHz tone), one
    class with its text encoding; where libav exists."""
    import numpy as np
    from asva_tpu_torch.data import media
    rng = np.random.default_rng(950)
    names = [f"dog/v{i}.mp4" for i in range(n_clips)]
    t = np.arange(int(seconds * 16000)) / 16000
    for i, name in enumerate(names):
        frames = (rng.random((int(seconds * 12), 64, 64, 3)) * 255).astype(
            np.uint8)
        audio = (0.3 * np.sin(2 * np.pi * (200 + 30 * i) * t)).astype(
            np.float32)[None]
        media.write_video(os.path.join(root, name), frames, 12.0, audio,
                          16000)
    with open(os.path.join(root, "list.txt"), "w") as f:
        f.write("\n".join(names))
    with open(os.path.join(root, "mapping.json"), "w") as f:
        json.dump({"dog": "a dog"}, f)
    np.savez(os.path.join(root, "enc.npz"), **{
        "a dog": rng.standard_normal((77, 768)).astype(np.float32)})


def _job_yaml(src, tmp, name, edit):
    """A copy of the repository's YAML `src` with `edit(raw)` applied."""
    import yaml
    with open(os.path.join(ROOT, src)) as f:
        raw = yaml.safe_load(f)
    edit(raw)
    path = os.path.join(tmp, f"{name}.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(raw, f)
    return path


def _animation_yamls(tmp, names):
    """{name: a copy of the AVSync15 YAML writing to <tmp>/<name>, a log
    record a step, a checkpoint every 2 steps kept as a milestone}."""
    def edit(raw, name):
        raw["exp"]["output_dir"] = os.path.join(tmp, name)
        raw["train"]["log_steps"] = 1
        raw["optim"]["checkpointing_steps"] = 2
        raw["optim"]["checkpointing_milestones"] = 2
    return {name: _job_yaml(ANIMATION_YAML, tmp, name,
                            lambda raw, name=name: edit(raw, name))
            for name in names}


@contextlib.contextmanager
def _timed_saves(marks):
    """Record (step, card idle, save done) host times of every checkpoint
    written: the card is synchronised before the save, so a step's time is
    from the previous save's end to its own synchronisation."""
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    orig = CheckpointManager.save

    def save(self, step, *a, **kw):
        _sync()
        synced = time.perf_counter()
        saved = orig(self, step, *a, **kw)
        if saved:
            marks.append((step, synced, time.perf_counter()))
        return saved
    CheckpointManager.save = save
    try:
        yield
    finally:
        CheckpointManager.save = orig


def _step_seconds(marks):
    """Seconds of each step after the first, from checkpoints every step."""
    return [round(b[1] - a[2], 4) for a, b in zip(marks, marks[1:])]


def phase_cli_train(report, media_root, tmp):
    """animation_train at the AVSync15 config's full width: 3 steps, then
    a resume from their checkpoint-2 to 3; the resumed step equals the
    uninterrupted one bit for bit."""
    import shutil

    import torch
    from asva_tpu_torch.config import AnimationJobConfig
    from asva_tpu_torch.scripts import animation_train
    from asva_tpu_torch.training.checkpoint import CheckpointManager

    def run(name, max_steps):
        out_dir = os.path.join(tmp, name)

        def edit(raw):
            raw["exp"]["output_dir"] = out_dir
            d = raw["train"]["dataset"]
            d["data_root"] = media_root or ""
            d["example_list_path"] = os.path.join(media_root or "",
                                                  "list.txt")
            d["class_mapping_json"] = os.path.join(media_root or "",
                                                   "mapping.json")
            d["class_text_encoding_mapping_pt"] = os.path.join(
                media_root or "", "enc.npz")
            raw["optim"]["checkpointing_steps"] = 1
            raw["optim"]["checkpointing_milestones"] = 2
        path = _job_yaml(ANIMATION_YAML, tmp, name, edit)
        cfg = AnimationJobConfig.from_yaml(path)
        if media_root:
            out = animation_train.main(["--config_file", path,
                                        "--max_steps_override",
                                        str(max_steps), "--device", "cuda"])
        else:
            out = animation_train.train(
                cfg, ChipClips(TRAIN_ITEMS, cfg.dataset, cfg.seed), "cuda",
                max_steps)
        torch.cuda.synchronize()
        return cfg, out, CheckpointManager(os.path.join(out_dir, "ckpts"))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    marks = []
    reset_counts()
    t0 = time.perf_counter()
    with _timed_saves(marks):
        cfg, full, mgr = run("uninterrupted", 3)
    full_s = time.perf_counter() - t0
    counts_full = read_counts()
    peak = torch.cuda.max_memory_allocated()
    state = full["state"]
    want = {n: p.detach().clone() for n, p in
            zip(state.optimizer.names, state.optimizer.params)}
    full_losses = full["losses"]
    want_loss, want_loader = full_losses[-1], full["loader"]
    extra3 = mgr.restore_extra(3)
    full_marks = list(marks)
    del full, state
    # the resumed run starts from the uninterrupted run's checkpoint-2
    os.makedirs(os.path.join(tmp, "resumed", "ckpts"))
    os.rename(mgr._path(2), os.path.join(tmp, "resumed", "ckpts",
                                         "checkpoint-2"))
    extra2 = CheckpointManager(os.path.join(
        tmp, "resumed", "ckpts")).restore_extra(2)
    shutil.rmtree(os.path.join(tmp, "uninterrupted"))
    torch.cuda.empty_cache()
    marks.clear()
    reset_counts()
    with _timed_saves(marks):
        _, resumed, _ = run("resumed", 3)
    counts_resumed = read_counts()
    state = resumed["state"]
    same_params = all(torch.equal(p, want[n]) for n, p in
                      zip(state.optimizer.names, state.optimizer.params))
    o = cfg.optim
    out = dict(
        data="media files through main(argv)" if media_root else
        "in-memory ChipClips through train()",
        batch_size=cfg.batch_size, accumulation=o.gradient_accumulation_steps,
        img_size=list(cfg.dataset.img_size),
        frames=cfg.dataset.video_num_frame, losses=full_losses,
        seconds_3_steps=full_s, save_marks=full_marks,
        seconds_per_step=_step_seconds(full_marks),
        save_seconds=[round(m[2] - m[1], 3) for m in full_marks],
        max_memory_allocated=peak, loss_step3=want_loss,
        resumed_loss_step3=resumed["losses"], resumed_from=resumed[
            "resumed_from"], params_equal=same_params,
        cursor_checkpoint2=extra2["loader"], cursor_checkpoint3=extra3[
            "loader"], loader_after_resume=resumed["loader"],
        launches_uninterrupted=counts_full, launches_resumed=counts_resumed,
        phase5_seconds_per_step=report["train"]["seconds_per_step"])
    report["cli_train"] = out
    log(f"  animation_train: {out['data']}; batch {cfg.batch_size} x "
        f"accumulation {o.gradient_accumulation_steps} of {out['frames']} x "
        f"{out['img_size']}; 3 steps in {full_s:.1f} s; seconds per step "
        f"(checkpoint every step, its save excluded) "
        f"{out['seconds_per_step']} beside phase 5's one-batch steps "
        f"{[round(s, 3) for s in out['phase5_seconds_per_step']]}; saves "
        f"{out['save_seconds']} s; max_memory_allocated "
        f"{peak / 2**30:.2f} GiB")
    log(f"  animation_train: step-3 loss {want_loss!r}, resumed from "
        f"checkpoint-{resumed['resumed_from']} {resumed['losses']}; "
        f"trainable parameters equal {same_params}; loader cursor at "
        f"checkpoint-2 {extra2['loader']}, checkpoint-3 {extra3['loader']}, "
        f"after the resume {resumed['loader']}; launches {counts_full} + "
        f"{counts_resumed}")
    accum = o.gradient_accumulation_steps
    if not (resumed["resumed_from"] == 2 and resumed["losses"] == [want_loss]
            and same_params and len(full_losses) == 3
            and all(math.isfinite(x) for x in full_losses)
            and extra2["loader"]["cursor"] == 2 * accum
            and extra3["loader"] == want_loader == resumed["loader"]
            and want_loader["cursor"] == 3 * accum):
        fail(f"animation_train resume: {out}")
    counts = {k: counts_full[k] + counts_resumed[k] for k in counts_full}
    if not (counts["B1"] > 0 and counts["B3"] > 0 and counts["B4"] > 0
            and counts["B5"] > 0 and counts["B2"] == 0 and counts["B6"] == 0
            and all(counts[f"KG.{f}"] > 0 for f, *_ in GEMM_FORMS)):
        fail(f"animation_train launches: {counts}")
    del resumed, state, want
    torch.cuda.empty_cache()
    return counts


def _drain(ds, batch_size, mode, workers):
    """Items a second through a loader whose batches nobody uses: the
    whole epoch (pool start included) and after the first batch."""
    from asva_tpu_torch.data.loader import DataLoader
    dl = DataLoader(ds, batch_size, shuffle=True, num_workers=workers,
                    worker_mode=mode)
    try:
        t0 = time.perf_counter()
        stamps = [time.perf_counter() for _ in dl]
    finally:
        dl.close()
    n = len(stamps) * batch_size
    return dict(mode=mode, workers=workers, items=n,
                items_per_s=n / (stamps[-1] - t0),
                items_per_s_after_first=(n - batch_size) / (
                    stamps[-1] - stamps[0]))


def phase_cli_sync(report, media_root, tmp):
    """avsync_train at the VGGSS config's sizes: 2 steps through the process
    loader, one evaluate over 2 test batches, a checkpoint round trip with
    the loader's state; the loaders drained alone."""
    import logging

    import torch
    from asva_tpu_torch.config import SyncJobConfig
    from asva_tpu_torch.data.loader import DataLoader
    from asva_tpu_torch.runtime import build_avsync_classifier
    from asva_tpu_torch.scripts import avsync_train
    from asva_tpu_torch.training import SyncTrainState, build_optimizer
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    out_dir = os.path.join(tmp, "sync")

    def edit(raw):
        raw["exp"]["output_dir"] = out_dir
        for part in ("train", "test"):
            d = raw[part]["dataset"]
            d["data_root"] = media_root or ""
            d["example_list_path"] = os.path.join(media_root or "",
                                                  "list.txt")
    path = _job_yaml(SYNC_YAML, tmp, "sync", edit)
    cfg = SyncJobConfig.from_yaml(path)
    b, tb = cfg.batch_size, cfg.test_batch_size
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if media_root:
        res = avsync_train.main(["--config_file", path, "--max_steps_override",
                                 "2", "--device", "cuda"])
        train_ds = avsync_train.build_dataset(cfg, cfg.train_dataset,
                                              "train")
    else:
        train_ds = ChipPairs(2 * b, cfg.train_dataset, cfg.seed)
        res = avsync_train.train(cfg, train_ds,
                                 ChipPairs(2 * tb, cfg.test_dataset,
                                           cfg.seed), "cuda", 2)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    state = res["state"]
    t0 = time.perf_counter()
    mean = avsync_train.evaluate(res["trainer"], res["test_loader"], "cuda",
                                 logging.getLogger("chip_smoke"), step=2,
                                 max_batches=2)
    eval_s = time.perf_counter() - t0

    mgr = CheckpointManager(os.path.join(out_dir, "ckpts"))
    step, saved = mgr.restore_latest("cuda")
    clf = build_avsync_classifier(device="cuda", seed=1, train=True)
    back = SyncTrainState(0, clf, build_optimizer(clf))
    back.load_state_dict(saved)
    del saved
    loader = DataLoader(train_ds, b, shuffle=True, seed=cfg.seed,
                        worker_mode="process")
    loader.load_state_dict(mgr.restore_extra(step)["loader"])
    exported = build_avsync_classifier(
        os.path.join(mgr.modules_dir(step), "classifier"), device="cuda")
    want = state.classifier.state_dict()
    exact = (all(torch.equal(v, want[k])
                 for k, v in back.classifier.state_dict().items())
             and all(torch.equal(v, want[k])
                     for k, v in exported.state_dict().items())
             and all(torch.equal(a, c) for kind in ("mu", "nu")
                     for a, c in zip(getattr(back.optimizer, kind),
                                     getattr(state.optimizer, kind)))
             and back.step == state.step == step == 2)
    loader_back = loader.state_dict() == res["loader"] == dict(
        epoch=0, cursor=2, seed=cfg.seed)
    step_s = [round(y - x, 4) for x, y in zip(res["step_times"],
                                              res["step_times"][1:])]

    # the parts of a CLI step, each synchronised, on one batch of the same
    # items: collation into pinned memory (the loader's copy), the copy to
    # the card, 84 mels on the card, the trainer's step with its metrics
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        value = fn()
        torch.cuda.synchronize()
        return value, round(time.perf_counter() - t, 4)
    from asva_tpu_torch.data.loader import _collate
    from asva_tpu_torch.parallel.multihost import make_global_batch
    batch, collate_s = timed(lambda: _collate([train_ds[i]
                                               for i in range(b)]))
    dev, h2d_s = timed(lambda: make_global_batch(
        {"waveforms": batch["waveforms"], "videos": batch["videos"]},
        "cuda"))
    mels, mel_s = timed(lambda: avsync_train.mels_of(dev["waveforms"]))
    _, trainer_s = timed(lambda: {k: float(v) for k, v in res[
        "trainer"].train_step(state, {"mels": mels,
                                      "videos": dev["videos"]}).items()})
    parts = dict(items_and_collate=collate_s, to_card=h2d_s, mels=mel_s,
                 train_step=trainer_s)
    del batch, dev, mels
    pairs = train_ds if media_root else ChipPairs(4 * b, cfg.train_dataset,
                                                  cfg.seed)
    drains = [_drain(pairs, b, "process", os.cpu_count() or 8),
              _drain(pairs, b, "thread", 8)]
    clips = ChipClips(TRAIN_ITEMS, _animation_dataset_cfg(), 0)
    drains.append(_drain(clips, 4, "thread", 8))
    out = dict(
        data="media files through main(argv)" if media_root else
        "in-memory ChipPairs through train()",
        batch_size=b, clips_per_step=b * cfg.train_dataset.num_clips,
        seconds_2_steps=train_s, seconds_after_first_step=step_s,
        step_items_per_s=[b / s for s in step_s], metrics=res["metrics"],
        evaluate=mean, evaluate_seconds=eval_s, checkpoint_step=step,
        checkpoint_bit_exact=exact, loader_state_restored=loader_back,
        drains=drains, step_parts=parts,
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        phase8_seconds_per_step=report["sync"]["seconds_per_step"])
    report["cli_sync"] = out
    log(f"  avsync_train: {out['data']}; batch {b} ({out['clips_per_step']} "
        f"clips a step) through {os.cpu_count()} forked workers; 2 steps in "
        f"{train_s:.1f} s (pool start included), the second "
        f"{step_s} s = {[round(x, 2) for x in out['step_items_per_s']]} "
        f"items/s beside phase 8's "
        f"{[round(s, 3) for s in out['phase8_seconds_per_step']]} s a step; "
        f"evaluate over 2 test batches of {tb} in {eval_s:.1f} s: {mean}; "
        f"the parts of a step on one batch (s): {parts}")
    log(f"  avsync_train: checkpoint-{step} round trip bit-exact {exact}, "
        f"loader state {res['loader']} restored {loader_back}; loaders "
        f"drained alone (items/s): " + "; ".join(
            f"{d['mode']} x{d['workers']} {d['items_per_s']:.2f} "
            f"({d['items_per_s_after_first']:.2f} after the first batch)"
            for d in drains))
    if not (exact and loader_back and len(res["metrics"]) == 2
            and all(math.isfinite(v) for m in res["metrics"]
                    for v in m.values())
            and all(math.isfinite(v) for v in mean.values())):
        fail(f"avsync_train: {out}")
    del res, state, back, clf, exported
    torch.cuda.empty_cache()
    return os.path.join(mgr.modules_dir(step), "classifier")


def _animation_dataset_cfg():
    from asva_tpu_torch.config import AnimationJobConfig
    return AnimationJobConfig.from_yaml(
        os.path.join(ROOT, ANIMATION_YAML)).dataset


def _http(port, method, path, body=None, timeout=600):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, json.dumps(body) if body else None,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


class _Lines:
    """sys.stdout for the server's thread: writes through, keeps lines."""

    def __init__(self, out):
        self.out, self.text = out, ""

    def write(self, s):
        self.text += s
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def phase_cli_serve(report, media_available, tmp):
    """animation_serve at the full-width defaults in a thread: warmup,
    /healthz, one /generate, shutdown."""
    import threading

    import torch
    from asva_tpu_torch.scripts import animation_serve
    servers, errors = [], []

    def serve():
        try:
            animation_serve.main([
                "--port", "0", "--warmup", "--warmup_steps", "5",
                "--warmup_clips", "3", "--sd_root", "",
                "--null_text_encoding_path", "", "--max_requests", "1",
                "--device", "cuda"], on_listen=servers.append)
        except BaseException as e:   # re-raised below, in the main thread
            errors.append(e)
            raise
    lines = _Lines(sys.stdout)
    saved_stdout, sys.stdout = sys.stdout, lines
    torch.cuda.synchronize()
    reset_counts()
    thread = threading.Thread(target=serve, daemon=True)
    try:
        thread.start()
        deadline = time.time() + 600
        while not servers and thread.is_alive() and time.time() < deadline:
            time.sleep(0.1)
    finally:
        sys.stdout = saved_stdout
    counts = read_counts()
    if errors or not servers:
        fail(f"animation_serve did not start: {errors or 'timeout'}")
    server = servers[0]
    port = server.server_address[1]
    warm_line = next(ln for ln in lines.text.splitlines()
                     if ln.startswith("[serve] warmup"))
    warm_s = float(warm_line.split()[2].rstrip("s"))
    health = _http(port, "GET", "/healthz")
    image_path, audio_path = _write_conditioning(tmp)
    status, reply = _http(port, "POST", "/generate", dict(
        image_path=image_path, audio_path=audio_path, num_clips=3,
        num_inference_steps=5, save_template=os.path.join(tmp, "serve",
                                                          "gen")))
    if media_available:
        # the one successful request ends the server (--max_requests 1)
        answered = status == 200 and len(reply["outputs"]) == 3 and all(
            os.path.isfile(p) for p in reply["outputs"])
        after = None
    else:
        # a failed request does not count: the server answers on
        answered = status == 500 and "save_template" in reply["error"]
        after = _http(port, "GET", "/healthz")
        answered = answered and after == (200, {"ok": True, "requests": 0,
                                                "warm": True})
        server.shutdown()
    thread.join(timeout=60)
    out = dict(port=port, healthz=health, generate_status=status,
               generate_reply=reply, healthz_after=after,
               warmup_seconds=warm_s, warmup_seconds_per_clip=warm_s / 3,
               pipeline_seconds_per_clip=report["pipeline"][
                   "seconds_per_clip"], launches_warmup=counts,
               stopped=not thread.is_alive())
    report["cli_serve"] = out
    log(f"  animation_serve: port {port}; warmup {warm_s:.1f} s for 3 clips "
        f"(PLMS 5 steps, one UNet batch of 6) = {warm_s / 3:.3f} s a clip "
        f"beside phase 4's "
        f"{[round(s, 3) for s in out['pipeline_seconds_per_clip']]} (DDIM 5, "
        f"one clip); /healthz {health}; /generate {status} {reply}; "
        f"/healthz after {after}; launches in the warmup {counts}; stopped "
        f"{out['stopped']}")
    if not (health == (200, {"ok": True, "requests": 0, "warm": True})
            and answered and out["stopped"] and not errors
            and counts["B2"] > 0 and counts["B3"] > 0 and counts["B1"] == 0
            and counts["B4"] == 0 and counts["B6"] == 0
            and all(counts[f"KG.{f}"] > 0 for f, *_ in GEMM_FORMS)):
        fail(f"animation_serve: {out}")
    return counts


def phase_cli_eval(report, media_root, classifier_export, tmp):
    """avsync_eval on the written clips with part 2's classifier, split
    into the per-module files the CLI reads (only where libav exists)."""
    import torch
    from asva_tpu_torch.scripts import avsync_eval
    state = torch.load(classifier_export + ".pt", map_location="cpu",
                       weights_only=True)
    mods = os.path.join(tmp, "eval_modules")
    os.makedirs(mods)
    for name in ("audio_encoder", "video_encoder", "head"):
        torch.save({k[len(name) + 1:]: v for k, v in state.items()
                    if k.startswith(name + ".")},
                   os.path.join(mods, f"{name}.pt"))
    res = avsync_eval.main(["--data_root", media_root, "--example_list_path",
                            os.path.join(media_root, "list.txt"),
                            "--checkpoint_modules_dir", mods,
                            "--max_examples", "4", "--device", "cuda"])
    report["cli_eval"] = dict(a2v=res["a2v"], v2a=res["v2a"],
                              examples=len(res["indices"]))
    log(f"  avsync_eval: {report['cli_eval']}")
    if not (len(res["indices"]) == 4 and 0 <= res["a2v"] <= 1
            and 0 <= res["v2a"] <= 1):
        fail(f"avsync_eval: {report['cli_eval']}")


def phase_cli(report):
    """Phase 10: the train, sync-train and serve CLIs at full width (and
    avsync_eval where libav exists).  Returns (training launches, serve
    warmup launches)."""
    import torch
    from asva_tpu_torch.data import media
    has_media = media.media_available()
    # the training YAML logs with wandb: never let a run reach for a network
    os.environ["WANDB_MODE"] = "disabled"
    # every check below compares runs bit for bit: no nondeterministic
    # cuDNN algorithm (as phase 8's repeated fp32 step)
    cudnn_was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    with tempfile.TemporaryDirectory() as tmp:
        media_root = None
        if has_media:
            media_root = os.path.join(tmp, "media")
            _write_media_tree(media_root, TRAIN_ITEMS, 7.0)
        log("  data source: " + (
            f"{TRAIN_ITEMS} clips written with the port's writer, read by "
            "AudioVideoDataset / MultiPairAVDataset through the CLIs' main"
            if has_media else
            "in-memory ChipClips / ChipPairs items (no libav on this "
            "machine), through the CLIs' train()"))
        train_counts = phase_cli_train(report, media_root, tmp)
        export = phase_cli_sync(report, media_root, tmp)
        serve_counts = phase_cli_serve(report, has_media, tmp)
        if has_media:
            phase_cli_eval(report, media_root, export, tmp)
    torch.backends.cudnn.deterministic = cudnn_was
    return train_counts, serve_counts


# ------------------------------------------------------------ phase 11 ---

RANKS = 2
RANK_FLAG = "--rank-job"
RANK_COMMAND = [sys.executable, os.path.abspath(__file__)]
RANKS_TIMEOUT_S = 600
DEVICE = "cuda"
RANK_ITEMS = 48       # ChipClips: 24 a rank, 6 batches of 4 an epoch
SYNC_REDUCED_B = 2    # items a rank in the fp32 classifier comparison


def _sync():
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def _peak():
    import torch
    return torch.cuda.max_memory_allocated() if torch.cuda.is_available() \
        else None


def _digest(tensors):
    """(n, 2) int64: each tensor's sum of its bit patterns and their
    position-weighted sum (wrapping); bit-equal tensors give equal rows,
    and one changed bit changes both."""
    import torch
    ints = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    rows = []
    with torch.no_grad():
        for t in tensors:
            bits = t.detach().contiguous().view(
                ints[t.element_size()]).reshape(-1).long()
            w = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
            rows.append(torch.stack([bits.sum(), (bits * w).sum()]))
        return torch.stack(rows).cpu().numpy()


def _gathered_digests(tensors):
    """Every rank's digests of its `tensors`, (ranks, n, 2)."""
    from asva_tpu_torch.parallel import multihost
    return multihost.process_allgather(_digest(tensors), tiled=False)


def _same(gathered) -> bool:
    return bool((gathered == gathered[0]).all())


def _rel_l2(got, want) -> float:
    num = sum(float((a.double() - b.double()).square().sum())
              for a, b in zip(got, want))
    den = sum(float(b.double().square().sum()) for b in want)
    return math.sqrt(num / den)


def rank_gathers(mesh, spec, tmp):
    """process_allgather tiled and stacked; gather_metric_records with
    ragged counts, an index on several ranks and, second, empty ranks with
    value_shape; each against the numpy answer, exactly (2 or 4 ranks)."""
    import numpy as np
    from asva_tpu_torch.parallel import multihost
    parts = [np.arange(6, dtype=np.float64).reshape(2, 3) + 100 * r
             for r in range(mesh.world)]
    tiled = multihost.process_allgather(parts[mesh.rank])
    stacked = multihost.process_allgather(parts[mesh.rank], tiled=False)
    records = [([5, 1, 3], [[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]),
               ([3, 7], [[0.0, 0.0], [1.0, 0.0]]),
               ([7, 2], [[2.0, 0.0], [0.0, 2.0]]),
               ([9], [[3.0, 3.0]])][:mesh.world]
    empty = [([4, 2], [[1.0, 1.0], [0.0, 1.0]]), ([], []),
             ([8, 4], [[1.0, 2.0], [2.0, 1.0]]), ([], [])][:mesh.world]
    got = [multihost.gather_metric_records(*records[mesh.rank]),
           multihost.gather_metric_records(*empty[mesh.rank],
                                           value_shape=(2,))]
    want = []
    for recs in (records, empty):
        idx = np.concatenate([np.asarray(i, np.int64) for i, _ in recs])
        vals = np.concatenate([np.asarray(v, np.float64).reshape(-1, 2)
                               for _, v in recs])
        uniq, first = np.unique(idx, return_index=True)
        want.append((uniq, vals[first]))
    exact = (np.array_equal(tiled, np.concatenate(parts))
             and np.array_equal(stacked, np.stack(parts))
             and all(np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
                     for g, w in zip(got, want)))
    return dict(exact=exact, records=[g[0].tolist() for g in got],
                values=[g[1].tolist() for g in got])


def rank_fp32_step(mesh, spec, tmp):
    """One fp32 micro-step at full width, batch 1 a rank, its gradients'
    mean; rank 0 then takes the step of one process on both rows with the
    same draws (no collective) and compares."""
    import torch
    from asva_tpu_torch.parallel import multihost
    from asva_tpu_torch.parallel.reduce import all_reduce_mean_
    trainer, state, batch, _ = build_trainer(torch.float32, mesh.world)
    mine = {k: v[mesh.rank:mesh.rank + 1] for k, v in batch.items()}
    loss, grads = trainer.grad_step(state, mine, _gen(600), mesh=mesh)
    local = _gathered_digests(grads)
    all_reduce_mean_(grads, mesh)
    loss = loss.reshape(1).clone()
    all_reduce_mean_([loss], mesh)
    out = dict(local_grads_differ=not _same(local),
               reduced_grads_equal=_same(_gathered_digests(grads)),
               loss_two_ranks=float(loss))
    if mesh.rank == 0:
        loss1, grads1 = trainer.grad_step(state, batch, _gen(600))
        out.update(loss_one_process=float(loss1),
                   grad_rel_l2=_rel_l2(grads, grads1))
        del grads1
    multihost.barrier()
    del trainer, state, batch, grads
    return out


def _step_seconds_of(steps, marks):
    """Seconds of each step after the first: from the later of the
    previous step's end (its digests gathered) and its save's end to the
    synchronisation after this step's optimizer."""
    saved = {m[0]: m[2] for m in marks}
    return [round(b["t_end"] - max(a["t_ready"], saved.get(a["step"], 0.0)),
                  4) for a, b in zip(steps, steps[1:])]


def rank_animation(mesh, spec, tmp):
    """animation_train.train on this rank's shard of ChipClips: after every
    step the replicas' digests, before the first the local gradients', the
    all-reduce's seconds and bytes, the files this rank wrote, the batches
    it took, and its launches."""
    import hashlib

    from asva_tpu_torch.config import AnimationJobConfig
    from asva_tpu_torch.parallel import multihost
    from asva_tpu_torch.scripts import animation_train
    from asva_tpu_torch.training import animation_trainer, checkpoint
    name = spec["run"]
    cfg = AnimationJobConfig.from_yaml(spec[name])
    steps, reduces, written, batches, first = [], [], [], [0], {}
    trainer_cls = animation_trainer.AnimationTrainer
    orig = (trainer_cls.apply_step, trainer_cls.grad_step,
            animation_trainer.all_reduce_mean_, checkpoint._write_atomic)

    def grad_step(self, *a, **kw):
        batches[0] += 1
        return orig[1](self, *a, **kw)

    def all_reduce_mean_(tensors, m):
        tensors = list(tensors)
        _sync()
        multihost.barrier()
        t0 = time.perf_counter()
        nbytes = orig[2](tensors, m)
        _sync()
        reduces.append((time.perf_counter() - t0, nbytes))
        return nbytes

    def apply_step(self, state, grads, mesh=None):
        if not first:
            first["local_grads_differ"] = not _same(_gathered_digests(grads))
        orig[0](self, state, grads, mesh)
        _sync()
        t_end = time.perf_counter()
        digests = _gathered_digests(state.optimizer.params)
        steps.append(dict(step=state.step, t_end=t_end,
                          replicas_equal=_same(digests),
                          digest=hashlib.sha256(digests[0].tobytes())
                          .hexdigest(), t_ready=time.perf_counter()))

    def write(path, fn):
        written.append(os.path.relpath(path, cfg.output_dir))
        orig[3](path, fn)
    trainer_cls.apply_step, trainer_cls.grad_step = apply_step, grad_step
    animation_trainer.all_reduce_mean_ = all_reduce_mean_
    checkpoint._write_atomic = write
    marks = []
    try:
        reset_counts()
        with _timed_saves(marks):
            res = animation_train.train(
                cfg, ChipClips(RANK_ITEMS, cfg.dataset, cfg.seed), DEVICE, 3)
        counts = read_counts()
    finally:
        (trainer_cls.apply_step, trainer_cls.grad_step,
         animation_trainer.all_reduce_mean_, checkpoint._write_atomic) = orig
    out = dict(run=name, losses=res["losses"], step=res["state"].step,
               resumed_from=res["resumed_from"], loader=res["loader"],
               batches=batches[0], steps=steps, written=written,
               seconds_per_step=_step_seconds_of(steps, marks),
               save_seconds=[round(m[2] - m[1], 3) for m in marks],
               allreduce_seconds=[round(t, 4) for t, _ in reduces],
               allreduce_bytes=[n for _, n in reduces], launches=counts,
               **first)
    del res
    return out


def _classifier_step(mesh, cfg, batch, rows, step_mesh, dtype, group=None):
    """One classifier step in `dtype` on `batch`'s `rows`: (the gradients
    the optimizer took, the running statistics after the step).  `group`:
    every BatchNorm's process group (a group of one normalises by its own
    batch)."""
    import torch
    from asva_tpu_torch.models.avsync.classifier import (
        _BiasedVarianceBatchNorm)
    from asva_tpu_torch.runtime import build_avsync_classifier
    from asva_tpu_torch.scripts.avsync_train import mels_of
    from asva_tpu_torch.training import (SyncContrastiveTrainer,
                                         SyncTrainState, build_optimizer)
    clf = build_avsync_classifier(device=mesh.device, seed=cfg.seed,
                                  train=True).to(dtype)
    if group is not None:
        for module in clf.modules():
            if isinstance(module, _BiasedVarianceBatchNorm):
                module.process_group = group
    state = SyncTrainState(0, clf, build_optimizer(
        clf, cfg.optim.learning_rate))
    taken = []
    opt_step = state.optimizer.step

    def record(grads):
        taken.extend(g.detach().clone() for g in grads)
        return opt_step(grads)
    state.optimizer.step = record
    wav = torch.as_tensor(batch["waveforms"][rows]).to(mesh.device, dtype)
    vid = torch.as_tensor(batch["videos"][rows]).to(mesh.device, dtype)
    SyncContrastiveTrainer(clf, tau=cfg.tau).train_step(
        state, {"mels": mels_of(wav), "videos": vid}, step_mesh)
    stats = [b.detach().clone() for n, b in clf.named_buffers()
             if "running" in n]
    return taken, stats


def rank_sync_steps(mesh, spec, tmp):
    """The classifier step across the ranks (global BatchNorm statistics,
    the gradients' mean) against one process on all the items, on rank 0
    (its BatchNorms in a group of one): in fp32 on SYNC_REDUCED_B items a
    rank, beside the distance of one process from itself with the ranks'
    halves swapped (the same function summed in another order), and in
    fp64 on one item a rank.  fp32 cannot hold the gradients closer than
    that floor: the training-mode BatchNorm backward of the video tower
    cancels most of the gradient it receives, and rounding is what is
    left.  The spec's "sync_dtypes" may keep one of the two (phase 14:
    fp64 alone)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from asva_tpu_torch.config import SyncJobConfig
    from asva_tpu_torch.data.loader import _collate
    from asva_tpu_torch.parallel import multihost
    cfg = SyncJobConfig.from_yaml(spec["sync"])
    runs = [(dtype, per_rank) for dtype, per_rank in (
        (torch.float32, SYNC_REDUCED_B), (torch.float64, 1))
        if str(dtype).split(".")[-1] in spec.get("sync_dtypes",
                                                 ("float32", "float64"))]
    n = max(per_rank for _, per_rank in runs) * mesh.world
    items = ChipPairs(n, cfg.train_dataset, cfg.seed)
    batch = _collate([items[i] for i in range(n)])
    batch = {k: np.asarray(batch[k], np.float64)
             for k in ("waveforms", "videos")}
    solo = dist.new_group([0])
    out = {}
    for dtype, per_rank in runs:
        rows = slice(mesh.rank * per_rank, (mesh.rank + 1) * per_rank)
        grads, stats = _classifier_step(mesh, cfg, batch, rows, mesh, dtype)
        res = dict(items_per_rank=per_rank,
                   grads_equal=_same(_gathered_digests(grads)),
                   stats_equal=_same(_gathered_digests(stats)))
        if mesh.rank == 0:
            both = slice(0, per_rank * mesh.world)
            grads1, stats1 = _classifier_step(mesh, cfg, batch, both, None,
                                              dtype, solo)
            res.update(grad_rel_l2=_rel_l2(grads, grads1),
                       stats_rel_l2=_rel_l2(stats, stats1))
            if dtype == torch.float32:
                swapped = list(range(per_rank, 2 * per_rank)) + list(
                    range(per_rank))
                grads2, stats2 = _classifier_step(mesh, cfg, batch, swapped,
                                                  None, dtype, solo)
                res.update(grad_rel_l2_order_swapped=_rel_l2(grads2, grads1),
                           stats_rel_l2_order_swapped=_rel_l2(stats2, stats1))
                del grads2, stats2
            del grads1, stats1
        del grads, stats
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        multihost.barrier()
        out[str(dtype).split(".")[-1]] = res
    return out


def rank_sync(mesh, spec, tmp):
    """avsync_train.train on this rank's shard of ChipPairs (the VGGSS
    sizes a rank) for 2 steps, the replicas' digests (parameters and
    running statistics) after each; then evaluate over one test batch a
    rank, whose mean must be the batch-weighted mean of every rank's
    metrics."""
    import logging

    import numpy as np
    from asva_tpu_torch.config import SyncJobConfig
    from asva_tpu_torch.parallel import multihost
    from asva_tpu_torch.scripts import avsync_train
    from asva_tpu_torch.training import sync_trainer
    cfg = SyncJobConfig.from_yaml(spec["sync"])
    b, tb = cfg.batch_size, cfg.test_batch_size
    cls = sync_trainer.SyncContrastiveTrainer
    orig = (cls.train_step, cls.eval_metrics)
    replicas, evals = [], []

    def train_step(self, state, batch, mesh=None):
        metrics = orig[0](self, state, batch, mesh)
        clf = state.classifier
        tensors = list(clf.parameters()) + [
            buf for n, buf in clf.named_buffers() if "running" in n]
        replicas.append(_same(_gathered_digests(tensors)))
        return metrics

    def eval_metrics(self, batch):
        metrics = orig[1](self, batch)
        evals.append(({k: float(v) for k, v in metrics.items()},
                      len(batch["videos"])))
        return metrics
    cls.train_step, cls.eval_metrics = train_step, eval_metrics
    try:
        res = avsync_train.train(
            cfg, ChipPairs(2 * b * mesh.world, cfg.train_dataset, cfg.seed),
            ChipPairs(tb * mesh.world, cfg.test_dataset, cfg.seed), DEVICE,
            2)
        evals.clear()
        mean = avsync_train.evaluate(res["trainer"], res["test_loader"],
                                     mesh.device,
                                     logging.getLogger("chip_smoke"), step=2,
                                     max_batches=1)
    finally:
        cls.train_step, cls.eval_metrics = orig
    names = sorted(mean)
    local = [sum(m[k] * n for m, n in evals) for k in names]
    totals = multihost.process_allgather(
        np.array([local + [float(sum(n for _, n in evals))]])).sum(axis=0)
    want = dict(zip(names, (totals[:-1] / totals[-1]).tolist()))
    step_s = [round(y - x, 4) for x, y in zip(res["step_times"],
                                              res["step_times"][1:])]
    out = dict(replicas_equal=replicas, metrics=res["metrics"],
               evaluate=mean, evaluate_want=want, evaluated=len(evals),
               evaluate_matches=all(abs(mean[k] - want[k])
                                    <= 1e-12 * max(1.0, abs(want[k]))
                                    for k in names),
               seconds_after_first_step=step_s, loader=res["loader"])
    del res
    return out


RANK_JOBS = {"train": (("gathers", rank_gathers), ("fp32", rank_fp32_step),
                       ("animation", rank_animation),
                       ("sync_steps", rank_sync_steps), ("sync", rank_sync)),
             "resume": (("animation", rank_animation),)}
# the animation run a job's rank_animation part reads from the spec
RANK_RUNS = {"train": "uninterrupted", "resume": "resumed"}


def rank_worker(job, tmp) -> int:
    """One rank of phase 11 or 12: join the group through
    maybe_initialize_distributed, run the job's parts, write
    <tmp>/<job>.<rank>.json."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from asva_tpu_torch.parallel import make_mesh, multihost
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    multihost.maybe_initialize_distributed(DEVICE)
    mesh = make_mesh(DEVICE)
    with open(os.path.join(tmp, "spec.json")) as f:
        spec = json.load(f)
    spec["run"] = RANK_RUNS.get(job)
    nccl = torch.cuda.nccl.version() if mesh.backend == "nccl" else None
    if isinstance(nccl, tuple):
        nccl = ".".join(map(str, nccl))
    res = dict(rank=mesh.rank, world=mesh.world, device=mesh.device,
               backend=mesh.backend, device_count=torch.cuda.device_count(),
               current_device=torch.cuda.current_device(), nccl=nccl)
    log(f"rank {mesh.rank} of {mesh.world}: backend {mesh.backend}, device "
        f"{mesh.device} (current {res['current_device']} of "
        f"{res['device_count']} visible), NCCL {nccl}")
    for name, part in RANK_JOBS[job]:
        if torch.cuda.is_available():
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res[name] = part(mesh, spec, tmp)
        res[name].update(seconds=time.perf_counter() - t0,
                         max_memory_allocated=_peak())
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    with open(os.path.join(tmp, f"{job}.{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    return 0


def _first_card():
    """This process's first card, as CUDA_VISIBLE_DEVICES names it."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return visible.split(",")[0].strip() if visible else "0"


def _run_ranks(job, tmp, phase=11, ranks=RANKS):
    """Start `ranks` rank processes of `job` on a free localhost port
    (LOCAL_WORLD_SIZE = ranks) and wait for all; one that fails or
    outlives RANKS_TIMEOUT_S kills them all and fails the phase with the
    end of its output.  The ranks of phases 11 and 12 see the first card
    alone and share it over gloo, as on a machine of one card; phase 14's
    see every card and take one each (NCCL).  Returns (the ranks'
    results, seconds)."""
    import shutil
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(ranks), LOCAL_WORLD_SIZE=str(ranks))
    if phase in (11, 12):
        env["CUDA_VISIBLE_DEVICES"] = _first_card()
    logs = [os.path.join(tmp, f"{job}.{r}.log") for r in range(ranks)]
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(ranks):
            env.update(RANK=str(rank), LOCAL_RANK=str(rank))
            with open(logs[rank], "w") as f:
                procs.append(subprocess.Popen(
                    RANK_COMMAND + [RANK_FLAG, job, tmp], env=dict(env),
                    stdout=f, stderr=subprocess.STDOUT, cwd=ROOT))
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            late = time.perf_counter() - t0 > RANKS_TIMEOUT_S
            if bad or late:
                r = bad[0] if bad else codes.index(None)
                with open(logs[r]) as f:
                    tail = f.read()[-4000:]
                fail(f"phase {phase} {job}: rank {r} "
                     + (f"exited {codes[r]}" if bad else
                        f"still running after {RANKS_TIMEOUT_S} s")
                     + f":\n{tail}")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        out_dir = os.path.join(ROOT, "chiprun_out")
        os.makedirs(out_dir, exist_ok=True)
        for path in logs:
            if os.path.isfile(path):
                shutil.copy(path, os.path.join(
                    out_dir, f"phase{phase}_" + os.path.basename(path)))
    results = []
    for r in range(ranks):
        with open(os.path.join(tmp, f"{job}.{r}.json")) as f:
            results.append(json.load(f))
    return results, time.perf_counter() - t0


def _check_animation_runs(full, resumed, ckpts, metrics_path):
    """The gates on the two animation_train runs across ranks."""
    files = {"extra.json", "modules/unet.pt", "modules/audio_encoder.pt",
             "modules_config.json", "state.pt"}
    want_written = sorted(f"ckpts/checkpoint-{s}/{n}" for s in (2, 3)
                          for n in files)
    with open(metrics_path) as f:
        logged = [json.loads(line)["step"] for line in f]
    accum_batches = [2 * s for s in (2, 3)]
    extra = ckpts["extra"]
    checks = {
        "replicas bit-equal after every step": all(
            s["replicas_equal"] for run in (full, resumed) for r in run
            for s in r["animation"]["steps"]),
        "step-1 local gradients differ": all(
            r["animation"]["local_grads_differ"] for r in full),
        "3 steps, the ranks' mean losses equal on both ranks": all(
            r["animation"]["step"] == 3 and r["animation"]["losses"]
            == full[0]["animation"]["losses"] for r in full)
        and len(full[0]["animation"]["losses"]) == 3,
        "only rank 0 wrote, each file once": (
            sorted(full[0]["animation"]["written"]) == want_written
            and all(r["animation"]["written"] == [] for r in full[1:])),
        "no temporary name left": ckpts["tmp_left"] == [],
        "checkpoint-2 kept (milestone), -3 latest": ckpts["steps"] == [2, 3],
        "metrics.jsonl: one record a step, rank 0's": logged == [1, 2, 3],
        "cursors count each rank's batches": (
            [extra[2]["cursor"], extra[3]["cursor"]] == accum_batches
            and all(r["animation"]["batches"] == accum_batches[1]
                    and r["animation"]["loader"] == extra[3]
                    for r in full)),
        "resumed from checkpoint-2 to 3": all(
            r["animation"]["resumed_from"] == 2 and r["animation"]["step"]
            == 3 for r in resumed),
        "resumed step-3 loss equal": all(
            r["animation"]["losses"] == full[0]["animation"]["losses"][2:]
            for r in resumed),
        "resumed parameters equal (digest)": all(
            r["animation"]["steps"][-1]["digest"]
            == full[0]["animation"]["steps"][-1]["digest"] for r in resumed),
        "resumed: rank 0 wrote checkpoint-3 alone": (
            sorted(resumed[0]["animation"]["written"]) == sorted(
                f"ckpts/checkpoint-3/{n}" for n in files)
            and all(r["animation"]["written"] == [] for r in resumed[1:])),
    }
    return checks


def phase_ranks(report):
    """Phase 11: training across RANKS processes on the card, started with
    torchrun's environment and joined through maybe_initialize_distributed
    (gloo with both on cuda:0 where there is one card).  One pair runs the
    host gathers, the fp32 step against one process, animation_train for 3
    steps, the fp32 classifier step against one process and avsync_train
    with evaluate; a fresh pair resumes animation_train from checkpoint-2
    to 3.  Returns the animation runs' launches, summed over the ranks."""
    import torch
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info()
        log(f"  card memory before the ranks: {free / 2**30:.2f} GiB free "
            f"of {total / 2**30:.2f} (torch.cuda.mem_get_info)")
    # the training YAML logs with wandb: never let a rank reach for a
    # network (the ranks inherit this environment)
    os.environ["WANDB_MODE"] = "disabled"
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        spec = _animation_yamls(tmp, ("uninterrupted", "resumed"))

        def edit_sync(raw):
            raw["exp"]["output_dir"] = os.path.join(tmp, "sync")
        spec["sync"] = _job_yaml(SYNC_YAML, tmp, "sync_ranks", edit_sync)
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(spec, f)

        full, full_s = _run_ranks("train", tmp)
        run_dir = os.path.join(tmp, "uninterrupted")
        mgr = CheckpointManager(os.path.join(run_dir, "ckpts"))
        ckpts = dict(
            steps=mgr.existing_steps(),
            extra={s: mgr.restore_extra(s)["loader"] for s in (2, 3)},
            tmp_left=[n for _, _, names in os.walk(mgr.directory)
                      for n in names if n.endswith(".tmp")])
        os.makedirs(os.path.join(tmp, "resumed", "ckpts"))
        os.rename(mgr._path(2), os.path.join(tmp, "resumed", "ckpts",
                                             "checkpoint-2"))
        resumed, resumed_s = _run_ranks("resume", tmp)
        checks = _check_animation_runs(
            full, resumed, ckpts, os.path.join(run_dir, "metrics.jsonl"))
    seconds = time.perf_counter() - t_phase
    zero = full[0]
    fp32 = zero["fp32"]
    sync32, sync64 = zero["sync_steps"]["float32"], zero["sync_steps"][
        "float64"]
    loss_err = abs(fp32["loss_two_ranks"] - fp32["loss_one_process"])
    checks.update({
        "host gathers exact": all(r["gathers"]["exact"] for r in full),
        "fp32: gradients within 1e-4 relative L2 of one process":
            fp32["grad_rel_l2"] <= 1e-4,
        "fp32: loss within 1e-5 of one process": loss_err <= 1e-5 * max(
            1.0, abs(fp32["loss_one_process"])),
        "fp32: local gradients differ, reduced ones equal": all(
            r["fp32"]["local_grads_differ"] and r["fp32"]["reduced_grads_equal"]
            for r in full),
        "classifier fp32: running statistics within 1e-4 relative L2 of "
        "one process": sync32["stats_rel_l2"] <= 1e-4,
        "classifier fp64: gradients and running statistics within 1e-4 "
        "relative L2 of one process": (sync64["grad_rel_l2"] <= 1e-4
                                       and sync64["stats_rel_l2"] <= 1e-4),
        "classifier: replicas equal": all(
            r["sync_steps"][key]["grads_equal"]
            and r["sync_steps"][key]["stats_equal"]
            for r in full for key in ("float32", "float64")),
        "avsync_train: replicas (and statistics) equal after each step": all(
            r["sync"]["replicas_equal"] == [True, True] for r in full),
        "avsync_train: evaluate is the ranks' batch-weighted mean": all(
            r["sync"]["evaluate_matches"] and r["sync"]["evaluated"] == 1
            for r in full),
        "avsync_train: metrics equal on both ranks": all(
            r["sync"]["metrics"] == zero["sync"]["metrics"] for r in full)
        and all(math.isfinite(v) for m in zero["sync"]["metrics"]
                for v in m.values()),
    })
    launches = {k: sum(r["animation"]["launches"][k]
                       for run in (full, resumed) for r in run)
                for k in zero["animation"]["launches"]}
    anim = [r["animation"] for r in full]
    out = dict(
        device_count=zero["device_count"], backend=zero["backend"],
        devices=[r["device"] for r in full], seconds=seconds,
        pair_seconds=[full_s, resumed_s], checks=checks,
        peak_bytes={name: [r[name]["max_memory_allocated"] for r in full]
                    for name, _ in RANK_JOBS["train"]},
        part_seconds={name: [round(r[name]["seconds"], 2) for r in full]
                      for name, _ in RANK_JOBS["train"]},
        animation=dict(
            losses=anim[0]["losses"],
            seconds_per_step=[a["seconds_per_step"] for a in anim],
            allreduce_seconds=[a["allreduce_seconds"] for a in anim],
            allreduce_bytes=anim[0]["allreduce_bytes"],
            save_seconds=anim[0]["save_seconds"],
            resumed_losses=resumed[0]["animation"]["losses"],
            phase10_seconds_per_step=report.get("cli_train", {}).get(
                "seconds_per_step")),
        fp32=fp32, classifier=zero["sync_steps"],
        sync=dict(metrics=zero["sync"]["metrics"],
                  evaluate=zero["sync"]["evaluate"],
                  seconds_after_first_step=[
                      r["sync"]["seconds_after_first_step"] for r in full]),
        gathers=zero["gathers"], launches=launches)
    report["ranks"] = out
    a = out["animation"]
    log(f"  {RANKS} ranks: torch.cuda.device_count() {out['device_count']}, "
        f"backend {out['backend']}, devices {out['devices']}; phase "
        f"{seconds:.1f} s (pairs {full_s:.1f} + {resumed_s:.1f} s); parts "
        f"(s, rank 0 / 1) {out['part_seconds']}")
    log(f"  peak memory per rank (GiB): " + "; ".join(
        f"{k} " + "/".join("-" if b is None else f"{b / 2**30:.2f}"
                           for b in v) for k, v in out["peak_bytes"].items()))
    log(f"  animation_train, batch 4 a rank x accumulation 2: seconds per "
        f"step after the first {a['seconds_per_step']} beside phase 10's "
        f"one process {a['phase10_seconds_per_step']}; gradient all-reduce "
        f"a step {a['allreduce_seconds']} s of "
        f"{[n / 2**30 for n in a['allreduce_bytes']]} GiB; saves "
        f"{a['save_seconds']} s; losses {a['losses']}, resumed "
        f"{a['resumed_losses']}")
    log(f"  fp32 step, batch 1 a rank vs one process on 2: loss "
        f"{fp32['loss_two_ranks']!r} vs {fp32['loss_one_process']!r}, "
        f"gradients relative L2 {fp32['grad_rel_l2']:.3e}; classifier fp32, "
        f"{SYNC_REDUCED_B} items a rank: gradients {sync32['grad_rel_l2']:.3e}"
        f", running statistics {sync32['stats_rel_l2']:.3e} (one process "
        f"with the halves swapped: {sync32['grad_rel_l2_order_swapped']:.3e}"
        f", {sync32['stats_rel_l2_order_swapped']:.3e}); fp64, 1 item a "
        f"rank: gradients {sync64['grad_rel_l2']:.3e}, running statistics "
        f"{sync64['stats_rel_l2']:.3e}")
    log(f"  avsync_train: metrics {out['sync']['metrics']}; evaluate "
        f"{out['sync']['evaluate']}; seconds after the first step "
        f"{out['sync']['seconds_after_first_step']}; host gathers "
        f"{out['gathers']['records']}")
    log(f"  gates: {checks}; launches {launches}")
    if not all(checks.values()):
        fail(f"phase 11: {[k for k, v in checks.items() if not v]}")
    if not (launches["B1"] > 0 and launches["B3"] > 0 and launches["B4"] > 0
            and launches["B5"] > 0 and launches["B2"] == 0
            and launches["B6"] == 0
            and all(launches[f"KG.{f}"] > 0 for f, *_ in GEMM_FORMS)):
        fail(f"phase 11 launches: {launches}")
    return launches


# ------------------------------------------------------------ phase 12 ---

# the generation meshes of phase 12: (seq size, clips); data = RANKS // seq
GEN_CASES = {"data": (1, 2), "seq": (2, 1)}
GEN_KW = dict(video_length=F, num_inference_steps=5, sampler="ddim",
              audio_guidance_scale=4.0, text_guidance_scale=1.0)


def _gen_inputs(n):
    """n full-width requests made as phase 4 makes them (a 256x256 image,
    2 s of 16 kHz audio, a (77, 768) text encoding), and the seeded
    stand-in null text encoding, on the current card."""
    import torch
    g = _gen(120)
    images = torch.rand((n, 256, 256, 3), generator=g, device="cuda")
    waves = torch.randn((n, 1, 32000), generator=g, device="cuda") * 0.1
    text = torch.randn((n, TEXT_TOKENS, 768), generator=g, device="cuda")
    null = torch.randn((1, TEXT_TOKENS, 768), device="cuda",
                       generator=_gen(100))
    return images, waves, text, null


def _gen_pipeline(dtype, null):
    """Phase 4's seeded full-width pipeline."""
    from asva_tpu_torch.runtime import load_animation_pipeline
    return load_animation_pipeline(device="cuda", dtype=dtype, seed=0,
                                   randomize_all=True,
                                   null_text_encoding=null)


def _generate(pipe, n, decode):
    images, waves, text, _ = _gen_inputs(n)
    mels = pipe.encode_audio_waveform(list(waves))
    return pipe(images, mels, text, generator=_gen(130), decode=decode,
                **GEN_KW)


@contextlib.contextmanager
def _timed_exchanges(stats):
    """Count, time (the card synchronised on both sides) and size the
    UNet's frame exchanges: {name: [calls, seconds, bytes]}, the bytes of
    the tensor each returns (all_reduce_sum: of its input)."""
    from asva_tpu_torch.ops import norms
    from asva_tpu_torch.parallel import reduce
    saved = {"broadcast_frame0": (reduce, reduce.broadcast_frame0),
             "prev_frame_halo": (reduce, reduce.prev_frame_halo),
             "all_gather_frames": (reduce, reduce.all_gather_frames),
             "all_reduce_sum": (norms, norms.all_reduce_sum)}

    def timed(name, fn):
        def run(x, group):
            _sync()
            t0 = time.perf_counter()
            y = fn(x, group)
            _sync()
            moved = x if name == "all_reduce_sum" else y
            row = stats.setdefault(name, [0, 0.0, 0])
            row[0] += 1
            row[1] += time.perf_counter() - t0
            row[2] += moved.numel() * moved.element_size()
            return y
        return run
    for name, (mod, fn) in saved.items():
        setattr(mod, name, timed(name, fn))
    try:
        yield stats
    finally:
        for name, (mod, fn) in saved.items():
            setattr(mod, name, fn)


def rank_generation(mesh, spec, tmp):
    """Phase 12 (a) and (b), phase 14 (a): each generation mesh of the
    spec's cases (GEN_CASES by default) and dtype: a warm-up call, a timed
    call (its B2/B3 launches), and a call returning the latents with the
    frame exchanges timed; rank 0 writes the gathered videos and latents.
    Where the spec asks for "one_card", each rank first times one clip's
    request without a mesh on its own card (after a warm-up call): one
    card's time in the same run."""
    import torch
    from asva_tpu_torch.parallel import make_gen_mesh, multihost
    from asva_tpu_torch.pipelines.animation import AnimationPipeline
    cases = spec.get("gen_cases", GEN_CASES)
    meshes = {case: make_gen_mesh(DEVICE, seq=seq)
              for case, (seq, _) in cases.items()}
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        base = _gen_pipeline(dtype, _gen_inputs(1)[3])
        if spec.get("one_card"):
            _generate(base, 1, True)
            _sync()
            t0 = time.perf_counter()
            _generate(base, 1, True)
            _sync()
            out[f"one_card_{str(dtype).split('.')[-1]}"] = \
                time.perf_counter() - t0
        for case, (seq, n) in cases.items():
            gmesh = meshes[case]
            name = f"{case}_{str(dtype).split('.')[-1]}"
            pipe = AnimationPipeline(base.unet, base.vae, base.audio_encoder,
                                     base.schedule, base.null_text_encoding,
                                     mesh=gmesh)
            _generate(pipe, n, True)
            _sync()
            multihost.barrier()
            reset_counts()
            t0 = time.perf_counter()
            videos = _generate(pipe, n, True)
            _sync()
            seconds = time.perf_counter() - t0
            counts = read_counts()
            stats = {}
            with _timed_exchanges(stats):
                _sync()
                t0 = time.perf_counter()
                latents = _generate(pipe, n, False)
                _sync()
                timed_s = time.perf_counter() - t0
            if mesh.rank == 0:
                torch.save({"videos": videos.float().cpu(),
                            "latents": latents.float().cpu()},
                           os.path.join(tmp, f"gen_{name}.pt"))
            out[name] = dict(
                data=gmesh.size("data"), seq=gmesh.size("seq"),
                coords=list(gmesh.coords), seconds_per_request=seconds,
                seconds_with_exchanges_timed=timed_s,
                launches={k: counts[k] for k in ("B2", "B3")},
                launches_all=counts, exchanges=stats,
                ranks_equal=_same(_gathered_digests([videos, latents])),
                shape=list(videos.shape))
            del pipe, videos, latents
            torch.cuda.empty_cache()
        del base
    return out


def _replicas_equal(mesh, params) -> bool:
    """Whether every rank's `params` equal, bit for bit, those of the
    ranks that should hold the same values: a split parameter's block on
    the ranks of one fsdp index (rank r and r % fsdp), the rest on every
    rank (by `_digest`, gathered over the host group)."""
    from asva_tpu_torch.parallel import sharding
    digests = _gathered_digests(params)
    fsdp = mesh.size("fsdp")
    split = [sharding.is_sharded(p) for p in params]
    return all(bool((digests[r, i] == digests[r % fsdp if s else 0, i])
                    .all()) for r in range(mesh.world)
               for i, s in enumerate(split))


def _fsdp_run(mesh, name, spec, fsdp):
    """animation_train.train at `fsdp` on the run `name`'s YAML for 3
    steps (a resumed run: to 3), writing checkpoint-2 alone (dropped after
    the run where the spec's "drop_ckpts" names it), on 24 ChipClips a
    rank: each step's gathers, reduce-scatters, the replicas' gradient
    all-reduce and the clip's gathers (count, seconds with the card
    synchronised, bytes; the all-reduce after a barrier), whether the
    replicas are bit-equal after each step, each step's seconds after the
    first (its save's excluded) and each save's, the peak memory of each
    step and of each save, the files this rank wrote and its launches."""
    import shutil

    import torch
    from asva_tpu_torch.config import AnimationJobConfig
    from asva_tpu_torch.parallel import multihost, sharding
    from asva_tpu_torch.scripts import animation_train
    from asva_tpu_torch.training import animation_trainer, checkpoint
    cfg = AnimationJobConfig.from_yaml(spec[name])
    label, comms, peaks, written = ["build"], {}, {}, []
    replicas, saves = [], []
    trainer_cls = animation_trainer.AnimationTrainer
    state_cls = animation_trainer.TrainState
    mgr = checkpoint.CheckpointManager
    orig = dict(gather=sharding.gather, full_gather=sharding.full_tensor,
                reduce_scatter=sharding.reduce_scatter_mean,
                all_reduce=animation_trainer.all_reduce_mean_,
                grad_step=trainer_cls.grad_step,
                apply_step=trainer_cls.apply_step,
                state_dict=state_cls.state_dict, save=mgr.save,
                write=checkpoint._write_atomic)

    def timed(kind):
        def run(*args):
            if kind == "full_gather" and not sharding.is_sharded(args[0]):
                return orig[kind](*args)     # a replica: no collective
            _sync()
            t0 = time.perf_counter()
            y = orig[kind](*args)
            _sync()
            moved = args[0] if kind == "reduce_scatter" else y
            row = comms.setdefault(label[0], {}).setdefault(kind,
                                                            [0, 0.0, 0])
            row[0] += 1
            row[1] += time.perf_counter() - t0
            row[2] += moved.numel() * moved.element_size()
            return y
        return run

    def all_reduce(tensors, m):
        tensors = list(tensors)
        _sync()
        multihost.barrier()
        t0 = time.perf_counter()
        nbytes = orig["all_reduce"](tensors, m)
        _sync()
        row = comms.setdefault(label[0], {}).setdefault("all_reduce",
                                                        [0, 0.0, 0])
        row[0] += 1
        row[1] += time.perf_counter() - t0
        row[2] += nbytes
        return nbytes

    def relabel(new):
        """Close the peak of the window `label` names, open `new`'s."""
        _sync()
        peaks[label[0]] = max(peaks.get(label[0], 0),
                              torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        label[0] = new

    def grad_step(self, state, *a, **kw):
        if label[0] != f"step {state.step + 1}":
            relabel(f"step {state.step + 1}")
        return orig["grad_step"](self, state, *a, **kw)

    def apply_step(self, state, grads, mesh=None):
        orig["apply_step"](self, state, grads, mesh)
        relabel(label[0])
        replicas.append(_replicas_equal(mesh, state.optimizer.params))

    # phase 12 writes checkpoint-2 alone: the loop's final forced save at
    # step 3 neither gathers the state nor writes it
    def state_dict(self):
        if self.step == 3:
            return {"unet": None}
        saves.append([time.perf_counter()])
        relabel(f"save {self.step}")
        full = orig["state_dict"](self)
        relabel(label[0])
        return full

    def save(self, step, *a, force=False, **kw):
        if force and step == 3:
            return False
        done = orig["save"](self, step, *a, force=force, **kw)
        saves[-1].append(time.perf_counter())
        return done

    def write(path, fn):
        written.append(os.path.relpath(path, cfg.output_dir))
        orig["write"](path, fn)
    sharding.gather = timed("gather")
    sharding.full_tensor = timed("full_gather")
    sharding.reduce_scatter_mean = timed("reduce_scatter")
    animation_trainer.all_reduce_mean_ = all_reduce
    trainer_cls.grad_step, trainer_cls.apply_step = grad_step, apply_step
    state_cls.state_dict, mgr.save = state_dict, save
    checkpoint._write_atomic = write
    try:
        reset_counts()
        res = animation_train.train(
            cfg, ChipClips(24 * mesh.world, cfg.dataset, cfg.seed), DEVICE,
            3, fsdp=fsdp)
        counts = read_counts()
        relabel("end")
    finally:
        sharding.gather, sharding.full_tensor = (orig["gather"],
                                                 orig["full_gather"])
        sharding.reduce_scatter_mean = orig["reduce_scatter"]
        animation_trainer.all_reduce_mean_ = orig["all_reduce"]
        trainer_cls.grad_step = orig["grad_step"]
        trainer_cls.apply_step = orig["apply_step"]
        state_cls.state_dict, mgr.save = orig["state_dict"], orig["save"]
        checkpoint._write_atomic = orig["write"]
    state = res["state"]
    split = sum(sharding.is_sharded(p) for p in state.unet.parameters())
    out = dict(run=name, fsdp=fsdp, losses=res["losses"], step=state.step,
               resumed_from=res["resumed_from"], loader=res["loader"],
               split_parameters=split,
               parameters=sum(1 for _ in state.unet.parameters()),
               seconds_per_step=[round(b - a - sum(
                   e - s for s, e in saves if a < s < b), 3) for a, b in zip(
                   res["step_times"], res["step_times"][1:])],
               save_seconds=[round(e - s, 3) for s, e in saves],
               comms=comms, peaks=peaks, peak=max(peaks.values()),
               written=written, replicas_equal=replicas, launches=counts)
    del res, state
    torch.cuda.empty_cache()
    if mesh.rank == 0 and name in spec.get("drop_ckpts", ()):
        shutil.rmtree(os.path.join(cfg.output_dir, "ckpts"))
    return out


RANK_JOBS.update({
    "gen": (("generation", rank_generation),),
    "fsdp": (("fsdp", lambda mesh, spec, tmp: _fsdp_run(mesh, "fsdp", spec,
                                                        2)),),
    "fsdp_resume": tuple(
        (f"resume{n}", lambda mesh, spec, tmp, n=n: _fsdp_run(
            mesh, f"resume{n}", spec, n)) for n in (2, 1))})


def _generation_ranks(gen_rows):
    """{case_dtype: each rank's place, seconds, launches and exchanges}."""
    return {k: [{f: r[f] for f in (
        "coords", "seconds_per_request", "seconds_with_exchanges_timed",
        "launches", "exchanges")} for r in rows]
        for k, rows in gen_rows.items()}


def _log_generation(generation_ranks):
    for k, rows in generation_ranks.items():
        log(f"  {k}: per rank {[(r['coords'], round(r['seconds_per_request'], 3), r['launches']) for r in rows]}"
            f"; frame exchanges (calls, s, bytes) on rank 0 "
            f"{ {n: [v[0], round(v[1], 4), v[2]] for n, v in rows[0]['exchanges'].items()} }"
            f" in a request of {round(rows[0]['seconds_with_exchanges_timed'], 3)} s")


def _log_comms(comms):
    """Rank 0's collectives by step and save: count, seconds, GiB."""
    for step, kinds in comms.items():
        log(f"    rank 0 {step}: " + "; ".join(
            f"{kind} x{v[0]} {v[1]:.4f} s {v[2] / 2**30:.3f} GiB"
            for kind, v in kinds.items()))


def _one_process_references(cases=GEN_CASES):
    """Each case's one-process results on the same inputs and noise: fp32
    videos and latents through the kernels, and the latents of the plain
    sub-layers in fp32 and bf16 (phase 4's bf16 gate)."""
    import torch
    refs = {}
    for case, (_, n) in cases.items():
        null = _gen_inputs(n)[3]
        pipe = _gen_pipeline(torch.float32, null)
        ref = dict(videos=_generate(pipe, n, True).cpu(),
                   latents=_generate(pipe, n, False).float().cpu())
        with plain_sublayers():
            ref["plain32"] = _generate(pipe, n, False).float().cpu()
            del pipe
            torch.cuda.empty_cache()
            pipe = _gen_pipeline(torch.bfloat16, null)
            ref["plain16"] = _generate(pipe, n, False).float().cpu()
        del pipe
        torch.cuda.empty_cache()
        refs[case] = ref
    return refs


def _gen_checks(tmp, refs, results, cases=GEN_CASES):
    """phase 12's generation gates (phase 14's too): fp32 videos within one
    uint8 level of one process, fp32 latents within 1e-4 * max(1,
    max|ref|), bf16 latents within 1.5x the plain bf16 version's relative
    RMS from the fp32 plain ones; the ranks' results equal; B2 = B3 = 80
    per rank (16 blocks x 5 steps, one process's count)."""
    import torch
    checks, numbers = {}, {}
    for case in cases:
        ref = refs[case]
        got32 = torch.load(os.path.join(tmp, f"gen_{case}_float32.pt"))
        got16 = torch.load(os.path.join(tmp, f"gen_{case}_bfloat16.pt"))

        def u8(v):
            return (v * 255).to(torch.uint8).int()

        def rel_rms(a):
            return float((a - ref["plain32"]).norm() / ref["plain32"].norm())
        levels = int((u8(got32["videos"]) - u8(ref["videos"])).abs().max())
        lat_err = float((got32["latents"] - ref["latents"]).abs().max())
        lat_tol = 1e-4 * max(1.0, float(ref["latents"].abs().max()))
        rms16, rms_plain = rel_rms(got16["latents"]), rel_rms(ref["plain16"])
        numbers[case] = dict(fp32_uint8_levels=levels,
                             fp32_latents_max_abs=lat_err,
                             fp32_latents_tol=lat_tol,
                             bf16_rel_rms=rms16, plain_bf16_rel_rms=rms_plain)
        checks[f"{case}: fp32 videos within one uint8 level"] = levels <= 1
        checks[f"{case}: fp32 latents within 1e-4 * max(1, |ref|)"] = \
            lat_err <= lat_tol
        checks[f"{case}: bf16 within 1.5x the plain bf16's distance"] = \
            rms16 <= 1.5 * rms_plain
        for dname in ("bfloat16", "float32"):
            rows = [r["generation"][f"{case}_{dname}"] for r in results]
            checks[f"{case} {dname}: ranks equal, global shape"] = all(
                r["ranks_equal"] and r["shape"][:2]
                == [cases[case][1], F] for r in rows)
            checks[f"{case} {dname}: B2 = B3 = 80 a rank"] = all(
                r["launches"] == {"B2": 80, "B3": 80} for r in rows)
    return checks, numbers


def _fsdp_checks(full, resumed, phase11_losses):
    """phase 12's FSDP gates: losses within 1e-6 relative of phase 11's
    data-parallel run; both resumes' step-3 loss within 1e-6 relative of
    the uninterrupted run's; checkpoint-2 written by rank 0 alone; the
    resumes start at 2 and reach 3."""
    zero = full[0]["fsdp"]

    def close(a, b):
        return abs(a - b) <= 1e-6 * abs(b)
    files = {"extra.json", "modules/unet.pt", "modules/audio_encoder.pt",
             "modules_config.json", "state.pt"}
    checks = {
        "fsdp 2: 3 steps, losses equal on both ranks": all(
            r["fsdp"]["step"] == 3 and r["fsdp"]["losses"] == zero["losses"]
            for r in full) and len(zero["losses"]) == 3,
        "fsdp 2: parameters split": zero["split_parameters"] > 0,
        "fsdp 2: losses within 1e-6 relative of phase 11's": (
            phase11_losses is not None and len(phase11_losses) == 3
            and all(close(a, b) for a, b in zip(zero["losses"],
                                                phase11_losses))),
        "fsdp 2: checkpoint-2 by rank 0 alone": (
            sorted(zero["written"]) == sorted(
                f"ckpts/checkpoint-2/{n}" for n in files)
            and all(r["fsdp"]["written"] == [] for r in full[1:])),
    }
    for n in (2, 1):
        runs = [r[f"resume{n}"] for r in resumed]
        checks[f"resume at fsdp {n}: from 2 to 3"] = all(
            r["resumed_from"] == 2 and r["step"] == 3 and r["fsdp"] == n
            and r["written"] == [] for r in runs)
        checks[f"resume at fsdp {n}: step-3 loss within 1e-6 relative"] = \
            all(len(r["losses"]) == 1 and close(r["losses"][0],
                                                zero["losses"][2])
                for r in runs)
    return checks


def phase_parallel_gen_fsdp(report):
    """Phase 12: generation across RANKS processes at data 2 and at seq 2
    against one process on the same inputs and noise, then
    animation_train at fsdp 2 for 3 steps against phase 11's data-parallel
    losses, and a fresh pair's resumes from its checkpoint-2 at fsdp 2 and
    at fsdp 1.  Returns the paths' launches, summed over the ranks."""
    import torch
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    refs = _one_process_references()
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_phase
    os.environ["WANDB_MODE"] = "disabled"
    with tempfile.TemporaryDirectory() as tmp:
        spec = _animation_yamls(tmp, ("fsdp", "resume2", "resume1"))
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(spec, f)
        gen, gen_s = _run_ranks("gen", tmp, 12)
        checks, numbers = _gen_checks(tmp, refs, gen)
        full, full_s = _run_ranks("fsdp", tmp, 12)
        for n in (2, 1):
            ckpts = os.path.join(tmp, f"resume{n}", "ckpts")
            os.makedirs(ckpts)
            os.symlink(os.path.join(tmp, "fsdp", "ckpts", "checkpoint-2"),
                       os.path.join(ckpts, "checkpoint-2"))
        resumed, resumed_s = _run_ranks("fsdp_resume", tmp, 12)
    phase11 = report.get("ranks", {}).get("animation", {}).get("losses")
    checks.update(_fsdp_checks(full, resumed, phase11))
    seconds = time.perf_counter() - t_phase
    zero = full[0]["fsdp"]
    gen_rows = {f"{c}_{d}": [r["generation"][f"{c}_{d}"] for r in gen]
                for c in GEN_CASES for d in ("bfloat16", "float32")}
    launches = {
        "generation": {k: sum(r["launches_all"][k] for rows in
                              gen_rows.values() for r in rows)
                       for k in gen_rows["data_bfloat16"][0][
                           "launches_all"]},
        "fsdp": {k: sum(r["fsdp"]["launches"][k] for r in full)
                 + sum(r[f"resume{n}"]["launches"][k] for r in resumed
                       for n in (2, 1))
                 for k in zero["launches"]}}
    out = dict(
        seconds=seconds, reference_seconds=ref_s,
        pair_seconds=dict(gen=gen_s, fsdp=full_s, resume=resumed_s),
        checks=checks, generation=numbers,
        generation_ranks=_generation_ranks(gen_rows),
        phase4_seconds_per_clip=report.get("pipeline", {}).get(
            "seconds_per_clip"),
        fsdp=dict(losses=zero["losses"], phase11_losses=phase11,
                  bit_equal_to_phase11=zero["losses"] == phase11,
                  resumed={n: [r[f"resume{n}"]["losses"] for r in resumed]
                           for n in (2, 1)},
                  resume2_bit_equal=all(
                      r["resume2"]["losses"] == zero["losses"][2:]
                      for r in resumed),
                  split_parameters=[zero["split_parameters"],
                                    zero["parameters"]],
                  seconds_per_step=[r["fsdp"]["seconds_per_step"]
                                    for r in full],
                  peaks={r["rank"]: r["fsdp"]["peaks"] for r in full},
                  peak_bytes=[r["fsdp"]["peak"] for r in full],
                  resumed_peak_bytes={n: [r[f"resume{n}"]["peak"]
                                          for r in resumed]
                                      for n in (2, 1)},
                  phase11_peak_bytes=report.get("ranks", {}).get(
                      "peak_bytes", {}).get("animation"),
                  comms=zero["comms"]),
        launches=launches)
    report["parallel_gen_fsdp"] = out
    log(f"  phase {seconds:.1f} s (one-process references {ref_s:.1f} s, "
        f"pairs {gen_s:.1f} + {full_s:.1f} + {resumed_s:.1f} s)")
    _log_generation(out["generation_ranks"])
    log(f"  generation gates' numbers {numbers}; phase 4's seconds per "
        f"clip {out['phase4_seconds_per_clip']}")
    f12 = out["fsdp"]
    log(f"  fsdp 2: losses {f12['losses']!r} beside phase 11's "
        f"{f12['phase11_losses']!r} (bit-equal {f12['bit_equal_to_phase11']});"
        f" resumed step-3 losses {f12['resumed']} (fsdp 2 bit-equal "
        f"{f12['resume2_bit_equal']}); {f12['split_parameters'][0]} of "
        f"{f12['split_parameters'][1]} parameters split")
    log(f"  fsdp 2: seconds per step after the first "
        f"{f12['seconds_per_step']}; peak per rank (GiB) "
        f"{[b / 2**30 for b in f12['peak_bytes']]} beside phase 11's "
        f"{[b / 2**30 for b in (f12['phase11_peak_bytes'] or [])]}; by step"
        f" and save {f12['peaks']}; resumed runs' peaks (GiB) "
        f"{ {n: [b / 2**30 for b in v] for n, v in f12['resumed_peak_bytes'].items()} }")
    _log_comms(f12["comms"])
    log(f"  gates: {checks}; launches {launches}")
    if not all(checks.values()):
        fail(f"phase 12: {[k for k, v in checks.items() if not v]}")
    gl, fl = launches["generation"], launches["fsdp"]
    if not (gl["B2"] > 0 and gl["B3"] > 0 and gl["B1"] == 0
            and fl["B1"] > 0 and fl["B3"] > 0 and fl["B4"] > 0
            and fl["B5"] > 0 and fl["B2"] == 0 and fl["B6"] == 0):
        fail(f"phase 12 launches: {launches}")
    return launches


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

# ------------------------------------------------------------ phase 13 ---

def _conv_counter():
    """A dispatch mode counting the convolutions that run (not those a
    remat policy replays)."""
    from torch.utils._python_dispatch import TorchDispatchMode
    import torch

    class Convs(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten.convolution.default:
                self.n += 1
            return func(*args, **(kwargs or {}))
    return Convs()


def phase_remat(report):
    """Phase 13: the remat policies at full width; returns the launches
    summed over its timed steps."""
    import dataclasses
    import torch
    from asva_tpu_torch.models.unet3d.model import REMAT_POLICIES
    from asva_tpu_torch.models.unet3d.primitives import (CrossAttention,
                                                         FFSpatialAttention)
    from asva_tpu_torch.training import TrainState, build_optimizer
    torch.cuda.empty_cache()
    cudnn_was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    trainer, state, batch, mask = build_trainer(torch.bfloat16, TRAIN_B)
    unet = state.unet
    n_attn = sum(isinstance(m, (FFSpatialAttention, CrossAttention))
                 for m in unet.modules())
    start = {n: p.detach().cpu() for n, p in unet.named_parameters()
             if mask[n]}
    draws = trainer.draw(batch, _gen(1300))
    trainer.null_audio_encoding()       # computed once, then cached
    with torch.no_grad(), _conv_counter() as convs:
        trainer.loss_fn(batch, draws=draws)
    convs_forward = convs.n
    runs, ref, total = {}, None, {}
    for run, policy in enumerate(REMAT_POLICIES + ("full",)):
        with torch.no_grad():
            for n, p in unet.named_parameters():
                if mask[n]:
                    p.copy_(start[n])
        unet.config = dataclasses.replace(unet.config, remat_policy=policy)
        state = TrainState(0, unet, build_optimizer(
            unet, 1e-4, mask=mask, weight_decay=1e-2, max_grad_norm=1.0))
        # an untimed gradient step first: its convolutions counted, and the
        # policy's allocations made before the timed steps
        with _conv_counter() as convs:
            trainer.grad_step(state, batch, draws=draws)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        losses, seconds, counts, digests = [], [], [], []
        for i in range(2):
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = trainer.grad_step(
                state, batch, draws=trainer.draw(batch, _gen(1300 + i)))
            trainer.apply_step(state, grads)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            counts.append(read_counts())
            losses.append(loss.item())
            digests.append(_digest(grads).tolist())
            del grads
        peak = torch.cuda.max_memory_allocated()
        for c in counts:
            for k, v in c.items():
                total[k] = total.get(k, 0) + v
        if ref is None:
            ref = (losses, digests)
        same = (losses, digests) == ref
        key = policy if run < len(REMAT_POLICIES) else "full (repeat)"
        runs[key] = dict(seconds_per_step=seconds, max_memory_allocated=peak,
                         losses=losses, launches_per_step=counts,
                         convs_per_step=convs.n, bit_equal_to_full=same)
        log(f"  remat {key}: seconds per step "
            f"{[round(x, 3) for x in seconds]}; peak "
            f"{peak / 2**30:.2f} GiB; B4 {[c['B4'] for c in counts]}, B5 "
            f"{[c['B5'] for c in counts]}, B1 {[c['B1'] for c in counts]}, "
            f"B3 {[c['B3'] for c in counts]} a step; convolutions "
            f"{convs.n} a step ({convs_forward} in a forward without a "
            f"graph); losses {losses}; losses and gradients bit-equal to "
            f"full's: {same} ({report['card']})")
    torch.backends.cudnn.deterministic = cudnn_was
    out = dict(batch_size=TRAIN_B, attention_sublayers=n_attn,
               convs_in_a_forward=convs_forward, runs=runs,
               card=report["card"])
    report["remat"] = out
    save = runs["saveconv"]
    # losses and both steps' gradients bit-equal across the policies (no
    # kernel of the path sums with atomics; cuDNN deterministic); the repeat
    # of full shows the run is deterministic
    bad = [k for k, r in runs.items()
           if not all(math.isfinite(x) for x in r["losses"])
           or not r["bit_equal_to_full"]]
    if bad or not (all(c["B4"] == n_attn and c["B5"] == n_attn
                       for c in save["launches_per_step"])
                   and save["convs_per_step"] == convs_forward):
        fail(f"remat policies: {bad or 'saveconv counts'}: {out}")
    del trainer, state, batch
    torch.cuda.empty_cache()
    return total


# ------------------------------------------------------------ phase 14 ---

CARD_RANKS = 4
# phase 14's generation meshes: (seq size, clips); data = CARD_RANKS // seq
CARD_GEN_CASES = {"data4": (1, 4), "seq4": (4, 1), "data2_seq2": (2, 2)}
# phase 14's animation_train runs, name -> fsdp size: three from scratch in
# one group, then a fresh group resuming fsdp4's checkpoint-2
CARD_TRAIN_RUNS = {"data4": 1, "fsdp4": 4, "data2_fsdp2": 2}
CARD_RESUMES = {"resume4": 4, "resume1": 1}


def _run_part(name, fsdp):
    return (name, lambda mesh, spec, tmp: _fsdp_run(mesh, name, spec, fsdp))


RANK_JOBS.update({
    "cards_gen": (("generation", rank_generation),),
    "cards_train": (("gathers", rank_gathers),)
    + tuple(_run_part(n, f) for n, f in CARD_TRAIN_RUNS.items())
    + (("sync_steps", rank_sync_steps), ("sync", rank_sync)),
    "cards_resume": tuple(_run_part(n, f) for n, f in CARD_RESUMES.items())})


def _cards_checks(gen, train, resumed):
    """Phase 14's gates on the ranks' layout, the training runs, the
    resumes and the classifier (the generation gates are _gen_checks')."""
    files = {"extra.json", "modules/unet.pt", "modules/audio_encoder.pt",
             "modules_config.json", "state.pt"}
    want_written = sorted(f"ckpts/checkpoint-2/{n}" for n in files)
    cards = [f"cuda:{i}" for i in range(CARD_RANKS)]

    def close(a, b):
        return abs(a - b) <= 1e-6 * abs(b)
    checks = {
        f"every rank on NCCL, cards {cards[0]}-{cards[-1]} one a rank": all(
            [r["device"] for r in job] == cards
            and all(r["backend"] == "nccl" and r["nccl"]
                    and r["current_device"] == i
                    and r["device_count"] >= CARD_RANKS
                    for i, r in enumerate(job))
            for job in (gen, train, resumed))}
    data4 = train[0]["data4"]["losses"]
    for name, fsdp in CARD_TRAIN_RUNS.items():
        runs = [r[name] for r in train]
        zero = runs[0]
        checks[f"{name}: 3 steps, losses equal on every rank"] = all(
            r["step"] == 3 and r["losses"] == zero["losses"] for r in runs
        ) and len(zero["losses"]) == 3
        checks[f"{name}: replicas bit-equal after every step"] = all(
            r["replicas_equal"] == [True] * 3 for r in runs)
        checks[f"{name}: checkpoint-2 by rank 0 alone"] = (
            sorted(zero["written"]) == want_written
            and all(r["written"] == [] for r in runs[1:]))
        if fsdp > 1:
            checks[f"{name}: parameters split"] = zero["split_parameters"] > 0
            checks[f"{name}: losses within 1e-6 relative of data 4's"] = \
                all(close(a, b) for a, b in zip(zero["losses"], data4))
    fsdp4 = train[0]["fsdp4"]["losses"]
    for name, fsdp in CARD_RESUMES.items():
        runs = [r[name] for r in resumed]
        checks[f"{name}: from checkpoint-2 to 3 at fsdp {fsdp}"] = all(
            r["resumed_from"] == 2 and r["step"] == 3 and r["fsdp"] == fsdp
            and r["written"] == [] and r["replicas_equal"] == [True]
            for r in runs)
        checks[f"{name}: step-3 loss within 1e-6 relative of fsdp 4's"] = \
            all(len(r["losses"]) == 1 and close(r["losses"][0], fsdp4[2])
                for r in runs)
    sync64 = train[0]["sync_steps"]["float64"]
    checks.update({
        "host gathers exact (the gloo host group beside NCCL)": all(
            r["gathers"]["exact"] for r in train),
        "classifier fp64: gradients and running statistics within 1e-4 "
        "relative L2 of one process": (sync64["grad_rel_l2"] <= 1e-4
                                       and sync64["stats_rel_l2"] <= 1e-4),
        "classifier fp64: replicas equal": all(
            r["sync_steps"]["float64"]["grads_equal"]
            and r["sync_steps"]["float64"]["stats_equal"] for r in train),
        "avsync_train: replicas (and statistics) equal after each step": all(
            r["sync"]["replicas_equal"] == [True, True] for r in train),
        "avsync_train: evaluate is the ranks' batch-weighted mean": all(
            r["sync"]["evaluate_matches"] and r["sync"]["evaluated"] == 1
            for r in train),
        "avsync_train: metrics equal on every rank": all(
            r["sync"]["metrics"] == train[0]["sync"]["metrics"]
            for r in train) and all(math.isfinite(v) for m in train[0][
                "sync"]["metrics"] for v in m.values())})
    return checks


def _gib(b):
    return None if b is None else round(b / 2 ** 30, 3)


def phase_cards(report):
    """Phase 14: the meshes of phases 11 and 12 on CARD_RANKS cards, one a
    rank, over NCCL (the ranks see every card; multihost.local_layout
    gives rank r NCCL and cuda:r).  One process's generation references
    first, on the first card; then one group generates at data 4, seq 4
    and data 2 x seq 2 in bf16 and fp32 (phase 12's gates); one runs
    animation_train for 3 steps at data 4, fsdp 4 and data 2 x fsdp 2,
    the fp64 classifier step against one process and avsync_train +
    evaluate; a fresh group resumes fsdp 4's checkpoint-2 at fsdp 4 and at
    fsdp 1.  Returns the launches of generation and of training, summed
    over the ranks."""
    import torch
    count = torch.cuda.device_count()
    if count < CARD_RANKS:
        fail(f"phase 14 needs {CARD_RANKS} visible CUDA cards; this machine "
             f"shows {count}")
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    refs = _one_process_references(CARD_GEN_CASES)
    torch.cuda.empty_cache()
    ref_s = time.perf_counter() - t_phase
    os.environ["WANDB_MODE"] = "disabled"
    with tempfile.TemporaryDirectory() as tmp:
        spec = {"gen_cases": CARD_GEN_CASES, "sync_dtypes": ["float64"],
                "one_card": True,
                "drop_ckpts": [n for n in CARD_TRAIN_RUNS if n != "fsdp4"],
                **_animation_yamls(tmp, list(CARD_TRAIN_RUNS)
                                   + list(CARD_RESUMES))}

        def edit_sync(raw):
            raw["exp"]["output_dir"] = os.path.join(tmp, "sync")
        spec["sync"] = _job_yaml(SYNC_YAML, tmp, "sync_cards", edit_sync)
        with open(os.path.join(tmp, "spec.json"), "w") as f:
            json.dump(spec, f)
        gen, gen_s = _run_ranks("cards_gen", tmp, 14, CARD_RANKS)
        checks, numbers = _gen_checks(tmp, refs, gen, CARD_GEN_CASES)
        train, train_s = _run_ranks("cards_train", tmp, 14, CARD_RANKS)
        for name in CARD_RESUMES:
            ckpts = os.path.join(tmp, name, "ckpts")
            os.makedirs(ckpts)
            os.symlink(os.path.join(tmp, "fsdp4", "ckpts", "checkpoint-2"),
                       os.path.join(ckpts, "checkpoint-2"))
        resumed, resumed_s = _run_ranks("cards_resume", tmp, 14, CARD_RANKS)
    checks.update(_cards_checks(gen, train, resumed))
    seconds = time.perf_counter() - t_phase
    gen_rows = {f"{c}_{d}": [r["generation"][f"{c}_{d}"] for r in gen]
                for c in CARD_GEN_CASES for d in ("bfloat16", "float32")}
    runs = list(CARD_TRAIN_RUNS) + list(CARD_RESUMES)
    by_run = {n: [r[n] for r in (train if n in CARD_TRAIN_RUNS else resumed)]
              for n in runs}
    launches = {
        "generation": {k: sum(r["launches_all"][k] for rows in
                              gen_rows.values() for r in rows)
                       for k in gen_rows["data4_bfloat16"][0][
                           "launches_all"]},
        "training": {k: sum(r["launches"][k] for n in runs
                            for r in by_run[n])
                     for k in train[0]["data4"]["launches"]}}
    fsdp4, data4 = by_run["fsdp4"][0]["losses"], by_run["data4"][0]["losses"]
    phase11 = report.get("ranks", {}).get("animation", {})
    phase12 = report.get("parallel_gen_fsdp", {})
    out = dict(
        seconds=seconds, reference_seconds=ref_s,
        group_seconds=dict(gen=gen_s, train=train_s, resume=resumed_s),
        ranks={job: [{k: r[k] for k in ("rank", "backend", "device",
                                          "current_device", "nccl")}
                     for r in rows]
               for job, rows in (("gen", gen), ("train", train),
                                 ("resume", resumed))},
        checks=checks, generation=numbers,
        generation_ranks=_generation_ranks(gen_rows),
        one_card_seconds_per_request={
            d: [round(r["generation"][f"one_card_{d}"], 3) for r in gen]
            for d in ("bfloat16", "float32")},
        training={n: dict(
            fsdp=rows[0]["fsdp"], losses=rows[0]["losses"],
            split_parameters=[rows[0]["split_parameters"],
                              rows[0]["parameters"]],
            seconds_per_step=[r["seconds_per_step"] for r in rows],
            save_seconds=rows[0]["save_seconds"],
            peak_bytes=[r["peak"] for r in rows], peaks=rows[0]["peaks"],
            comms=rows[0]["comms"]) for n, rows in by_run.items()},
        fsdp_losses_bit_equal_to_data4={
            n: by_run[n][0]["losses"] == data4 for n in CARD_TRAIN_RUNS},
        resumes_bit_equal_to_fsdp4={
            n: by_run[n][0]["losses"] == fsdp4[2:] for n in CARD_RESUMES},
        classifier=train[0]["sync_steps"]["float64"],
        sync=dict(metrics=train[0]["sync"]["metrics"],
                  evaluate=train[0]["sync"]["evaluate"],
                  seconds_after_first_step=[
                      r["sync"]["seconds_after_first_step"] for r in train]),
        gloo_one_card=dict(
            phase11_seconds_per_step=phase11.get("seconds_per_step"),
            phase11_allreduce_seconds=phase11.get("allreduce_seconds"),
            phase12_fsdp2_seconds_per_step=phase12.get("fsdp", {}).get(
                "seconds_per_step"),
            phase4_seconds_per_clip=report.get("pipeline", {}).get(
                "seconds_per_clip")),
        launches=launches)
    report["cards"] = out
    log(f"  phase {seconds:.1f} s (one-process references {ref_s:.1f} s, "
        f"groups {gen_s:.1f} + {train_s:.1f} + {resumed_s:.1f} s)")
    for job, rows in out["ranks"].items():
        log(f"  {job} ranks (rank, backend, device, current card, NCCL): "
            f"{[tuple(r.values()) for r in rows]}")
    _log_generation(out["generation_ranks"])
    log(f"  one clip's request without a mesh, each rank on its own card "
        f"(s): {out['one_card_seconds_per_request']}")
    log(f"  generation gates' numbers {numbers}")
    for n, t in out["training"].items():
        log(f"  {n} (fsdp {t['fsdp']}): losses {t['losses']!r}; seconds per "
            f"step after the first {t['seconds_per_step']} (saves "
            f"{t['save_seconds']} s excluded); peak per rank "
            f"(GiB) {[_gib(b) for b in t['peak_bytes']]}; "
            f"{t['split_parameters'][0]} of {t['split_parameters'][1]} "
            "parameters split")
        _log_comms(t["comms"])
    log(f"  losses bit-equal to data 4's: "
        f"{out['fsdp_losses_bit_equal_to_data4']}; resumed step-3 losses "
        f"bit-equal to fsdp 4's: {out['resumes_bit_equal_to_fsdp4']}")
    c = out["classifier"]
    log(f"  classifier fp64, 1 item a rank vs one process on "
        f"{CARD_RANKS}: gradients {c['grad_rel_l2']:.3e}, running statistics"
        f" {c['stats_rel_l2']:.3e}; avsync_train: metrics "
        f"{out['sync']['metrics']}; evaluate {out['sync']['evaluate']}; "
        f"seconds after the first step "
        f"{out['sync']['seconds_after_first_step']}")
    log(f"  on one card over gloo: {out['gloo_one_card']}")
    log(f"  gates: {checks}; launches {launches}")
    if not all(checks.values()):
        fail(f"phase 14: {[k for k, v in checks.items() if not v]}")
    gl, tl = launches["generation"], launches["training"]
    if not (gl["B2"] > 0 and gl["B3"] > 0 and gl["B1"] == 0
            and tl["B1"] > 0 and tl["B3"] > 0 and tl["B4"] > 0
            and tl["B5"] > 0 and tl["B2"] == 0 and tl["B6"] == 0):
        fail(f"phase 14 launches: {launches}")
    return launches


# ------------------------------------------------------------ phase 15 ---

WEIGHTS_SEED = 0       # fabricate's seed for the full-size tree


@contextlib.contextmanager
def _timed_builds(seconds):
    """Record the seconds of each module build (and its load from files)
    inside load_animation_pipeline, the card synchronised after each."""
    from asva_tpu_torch import runtime
    names = {"build_unet": "unet", "build_vae": "vae",
             "build_audio_encoder": "audio_encoder",
             "load_null_text_encoding": "null_text_encoding"}
    saved = {n: getattr(runtime, n) for n in names}

    def timed(name, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            _sync()
            seconds[names[name]] = time.perf_counter() - t0
            return out
        return call
    for n, fn in saved.items():
        setattr(runtime, n, timed(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(runtime, n, fn)


def _request15(pipe, size=256):
    """Phase 4's first request (seed 101: a 256x256 image, 2 s of audio,
    77 text tokens; DDIM 5, audio guidance 4.0) through `pipe`."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(101)
    image = torch.rand((1, size, size, 3), generator=g, device=DEVICE)
    wave = torch.randn((1, 32000), generator=g, device=DEVICE) * 0.1
    text = torch.randn((1, TEXT_TOKENS, 768), generator=g, device=DEVICE)
    mels = pipe.encode_audio_waveform([wave])
    video = pipe(image, mels, text, video_length=F, num_inference_steps=5,
                 sampler="ddim", audio_guidance_scale=4.0,
                 text_guidance_scale=1.0,
                 generator=torch.Generator(device=DEVICE).manual_seed(101))
    _sync()
    return video, mels


def _features15(models, video, mels, ids):
    """Every feature the metric bundle computes on one clip, in fp32."""
    from asva_tpu_torch.data.transforms import (clip_frame_transform,
                                                fid_frame_transform,
                                                fvd_frame_transform)
    f = video.shape[1]
    frames = clip_frame_transform(video).flatten(0, 1)
    return {"fid": models.fid_features(fid_frame_transform(video)
                                       .flatten(0, 1)),
            "fvd": models.fvd_features(fvd_frame_transform(video)),
            "avsync": models.avsync_score(mels, clip_frame_transform(video)),
            "ia": models.ia_sim(frames, mels.repeat_interleave(f, dim=0)),
            "it": models.it_sim(frames, ids.repeat_interleave(f, dim=0))}


def phase_weights(report):
    """Phase 15: the real-weights path at full size from files that
    asva_tpu_torch.tools.fabricate writes in the published formats.  Returns
    {"request": launches of the request from files, "train": launches of
    the training step from the graft}."""
    import dataclasses

    import torch
    from asva_tpu_torch.config import AnimationJobConfig
    from asva_tpu_torch.diffusion.schedules import DiffusionSchedule
    from asva_tpu_torch.eval.harness import eval_models_from_nets
    from asva_tpu_torch.pipelines.animation import AnimationPipeline
    from asva_tpu_torch.runtime import build_unet, load_animation_pipeline
    from asva_tpu_torch.scripts import animation_eval, animation_train
    from asva_tpu_torch.tools import fabricate as fab
    from asva_tpu_torch.tools import validate_weights
    from asva_tpu_torch.training.optim import TRAINABLE_SEGMENTS
    os.environ["WANDB_MODE"] = "disabled"
    cudnn_was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # the clips compare bit for bit
    cfgs = fab.configs(True)
    out, checks = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "artifacts")
        # 1. the tree
        tree = fab.fabricate(root, full=True, seed=WEIGHTS_SEED,
                             device=DEVICE)
        out["fabricate"] = dict(bytes=tree["bytes"],
                                total_bytes=sum(tree["bytes"].values()),
                                seconds=tree["seconds"])
        log(f"  fabricate: {out['fabricate']['total_bytes']} bytes in "
            f"{tree['seconds']:.1f} s: {tree['bytes']}")
        mods = tree["checkpoint_modules_dir"]
        sd = os.path.join(root, fab.SD)
        null = os.path.join(root, fab.PATHS["null_text_encoding"])

        # 2. the gate, in-process, on the card
        t0 = time.perf_counter()
        code, results = validate_weights.run([
            "--root", root, "--checkpoint_modules_dir", mods,
            "--avsync_modules_dir", tree["avsync_modules_dir"],
            "--avid_cma_path", tree["avid_cma_path"], "--device", DEVICE])
        i3d = next(r for r in results if r["label"] == "fvd_i3d")
        out["gate"] = dict(code=code, seconds=time.perf_counter() - t0,
                           results=results)
        checks["gate_13_pass"] = (code == 0 and len(results) == 13 and all(
            r["status"] == validate_weights.PASS for r in results))
        checks["gate_i3d_eps"] = i3d.get("bn_eps") == fab.I3D_EPS
        log(f"  gate: exit {code} in {out['gate']['seconds']:.1f} s; "
            f"{sum(r['status'] == 'PASS' for r in results)} of "
            f"{len(results)} PASS; I3D eps {i3d.get('bn_eps')}")

        # 3. the pipeline from files, bf16: one request, beside the seeded
        # modules the files were written from, cast as the loader casts
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        load_s = {}
        t0 = time.perf_counter()
        with _timed_builds(load_s):
            pipe = load_animation_pipeline(
                checkpoint_modules_dir=mods, sd_root=sd,
                null_text_encoding_path=null, n_segment=cfgs["n_segment"],
                device=DEVICE, dtype=torch.bfloat16,
                vae_config=cfgs["vae"])
            _sync()
        load_total = time.perf_counter() - t0
        reset_counts()
        t0 = time.perf_counter()
        video, mels = _request15(pipe)
        first_s = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        del pipe
        torch.cuda.empty_cache()
        ref = AnimationPipeline(
            **{k: fab.build(k, True, DEVICE, WEIGHTS_SEED, torch.bfloat16)
               for k in ("unet", "vae", "audio_encoder")},
            schedule=DiffusionSchedule(),
            null_text_encoding=fab.build("null_text_encoding", True,
                                         DEVICE, WEIGHTS_SEED).float()
            .reshape(1, 77, 768).to(DEVICE))
        want, _ = _request15(ref)
        del ref
        torch.cuda.empty_cache()
        out["request"] = dict(
            load_seconds=load_s, load_seconds_total=load_total,
            first_request_seconds=first_s,
            time_to_first_clip=load_total + first_s,
            max_memory_allocated=peak, launches=counts,
            shape=list(video.shape),
            max_abs_diff_to_seeded=(video.float() - want.float()).abs()
            .max().item())
        checks["clip_equal_to_seeded"] = bool(torch.equal(video, want))
        checks["clip_finite"] = bool(torch.isfinite(video).all())
        checks["request_b2_b3_80"] = counts["B2"] == counts["B3"] == 80
        log(f"  pipeline from files: load seconds {load_s} (sum "
            f"{load_total:.2f} s); first request {first_s:.2f} s; time to "
            f"the first clip {load_total + first_s:.2f} s; "
            f"max_memory_allocated {peak / 2**30:.2f} GiB; clip "
            f"torch.equal to the seeded modules' "
            f"{checks['clip_equal_to_seeded']}; B2 {counts['B2']} B3 "
            f"{counts['B3']}")

        # 4. the 2D graft: file tensors in, _temp/_audio at their seeded
        # init; then the fine-tuner's first step from it
        flat = torch.load(os.path.join(root, fab.PATHS["sd15_unet"]),
                          map_location=DEVICE, weights_only=True)
        t0 = time.perf_counter()
        graft = load_animation_pipeline(
            sd_root=sd, n_segment=cfgs["n_segment"], device=DEVICE,
            dtype=torch.float32, unet_config=cfgs["unet"],
            vae_config=cfgs["vae"]).unet
        _sync()
        graft_s = time.perf_counter() - t0
        seeded = build_unet(cfgs["unet"], DEVICE, torch.float32, seed=0)
        own, init = graft.state_dict(), seeded.state_dict()
        trainable = {k for k in own if TRAINABLE_SEGMENTS & set(k.split("."))}
        checks["graft_2d_equal_file"] = set(own) - trainable == set(flat) \
            and all(torch.equal(own[k], flat[k]) for k in flat)
        checks["graft_temp_audio_seeded"] = bool(trainable) and all(
            torch.equal(own[k], init[k]) for k in trainable)
        del graft, seeded, own, init
        torch.cuda.empty_cache()

        def edit(raw):
            raw["exp"]["output_dir"] = os.path.join(tmp, "train")
            raw["model"]["unet"]["pretrained_model_name_or_path"] = sd
            raw["model"]["vae"]["pretrained_model_name_or_path"] = sd
            raw["optim"]["checkpointing_steps"] = 1000
        cfg = AnimationJobConfig.from_yaml(
            _job_yaml(ANIMATION_YAML, tmp, "weights", edit))
        cfg = dataclasses.replace(cfg, null_text_encoding_path=null)
        items = cfg.batch_size * cfg.optim.gradient_accumulation_steps
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        run = animation_train.train(
            cfg, ChipClips(items, cfg.dataset, cfg.seed), DEVICE, 1)
        _sync()
        train_s = time.perf_counter() - t0
        train_counts = read_counts()
        unet = run["state"].unet.state_dict()
        frozen_kept = all(torch.equal(unet[k], flat[k].to(unet[k].dtype))
                          for k in flat)
        changed = sum(not torch.equal(unet[k].float(), v)
                      for k, v in build_unet(
                          cfgs["unet"], DEVICE, torch.float32, seed=0)
                      .state_dict().items() if k in trainable)
        loss = run["losses"][-1]
        out["train"] = dict(graft_load_seconds=graft_s, loss=loss,
                            seconds_with_save=train_s,
                            trainable_changed=changed,
                            trainable=len(trainable),
                            max_memory_allocated=
                            torch.cuda.max_memory_allocated(),
                            launches=train_counts)
        checks["train_loss_finite"] = math.isfinite(loss)
        checks["train_frozen_equal_file"] = frozen_kept
        checks["train_launches"] = (
            train_counts["B1"] > 0 and train_counts["B3"] > 0
            and train_counts["B4"] > 0 and train_counts["B5"] > 0
            and train_counts["B2"] == 0)
        del run, unet, flat
        torch.cuda.empty_cache()
        log(f"  graft: {graft_s:.1f} s; 2D tensors equal the file's "
            f"{checks['graft_2d_equal_file']}; {len(trainable)} "
            f"_temp/_audio tensors at their seeded init "
            f"{checks['graft_temp_audio_seeded']}; one animation_train step "
            f"from it: loss {loss!r}, {train_s:.1f} s with the final save, "
            f"frozen tensors still the file's {frozen_kept}, {changed} of "
            f"{len(trainable)} trainable tensors changed; launches "
            f"{train_counts}")

        # 5. the judge from files against the same nets built seeded
        args = animation_eval.parser().parse_args([
            "--exp_root", tmp, "--checkpoint", "0", "--pretrained_root",
            os.path.join(root, "pretrained"), "--avsync_checkpoint",
            tree["avsync_modules_dir"], "--eval_fid", "--eval_fvd",
            "--eval_clipsim", "--eval_relsync", "--eval_alignsync",
            "--device", DEVICE])
        t0 = time.perf_counter()
        models = animation_eval.build_eval_models(args)
        _sync()
        judge_s = time.perf_counter() - t0
        ids = _prompt_ids(1501, 6)
        clip = video.float()
        got = _features15(models, clip, mels.float(), ids)
        random_nets, prov = models.random_nets, models.provenance
        del models
        nets = {k: fab.build(name, True, DEVICE, WEIGHTS_SEED) for k, name in (
            ("fid_net", "fid_inception_v3"), ("i3d_net", "fvd_i3d"),
            ("classifier", "avsync_classifier"),
            ("vision", "imagebind_vision"), ("audio", "imagebind_audio"),
            ("text", "imagebind_text"))}
        want = _features15(eval_models_from_nets(DEVICE, **nets), clip,
                           mels.float(), ids)
        del nets
        out["judge"] = dict(
            load_seconds=judge_s, random_nets=random_nets,
            provenance=prov,
            max_abs_diff={k: (got[k] - want[k]).abs().max().item()
                          for k in got},
            finite={k: bool(torch.isfinite(v).all()) for k, v in got.items()})
        checks["judge_no_random_net"] = random_nets == []
        checks["judge_i3d_eps"] = prov.get("I3D_BN_EPS") == fab.I3D_EPS
        checks["judge_features_equal"] = all(torch.equal(got[k], want[k])
                                             for k in got)
        checks["judge_finite"] = all(out["judge"]["finite"].values())
        log(f"  judge from files: {judge_s:.1f} s; random nets "
            f"{random_nets}; I3D eps {prov.get('I3D_BN_EPS')} "
            f"({prov.get('I3D_BN_EPS_SOURCE')}); fp32 features equal the "
            f"seeded nets' {checks['judge_features_equal']} (max |diff| "
            f"{out['judge']['max_abs_diff']})")
    torch.backends.cudnn.deterministic = cudnn_was
    out["checks"] = checks
    out["card"] = report.get("card")
    report["weights"] = out
    log(f"  phase 15 on {report.get('card')}: checks {checks}")
    if not all(checks.values()):
        fail(f"phase 15 checks: {checks}")
    return {"request": counts, "train": train_counts}


# ------------------------------------------------------------ phase 16 ---

GHITS_YAML = "configs/audio-cond_animation/thegreatesthits_audio-cond_cfg.yaml"
RECT_SIZE = (128, 256)          # TheGreatestHits' (h, w) frames
# 128x256's latent levels (16x32): tokens and channels of each attention
RECT_LEVELS = {"16x32": (512, 320), "8x16": (128, 640), "4x8": (32, 1280),
               "2x4": (8, 1280)}
RECT_CLIPS = 3                  # the recipe's clips a video
RECT_B = 2 * RECT_CLIPS         # UNet rows of a request under audio CFG
RECT_TRAIN_B = 16               # the YAML's batch_size
RECT_STEPS = 50                 # animation_gen's PLMS default
# the cases whose bf16 times go into the kernels line
RECT_TIMED_CASE = {"B1": "rect train attn1 16x32", "B2": "rect attn3 16x32",
                   "B3": "rect ff 16x32", "B4": "rect attn1 16x32",
                   "B5": "rect attn1 16x32"}
RECT_TRAIN_TIMED_CASE = {"B3": "rect train ff 16x32"}


def rect_kernels(report):
    """Phase 16 (a): B1-B5 at TheGreatestHits' shapes against their plain
    versions in fp32 and bf16, under phase 2's gates and gradient checks:
    B2 and B3 at every level of a request (3 clips under audio CFG: 6 rows
    of 12 frames), B1 and B3 at every level of a training batch of 16, B4
    and B5 at its attention shapes.  The bf16 rows are timed."""
    import torch
    gen = torch.Generator(device=DEVICE).manual_seed(1616)
    every = tuple(RECT_LEVELS)
    rows = []
    for dtype in (torch.float32, torch.bfloat16):
        dname = str(dtype).split(".")[-1]
        for make in (lambda: kernel_cases(
                         gen, dtype, RECT_LEVELS, RECT_B, RECT_TRAIN_B,
                         "rect ", every, (("train ", every),)),
                     lambda: flash_cases(gen, dtype, RECT_LEVELS,
                                         RECT_TRAIN_B, "rect ")):
            cases = make()
            while cases:                 # each case's tensors freed after it
                kernel, label, wrapper, args, plain, flops = cases.pop(0)
                rows.append(kernel_row(kernel, label, wrapper, args, plain,
                                       flops, (), dname,
                                       timed=dname == "bfloat16"))
                del args
            torch.cuda.empty_cache()
    bad = [(r["kernel"], r["dtype"], r["case"]) for r in rows if not r["ok"]]
    report["kernels"] = rows
    if bad:
        fail(f"phase 16: {len(bad)} kernel comparisons out of tolerance at "
             f"128x256's shapes: {bad}")
    return rows


def rect_request(report, tmp):
    """Phase 16 (b): the recipe's request.  generate_videos from a 4:3 PNG
    and a wav at image_size (128, 256), 3 clips batched, PLMS 50, audio
    guidance 4.0, text guidance 1.0, on seeded full-size weights in bf16
    and fp32, each also through the plain sub-layers.  Returns (the bf16
    request's launches, its frames (3, 12, 128, 256, 3) uint8, the clips'
    waveforms)."""
    import numpy as np
    import torch
    from asva_tpu_torch.diffusion.samplers import plms_plan
    from asva_tpu_torch.diffusion.schedules import DiffusionSchedule
    from asva_tpu_torch.pipelines.generate import load_audio_clips_uniformly
    from asva_tpu_torch.runtime import load_animation_pipeline
    image_path, audio_path = _write_conditioning(tmp, (480, 640))
    text = torch.randn((TEXT_TOKENS, 768), generator=_gen(1601),
                       device=DEVICE)
    kw = dict(image_path=image_path, audio_path=audio_path,
              category_text_encoding=text, image_size=RECT_SIZE,
              video_fps=6, video_num_frame=F, num_clips_per_video=RECT_CLIPS,
              num_inference_steps=RECT_STEPS, sampler="plms",
              audio_guidance_scale=4.0, text_guidance_scale=1.0, seed=0)
    null_text = torch.randn((1, TEXT_TOKENS, 768), device=DEVICE,
                            generator=_gen(100))
    runs, seconds, counts, calls, peaks = {}, {}, {}, {}, {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = str(dtype).split(".")[-1]
        pipe = load_animation_pipeline(device=DEVICE, dtype=dtype, seed=0,
                                       randomize_all=True,
                                       null_text_encoding=null_text)
        n_audio, n_blocks = _unet_blocks(pipe.unet)
        for mode in ("kernels", "plain"):
            name = f"{dname} {mode}"
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            out, video, seconds[name], counts[name], calls[name] = _request(
                pipe, plain=mode == "plain", **kw)
            peaks[name] = torch.cuda.max_memory_allocated()
            runs[name] = (out, video)
            log(f"  request {name}: {seconds[name]:.2f} s "
                f"({seconds[name] / RECT_CLIPS:.3f} s a clip), {calls[name]} "
                f"UNet calls, peak {peaks[name] / 2**30:.2f} GiB, launches "
                f"{ {k: v for k, v in counts[name].items() if v} }")
        del pipe
        torch.cuda.empty_cache()
    waves = load_audio_clips_uniformly(audio_path, F / 6, RECT_CLIPS)

    n_iter = plms_plan(DiffusionSchedule(), RECT_STEPS).num_iterations
    shape_ok = all(
        len(out) == RECT_CLIPS and all(
            f.shape == (F,) + RECT_SIZE + (3,) and f.dtype == np.uint8
            and a.shape == (2, 32000) for f, a in out)
        and tuple(video.shape) == (RECT_CLIPS, F) + RECT_SIZE + (3,)
        and bool(torch.isfinite(video).all())
        for out, video in runs.values())
    counts_ok = all(
        calls[m] == n_iter
        and counts[m]["B2"] == (n_audio * n_iter if "kernels" in m else 0)
        and counts[m]["B3"] == (n_blocks * n_iter if "kernels" in m else 0)
        and counts[m]["B1"] == counts[m]["B6"] == 0 for m in runs)

    def frames(name):
        return np.stack([f for f, _ in runs[name][0]]).astype(np.int16)
    d32 = np.abs(frames("float32 kernels") - frames("float32 plain"))
    ref32 = runs["float32 plain"][1]

    def rel_rms(v):
        return ((v - ref32).norm() / ref32.norm()).item()
    gate = dict(fp32_max_levels=int(d32.max()),
                fp32_share_differing=float((d32 > 0).mean()),
                fp32_kernels_rel_rms=rel_rms(runs["float32 kernels"][1]),
                bf16_kernels_rel_rms=rel_rms(runs["bfloat16 kernels"][1]),
                bf16_plain_rel_rms=rel_rms(runs["bfloat16 plain"][1]))
    # phase 4's rules: fp32 within one uint8 level of the plain
    # sub-layers; bf16's relative RMS distance from the fp32 plain video
    # within 1.5x the plain bf16 version's
    gate_ok = (gate["fp32_max_levels"] <= 1
               and gate["bf16_kernels_rel_rms"]
               <= 1.5 * gate["bf16_plain_rel_rms"])
    out = dict(image_size=list(RECT_SIZE), clips=RECT_CLIPS, sampler="plms",
               steps=RECT_STEPS, unet_calls=calls, plan_iterations=n_iter,
               seconds=seconds, seconds_per_clip={
                   m: s / RECT_CLIPS for m, s in seconds.items()},
               max_memory_allocated=peaks, launches=counts,
               blocks=dict(audio=n_audio, all=n_blocks), gate=gate,
               shape_ok=shape_ok, counts_ok=counts_ok, gate_ok=gate_ok)
    report["request"] = out
    log(f"  request: {n_iter} UNet calls a request (PLMS {RECT_STEPS}), "
        f"B2 = {n_audio} x calls, B3 = {n_blocks} x calls; gates {gate}")
    if not (shape_ok and counts_ok and gate_ok):
        fail(f"phase 16 request: {out}")
    return counts["bfloat16 kernels"], frames("bfloat16 kernels"), waves


def _step_launches(unet, policy):
    """{B1, B3, B4, B5: launches of one batch's gradient step} with remat
    `policy` (None: no remat) at fuse_blocks=False: each attention
    sub-layer runs B1 (and B4 in it) and each transformer block B3 in the
    forward, and again where its level is rematerialised in full; B5 once
    an attention sub-layer."""
    from asva_tpu_torch.models.unet3d.model import remat_saves_at
    from asva_tpu_torch.models.unet3d.primitives import (CrossAttention,
                                                         FFSpatialAttention)
    from asva_tpu_torch.models.unet3d.transformer import (
        SpatioAudioTempTransformerBlock)
    top = len(unet.down_blocks) - 1
    units = (list(enumerate(unet.down_blocks)) + [(top, unet.mid_block)]
             + [(top - i, b) for i, b in enumerate(unet.up_blocks)])
    attn = ff = once = 0
    for level, block in units:
        saves = None if policy is None else remat_saves_at(policy, level)
        if saves not in (None, ()):
            fail(f"_step_launches counts no partial remat ({policy})")
        runs = 1 if saves is None else 2
        n_attn = sum(isinstance(m, (FFSpatialAttention, CrossAttention))
                     for m in block.modules())
        attn += runs * n_attn
        ff += runs * sum(isinstance(m, SpatioAudioTempTransformerBlock)
                         for m in block.modules())
        once += n_attn
    return {"B1": attn, "B4": attn, "B3": ff, "B5": once}


class ChipClipsOneEncoding(ChipClips):
    """ChipClips whose text encoding is TheGreatestHits' one tensor for
    every item (read by load_text_encoding_mapping from a .pt holding it
    alone, as AudioVideoDataset reads class_text_encoding_mapping_pt when
    class_mapping_json is empty)."""

    def __init__(self, n, dataset_cfg, seed):
        import numpy as np
        from asva_tpu_torch.data.datasets import load_text_encoding_mapping
        super().__init__(n, dataset_cfg, seed)
        enc = load_text_encoding_mapping(
            dataset_cfg.class_text_encoding_mapping_pt)
        if not isinstance(enc, np.ndarray):
            fail(f"the single-tensor encoding read as a {type(enc)}")
        self.encoding = enc.reshape(enc.shape[-2], enc.shape[-1])

    def __getitem__(self, index):
        item = super().__getitem__(index)
        item["text_encoding"] = self.encoding
        return item


def rect_train(report, tmp):
    """Phase 16 (c): animation_train.train from the TheGreatestHits YAML
    (batch 16 of 12x128x256, accumulation 1, remat as the YAML sets it) for
    3 steps on in-memory items with the single-tensor encoding, checkpoint-2
    kept; a run resumed from it takes step 3 bit for bit; an fp32 batch-1
    step against the plain sub-layers.  Returns the launches of the 3 + 1
    steps."""
    import shutil

    import torch
    from asva_tpu_torch.config import AnimationJobConfig
    from asva_tpu_torch.scripts import animation_train
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    enc_path = os.path.join(tmp, "class_clip_text_encodings.pt")
    torch.save(torch.randn((1, TEXT_TOKENS, 768), generator=torch.Generator(
        ).manual_seed(1602)), enc_path)

    def run(name):
        def edit(raw):
            raw["exp"].update(output_dir=os.path.join(tmp, name),
                              log_with=None)
            raw["train"]["log_steps"] = 1
            raw["train"]["dataset"].update(
                data_root=tmp, example_list_path=os.path.join(tmp, "none"),
                class_text_encoding_mapping_pt=enc_path)
            raw["optim"].update(checkpointing_steps=2,
                                checkpointing_milestones=2)
        cfg = AnimationJobConfig.from_yaml(_job_yaml(GHITS_YAML, tmp, name,
                                                     edit))
        n = cfg.batch_size * 3         # 3 steps of one batch
        _sync()
        reset_counts()
        t0 = time.perf_counter()
        res = animation_train.train(
            cfg, ChipClipsOneEncoding(n, cfg.dataset, cfg.seed), DEVICE, 3)
        _sync()
        return cfg, res, time.perf_counter() - t0, read_counts(), \
            CheckpointManager(os.path.join(tmp, name, "ckpts"))

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    marks = []
    with _timed_saves(marks):
        cfg, full, full_s, counts_full, mgr = run("uninterrupted")
    peak = torch.cuda.max_memory_allocated()
    state = full["state"]
    want = {n: p.detach().clone() for n, p in
            zip(state.optimizer.names, state.optimizer.params)}
    per_batch = _step_launches(state.unet, cfg.unet.remat_policy
                               if cfg.unet.remat else None)
    full_losses = full["losses"]
    del full, state
    os.makedirs(os.path.join(tmp, "resumed", "ckpts"))
    os.rename(mgr._path(2), os.path.join(tmp, "resumed", "ckpts",
                                         "checkpoint-2"))
    shutil.rmtree(os.path.join(tmp, "uninterrupted"))
    torch.cuda.empty_cache()
    _, resumed, resumed_s, counts_resumed, _ = run("resumed")
    state = resumed["state"]
    same = all(torch.equal(p, want[n]) for n, p in
               zip(state.optimizer.names, state.optimizer.params))
    d = cfg.dataset
    out = dict(yaml=GHITS_YAML, batch_size=cfg.batch_size,
               accumulation=cfg.optim.gradient_accumulation_steps,
               img_size=list(d.img_size), frames=d.video_num_frame,
               remat=cfg.unet.remat, remat_policy=cfg.unet.remat_policy,
               losses=full_losses, seconds_3_steps=full_s,
               # step 3 alone: from checkpoint-2's save to the card's
               # synchronisation before checkpoint-3's
               seconds_step3=marks[1][1] - marks[0][2],
               save_seconds=[round(m[2] - m[1], 3) for m in marks],
               max_memory_allocated=peak, resumed_from=resumed[
                   "resumed_from"], resumed_losses=resumed["losses"],
               resumed_seconds=resumed_s, params_equal=same,
               launches_uninterrupted=counts_full,
               launches_resumed=counts_resumed)
    log(f"  train: {GHITS_YAML} batch {cfg.batch_size} x accumulation "
        f"{out['accumulation']} of {d.video_num_frame} x {list(d.img_size)}, "
        f"remat {cfg.unet.remat} ({cfg.unet.remat_policy}); 3 steps in "
        f"{full_s:.1f} s with the builds and saves (step 3 "
        f"{out['seconds_step3']:.3f} s; saves {out['save_seconds']} s); "
        f"max_memory_allocated "
        f"{peak / 2**30:.2f} GiB; losses {full_losses}; resumed from "
        f"checkpoint-{resumed['resumed_from']} {resumed['losses']}; "
        f"parameters equal {same}")
    del resumed, state, want
    torch.cuda.empty_cache()
    ok = (cfg.batch_size == RECT_TRAIN_B and tuple(d.img_size) == RECT_SIZE
          and out["accumulation"] == 1 and cfg.unet.remat
          and len(full_losses) == 3
          and all(math.isfinite(x) for x in full_losses)
          and out["resumed_from"] == 2
          and out["resumed_losses"] == full_losses[2:] and same)
    counts = {k: counts_full[k] + counts_resumed[k] for k in counts_full}
    # the 3 + 1 steps of one batch each: B1 and K-gemm's q and out
    # projections once an attention sub-layer, B3 and the FF's two products
    # once a block, each again where remat recomputes its level
    want = {k: 4 * n for k, n in per_batch.items()}
    want.update({"KG.q": want["B1"], "KG.out": want["B1"],
                 "KG.ff1": want["B3"], "KG.ff2": want["B3"], "B2": 0,
                 "B6": 0})
    out["expected_launches"] = want
    counts_ok = all(counts[k] == n for k, n in want.items())
    if not (ok and counts_ok):
        fail(f"phase 16 train: {out}")

    # fp32 at batch 1 on 128x256 clips: phase 5's gates
    trainer, state, batch, _ = build_trainer(torch.float32, 1, RECT_SIZE)
    draws = trainer.draw(batch, _gen(1603))
    loss_k, grads_k = trainer.grad_step(state, batch, draws=draws)
    with plain_sublayers():
        loss_p, grads_p = trainer.grad_step(state, batch, draws=draws)
    worst = max(((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()
                for a, b in zip(grads_k, grads_p))
    loss_rel = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    out["fp32_batch1"] = dict(loss_kernels=loss_k.item(),
                              loss_plain=loss_p.item(), loss_rel=loss_rel,
                              worst_grad_rel_to_max=worst)
    log(f"  train: fp32 batch 1 at 128x256, kernels vs plain "
        f"{out['fp32_batch1']}")
    report["train"] = out
    del trainer, state, batch, grads_k, grads_p
    torch.cuda.empty_cache()
    if not (loss_rel <= 1e-4 and worst <= 2e-3):
        fail(f"phase 16 fp32 batch-1 step: {out['fp32_batch1']}")
    return counts


def rect_judge(report, frames, waves):
    """Phase 16 (d): evaluate_arrays on the request's three 128x256 clips
    against three seeded reference clips of the same size, with phase 6's
    five nets at their published sizes (phase 9's metric step and
    checks)."""
    metrics, seconds, ok = _judge_frames(frames, waves, 1604)
    report["judge"] = dict(metrics=metrics, seconds=seconds,
                           clip_shape=list(frames.shape), ok=ok)
    log(f"  judge: {list(frames.shape)} clips, metrics {metrics}; "
        f"evaluate_arrays {seconds:.2f} s")
    if not ok:
        fail(f"phase 16 judge: {report['judge']}")


def rect_kernel_entries(p16):
    """{kernel: its phase-16 fields for the kernels line}: the bf16 times
    of its timed 128x256 cases beside the plain version's, the bound and
    the SDPA yardstick, the worst error of its rows and its launches on
    phase 16's paths."""
    rows, out = p16["kernels"], {}
    for name, prefix in RECT_TIMED_CASE.items():
        mine = [r for r in rows if r["kernel"] == name]
        entry = time_fields(timed_row(mine, prefix))
        if name in RECT_TRAIN_TIMED_CASE:
            entry["train_shape"] = time_fields(timed_row(
                mine, RECT_TRAIN_TIMED_CASE[name]))
        entry["max_abs_err"] = max(r["max_abs_err"] for r in mine)
        entry["launches"] = {path: p16[path][name]
                             for path in ("request", "train")
                             if p16[path][name]}
        out[name] = entry
    return out


def phase_rect(report):
    """Phase 16: TheGreatestHits' rectangular configuration at full width.
    Returns {"kernels": its rows, "request": launches of the bf16 request,
    "train": launches of the 3 + 1 training steps}."""
    import torch
    os.environ["WANDB_MODE"] = "disabled"
    out = report["rect"] = {}
    parts = out["part_seconds"] = {}
    t0 = time.perf_counter()

    def part(name):
        nonlocal t0
        parts[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
    log("  (a) B1-B5 at 128x256's shapes")
    rows = rect_kernels(out)
    part("kernels")
    cudnn_was = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True   # the resume compares bits
    with tempfile.TemporaryDirectory() as tmp:
        log("  (b) the recipe's request: generate_videos, 3 clips, PLMS 50")
        request, frames, waves = rect_request(out, tmp)
        part("request")
        log("  (c) animation_train on the TheGreatestHits YAML, batch 16")
        train = rect_train(out, tmp)
        part("train")
    torch.backends.cudnn.deterministic = cudnn_was
    log("  (d) the judge on the three 128x256 clips")
    rect_judge(out, frames, waves)
    part("judge")
    log(f"  phase 16 seconds by part: "
        f"{ {k: round(v, 1) for k, v in parts.items()} }")
    return {"kernels": rows, "request": request, "train": train}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from asva_tpu_torch.ops import cuda_build  # fails outside the repo
    if RANK_FLAG in sys.argv[1:]:       # one rank of phase 11, 12 or 14
        at = sys.argv.index(RANK_FLAG)
        return rank_worker(sys.argv[at + 1], sys.argv[at + 2])
    cards = torch.cuda.device_count()
    if "--cards-only" in sys.argv[1:] and cards < CARD_RANKS:
        print(f"chip_smoke: --cards-only runs phase 14, which needs "
              f"{CARD_RANKS} visible CUDA cards; this machine shows {cards}",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {"torch": torch.__version__, "cuda": torch.version.cuda,
              "device": torch.cuda.get_device_name(0)}
    t_run = time.perf_counter()

    def stamp(msg):
        """A phase's header with the seconds since the start (the whole
        run must end within 1200 s), kept in the report."""
        at = time.perf_counter() - t_run
        report.setdefault("phase_started_s", []).append([msg, round(at, 1)])
        log(f"{msg} [{at:.0f} s in]")

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
    if "--remat-only" in sys.argv[1:]:
        log(f"phase 13 alone: the remat policies on {card}")
        phase_remat(report)
        with open(os.path.join(out_dir, "chip_smoke_remat.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(card)
        return 0
    if "--ranks-only" in sys.argv[1:]:
        log(f"phases 11-12 alone: training and generation across {RANKS} "
            f"processes on {card}")
        phase_ranks(report)
        log(f"phase 12: generation at data 2 and seq 2, FSDP at fsdp 2")
        phase_parallel_gen_fsdp(report)
        with open(os.path.join(out_dir, "chip_smoke_ranks.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(card)
        return 0
    if "--weights-only" in sys.argv[1:]:
        log(f"phase 15 alone: the real-weights path at full size on {card}")
        p15 = phase_weights(report)
        with open(os.path.join(out_dir, "chip_smoke_weights.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps({"phase15_launches": p15}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cards}}))
        return 0
    if "--rect-only" in sys.argv[1:]:
        log(f"phase 16 alone: TheGreatestHits' 128x256 configuration on "
            f"{card}")
        p16 = phase_rect(report)
        with open(os.path.join(out_dir, "chip_smoke_rect.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps({"phase16_launches": {
            "request": p16["request"], "train": p16["train"]},
            "phase16_kernels": rect_kernel_entries(p16)}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cards}}))
        return 0
    if "--cards-only" in sys.argv[1:]:
        log(f"phase 14 alone: the meshes across {CARD_RANKS} cards over NCCL"
            f" on {smi}")
        p14 = phase_cards(report)
        with open(os.path.join(out_dir, "chip_smoke_cards.json"), "w") as f:
            json.dump(report, f, indent=1)
        print(json.dumps({"phase14_launches": p14}))
        print(card)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cards}}))
        return 0

    stamp("phase 2: kernels vs plain")
    rows = phase_kernels(report)
    stamp("phase 3: ln=None modules, fused_ff_mix, unet")
    b6_count, b7_count = phase_attend(report)
    b1_counts = phase_unet(report)
    stamp("phase 4: pipeline")
    pipe_counts = phase_pipeline(report)
    stamp("phase 5: train")
    train_counts = phase_train(report)
    stamp("phase 6: judge")
    judge_counts = phase_judge(report)
    if pipe_counts["B6"] or train_counts["B6"] or judge_counts["B6"]:
        fail("generation or training launched B6: they go through B1-B5")
    stamp("phase 7: tools")
    tool_counts = phase_tools(report)
    stamp("phase 8: sync trainer")
    phase_sync(report)
    stamp("phase 9: generation and evaluation from files")
    batched_counts, per_clip_counts = phase_files(
        report, report["pipeline"]["seconds_per_clip"])
    stamp("phase 10: training and serving from the CLIs")
    cli_counts, serve_counts = phase_cli(report)
    stamp(f"phase 11: training across {RANKS} processes")
    rank_counts = phase_ranks(report)
    stamp("phase 12: generation at data 2 and seq 2, FSDP at fsdp 2")
    p12 = phase_parallel_gen_fsdp(report)
    stamp("phase 13: the remat policies")
    remat_counts = phase_remat(report)
    stamp("phase 15: the real-weights path at full size, from files")
    p15 = phase_weights(report)
    stamp("phase 16: TheGreatestHits' 128x256 configuration")
    p16 = phase_rect(report)
    p14 = None
    if cards >= CARD_RANKS:
        stamp(f"phase 14: the meshes across {CARD_RANKS} cards over NCCL")
        p14 = phase_cards(report)
    else:
        stamp(f"phase 14: not run: it needs {CARD_RANKS} visible CUDA cards "
            f"and this machine shows {cards}; on a machine with "
            f"{CARD_RANKS}, `python3 chip_smoke.py --cards-only` runs it "
            "(or this script runs it after phase 13)")

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
    for key in ("B1", "B3", "B4", "B5"):
        by_path[key]["animation_train CLI, 3 + 1 steps"] = cli_counts[key]
        by_path[key][f"animation_train, {RANKS} ranks, 3 + 1 steps"] = \
            rank_counts[key]
    for key in ("B2", "B3"):
        by_path[key]["serve warmup, 3 clips"] = serve_counts[key]
        by_path[key][f"generation, {RANKS} ranks at data 2 and seq 2"] = \
            p12["generation"][key]
    remat_path = "train under the 6 remat policies and full again, 2 steps"
    for key in ("B1", "B3", "B4", "B5"):
        by_path[key][f"animation_train fsdp 2, {RANKS} ranks, 3 + 2 x 1 "
                     "steps"] = p12["fsdp"][key]
        by_path[key][remat_path] = remat_counts[key]
    p15_paths = {"request": "phase 15: a request from the full-size files",
                 "train": "phase 15: animation_train, 1 step from the SD1.5 "
                          "graft"}
    for path, keys in (("request", ("B2", "B3")),
                       ("train", ("B1", "B3", "B4", "B5"))):
        for key in keys:
            by_path[key][p15_paths[path]] = p15[path][key]
    p16_paths = {"request": "phase 16: generate_videos at 128x256, 3 clips"
                            ", PLMS 50 (bf16)",
                 "train": "phase 16: animation_train on the TheGreatestHits "
                          "YAML, batch 16, 3 + 1 steps"}
    for path, keys in (("request", ("B2", "B3")),
                       ("train", ("B1", "B3", "B4", "B5"))):
        for key in keys:
            by_path[key][p16_paths[path]] = p16[path][key]
    p14_paths = {"generation": f"generation, {CARD_RANKS} cards at data 4, "
                               "seq 4 and data 2 x seq 2",
                 "training": f"animation_train, {CARD_RANKS} cards at data "
                             "4, fsdp 4, data 2 x fsdp 2, 3 + 2 x 1 steps"}
    for path, keys in (("generation", ("B2", "B3")),
                       ("training", ("B1", "B3", "B4", "B5"))):
        for key in keys:
            if p14 is not None:
                by_path[key][p14_paths[path]] = p14[path][key]
    for form in ("q", "out", "ff1", "ff2"):
        key = f"KG.{form}"
        by_path[key] = {"unet fuse_blocks=False": b1_counts[key],
                        "pipeline, 3 requests": pipe_counts[key],
                        "train, 4 steps": train_counts[key],
                        "judge, 3 requests": judge_counts[key],
                        "generate_videos, 3 clips batched":
                            batched_counts[key],
                        "generate_videos, 3 clips per clip":
                            per_clip_counts[key],
                        "animation_train CLI, 3 + 1 steps": cli_counts[key],
                        f"animation_train, {RANKS} ranks, 3 + 1 steps":
                            rank_counts[key],
                        "serve warmup, 3 clips": serve_counts[key],
                        f"generation, {RANKS} ranks at data 2 and seq 2":
                            p12["generation"][key],
                        f"animation_train fsdp 2, {RANKS} ranks, 3 + 2 x 1 "
                        "steps": p12["fsdp"][key],
                        remat_path: remat_counts[key]}
        for path, name in p15_paths.items():
            by_path[key][name] = p15[path][key]
        for path, name in p16_paths.items():
            by_path[key][name] = p16[path][key]
        if p14 is not None:
            for path, name in p14_paths.items():
                by_path[key][name] = p14[path][key]
    rect = rect_kernel_entries(p16)
    kernels = []
    for name, (replaces, tpu, sources) in KERNELS.items():
        mine = [r for r in rows if r["kernel"] == name
                and r.get("supported", True)]
        main = timed_row(mine, TIMED_CASE[name])
        err = max(r["max_abs_err"] for r in mine)
        entry = dict(
            name=name, route="cuda", source=sources[0], sources=sources,
            replaces=replaces, tpu=tpu, launches=sum(by_path[name].values()),
            launches_by_path=by_path[name], max_abs_err=err,
            **time_fields(main))
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
            train = timed_row(mine, TRAIN_TIMED_CASE[name])
            entry["train_shape"] = time_fields(train)
            if "matmul_ms" in train:
                entry["train_shape"].update(matmul_ms=train["matmul_ms"],
                                            tflops=train["tflops"])
        if name in rect:
            entry["rect_128x256"] = rect[name]
        kernels.append(entry)
    if any(n <= 0 for paths in by_path.values() for n in paths.values()):
        fail(f"a kernel was not launched on one of its paths: {by_path}")

    report["seconds"] = time.perf_counter() - t_run
    stamp("all phases passed")
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
