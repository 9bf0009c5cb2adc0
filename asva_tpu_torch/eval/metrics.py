"""Synchronisation and CLIP-consistency metric formulas.

Port of asva_tpu/eval/metrics.py:
  avsync score : classifier logit on (mel, CLIP-normalised 224^2 video)
  RelSync      : softmax over [ref_score, gen_score] -> P(gen)
                 == exp(gen) / (exp(ref) + exp(gen))
  align_prob   : per predicted frame i >= 1, softmax over
                 [ia_sim(GT first frame), ia_sim(gen frame i)] -> P(gen),
                 averaged over frames
  AlignSync    : align_prob * RelSync
Videos and mels are torch tensors, preprocessed and scored on their device;
the reducers run in float64 on the host and return float32 numpy arrays, as
the JAX package's do.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..data.transforms import clip_frame_transform


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def compute_avsync_scores(score_fn: Callable, mels, videos) -> np.ndarray:
    """score_fn(mels, clip_videos) -> (b,); videos (b, f, h, w, 3) in [0, 1]
    are CLIP-preprocessed here (bicubic 224 + normalise)."""
    scores = score_fn(mels, clip_frame_transform(videos))
    return _host(scores).astype(np.float32)


def relsync_from_scores(ref_scores, gen_scores) -> np.ndarray:
    ref, gen = _host(ref_scores), _host(gen_scores)
    m = np.maximum(ref, gen)
    e_ref, e_gen = np.exp(ref - m), np.exp(gen - m)
    return (e_gen / (e_ref + e_gen)).astype(np.float32)


def compute_relsync(score_fn, mels, videos, ref_mels=None,
                    ref_videos=None) -> np.ndarray:
    if (ref_mels is None) == (ref_videos is None):
        raise ValueError("specify exactly one of ref_mels / ref_videos")
    gen = compute_avsync_scores(score_fn, mels, videos)
    if ref_mels is not None:
        ref = compute_avsync_scores(score_fn, ref_mels, videos)
    else:
        ref = compute_avsync_scores(score_fn, mels, ref_videos)
    return relsync_from_scores(ref, gen)


def alignsync_from_sims(gt_first_frame_ia, gen_frame_ias,
                        relsync) -> np.ndarray:
    """gt_first_frame_ia (b, 1), gen_frame_ias (b, f-1), relsync (b,)."""
    gt, gen = _host(gt_first_frame_ia), _host(gen_frame_ias)
    m = np.maximum(gt, gen)
    align_prob = (np.exp(gen - m)
                  / (np.exp(gt - m) + np.exp(gen - m))).mean(axis=1)
    return (align_prob * _host(relsync)).astype(np.float32)


def compute_alignsync(score_fn, ia_sim_fn, mels, videos,
                      ref_videos) -> np.ndarray:
    """Full AlignSync on (b, f, h, w, 3) [0, 1] videos.

    ia_sim_fn(frames (n, 224, 224, 3) CLIP-normalised, mels (n, ...)) -> (n,).
    Frame 0 is taken from the reference video (the conditioning frame)."""
    videos, ref_videos, mels = (torch.as_tensor(a)
                                for a in (videos, ref_videos, mels))
    b, f = videos.shape[:2]
    relsync = compute_relsync(score_fn, mels, videos, ref_videos=ref_videos)
    merged = torch.cat([ref_videos[:, 0:1], videos[:, 1:]], dim=1)
    frames = clip_frame_transform(merged)            # (b, f, 224, 224, 3)
    sims = _host(ia_sim_fn(frames.flatten(0, 1),
                           mels.repeat_interleave(f, dim=0))).reshape(b, f)
    return alignsync_from_sims(sims[:, 0:1], sims[:, 1:], relsync)
