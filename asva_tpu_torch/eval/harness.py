"""End-to-end generation evaluation (FID / FVD / IA / IT / RelSync /
AlignSync), port of asva_tpu/eval/harness.py (reference
avgen/evaluations/eval.py:28-279).

  * `EvalModels` (:36-47), the five metric callables, and
    `build_eval_models`, the counterpart of scripts/animation_eval.py:53-206,
    which makes them from the port's modules:

      fid_features(frames (n, 229, 229, 3) in [-1, 1])         -> (n, 2048)
      fvd_features(videos (b, f, 224, 224, 3) in [-1, 1])      -> (b, 400)
      avsync_score(mels (b, 128, 204, 1), videos (b, f, 224, 224, 3) CLIP-
                   normalised)                                 -> (b,)
      ia_sim(frames (n, 224, 224, 3) CLIP-normalised, mels (n, 128, 204, 1))
                                                               -> (n,)
      it_sim(frames (n, 224, 224, 3) CLIP-normalised, ids (n, 77)) -> (n,)

    Each takes torch tensors or numpy arrays, runs on the bundle's device
    without gradients and returns a float32 tensor there.  No released
    weights ship with the repository, so every net is built from the seed
    and listed in `random_nets`;
  * `evaluate_arrays`, the metric step on decoded clips: for every video
    the ground-truth clips (FID / FVD features, first-frame IA, AVSync
    scores) and then its generated clips, clip k paired with ground-truth
    clip k, each net ONE batched call per video; the reducers: Frechet
    distances (FID leaves out frame 0), IA / IT mean and std (ddof=1) over
    frames 1.., RelSync = the sigma-pair (gen, GT), AlignSync = align_prob x
    RelSync;
  * `evaluate_generation_results`, the walk over files: the GT videos
    (sorted), their `<stem>_clip-<k>.mp4` generated clips, the metric step,
    provenance and per-clip records, the JSON at `result_save_path`.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Callable, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..data.transforms import (clip_frame_transform, fid_frame_transform,
                               fvd_frame_transform)
from ..models.evalnets import InceptionV3FID
from ..models.imagebind_audio import (ImageBindAudioConfig,
                                      ImageBindAudioEncoder)
from ..models.imagebind_extra import (ImageBindTextConfig,
                                      ImageBindTextEncoder,
                                      ImageBindVisionConfig,
                                      ImageBindVisionEncoder)
from ..ops.mel import goldens_status, waveform_to_mel
from ..runtime import (_RELU_GAIN, _build, build_avsync_classifier,
                       build_i3d_classifier)
from .frechet import frechet_distance
from .metrics import alignsync_from_sims, relsync_from_scores


@dataclasses.dataclass
class EvalModels:
    """Metric callables; any may be None to skip its metric."""
    fid_features: Optional[Callable] = None
    fvd_features: Optional[Callable] = None
    avsync_score: Optional[Callable] = None
    ia_sim: Optional[Callable] = None
    it_sim: Optional[Callable] = None
    random_nets: List[str] = dataclasses.field(default_factory=list)
    # extra provenance entries recorded verbatim into a result
    provenance: dict = dataclasses.field(default_factory=dict)


def eval_models_from_nets(device, fid_net=None, i3d_net=None,
                          classifier=None, vision=None, audio=None,
                          text=None) -> EvalModels:
    """The metric callables of the nets given (ia_sim needs the vision and
    audio towers, it_sim the vision and text towers); `random_nets` and
    `provenance` are the caller's to fill."""
    def on(x):
        return torch.as_tensor(x).to(device)

    def metric(fn):
        def call(*args):
            with torch.no_grad():
                return fn(*(on(a) for a in args)).float()
        return call

    def ia_sim(frames, mels):
        v = vision(frames)
        a, _ = audio.encode(mels, normalize=True)
        return (v * (a / 20.0)).sum(dim=-1)  # de-scale the audio logit scale

    def it_sim(frames, ids):
        return (vision(frames) * text(ids)).sum(dim=-1)

    return EvalModels(
        fid_features=metric(fid_net) if fid_net is not None else None,
        fvd_features=metric(i3d_net) if i3d_net is not None else None,
        avsync_score=metric(classifier) if classifier is not None else None,
        ia_sim=(metric(ia_sim) if vision is not None and audio is not None
                else None),
        it_sim=(metric(it_sim) if vision is not None and text is not None
                else None))


def build_eval_models(device="cuda", dtype=torch.float32, seed: int = 0,
                      randomize_all: bool = False,
                      vision_config: Optional[ImageBindVisionConfig] = None,
                      text_config: Optional[ImageBindTextConfig] = None,
                      audio_config: Optional[ImageBindAudioConfig] = None
                      ) -> EvalModels:
    """The five metric callables at their published sizes (the ImageBind
    configs may be overridden, e.g. `tiny()`), with seeded random weights in
    `dtype` on `device`."""
    kw = dict(device=device, dtype=dtype, randomize_all=randomize_all)
    i3d_net, _ = build_i3d_classifier(seed=seed + 11, **kw)
    models = eval_models_from_nets(
        device,
        fid_net=_build(InceptionV3FID, seed=seed + 10, gain=_RELU_GAIN, **kw),
        i3d_net=i3d_net,
        classifier=build_avsync_classifier(seed=seed + 12, **kw),
        vision=_build(lambda: ImageBindVisionEncoder(
            vision_config or ImageBindVisionConfig()), seed=seed + 13, **kw),
        audio=_build(lambda: ImageBindAudioEncoder(
            audio_config or ImageBindAudioConfig()), seed=seed + 14, **kw),
        text=_build(lambda: ImageBindTextEncoder(
            text_config or ImageBindTextConfig()), seed=seed + 15, **kw))
    models.random_nets = ["fid_inception_v3", "fvd_i3d", "avsync_classifier",
                          "imagebind_vision", "imagebind_audio",
                          "imagebind_text"]
    models.provenance = {"I3D_BN_EPS": i3d_net.Mixed_3b.b0.bn.eps}
    return models


# ---------------------------------------------------------------------------
# the metric step on arrays
# ---------------------------------------------------------------------------

def _np(x) -> np.ndarray:
    """A net's output as a float32 host array."""
    if torch.is_tensor(x):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def _on(x, device):
    x = torch.as_tensor(x)
    return x if device is None else x.to(device)


def _features(models: EvalModels, videos, mels) -> dict:
    """FID / FVD features and AVSync scores of the k clips of one video."""
    k, f = videos.shape[:2]
    out = {}
    if models.fid_features is not None:
        flat = fid_frame_transform(videos).reshape((-1, 229, 229, 3))
        out["fid"] = _np(models.fid_features(flat)).reshape(k, f, -1)
    if models.fvd_features is not None:
        out["fvd"] = _np(models.fvd_features(fvd_frame_transform(videos)))
    if models.avsync_score is not None:
        out["sync"] = _np(models.avsync_score(
            mels, clip_frame_transform(videos)))             # (k,)
    return out


def ground_truth_features(models: EvalModels, videos, mels,
                          device=None) -> dict:
    """videos (k, f, h, w, 3) in [0, 1], mels (k, 128, 204, 1) of one
    ground-truth video's k clips -> its features (absent nets left out),
    with the first frame's IA."""
    videos, mels = _on(videos, device), _on(mels, device)
    out = _features(models, videos, mels)
    if models.ia_sim is not None:
        out["first_ia"] = _np(models.ia_sim(
            clip_frame_transform(videos[:, 0]), mels))       # (k,)
    return out


def generated_features(models: EvalModels, videos, mels, ids=None,
                       device=None) -> dict:
    """The generated clips of one video: (n, f, h, w, 3) in [0, 1] and
    their (n, 128, 204, 1) mels; `ids` (77,) the category's token ids for
    IT (None: no IT).  IA and IT are over frames 1.., per frame and per
    clip."""
    videos, mels = _on(videos, device), _on(mels, device)
    n, f = videos.shape[:2]
    out = _features(models, videos, mels)
    if models.ia_sim is not None or (models.it_sim is not None
                                     and ids is not None):
        frames = clip_frame_transform(videos.reshape((-1,) + videos.shape[2:]))
        if models.ia_sim is not None:
            sims = _np(models.ia_sim(frames, mels.repeat_interleave(
                f, dim=0))).reshape(n, f)
            out["ia_frames"] = sims[:, 1:]
            out["ia"] = sims[:, 1:].mean(axis=1)
        if models.it_sim is not None and ids is not None:
            ids = _on(ids, frames.device)
            ids_rep = ids[None].expand((n * f,) + tuple(ids.shape))
            its = _np(models.it_sim(frames, ids_rep)).reshape(n, f)
            out["it"] = its[:, 1:].mean(axis=1)
    return out


def evaluate_arrays(models: EvalModels, ground_truth: Iterable,
                    generated: Iterable, ids: Optional[List] = None,
                    device=None) -> Tuple[dict, dict]:
    """The metric step on decoded clips.  `ground_truth` and `generated`
    yield, video by video in the same order, (videos (k, f, h, w, 3) in
    [0, 1], mels (k, 128, 204, 1)); generated clip i of a video is paired
    with its ground-truth clip i.  `ids`: per video the (77,) token ids of
    its category for IT, or None.  Returns (the metric dict, the per-clip
    arrays 'RelSync', 'IA', 'AlignSync' that exist)."""
    gt = [ground_truth_features(models, v, m, device)
          for v, m in ground_truth]
    gen = [generated_features(models, v, m,
                              None if ids is None else ids[i], device)
           for i, (v, m) in enumerate(generated)]
    result, per_clip = {}, {}

    def cat(feats, key):
        return np.concatenate([x[key] for x in feats])

    if models.fid_features is not None:
        a, b = cat(gt, "fid")[:, 1:], cat(gen, "fid")[:, 1:]
        result["FID"] = frechet_distance(a.reshape(-1, a.shape[-1]),
                                         b.reshape(-1, b.shape[-1]))
    if models.fvd_features is not None:
        result["FVD"] = frechet_distance(cat(gt, "fvd"), cat(gen, "fvd"))
    if any("ia" in x for x in gen):
        ias = per_clip["IA"] = cat(gen, "ia")
        result.update(IA_mean=float(ias.mean()),
                      IA_std=float(ias.std(ddof=1)))
    if any("it" in x for x in gen):
        its = cat(gen, "it")
        result.update(IT_mean=float(its.mean()),
                      IT_std=float(its.std(ddof=1)))
    if models.avsync_score is not None:
        gt_s = np.concatenate([g["sync"][:len(x["sync"])]
                               for g, x in zip(gt, gen)])
        rel = per_clip["RelSync"] = relsync_from_scores(gt_s,
                                                        cat(gen, "sync"))
        result.update(RelSync_mean=float(rel.mean()),
                      RelSync_std=float(rel.std(ddof=1)))
        if models.ia_sim is not None:
            first = np.concatenate([g["first_ia"][:len(x["ia"])]
                                    for g, x in zip(gt, gen)])
            align = per_clip["AlignSync"] = alignsync_from_sims(
                first.reshape(-1, 1), cat(gen, "ia_frames"), rel)
            result.update(AlignSync_mean=float(align.mean()),
                          AlignSync_std=float(align.std(ddof=1)))
    return result, per_clip


# ---------------------------------------------------------------------------
# the walk over files
# ---------------------------------------------------------------------------

def generated_clip_paths(root: str, stem: str) -> List[Tuple[int, str]]:
    """Exact-name clip discovery: `<stem>_clip-<k>.mp4` full-matches only
    (the naming of pipelines/generate.py), sorted by the parsed clip index
    k, so that a stem that prefixes another (`dog_1`, `dog_10`) is never
    counted twice."""
    sub, base = os.path.split(stem)
    dirpath = os.path.join(root, sub) if sub else root
    pat = re.compile(re.escape(base) + r"_clip-(\d+)\.mp4")
    out = []
    if os.path.isdir(dirpath):
        for name in os.listdir(dirpath):
            m = pat.fullmatch(name)
            if m:
                out.append((int(m.group(1)), os.path.join(dirpath, name)))
    return sorted(out)


def load_av_clips_uniformly(video_path: str, video_fps: int,
                            video_num_frame: int,
                            image_size: Union[int, Tuple[int, int]],
                            num_clips: int):
    """(b, f, h, w, 3) [0, 1] videos and (b, 128, 204, 1) mels of clips
    spread uniformly over the file (reference avgen/data/utils.py:271-330):
    the clip sampling of pipelines.generate.load_av_clips_uniformly, whose
    zero-padded (c, T) waveforms are then turned into mels (pad, then
    mean-centre, as the reference's load-then-waveform2melspec order)."""
    from ..pipelines.generate import (load_av_clips_uniformly
                                      as _load_av_waves)
    videos, waves = _load_av_waves(video_path, video_fps, video_num_frame,
                                   image_size, num_clips)
    mels = [waveform_to_mel(torch.from_numpy(w)).numpy() for w in waves]
    return videos, np.stack(mels)


def evaluate_generation_results(
    models: EvalModels,
    groundtruth_video_root: str,
    groundtruth_video_names: List[str],
    groundtruth_categories: List[str],
    num_clips_per_video: int,
    generated_video_root: str,
    result_save_path: str,
    image_size: Union[int, Tuple[int, int]] = 256,
    video_fps: int = 6,
    video_num_frame: int = 12,
    text_ids_for_category: Optional[Callable] = None,
    record_instance_metrics: bool = False,
    device="cuda",
) -> dict:
    """Every metric the bundle has over a directory of generated clips;
    decoding on the host, the transforms and nets on `device`.  Writes the
    result as JSON to `result_save_path` and returns it."""
    names = sorted(groundtruth_video_names)
    cat_by_name = dict(zip(groundtruth_video_names, groundtruth_categories))

    # explicit (video, clip-index) pairing: generated clip k of a video is
    # compared with GT clip k (the reference indexes clips explicitly,
    # avgen/evaluations/eval.py:228-247)
    clips_by_name = {}
    for name in names:
        stem = name.replace(".mp4", "")
        clips = generated_clip_paths(generated_video_root, stem)
        assert len(clips) == num_clips_per_video, \
            f"{name}: {len(clips)} generated clips != {num_clips_per_video}"
        assert [k for k, _ in clips] == list(range(num_clips_per_video)), \
            f"{name}: clip indices {[k for k, _ in clips]}"
        clips_by_name[name] = clips

    result = {"groundtruth_video_root": groundtruth_video_root,
              "generated_video_root": generated_video_root,
              "num_clips_per_video": num_clips_per_video}
    if models.random_nets:
        result["RANDOM_WEIGHT_NETS"] = list(models.random_nets)
    # the provenance of the mel every audio-consuming metric saw
    result["MEL_PROVENANCE"] = goldens_status()
    result.update(models.provenance)

    def ground_truth():
        for name in names:
            yield load_av_clips_uniformly(
                os.path.join(groundtruth_video_root, name), video_fps,
                video_num_frame, image_size, num_clips_per_video)

    def generated():       # decoded per file, scored per video
        for name in names:
            decoded = [load_av_clips_uniformly(path, video_fps,
                                               video_num_frame, image_size, 1)
                       for _, path in clips_by_name[name]]
            yield (np.concatenate([v for v, _ in decoded]),
                   np.concatenate([m for _, m in decoded]))

    ids = None
    if models.it_sim is not None and text_ids_for_category:
        ids = [text_ids_for_category(cat_by_name[name]) for name in names]
    metrics, per_clip = evaluate_arrays(models, ground_truth(), generated(),
                                        ids, device)
    result.update(metrics)

    # per-clip records whenever ANY per-clip metric exists: the reference
    # records IA under eval_clipsim alone, independent of eval_relsync
    # (avgen/evaluations/eval.py:252-271)
    if record_instance_metrics and per_clip:
        inst = {}
        i = 0
        for name in names:
            for _, path in clips_by_name[name]:
                inst[os.path.basename(path)] = {
                    key: float(per_clip[key][i])
                    for key in ("RelSync", "IA", "AlignSync")
                    if key in per_clip}
                i += 1
        result["instance_metrics"] = inst

    os.makedirs(os.path.dirname(result_save_path) or ".", exist_ok=True)
    with open(result_save_path, "w") as f:
        json.dump(result, f, indent=4)
    return result
