"""The metric networks of the evaluation harness, as one bundle.

Port of the part of asva_tpu/eval/harness.py that reads no files: the
`EvalModels` bundle (:36-47) and `build_eval_models`, the counterpart of
scripts/animation_eval.py:53-206, which makes the five metric callables
from the port's modules:

  fid_features(frames (n, 229, 229, 3) in [-1, 1])           -> (n, 2048)
  fvd_features(videos (b, f, 224, 224, 3) in [-1, 1])        -> (b, 400)
  avsync_score(mels (b, 128, 204, 1), videos (b, f, 224, 224, 3) CLIP-
               normalised)                                   -> (b,)
  ia_sim(frames (n, 224, 224, 3) CLIP-normalised, mels (n, 128, 204, 1))
                                                             -> (n,)
  it_sim(frames (n, 224, 224, 3) CLIP-normalised, ids (n, 77)) -> (n,)

Each takes torch tensors or numpy arrays, runs on the bundle's device
without gradients and returns a float32 tensor there.  No released weights
ship with the repository, so every net is built from the seed and listed in
`random_nets`; the walk over a directory of generated clips
(`evaluate_generation_results`) follows with the media layer.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from ..models.evalnets import InceptionV3FID
from ..models.imagebind_audio import (ImageBindAudioConfig,
                                      ImageBindAudioEncoder)
from ..models.imagebind_extra import (ImageBindTextConfig,
                                      ImageBindTextEncoder,
                                      ImageBindVisionConfig,
                                      ImageBindVisionEncoder)
from ..runtime import (_RELU_GAIN, _build, build_avsync_classifier,
                       build_i3d_classifier)


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
    fid_net = _build(InceptionV3FID, seed=seed + 10, gain=_RELU_GAIN, **kw)
    i3d_net, _ = build_i3d_classifier(seed=seed + 11, **kw)
    clf = build_avsync_classifier(seed=seed + 12, **kw)
    vision = _build(lambda: ImageBindVisionEncoder(
        vision_config or ImageBindVisionConfig()), seed=seed + 13, **kw)
    audio = _build(lambda: ImageBindAudioEncoder(
        audio_config or ImageBindAudioConfig()), seed=seed + 14, **kw)
    text = _build(lambda: ImageBindTextEncoder(
        text_config or ImageBindTextConfig()), seed=seed + 15, **kw)

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
        fid_features=metric(fid_net), fvd_features=metric(i3d_net),
        avsync_score=metric(clf), ia_sim=metric(ia_sim),
        it_sim=metric(it_sim),
        random_nets=["fid_inception_v3", "fvd_i3d", "avsync_classifier",
                     "imagebind_vision", "imagebind_audio", "imagebind_text"],
        provenance={"I3D_BN_EPS": i3d_net.Mixed_3b.b0.bn.eps})
