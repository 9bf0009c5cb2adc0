"""Single-pair sync metrics: avsync_score / RelSync for one generated video
against its audio (and a reference video or audio where required).  Port
of scripts/avsync_metric.py (the reference's avsync_metric CLI), plus
`--device`:

    python3 -m asva_tpu_torch.scripts.avsync_metric --video_path gen.mp4 \
        [--metric relsync --ref_video_path gt.mp4] [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from .common import add_device_flag


def load_video_frames(path, video_fps, num_frames, image_size):
    """(f, h, w, 3) [0, 1] frames of the file's first clip, its (c, T)
    audio and the audio's sample rate."""
    import numpy as np
    from ..data.media import MediaReader
    from ..data.transforms import sd_video_transform
    with MediaReader(path) as r:
        frames = r.read_video_clip(0.0, num_frames / video_fps, video_fps,
                                   num_frames)
        wav = r.read_audio(0.0, num_frames / video_fps)
        sr = r.audio_sample_rate
    video = sd_video_transform(frames.astype(np.float32) / 255.0, image_size,
                               normalize=False)
    return video, wav, sr


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--video_path", required=True)
    p.add_argument("--audio_path", default=None,
                   help="defaults to the video's own audio track")
    p.add_argument("--ref_video_path", default=None)
    p.add_argument("--ref_audio_path", default=None)
    p.add_argument("--metric", default="avsync_score",
                   choices=["avsync_score", "relsync", "alignsync"])
    p.add_argument("--checkpoint_modules_dir", default=None)
    p.add_argument("--video_fps", type=int, default=6)
    p.add_argument("--video_num_frame", type=int, default=12)
    add_device_flag(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)

    import torch
    from ..eval.metrics import compute_avsync_scores, compute_relsync
    from ..ops.mel import waveform_to_mel
    from ..ops.resample import resample
    from ..pipelines.generate import load_audio_clips_uniformly
    from ..runtime import build_avsync_classifier

    dev = args.device
    wd = None
    if args.checkpoint_modules_dir:
        wd = {m: os.path.join(args.checkpoint_modules_dir, m)
              for m in ("audio_encoder", "video_encoder", "head")}
    clf = build_avsync_classifier(wd, device=dev)

    def score_fn(mels, vids):
        with torch.no_grad():
            return clf(mels.to(dev), vids.to(dev))

    def mel_of(wav):
        return waveform_to_mel(torch.as_tensor(wav, device=dev))[None]

    clip_s = args.video_num_frame / args.video_fps
    video, wav, sr = load_video_frames(args.video_path, args.video_fps,
                                       args.video_num_frame, 256)
    if args.audio_path:
        wav16 = load_audio_clips_uniformly(args.audio_path, clip_s, 1)[0]
    else:
        # keep (c, T): the mel mean-centres over all channels first
        wav16 = resample(wav, sr, 16000)
    mel = mel_of(wav16)
    videos = torch.as_tensor(video, device=dev)[None]

    if args.metric == "avsync_score":
        out = compute_avsync_scores(score_fn, mel, videos)[0]
    elif args.metric == "relsync":
        assert args.ref_video_path or args.ref_audio_path
        if args.ref_video_path:
            ref_video, _, _ = load_video_frames(
                args.ref_video_path, args.video_fps, args.video_num_frame,
                256)
            out = compute_relsync(
                score_fn, mel, videos,
                ref_videos=torch.as_tensor(ref_video, device=dev)[None])[0]
        else:
            ref_wav = load_audio_clips_uniformly(args.ref_audio_path,
                                                 clip_s, 1)[0]
            out = compute_relsync(score_fn, mel, videos,
                                  ref_mels=mel_of(ref_wav))[0]
    else:
        raise SystemExit("alignsync additionally needs the ImageBind "
                         "towers; use asva_tpu_torch.scripts.animation_eval "
                         "--eval_alignsync for dataset-level AlignSync")
    print(f"{args.metric}: {float(out):.6f}")
    return float(out)


if __name__ == "__main__":
    main()
