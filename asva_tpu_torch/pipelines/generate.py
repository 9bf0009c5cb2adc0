"""Clip generation from files (port of asva_tpu/pipelines/generate.py;
reference generate_videos, pipeline_audio_cond_animation.py:378-551).

Loads the conditioning image and audio (PIL, scipy for `.wav`, the media
layer for mp4), runs the pipeline on its device with a per-clip re-seeded
generator (reference :432-433) or all clips in one call with
`broadcast_rng`, and returns uint8 frames or writes mp4 + AAC clips.
"""
from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..data.media import MediaReader, media_available, write_video
from ..data.transforms import sd_video_transform
from ..observability import span, traced
from ..ops.mel import waveform_to_mel
from ..ops.resample import resample

log = logging.getLogger(__name__)


def load_image(path: str, image_size=(256, 256)) -> np.ndarray:
    """(h, w, 3) float32 in [0, 1], SD-transformed."""
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return sd_video_transform(img[None], image_size, normalize=False)[0]


def _resample16k(wav: np.ndarray, sr: int) -> np.ndarray:
    return resample(np.asarray(wav, np.float32), sr, 16000).numpy()


def _clip_starts(duration: float, clip_duration: float,
                 num_clips: int) -> np.ndarray:
    """One clip: the centre; several: linspace(0, duration - clip, n)."""
    if num_clips == 1:
        return np.array([(duration - clip_duration) / 2.0])
    return np.linspace(0.0, duration - clip_duration, num_clips)


def load_audio_clips_uniformly(path: str, clip_duration: float,
                               num_clips: int) -> list:
    """List of (c, T) float32 16 kHz waveforms from a wav or an mp4.

    Channels are kept: the mel frontend mean-centres over ALL channels
    before taking channel 0 (waveform2melspec semantics, ops/mel.py), so
    slicing a stereo channel here would change the mel."""
    if path.endswith(".wav"):
        from scipy.io import wavfile
        sr, data = wavfile.read(path)
        if data.dtype.kind == "i":
            data = data.astype(np.float32) / np.iinfo(data.dtype).max
        elif data.dtype.kind == "u":
            data = (data.astype(np.float32) - 128.0) / 128.0
        wav = data.T if data.ndim == 2 else data[None]
        duration = wav.shape[-1] / sr
    else:
        with MediaReader(path) as r:
            sr = r.audio_sample_rate
            duration = r.audio_duration
            wav = r.read_audio(0.0, duration)
    wav16 = _resample16k(wav, sr)
    out = []
    n = int(clip_duration * 16000)
    for s in _clip_starts(duration, clip_duration, num_clips):
        i0 = max(int(s * 16000), 0)
        seg = wav16[:, i0:i0 + n]
        if seg.shape[-1] < n:   # short audio: zeros at the end
            seg = np.pad(seg, ((0, 0), (0, n - seg.shape[-1])))
        out.append(seg)
    return out


def load_av_clips_uniformly(path: str, video_fps: int, video_num_frame: int,
                            image_size, num_clips: int):
    """videos (k, f, h, w, 3) in [0, 1] and a list of k (c, T) 16 kHz
    waveforms, the clips spread uniformly over the file."""
    clip_duration = video_num_frame / video_fps
    with MediaReader(path) as r:
        av_duration = min(r.video_duration, r.audio_duration)
        videos, waves = [], []
        sr = r.audio_sample_rate
        n = int(clip_duration * 16000)
        for s in _clip_starts(av_duration, clip_duration, num_clips):
            frames = r.read_video_clip(max(s, 0.0), clip_duration, video_fps,
                                       video_num_frame)
            videos.append(sd_video_transform(
                frames.astype(np.float32) / 255.0, image_size,
                normalize=False))
            w = _resample16k(r.read_audio(max(s, 0.0), clip_duration), sr)
            if w.shape[-1] < n:
                w = np.pad(w, ((0, 0), (0, n - w.shape[-1])))
            waves.append(w[:, :n])
    return np.stack(videos), waves


@traced("gen.request")
def generate_videos(
    pipeline,
    image_path: str = "",
    audio_path: str = "",
    video_path: str = "",
    category_text_encoding=None,
    image_size: Tuple[int, int] = (256, 256),
    video_fps: int = 6,
    video_num_frame: int = 12,
    num_clips_per_video: int = 3,
    audio_guidance_scale: float = 4.0,
    text_guidance_scale: float = 1.0,
    num_inference_steps: int = 50,
    seed: int = 0,
    save_template: str = "",
    sampler: str = "plms",
    batch_clips: bool = True,
):
    """Animate `num_clips_per_video` clips on the pipeline's device.

    batch_clips=True generates every clip of the video in ONE pipeline call
    with `broadcast_rng` (one noise draw shared by the clips), which equals
    the per-clip loop with a generator re-seeded per clip.  With a
    `save_template`, clip k goes to `<save_template>_clip-<kk>.mp4` and None
    is returned; else a list of (frames (f, h, w, 3) uint8, audio (c, T)).
    """
    assert not (image_path and audio_path and video_path), \
        "specify at most two of image/audio/video paths"
    if save_template and not media_available():
        raise RuntimeError(
            "generate_videos: save_template needs the media layer to write "
            "mp4, and the libav development files are missing here; pass "
            "save_template='' to get the frames back instead")
    clip_duration = video_num_frame / video_fps
    dev = pipeline.device

    images = audios = None
    with span("gen.load"):
        if image_path:
            images = ([load_image(image_path, image_size)]
                      * num_clips_per_video)
        if audio_path:
            audios = load_audio_clips_uniformly(audio_path, clip_duration,
                                                num_clips_per_video)
        if video_path:
            vids, waves = load_av_clips_uniformly(video_path, video_fps,
                                                  video_num_frame, image_size,
                                                  num_clips_per_video)
            if images is None:
                images = [v[0] for v in vids]
            if audios is None:
                audios = waves

    if category_text_encoding is None:
        # the reference CLIP-encodes the category (or empty) string here; a
        # zeros context changes the conditioning, so say so
        log.warning(
            "generate_videos: no category_text_encoding given — using a "
            "ZEROS text context (reference would CLIP-encode the category "
            "string; outputs will differ from reference numerics)")
        text_enc = torch.zeros((1, 77, 768), device=dev)
    else:
        text_enc = torch.as_tensor(category_text_encoding).to(
            device=dev, dtype=torch.float32).reshape(1, 77, 768)

    def mel(audio):
        with span("gen.load"):
            return waveform_to_mel(torch.as_tensor(audio, device=dev))

    def emit(k, video, audio):
        frames = torch.clamp(video.float() * 255.0, 0, 255).to(
            torch.uint8).cpu().numpy()           # a cast: truncates
        if save_template:
            path = f"{save_template}_clip-{k:02d}.mp4"
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            a = np.asarray(audio)
            write_video(path, frames, video_fps,
                        a if a.ndim == 2 else a[None], 16000)
            return None
        return (frames, audio)

    kw = dict(video_length=video_num_frame,
              num_inference_steps=num_inference_steps,
              audio_guidance_scale=audio_guidance_scale,
              text_guidance_scale=text_guidance_scale, sampler=sampler)

    def generator():
        return torch.Generator(device=dev).manual_seed(seed)

    results = []
    if batch_clips:
        videos = pipeline(
            torch.as_tensor(np.stack(images), device=dev),
            torch.stack([mel(a) for a in audios]),
            text_enc.expand((len(images),) + text_enc.shape[1:]),
            generator=generator(), broadcast_rng=True, **kw)
        for k, audio in enumerate(audios):
            results.append(emit(k, videos[k], audio))
    else:
        for k, (image, audio) in enumerate(zip(images, audios)):
            video = pipeline(torch.as_tensor(image, device=dev)[None],
                             mel(audio)[None], text_enc,
                             generator=generator(), **kw)[0]
            results.append(emit(k, video, audio))
    results = [r for r in results if r is not None]
    return results or None
