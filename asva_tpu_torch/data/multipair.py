"""Multi-clip aligned AV dataset for sync-classifier training and eval.
Port of asva_tpu/data/multipair.py (:30-190).

Mirrors the reference AudioVideoAlignedMultiPairDataset (avsync/data.py:
78-257): per video, k clip start times separated by shift_time via one of
four samplers (uniform / random-compact / center-compact / random); the
spanned frame range is decoded ONCE and frames are assigned to clips by
nearest pts; each clip is independently randomly flipped; k waveform clips
come from one audio pass.  A decode failure moves on to the next index
(`item["index"]` says which example was read).  `rng` is the item's
`random.Random` stream from (seed, epoch, index).

Items are host numpy arrays: "index" (int), "videos" (k, f, s, s, 3)
float32, CLIP-normalized, channels-last, and "waveforms" (k, samples)
float32, channel 0 at 16 kHz (the mel runs on the device).  Decode goes
through the port's media layer (`data/media.py`).
"""
from __future__ import annotations

import os.path as osp
from typing import Optional

import numpy as np

from ..ops.resize import resize_image
from .datasets import CLIP_SAMPLE_RATE, item_rng, mono_16k
from .media import MediaReader
from .transforms import CLIP_MEAN, CLIP_STD


def uniform_sample(start, end, num):
    return np.linspace(start, end, num, endpoint=True)


def random_compact_sample(rng, start, end, num, gap):
    assert (num - 1) * gap <= end - start
    first = rng.uniform(start, end - (num - 1) * gap)
    return np.arange(num) * gap + first


def center_compact_sample(start, end, num, gap):
    assert (num - 1) * gap <= end - start
    first = start + (end - start - (num - 1) * gap) / 2.0
    return np.arange(num) * gap + first


def random_sample(rng, start, end, num, gap):
    assert (num - 1) * gap <= end - start
    out = []
    while num:
        v = rng.uniform(start, end - (num - 1) * gap)
        out.append(v)
        start = v + gap
        num -= 1
    return np.array(out)


class MultiPairAVDataset:
    def __init__(
        self,
        example_list_path: str,
        data_root: str,
        mode: str = "test",
        image_size: int = 224,
        video_fps: int = 6,
        video_num_frames: int = 12,
        randflip: bool = True,
        shift_time: float = 0.2,
        num_clips: int = 21,
        sampling_type: str = "random-compact",
        seed: Optional[int] = None,
    ):
        if sampling_type not in ("random-compact", "center-compact",
                                 "random", "uniform"):
            raise ValueError(f"unknown sampling_type {sampling_type!r}")
        with open(example_list_path) as f:
            self.examples = [line.strip() for line in f if line.strip()]
        self.data_root = data_root
        self.mode = mode
        self.image_size = image_size
        self.video_fps = video_fps
        self.video_num_frames = video_num_frames
        self.clip_duration = video_num_frames / video_fps
        self.randflip = randflip
        self.shift_time = shift_time
        self.num_clips = num_clips
        self.sampling_type = sampling_type
        self.seed = 0 if seed is None else seed
        self.epoch = 0

    def __len__(self):
        return len(self.examples)

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-epoch RNG stream (called by DataLoader)."""
        self.epoch = epoch

    def _clip_preprocess(self, frames: np.ndarray) -> np.ndarray:
        """uint8 (n, h, w, 3) -> CLIP-normalized square (n, s, s, 3):
        torchvision Resize(s) (short side, bicubic, antialias) then
        CenterCrop(s)."""
        x = frames.astype(np.float32) / 255.0
        h, w = x.shape[1:3]
        s = self.image_size
        if h <= w:
            rh, rw = s, max(s, int(round(w * s / h)))
        else:
            rh, rw = max(s, int(round(h * s / w))), s
        x = resize_image(x, rh, rw, "bicubic", antialias=True)
        y0, x0 = (rh - s) // 2, (rw - s) // 2
        x = np.ascontiguousarray(x[:, y0:y0 + s, x0:x0 + s])
        x -= CLIP_MEAN
        x /= CLIP_STD
        return x

    def __getitem__(self, index) -> dict:
        for _ in range(len(self.examples)):
            try:
                return self._load(index)
            except Exception:   # an undecodable file: the next example
                index = (index + 1) % len(self.examples)
        raise RuntimeError("no decodable example found")

    def _load(self, index) -> dict:
        path = osp.join(self.data_root, self.examples[index])
        rng = item_rng(self.seed, self.epoch, index)
        k, f = self.num_clips, self.video_num_frames
        with MediaReader(path) as r:
            av_duration = min(r.video_duration, r.audio_duration)
            shift_total = (k - 1) * self.shift_time
            if av_duration < self.clip_duration + shift_total:
                raise ValueError(f"{path}: {av_duration:.3f} s is shorter "
                                 f"than {k} clips {self.shift_time} s apart")

            lo, hi = 0.0, av_duration - self.clip_duration
            if self.sampling_type == "random-compact":
                starts = random_compact_sample(rng, lo, hi, k,
                                               self.shift_time)
            elif self.sampling_type == "center-compact":
                starts = center_compact_sample(lo, hi, k, self.shift_time)
            elif self.sampling_type == "random":
                starts = random_sample(rng, lo, hi, k, self.shift_time)
            else:
                starts = uniform_sample(lo, hi, k)

            # frame target times per clip (k, f)
            frame_secs = starts[:, None] + np.arange(f)[None, :] / self.video_fps

            # decode the whole spanned range once at the source's fps
            span_start = float(frame_secs[0, 0])
            span_end = float(frame_secs[-1, -1])
            src_fps = max(r.video_fps, 1.0)
            n_src = int(np.ceil((span_end - span_start) * src_fps)) + 2
            all_frames = r.read_video_clip(span_start, span_end - span_start,
                                           src_fps, n_src)
            src_secs = span_start + np.arange(n_src) / src_fps

            # the nearest decoded frame for each clip frame; shifted clips
            # share most source frames, so each decoded frame is
            # preprocessed once and gathered into the (k, f) layout
            idx = np.abs(frame_secs[:, :, None]
                         - src_secs[None, None, :]).argmin(axis=2)
            uniq, inv = np.unique(idx.reshape(-1), return_inverse=True)
            videos = self._clip_preprocess(all_frames[uniq])[inv].reshape(
                (k, f, self.image_size, self.image_size, 3))
            if self.randflip:
                for i in range(k):
                    if rng.randint(0, 1):
                        videos[i] = videos[i, :, :, ::-1]

            # audio: one pass, a slice per clip
            sr = r.audio_sample_rate
            wav = r.read_audio(span_start,
                               span_end - span_start + 1.0 / self.video_fps)
        wav16 = mono_16k(wav, sr)
        target = int(self.clip_duration * CLIP_SAMPLE_RATE)
        clips = np.zeros((k, target), np.float32)
        for i in range(k):
            off = int(round((starts[i] - span_start) * CLIP_SAMPLE_RATE))
            seg = wav16[max(off, 0):off + target]
            clips[i, :len(seg)] = seg

        return {"index": index,
                "videos": videos.astype(np.float32, copy=False),
                "waveforms": clips}
