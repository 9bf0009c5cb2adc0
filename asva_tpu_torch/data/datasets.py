"""The AVSyncD training dataset and the text-encoding mapping.  Port of
asva_tpu/data/datasets.py (:31-152).

AudioVideoDataset mirrors the reference BaseAudioVideoDataset
(avgen/data/base.py:20-143): an example list file (one video path per line,
or "path,start,end" clip lines), per-item clip decode at (video_fps,
video_num_frame), train = random clip start / test = centred, SD-style
resize + crop (+ random flip in train), audio clip resampled to 16 kHz.
Items are host numpy arrays, as asva_tpu's (the loader collates them into
tensors):

  * "video" (f, h, w, 3) float32 in [0, 1], channels-last;
  * "waveform" (samples,) float32: channel 0 of the clip's audio at
    16 kHz, zero-padded to the clip's length (the mel runs on the device);
  * "text_encoding" (77, 768) float32 when an encoding mapping is given.

Decode goes through the port's media layer (`data/media.py`), the resample
through `ops/resample.py` and the transform through `data/transforms.py`.
The clip start and the flip come from (seed, epoch, index) alone, so items
do not depend on which worker decodes them.
"""
from __future__ import annotations

import json
import os.path as osp
import random
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.resample import resample
from .media import MediaReader
from .transforms import sd_video_transform

CLIP_SAMPLE_RATE = 16000


def load_text_encoding_mapping(path: str):
    """A class -> (77, 768) float32 text-encoding mapping from a `.pt` or
    `.npz` file; a `.pt` holding one tensor (TheGreatestHits) gives that
    array."""
    if path.endswith(".npz"):
        data = np.load(path)
        return {k: np.asarray(data[k], np.float32) for k in data.files}
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if torch.is_tensor(obj):
        return np.asarray(obj.float().numpy(), np.float32)
    return {k: np.asarray(v.float().numpy() if torch.is_tensor(v) else v,
                          np.float32)
            for k, v in obj.items()}


def item_rng(seed: int, epoch: int, index: int) -> random.Random:
    """The per-item augmentation stream of asva_tpu's datasets."""
    return random.Random((seed * 1_000_003 + epoch) * 1_000_003 + index)


def mono_16k(wav: np.ndarray, sr: int) -> np.ndarray:
    """Channel 0 of (c, T) audio resampled to 16 kHz.  One channel keeps the
    batch's shape fixed; Kaldi fbank removes each frame's mean, so the mel
    equals the reference's all-channel mean-centre of it."""
    return resample(wav, sr, CLIP_SAMPLE_RATE)[0].numpy()


class AudioVideoDataset:
    def __init__(
        self,
        example_list_path: str,
        data_root: str,
        mode: str = "test",
        video_fps: int = 6,
        video_num_frame: int = 12,
        img_size: Union[int, Tuple[int, int]] = 256,
        randflip: bool = False,
        example_list_type: str = "video",
        class_mapping_json: Optional[str] = None,
        class_text_encoding_mapping_path: Optional[str] = None,
        category: Optional[Union[str, List[str]]] = None,
        seed: Optional[int] = None,
    ):
        with open(example_list_path) as f:
            examples = [line.strip() for line in f if line.strip()]
        if category is not None:
            cats = [category] if isinstance(category, str) else category
            examples = [e for e in examples if e.split("/")[0] in cats]
        self.examples = examples
        self.example_list_type = example_list_type
        self.data_root = data_root
        self.mode = mode
        self.video_fps = video_fps
        self.video_num_frame = video_num_frame
        self.clip_duration = video_num_frame / video_fps
        self.img_size = img_size
        self.randflip = randflip
        self.seed = 0 if seed is None else seed
        self.epoch = 0

        self.class_mapping = None
        if class_mapping_json:
            with open(class_mapping_json) as f:
                self.class_mapping = json.load(f)
        self.text_encodings = None
        if class_text_encoding_mapping_path:
            self.text_encodings = load_text_encoding_mapping(
                class_text_encoding_mapping_path)

    def __len__(self):
        return len(self.examples)

    def set_epoch(self, epoch: int) -> None:
        """Advance the per-epoch RNG stream (called by DataLoader)."""
        self.epoch = epoch

    def _item_rng(self, index: int) -> random.Random:
        return item_rng(self.seed, self.epoch, index)

    def _class_text_encoding(self, index) -> Optional[np.ndarray]:
        if self.text_encodings is None:
            return None
        if isinstance(self.text_encodings, np.ndarray):
            enc = self.text_encodings
        else:
            cls = self.examples[index].split("/")[0]
            if self.class_mapping is not None:
                cls = self.class_mapping[cls]
            enc = self.text_encodings[cls]
        return enc.reshape(enc.shape[-2], enc.shape[-1])

    def __getitem__(self, index) -> dict:
        entry = self.examples[index]
        if self.example_list_type == "clip":
            path, s0, s1 = entry.split(",")
            scene_start, av_duration = float(s0), float(s1) - float(s0)
        else:
            path, scene_start, av_duration = entry, 0.0, None

        rng = self._item_rng(index)
        with MediaReader(osp.join(self.data_root, path)) as r:
            if av_duration is None:
                av_duration = min(r.video_duration, r.audio_duration)
            if self.mode == "train":
                start = max(0.0, rng.uniform(
                    0.0, av_duration - self.clip_duration)) + scene_start
            else:
                start = max(0.0, (av_duration - self.clip_duration) / 2.0) \
                    + scene_start

            frames = r.read_video_clip(start, self.clip_duration,
                                       self.video_fps, self.video_num_frame)
            flip = (self.mode == "train" and self.randflip
                    and rng.randint(0, 1) == 1)
            video = sd_video_transform(frames.astype(np.float32) / 255.0,
                                       self.img_size, flip=flip,
                                       normalize=False)
            wav = r.read_audio(start, self.clip_duration)
            sr = r.audio_sample_rate
        wav = mono_16k(wav, sr)
        target = int(self.clip_duration * CLIP_SAMPLE_RATE)
        if wav.shape[0] < target:
            wav = np.pad(wav, (0, target - wav.shape[0]))
        wav = wav[:target]

        out = {"video": np.ascontiguousarray(video, np.float32),
               "waveform": wav.astype(np.float32, copy=False)}
        enc = self._class_text_encoding(index)
        if enc is not None:
            out["text_encoding"] = enc
        return out
