"""Image/video preprocessing transforms on channels-last frames.

Port of asva_tpu/data/transforms.py (:42-77).  Each takes a torch tensor
(resized on its device) or a numpy array (on the host) and returns the same
kind:

  * sd_video_transform: aspect-preserving center trim, bilinear antialias
    resize to the target, optional horizontal flip, optional [-1, 1];
  * clip_frame_transform: bicubic antialias 224 + CLIP mean/std;
  * fid_frame_transform: bicubic antialias 229, [-1, 1];
  * fvd_frame_transform: bicubic antialias 224, [-1, 1].
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from ..ops.resize import resize_image

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def _center_trim_to_aspect(images, target_h: int, target_w: int):
    """Trim (..., h, w, c) to the target aspect ratio about the center."""
    h, w = images.shape[-3], images.shape[-2]
    target_ar = target_h / target_w
    if target_ar >= h / w:  # trim width
        trimmed_w = int(h / target_ar)
        x0 = (w - trimmed_w) // 2
        return images[..., :, x0:x0 + trimmed_w, :]
    trimmed_h = int(w * target_ar)
    y0 = (h - trimmed_h) // 2
    return images[..., y0:y0 + trimmed_h, :, :]


def sd_video_transform(frames, size: Union[int, Tuple[int, int]] = 256,
                       flip: bool = False, normalize: bool = True):
    """frames (..., h, w, 3) in [0, 1] -> (..., th, tw, 3)."""
    th, tw = (size, size) if isinstance(size, int) else size
    x = _center_trim_to_aspect(frames, th, tw)
    x = resize_image(x, th, tw, "bilinear", antialias=True)
    if flip:
        x = torch.flip(x, dims=(-2,)) if torch.is_tensor(x) else x[..., ::-1, :]
    if normalize:
        x = x * 2.0 - 1.0
    return x


def _like(values: np.ndarray, x):
    if torch.is_tensor(x):
        return torch.from_numpy(values).to(device=x.device, dtype=x.dtype)
    return values


def clip_frame_transform(frames):
    """(..., h, w, 3) in [0, 1] -> bicubic 224 + CLIP normalize."""
    x = resize_image(frames, 224, 224, "bicubic", antialias=True)
    return (x - _like(CLIP_MEAN, x)) / _like(CLIP_STD, x)


def fid_frame_transform(frames):
    return resize_image(frames, 229, 229, "bicubic", antialias=True) * 2.0 - 1.0


def fvd_frame_transform(frames):
    return resize_image(frames, 224, 224, "bicubic", antialias=True) * 2.0 - 1.0
