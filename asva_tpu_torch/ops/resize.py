"""Resize with torch/PIL antialias numerics, as two dense contractions.

Port of asva_tpu/ops/resize.py (`resize_matrix` :36, `resize_image` :93).
The metric stack is sensitive to interpolation details (bilinear+antialias
for the SD data transforms, bicubic+antialias 224/229 for the CLIP / FVD /
FID preprocessing), so the interpolation weights per (in_size, out_size) are
host numpy matrices, built exactly as the JAX package builds them, and the
resize is one product per axis.  They reproduce
`F.interpolate(..., antialias=True, align_corners=False)`, which the
reference's preprocessing calls (tests/test_torch_eval.py holds the two
within 2e-6, border rows included); the port keeps the matrices so that it
and the JAX package run the same arithmetic.
"""
from __future__ import annotations

import functools

import numpy as np
import torch


def _bilinear_kernel(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


def _bicubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    x = np.abs(x)
    x2, x3 = x * x, x * x * x
    return np.where(x <= 1.0, (a + 2) * x3 - (a + 3) * x2 + 1,
                    np.where(x < 2.0, a * x3 - 5 * a * x2 + 8 * a * x - 4 * a,
                             0.0))


@functools.lru_cache(maxsize=64)
def resize_matrix(in_size: int, out_size: int, kind: str = "bilinear",
                  antialias: bool = True) -> np.ndarray:
    """(out_size, in_size) fp32 weight matrix.

    antialias=True follows the PIL path (bicubic a=-0.5, support widened by
    the downscale factor, out-of-range taps dropped and the rest
    renormalised); antialias=False follows torch's standard bicubic
    (a=-0.75, exactly 4 taps, indices edge-clamped)."""
    scale = in_size / out_size
    w = np.zeros((out_size, in_size), dtype=np.float64)
    if kind == "bicubic" and not antialias:
        for i in range(out_size):
            center = (i + 0.5) * scale - 0.5
            j0 = int(np.floor(center))
            j = np.arange(j0 - 1, j0 + 3)
            weights = _bicubic_kernel(j - center, a=-0.75)
            for jj, ww in zip(np.clip(j, 0, in_size - 1), weights):
                w[i, jj] += ww
        return w.astype(np.float32)

    if kind == "bilinear":
        kernel = _bilinear_kernel
    else:
        kernel = functools.partial(_bicubic_kernel, a=-0.5)  # PIL bicubic
    base_support = 1.0 if kind == "bilinear" else 2.0
    support_scale = max(scale, 1.0) if antialias else 1.0
    support = base_support * support_scale
    for i in range(out_size):
        center = (i + 0.5) * scale - 0.5
        lo = int(np.floor(center - support)) + 1
        hi = int(np.ceil(center + support))
        j = np.arange(lo, hi + 1)
        weights = kernel((j - center) / support_scale)
        valid = (j >= 0) & (j < in_size)
        weights = weights * valid
        total = weights.sum()
        for jj, ww in zip(j[valid], weights[valid] / total):
            w[i, jj] += ww
    return w.astype(np.float32)


def resize_image(images, out_h: int, out_w: int, kind: str = "bilinear",
                 antialias: bool = True):
    """images (..., h, w, c) -> (..., out_h, out_w, c), in the input's dtype.
    A torch tensor is resized on its device (fp32 products); a numpy array
    on the host, with the same matrices."""
    h, w = images.shape[-3], images.shape[-2]
    if isinstance(images, np.ndarray):
        x = images.astype(np.float32, copy=False)
        if h != out_h:
            m = resize_matrix(h, out_h, kind, antialias)
            x = np.moveaxis(np.tensordot(x, m, axes=([x.ndim - 3], [1])), -1,
                            x.ndim - 3)
        if w != out_w:
            m = resize_matrix(w, out_w, kind, antialias)
            x = np.moveaxis(np.tensordot(x, m, axes=([x.ndim - 2], [1])), -1,
                            x.ndim - 2)
        return np.ascontiguousarray(x.astype(images.dtype, copy=False))
    x = images.float()
    if h != out_h:
        wh = torch.from_numpy(resize_matrix(h, out_h, kind, antialias))
        x = torch.einsum("oh,...hwc->...owc", wh.to(x.device), x)
    if w != out_w:
        ww = torch.from_numpy(resize_matrix(w, out_w, kind, antialias))
        x = torch.einsum("ow,...hwc->...hoc", ww.to(x.device), x)
    return x.to(images.dtype)
