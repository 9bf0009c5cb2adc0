"""Polyphase windowed-sinc audio resampling (torchaudio-compatible).  Port
of asva_tpu/ops/resample.py: gcd-reduced rates, lowpass_filter_width=6,
rolloff=0.99, Hann-windowed sinc kernel, output length
ceil(new * T / orig).  The kernel bank is a host numpy constant; the
convolution is one strided `conv1d` with the phases as output channels."""
from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=32)
def _kernel_bank(orig_freq: int, new_freq: int,
                 lowpass_filter_width: int = 6,
                 rolloff: float = 0.99) -> tuple:
    g = math.gcd(orig_freq, new_freq)
    orig, new = orig_freq // g, new_freq // g
    base_freq = min(orig, new) * rolloff
    width = math.ceil(lowpass_filter_width * orig / base_freq)
    # one kernel per output phase
    idx = np.arange(-width, width + orig, dtype=np.float64)[None] / orig
    t = (-np.arange(new, dtype=np.float64)[:, None] / new + idx) * base_freq
    t = np.clip(t, -lowpass_filter_width, lowpass_filter_width)
    window = np.cos(t * np.pi / lowpass_filter_width / 2) ** 2
    tpi = t * np.pi
    kernel = np.where(t == 0, 1.0, np.sin(tpi) / np.where(tpi == 0, 1, tpi))
    kernel = kernel * window * (base_freq / orig)
    return kernel.astype(np.float32), orig, new, width


def resample(waveform, orig_freq: int, new_freq: int) -> torch.Tensor:
    """waveform (..., T), tensor or array -> (..., ceil(T * new / orig)),
    float32, on the waveform's device."""
    x = torch.as_tensor(waveform).to(torch.float32)
    if orig_freq == new_freq:
        return x
    kernels, orig, new, width = _kernel_bank(orig_freq, new_freq)
    shape = x.shape
    t = shape[-1]
    x2 = x.reshape(-1, 1, t)
    target_len = int(math.ceil(new * t / orig))
    num_wins = int(math.ceil(t / orig))
    klen = kernels.shape[1]
    pad_right = max(0, (num_wins - 1) * orig + klen - width - t)
    xp = torch.nn.functional.pad(x2, (width, pad_right))
    w = torch.from_numpy(kernels).to(x.device)[:, None]      # (new, 1, klen)
    out = torch.nn.functional.conv1d(xp, w, stride=orig)     # (b, new, wins)
    out = out[..., :num_wins].transpose(1, 2).reshape(x2.shape[0], -1)
    return out[:, :target_len].reshape(shape[:-1] + (target_len,))
