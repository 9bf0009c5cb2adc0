"""Kaldi-style log-mel filterbank ("fbank") in plain PyTorch.

Port of asva_tpu/ops/mel.py (`fbank` :64, `waveform_to_mel` :95); the
port does not depend on torchaudio.  16 kHz, 25 ms window, 10 ms shift,
snip_edges, DC-offset removal, preemphasis 0.97 with edge replication,
periodic=False Hann window, 512-point FFT, 128 Kaldi-mel bins from 20 Hz to
Nyquist, log with the float32-eps clamp; a 2 s clip gives 198 frames,
zero-padded to 204 and normalized (mean -4.268, std 9.138).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch
from torch.nn import functional as F

MEL_EPS = 1.1920928955078125e-07  # float32 machine eps (Kaldi log clamp)


def _mel(f):
    return 1127.0 * np.log(1.0 + f / 700.0)


@functools.lru_cache(maxsize=8)
def kaldi_mel_banks(num_bins: int, padded_window_size: int,
                    sample_freq: float, low_freq: float = 20.0,
                    high_freq: float = 0.0) -> np.ndarray:
    """(num_bins, padded_window_size//2 + 1) triangular weights, Kaldi mel."""
    if high_freq <= 0.0:
        high_freq = sample_freq / 2 + high_freq
    num_fft_bins = padded_window_size // 2
    fft_bin_width = sample_freq / padded_window_size
    mel_low, mel_high = _mel(low_freq), _mel(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)
    bins = np.arange(num_bins, dtype=np.float64)[:, None]
    left = mel_low + bins * mel_delta
    center = mel_low + (bins + 1) * mel_delta
    right = mel_low + (bins + 2) * mel_delta
    freqs = _mel(fft_bin_width * np.arange(num_fft_bins,
                                           dtype=np.float64))[None, :]
    up = (freqs - left) / (center - left)
    down = (right - freqs) / (right - center)
    weights = np.maximum(0.0, np.minimum(up, down))
    # final column (nyquist bin) is zero, mirroring torchaudio's pad
    weights = np.concatenate([weights, np.zeros((num_bins, 1))], axis=1)
    return weights.astype(np.float32)


def _hann_window(n: int) -> np.ndarray:
    # torch.hann_window(periodic=False)
    return (0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / (n - 1))).astype(
        np.float32)


def fbank(waveform: torch.Tensor, sample_rate: int = 16000,
          num_mel_bins: int = 128, frame_length_ms: float = 25.0,
          frame_shift_ms: float = 10.0,
          preemphasis: float = 0.97) -> torch.Tensor:
    """waveform (..., T) -> log-mel (..., num_frames, num_mel_bins), fp32."""
    window_size = int(sample_rate * frame_length_ms / 1000)
    window_shift = int(sample_rate * frame_shift_ms / 1000)
    padded = 1 << (window_size - 1).bit_length()
    frames = waveform.float().unfold(-1, window_size, window_shift)
    frames = frames - frames.mean(dim=-1, keepdim=True)
    prev = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
    frames = frames - preemphasis * prev
    dev = waveform.device
    frames = frames * torch.from_numpy(_hann_window(window_size)).to(dev)
    frames = F.pad(frames, (0, padded - window_size))
    spectrum = torch.fft.rfft(frames, dim=-1).abs() ** 2
    banks = torch.from_numpy(kaldi_mel_banks(num_mel_bins, padded,
                                             float(sample_rate))).to(dev)
    mel = spectrum @ banks.t()
    return torch.log(torch.clamp(mel, min=MEL_EPS))


def waveform_to_mel(waveform: torch.Tensor, sample_rate: int = 16000,
                    num_mel_bins: int = 128, target_length: int = 204,
                    clip_duration: float = 2.0, mean: float = -4.268,
                    std: float = 9.138) -> torch.Tensor:
    """(c, T) or (T,) waveform -> (num_mel_bins, target_length, 1)
    normalized mel image (channels-last).  Channel 0 is used after
    mean-centring; longer clips are centre-cropped to clip_duration."""
    waveform = torch.as_tensor(waveform)
    if waveform.dim() == 1:
        waveform = waveform[None]
    target_t = int(clip_duration * sample_rate)
    t = waveform.shape[-1]
    if t > target_t:
        start = (t - target_t) // 2
        waveform = waveform[..., start:start + target_t]
    elif t < target_t:
        waveform = F.pad(waveform, (0, target_t - t))
    waveform = waveform - waveform.mean()
    mel = fbank(waveform[0], sample_rate, num_mel_bins).t()   # (n_mels, m)
    n_frames = mel.shape[-1]
    if n_frames < target_length:
        mel = F.pad(mel, (0, target_length - n_frames))
    else:
        mel = mel[:, :target_length]
    return ((mel - mean) / std)[..., None]


# ---------------------------------------------------------------------------
# Provenance (asva_tpu/ops/mel.py:134-191): the fbank is implemented from
# the Kaldi/torchaudio parameters above; bit parity with torchaudio is
# proven only where the recorded goldens fixture exists
# (tools/make_mel_goldens.py).  Metric JSONs carry this label.

def golden_waveforms():
    """Deterministic golden test signals, as asva_tpu draws them."""
    rng = np.random.default_rng(1234)
    sr, n = 16000, 32000
    t = np.arange(n) / sr
    return sr, {
        "noise": (rng.standard_normal(n) * 0.1).astype(np.float32),
        "tones": (0.5 * np.sin(2 * np.pi * 440 * t)
                  + 0.2 * np.sin(2 * np.pi * 3210 * t)).astype(np.float32),
        "chirp": np.sin(2 * np.pi * (200 * t + 1900 * t * t)).astype(
            np.float32),
        "walk": np.clip(rng.standard_normal(n).cumsum() * 1e-3,
                        -1, 1).astype(np.float32),
    }


def goldens_fixture_path() -> str:
    env = os.environ.get("ASVA_MEL_GOLDENS")
    if env:
        return env
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.normpath(os.path.join(here, "..", "..", "tests",
                                         "fixtures", "mel_goldens.npz"))


@functools.lru_cache(maxsize=1)
def goldens_status() -> str:
    """'verified' iff fbank matches the recorded torchaudio goldens here,
    'MISMATCH ...' if the fixture disagrees, else 'unverified (...)'."""
    path = goldens_fixture_path()
    if not os.path.isfile(path):
        return ("unverified (torchaudio goldens fixture absent; run "
                "tools/make_mel_goldens.py where torchaudio exists)")
    goldens = np.load(path)
    sr, waves = golden_waveforms()
    worst = 0.0
    for name, wave in waves.items():
        if name not in goldens:
            return f"MISMATCH (fixture missing key {name})"
        got = fbank(torch.from_numpy(wave), sample_rate=sr).numpy()
        if got.shape != goldens[name].shape:
            return f"MISMATCH (shape {got.shape} vs {goldens[name].shape})"
        worst = max(worst, float(np.abs(got - goldens[name]).max()))
    return ("verified vs torchaudio goldens" if worst < 1e-4
            else f"MISMATCH vs torchaudio goldens (max abs diff {worst:g})")
