"""The conditioning files of generation requests, made from the seed: for
each pool item a PNG at the configuration's frame size (smooth colour
fields with noise) and a mono 16 kHz int16 wav (two tones of drawn
pitches, a beat and noise), written to a directory under TMPDIR."""
from __future__ import annotations

import os

import numpy as np


def write_pool(directory: str, seed: int, n: int, size, seconds: float):
    """[(png path, wav path)] of n items."""
    from PIL import Image
    from scipy.io import wavfile
    h, w = size
    out = []
    for i in range(n):
        rng = np.random.default_rng([seed % (1 << 63), i])
        yy, xx = np.mgrid[0:h, 0:w] / np.array([h - 1.0, w - 1.0])[:, None,
                                                                    None]
        a = rng.uniform(1, 8, size=(3, 2))
        img = np.stack([0.5 + 0.5 * np.sin(a[c, 0] * xx + a[c, 1] * yy
                                           + rng.uniform(0, 6))
                        for c in range(3)], -1)
        img = np.clip(img + 0.05 * rng.standard_normal(img.shape), 0, 1)
        png = os.path.join(directory, f"item{i}.png")
        Image.fromarray((img * 255).astype(np.uint8)).save(png)
        t = np.arange(int(seconds * 16000)) / 16000.0
        f1, f2, beat = rng.uniform(80, 1200), rng.uniform(80, 4000), \
            rng.uniform(0.5, 4)
        wave = (0.4 * np.sin(2 * np.pi * f1 * t) * (0.5 + 0.5 * np.sin(
            2 * np.pi * beat * t)) + 0.2 * np.sin(2 * np.pi * f2 * t)
            + 0.05 * rng.standard_normal(t.shape))
        wav = os.path.join(directory, f"item{i}.wav")
        wavfile.write(wav, 16000,
                      (np.clip(wave, -1, 1) * 32767).astype(np.int16))
        out.append((png, wav))
    return out
