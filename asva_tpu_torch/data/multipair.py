"""Clip start-time samplers of the multi-clip aligned AV dataset.  Port of
the four samplers of asva_tpu/data/multipair.py (:30-54): per video, k clip
start times separated by at least `gap` seconds, laid out uniformly,
compactly at a random or the central position, or at random.  `rng` is a
`numpy.random.Generator`, as there.

Only the samplers are here.  The dataset class (`MultiPairAVDataset`)
decodes video and audio and waits for the media layer's port.
"""
from __future__ import annotations

import numpy as np

CLIP_SAMPLE_RATE = 16000


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
