"""Dataset-side helpers (port of asva_tpu/data/datasets.py).

Only `load_text_encoding_mapping` (:31-42), which the generation CLIs read
the per-class CLIP encodings with, is ported so far; `AudioVideoDataset`
follows with the data loader.
"""
from __future__ import annotations

import numpy as np
import torch


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
