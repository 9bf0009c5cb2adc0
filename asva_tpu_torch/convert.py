"""Carry weights into the port's modules.

The port's modules use the reference's torch key space — the one the key
maps of asva_tpu/convert/torch_to_jax.py map from — so a torch-layout state
dict (the reference's checkpoints, or asva_tpu's
`convert/jax_to_torch.py:export_state_dict(params, <key map>)` output) loads
with `load_state_dict(strict=True)`.

One layout fix is needed beyond that export's own re-layout: 1x1
convolutions that asva_tpu holds as Dense (the VAE's quant_conv /
post_quant_conv) come out as (o, i) and are held here, as in the
reference checkpoints, as (o, i, 1, 1).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def load_exported(module: nn.Module, state: Dict[str, np.ndarray],
                  strict: bool = True) -> nn.Module:
    """Load a {torch key: numpy array} state dict into `module`, casting to
    each parameter's dtype and device.  Returns the module."""
    own = module.state_dict()
    tensors = {}
    for key, value in state.items():
        arr = np.asarray(value)
        target = own.get(key)
        if (target is not None and target.dim() == 4 and arr.ndim == 2
                and tuple(target.shape[2:]) == (1, 1)):
            arr = arr[:, :, None, None]
        t = torch.from_numpy(np.array(arr))  # a writable, contiguous copy
        if target is not None:
            t = t.to(dtype=target.dtype, device=target.device)
        tensors[key] = t
    module.load_state_dict(tensors, strict=strict)
    return module
