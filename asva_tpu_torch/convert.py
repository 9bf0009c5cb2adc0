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

The networks with BatchNorm (AVSync classifier, I3D, InceptionV3) keep
their running statistics in flax's `batch_stats` collection, outside
`params`; the key maps drop both prefixes and name the leaves
`running_mean` / `running_var`, so exporting the whole variables dict
({"params": ..., "batch_stats": ...}) yields every real key.  torch's
`num_batches_tracked` counters have no JAX source: `load_exported` keeps the
module's own value for exactly those keys and stays strict for all others.

An optax AdamW state exported the same way loads into the port's optimizer
(`load_exported_adam_state`), so a run can move between the two packages.
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
    for key, value in own.items():
        if key.endswith(".num_batches_tracked") and key not in tensors:
            tensors[key] = value
    module.load_state_dict(tensors, strict=strict)
    return module


def load_exported_adam_state(optimizer, mu: Dict[str, np.ndarray],
                             nu: Dict[str, np.ndarray], count: int) -> None:
    """Load an optax AdamW state into the port's optimizer
    (`training.optim.AdamW`): `mu` and `nu` are the first and second moments
    of the trainable subtree as {torch key: torch-layout numpy array} (the
    moment trees passed through asva_tpu's `export_state_dict` like the
    parameters), `count` the number of steps taken."""
    state = {"count": int(count), "mu": {}, "nu": {}}
    for name, p in zip(optimizer.names, optimizer.params):
        for kind, tree in (("mu", mu), ("nu", nu)):
            if name not in tree:
                raise KeyError(f"no {kind} for trainable parameter {name}")
            arr = np.asarray(tree[name])
            if arr.shape != tuple(p.shape):
                raise ValueError(f"{kind}[{name}]: shape {arr.shape}, "
                                 f"expected {tuple(p.shape)}")
            state[kind][name] = torch.from_numpy(np.array(arr))
    extra = (set(mu) | set(nu)) - set(optimizer.names)
    if extra:
        raise KeyError(f"moments for non-trainable parameters: "
                       f"{sorted(extra)[:8]}")
    optimizer.load_state_dict(state)
