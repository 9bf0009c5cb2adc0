"""Linear layer whose parameters are cast at use.

asva_tpu keeps fp32 parameters and casts them to the compute dtype where
they are used (flax `param_dtype` fp32, `kernel.astype(self.dtype)`).  The
UNet's layers do the same, so a training build may hold trainable parameters
in fp32 while activations run in bf16.  With parameters already in the
activation dtype the casts are no-ops and the layer is `nn.Linear`.  Its
product is tagged `dot` for the remat policies (ops/remat.py).
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F

from . import remat


class Linear(nn.Linear):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return remat.checkpoint_name(remat.DOT, F.linear, x,
                                     self.weight.to(x.dtype), bias)
