"""The products and normalisations of the plain reference.

Every product of the reference goes through one `Products` object, built
in one of two precisions:

  "fp32"  float32 operands and accumulation, TF32 off (`no_tf32`);
  "fp8"   the control: both operands of every product rounded to float8
          e4m3 under a per-tensor scale (the tensor's largest magnitude
          goes to 448) before the float32 product, the step below the
          bfloat16 that the configurations state.  The rounding passes
          the gradient through unchanged, so a backward reads the rounded
          operands that the forward saved.

The norms are `F.group_norm` and `F.layer_norm` on float32, the published
layers' own formulas.
"""
from __future__ import annotations

import contextlib

import torch
from torch.nn import functional as F

E4M3_MAX = 448.0
PRECISIONS = ("fp32", "fp8")


def round_fp8(t: torch.Tensor) -> torch.Tensor:
    """t in float32, its values rounded to float8 e4m3 under a per-tensor
    scale; the gradient passes through as the identity's."""
    t32 = t.float()
    d = t32.detach()
    scale = E4M3_MAX / d.abs().amax().clamp(min=1e-30)
    q = (d * scale).to(torch.float8_e4m3fn).float() / scale
    return t32 + (q - d)


class Products:
    def __init__(self, precision: str = "fp32"):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision

    def _q(self, t: torch.Tensor) -> torch.Tensor:
        return round_fp8(t) if self.precision == "fp8" else t.float()

    def linear(self, x, w, b=None):
        return F.linear(self._q(x), self._q(w),
                        None if b is None else b.float())

    def conv2d(self, x, w, b, stride: int = 1, padding=0):
        """x (n, c, h, w) channels first."""
        return F.conv2d(self._q(x), self._q(w),
                        None if b is None else b.float(), stride, padding)

    def matmul(self, a, b):
        return self._q(a) @ self._q(b)

    def attention(self, q, k, v, scale: float, mask=None):
        """softmax(q k^T scale) v over the last two axes; mask True =
        attend."""
        logits = self.matmul(q, k.transpose(-1, -2)) * scale
        if mask is not None:
            logits = logits.masked_fill(~mask, float("-inf"))
        return self.matmul(torch.softmax(logits, dim=-1), v)


def group_norm(x: torch.Tensor, groups: int, weight, bias, eps: float,
               lead: int) -> torch.Tensor:
    """GroupNorm of channels-last x, statistics pooled over every axis
    after the first `lead` ones."""
    shape = x.shape
    n = 1
    for s in shape[:lead]:
        n *= s
    xc = x.float().reshape(n, -1, shape[-1]).transpose(1, 2)   # (n, c, L)
    y = F.group_norm(xc, groups, weight.float(), bias.float(), eps)
    return y.transpose(1, 2).reshape(shape)


def layer_norm(x: torch.Tensor, weight, bias, eps: float) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), weight.float(),
                        bias.float(), eps)


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmuls and cuDNN."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
