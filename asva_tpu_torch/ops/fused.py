"""Fused residual sub-layers of the UNet transformer block: kernels B1-B3.

Port of asva_tpu/ops/pallas_fused.py.  Each Pallas TPU kernel on the
generation path becomes a composition of two hand-written CUDA kernels
(`csrc/gemm.cu` K-gemm, `csrc/attn.cu` K-attn), split exactly where the
Pallas body casts to x.dtype:

  B1 fused_ln_attn   (pallas _ln_attn_flat)   = K-gemm(LN, store q)
                                                -> K-attn -> K-gemm(+bo, +x)
  B2 fused_ln_attn3  (pallas _ln_attn3_flat)  = B1 three times, on the group
                                                layouts of _ln_attn3_reference
  B3 fused_ln_geglu  (pallas _ln_geglu_flat)  = K-gemm(LN, GEGLU)
                                                -> K-gemm(+bo, +x)

Dispatch is by device, not by a memory budget: on CPU tensors each wrapper
computes its plain PyTorch version (`*_plain`, the port's copy of the
Pallas `_reference` composites); on CUDA tensors it launches its kernels or
raises — it never falls back.  Weights stay in torch Linear layout (out, in)
and are read in place.  `LAUNCHES` counts each wrapper's kernel launches.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from . import cuda_build
from .norms import layer_norm_rows

# per-wrapper count of kernel launches (CUDA path only)
LAUNCHES = {"B1": 0, "B2": 0, "B3": 0}

_EPI_STORE, _EPI_GEGLU, _EPI_BIAS_RES = 0, 1, 2
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# --------------------------------------------------------------------------
# plain PyTorch versions (CPU path; the comparison for the kernels)
# --------------------------------------------------------------------------

def _ln(x, ls, lb, eps):
    return layer_norm_rows(x.float(), ls.float(), lb.float(), eps).to(x.dtype)


def ln_geglu_plain(x, ls, lb, wi, bi, wo, bo, eps: float) -> torch.Tensor:
    """x (M, C) -> x + Wo(v * gelu_erf(g)) + bo, [v|g] = LN(x) Wi^T + bi.
    Copy of pallas_fused._ln_geglu_reference: LN stats fp32, products in
    x.dtype with fp32 accumulation, h cast to x.dtype before Wo."""
    xn = _ln(x, ls, lb, eps)
    s = xn.float() @ wi.to(x.dtype).float().t() + bi.float()
    inner = wo.shape[1]
    value, gate = s[:, :inner], s[:, inner:]
    h = (value * torch.nn.functional.gelu(gate)).to(x.dtype)
    y = h.float() @ wo.to(x.dtype).float().t()
    return x + (y + bo.float()).to(x.dtype)


def mha_plain(q, k, v, num_heads: int, kv_len: Optional[int],
              scale: float) -> torch.Tensor:
    """Attention on the flat (G, M, H*D) layout (pallas _mha_einsum)."""
    g, m, hd = q.shape
    sk = k.shape[1]
    d = hd // num_heads
    qh = q.reshape(g, m, num_heads, d).transpose(1, 2).float()
    kh = k.reshape(g, sk, num_heads, d).transpose(1, 2).float()
    vh = v.reshape(g, sk, num_heads, d).transpose(1, 2).float()
    s = (qh @ kh.transpose(-1, -2)) * scale
    if kv_len is not None and kv_len < sk:
        cols = torch.arange(sk, device=q.device)
        s = torch.where(cols < kv_len, s, torch.full_like(s, -1e9))
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = (p.float() @ vh).to(q.dtype)
    return o.transpose(1, 2).reshape(g, m, hd)


def ln_attn_plain(x, ls, lb, wq, wo, bo, k, v, eps: float, num_heads: int,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """x (G, M, C) -> x + Wo MHA(Wq LN(x), k, v) + bo; k/v (G, Sk, C)
    pre-projected.  Copy of pallas_fused._ln_attn_reference."""
    c = x.shape[-1]
    xn = _ln(x, ls, lb, eps)
    q = xn @ wq.to(x.dtype).t()
    o = mha_plain(q, k, v, num_heads, kv_len, 1.0 / math.sqrt(c // num_heads))
    y = o.float() @ wo.to(x.dtype).float().t()
    return x + (y + bo.float()).to(x.dtype)


def ln_attn3_plain(x, ls1, lb1, wq1, wo1, bo1, k1, v1,
                   lsa, lba, wqa, woa, boa, ka, va,
                   lst, lbt, wqt, wot, bot, kt, vt,
                   eps3: Sequence[float], num_heads: int,
                   kv_lens: Sequence[Optional[int]] = (None, None, None)):
    """x (B, F, N, C): attn1 with per-b K/V (B, Sk1, C), audio-x with
    per-(b, f) K/V (B, F, Ska, C), text-x with per-b K/V (B, Skt, C).
    Copy of pallas_fused._ln_attn3_reference."""
    b, f, n, c = x.shape
    h = ln_attn_plain(x.reshape(b, f * n, c), ls1, lb1, wq1, wo1, bo1, k1,
                      v1, eps3[0], num_heads, kv_lens[0])
    h = ln_attn_plain(h.reshape(b * f, n, c), lsa, lba, wqa, woa, boa,
                      ka.reshape((b * f,) + ka.shape[2:]),
                      va.reshape((b * f,) + va.shape[2:]),
                      eps3[1], num_heads, kv_lens[1])
    h = ln_attn_plain(h.reshape(b, f * n, c), lst, lbt, wqt, wot, bot, kt,
                      vt, eps3[2], num_heads, kv_lens[2])
    return h.reshape(b, f, n, c)


# --------------------------------------------------------------------------
# kernel launches
# --------------------------------------------------------------------------

def _check(tensors, dtype, device):
    for t in tensors:
        if t.device != device:
            raise ValueError(
                f"tensor on {t.device}, expected {device}: the CUDA kernels "
                "take CUDA tensors (the plain version runs for CPU tensors)")
        if t.dtype != dtype:
            raise TypeError(f"dtype {t.dtype}, expected {dtype}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the CUDA kernels take 16-byte aligned tensors")


def _check_shape(name, t, shape):
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")


def _prepare(x, *tensors):
    if x.device.type != "cuda":
        raise ValueError(f"fused kernels need a CUDA or CPU tensor, got "
                         f"{x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"fused kernels take float32 or bfloat16, got "
                        f"{x.dtype}")
    _check((x,) + tensors, x.dtype, x.device)
    return cuda_build.library()


def _raise_on(lib, rc: int, what: str):
    if rc != 0:
        msg = lib.gemm.asva_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} "
                           f"({msg})")


def _gemm(lib, epi, a, lnw, lnb, eps, w, bias, res, out):
    m, k = a.shape
    n = out.shape[1]
    tile_k = 32 if a.dtype == torch.bfloat16 else 16
    if k % tile_k:
        raise ValueError(f"K-gemm takes a contraction dim that is a multiple "
                         f"of {tile_k} for {a.dtype}, got {k}")
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.gemm.asva_ln_gemm(
        _DTYPES[a.dtype], epi, m, n, k, ptr(a), ptr(lnw), ptr(lnb),
        float(eps), ptr(w), ptr(bias), ptr(res), ptr(out),
        torch.cuda.current_stream(a.device).cuda_stream)
    _raise_on(lib, rc, "K-gemm")


def _ln_attn_cuda(lib, x, ls, lb, wq, wo, bo, k, v, eps, num_heads, kv_len):
    g, m, c = x.shape
    sk = k.shape[1]
    _check((ls, lb, wq, wo, bo, k, v), x.dtype, x.device)
    for name, t, shape in (("ls", ls, (c,)), ("lb", lb, (c,)),
                           ("wq", wq, (c, c)), ("wo", wo, (c, c)),
                           ("bo", bo, (c,)), ("k", k, (g, sk, c)),
                           ("v", v, (g, sk, c))):
        _check_shape(name, t, shape)
    if c % num_heads or (c // num_heads) % 8 or c // num_heads > 160:
        raise ValueError(f"K-attn takes head dims that are multiples of 8 "
                         f"up to 160; got C={c}, H={num_heads}")
    kv_len = sk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= sk:
        raise ValueError(f"kv_len {kv_len} outside [1, {sk}]")
    d = c // num_heads
    q = torch.empty_like(x)
    _gemm(lib, _EPI_STORE, x.view(g * m, c), ls, lb, eps, wq, None, None,
          q.view(g * m, c))
    o = torch.empty_like(x)
    rc = lib.attn.asva_attn(
        _DTYPES[x.dtype], g, m, sk, kv_len, num_heads, d,
        1.0 / math.sqrt(d), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), torch.cuda.current_stream(x.device).cuda_stream)
    _raise_on(lib, rc, "K-attn")
    out = torch.empty_like(x)
    _gemm(lib, _EPI_BIAS_RES, o.view(g * m, c), None, None, 0.0, wo, bo,
          x.view(g * m, c), out.view(g * m, c))
    return out


# --------------------------------------------------------------------------
# public wrappers
# --------------------------------------------------------------------------

def fused_ln_geglu(x, ls, lb, wi, bi, wo, bo, eps: float) -> torch.Tensor:
    """B3: x (M, C) -> x + FF(LN(x)).  ls/lb (C,), wi (2*inner, C) with
    [value; gate] rows, bi (2*inner,), wo (C, inner), bo (C,)."""
    if x.device.type == "cpu":
        return ln_geglu_plain(x, ls, lb, wi, bi, wo, bo, eps)
    lib = _prepare(x, ls, lb, wi, bi, wo, bo)
    m, c = x.shape
    inner = wo.shape[1]
    for name, t, shape in (("ls", ls, (c,)), ("lb", lb, (c,)),
                           ("wi", wi, (2 * inner, c)), ("bi", bi, (2 * inner,)),
                           ("wo", wo, (c, inner)), ("bo", bo, (c,))):
        _check_shape(name, t, shape)
    h = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    _gemm(lib, _EPI_GEGLU, x, ls, lb, eps, wi, bi, None, h)
    out = torch.empty_like(x)
    _gemm(lib, _EPI_BIAS_RES, h, None, None, 0.0, wo, bo, x, out)
    LAUNCHES["B3"] += 1
    return out


def fused_ln_attn(x, ls, lb, wq, wo, bo, k, v, eps: float, num_heads: int,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """B1: x (G, M, C) -> x + Wo MHA(Wq LN(x), k, v) + bo.  wq/wo (C, C)
    in Linear layout, k/v (G, Sk, C) pre-projected; key columns >= kv_len
    are masked (None: all Sk)."""
    if x.device.type == "cpu":
        return ln_attn_plain(x, ls, lb, wq, wo, bo, k, v, eps, num_heads,
                             kv_len)
    lib = _prepare(x)
    out = _ln_attn_cuda(lib, x, ls, lb, wq, wo, bo, k, v, eps, num_heads,
                        kv_len)
    LAUNCHES["B1"] += 1
    return out


def fused_ln_attn3(x, ls1, lb1, wq1, wo1, bo1, k1, v1,
                   lsa, lba, wqa, woa, boa, ka, va,
                   lst, lbt, wqt, wot, bot, kt, vt,
                   eps3: Sequence[float], num_heads: int,
                   kv_lens: Sequence[Optional[int]] = (None, None, None)):
    """B2: attn1 + audio-x + text-x on x (B, F, N, C); see ln_attn3_plain
    for the K/V layouts."""
    if x.device.type == "cpu":
        return ln_attn3_plain(x, ls1, lb1, wq1, wo1, bo1, k1, v1,
                              lsa, lba, wqa, woa, boa, ka, va,
                              lst, lbt, wqt, wot, bot, kt, vt,
                              eps3, num_heads, kv_lens)
    lib = _prepare(x)
    b, f, n, c = x.shape
    if ka.dim() != 4 or tuple(ka.shape[:2]) != (b, f):
        raise ValueError(f"audio K/V must be (B, F, Ska, C), got "
                         f"{tuple(ka.shape)}")
    h = _ln_attn_cuda(lib, x.reshape(b, f * n, c), ls1, lb1, wq1, wo1, bo1,
                      k1, v1, eps3[0], num_heads, kv_lens[0])
    h = _ln_attn_cuda(lib, h.view(b * f, n, c), lsa, lba, wqa, woa, boa,
                      ka.reshape((b * f,) + ka.shape[2:]),
                      va.reshape((b * f,) + va.shape[2:]),
                      eps3[1], num_heads, kv_lens[1])
    h = _ln_attn_cuda(lib, h.view(b, f * n, c), lst, lbt, wqt, wot, bot,
                      kt, vt, eps3[2], num_heads, kv_lens[2])
    LAUNCHES["B2"] += 1
    return h.view(b, f, n, c)
