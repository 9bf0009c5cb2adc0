"""Fused residual sub-layers of the UNet transformer block (kernels B1-B5)
and the fused temporal mix of FFInflatedConv (B7).

Port of asva_tpu/ops/pallas_fused.py.  Each Pallas TPU kernel becomes a
composition of hand-written CUDA kernels (`csrc/gemm.cu` K-gemm,
`csrc/attn.cu` K-attn / B4, `csrc/attn_bwd.cu` B5), split exactly where the
Pallas body casts to x.dtype:

  B1 fused_ln_attn   (pallas _ln_attn_flat)   = K-gemm(LN, store q)
                                                -> K-attn -> K-gemm(+bo, +x)
  B2 fused_ln_attn3  (pallas _ln_attn3_flat)  = B1 three times, on the group
                                                layouts of _ln_attn3_reference
  B3 fused_ln_geglu  (pallas _ln_geglu_flat)  = K-gemm(LN, GEGLU)
                                                -> K-gemm(+bo, +x)
  B4 mha_fwd         (pallas _mha_fwd_flat)   = K-attn that also writes the
                                                per-head log-sum-exp
  B5 mha_bwd         (pallas _mha_bwd_flat)   = flash backward: dQ kernel +
                                                dK/dV kernel (+ a sum of its
                                                query-range partials when K/V
                                                are few: `dkv_split`)
  B7 fused_ff_mix    (pallas _ff_mix_flat)    = `csrc/mix.cu` K-mix: one
                                                product over [head|prev|curr]
                                                on K-gemm's wgmma + TMA ring
                                                (`ff_mix_plan`), y + bias in
                                                the epilogue

B6 (pallas_attn's flat attention) lives in `ops/flat_attention.py`; it shares
`csrc/attn.cu` and the `LAUNCHES` table below.

Gradients follow pallas_fused's custom_vjp rules, as
`torch.autograd.Function`s: `fused_ln_attn` keeps (o, lse) from B4 and its
backward is the manual composite around B5 (`_attn_bwd`, :399); the
attention forward never re-runs.  `fused_ln_geglu` and `fused_ln_attn3`
differentiate their plain composites recomputed in the backward (`_ff_bwd`
:176, `_attn3_bwd` :566), and so does `fused_ff_mix` (`_mix_bwd` :964).  A
wrapper whose input requires grad always returns a tensor with a grad_fn.
Their forwards tag what the remat policies keep (ops/remat.py): B1's (o,
lse) `attn_res` (pallas_fused.py:391-392); its q, its output and B2's and
B3's outputs `dot` (K-gemm products); B1's and B2's outputs `sublayer_x`
(in the UNet each is the next residual sub-layer's input) and B3's
`block_out` (the transformer block's output).  A rematerialised unit that
keeps them launches nothing for them in its recompute.

Dispatch is by device, not by a memory budget: on CPU tensors each wrapper
computes its plain PyTorch version (`*_plain`, the port's copy of the
Pallas `_reference` composites and kernel bodies); on CUDA tensors it
launches its kernels or raises — it never falls back.  The autograd rules
are the same on both devices, with the plain B4/B5 inside on the CPU.
Weights stay in torch Linear layout (out, in) and are read in place;
parameters stored in another dtype than x are cast at use (`w.to(x.dtype)`,
as asva_tpu casts its fp32 parameters).  `LAUNCHES` counts each wrapper's
kernel launches.  The wrappers of B1-B3, and the backward rules of B1
and B3, run inside the spans "fused.B1" - "fused.B3" (observability).
The three also take `out=`, a buffer like x that receives the result
where no gradient is due: the sampler loop's CUDA graphs
(models/unet3d/graphs.py) call them between graphs, into the buffer the
next graph reads.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence

import torch

from ..observability import traced
from . import cuda_build, remat
from .norms import layer_norm_rows

# per-wrapper count of kernel launches (CUDA path only)
LAUNCHES = {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "B5": 0, "B6": 0, "B7": 0,
            "T1": 0, "T2F": 0, "T2B": 0,    # T*: the tools' kernels, variants.py
            # K-gemm, by the launch it makes inside B1/B2 (q, out) and B3
            "KG.q": 0, "KG.out": 0, "KG.ff1": 0, "KG.ff2": 0}

_EPI_STORE, _EPI_GEGLU, _EPI_BIAS_RES = 0, 1, 2
# the four K-gemm launches of the sub-layers and their epilogues: the q
# projection (after LN), the output projection (+ bias + residual), the LN +
# GEGLU product and the FF's second product (+ bias + residual)
_FORMS = {"q": _EPI_STORE, "out": _EPI_BIAS_RES, "ff1": _EPI_GEGLU,
          "ff2": _EPI_BIAS_RES}
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


def ln_gemm_plain(form: str, a, w, bias=None, res=None, ln=None):
    """K-gemm plain: a (M, K) -> (M, N), the product with W (N, K) in
    Linear layout after an optional LayerNorm, `ln` = (weight, bias, eps),
    and the epilogue of `form` (`_FORMS`): "q" casts a @ W^T; "ff1" takes W
    as [value; gate] (2N, K) and returns (v + b) * gelu_erf(g + b); "out"
    and "ff2" return res + (a @ W^T + bias).  Products in a.dtype with fp32
    accumulation, the epilogue in fp32, one cast (the kernel's arithmetic)."""
    x = a if ln is None else _ln(a, *ln)
    s = x.float() @ w.to(a.dtype).float().t()
    epi = _FORMS[form]
    if epi == _EPI_STORE:
        return s.to(a.dtype)
    s = s + bias.to(a.dtype).float()
    if epi == _EPI_GEGLU:
        n = w.shape[0] // 2
        return (s[:, :n] * torch.nn.functional.gelu(s[:, n:])).to(a.dtype)
    return (res.float() + s).to(a.dtype)


def _heads(t, num_heads: int):
    """(G, S, H*D) -> (G, H, S, D) fp32."""
    g, s, hd = t.shape
    return t.reshape(g, s, num_heads, hd // num_heads).transpose(1, 2).float()


def _logits(q, k, num_heads: int, kv_len: Optional[int], scale: float):
    """(G, H, M, Sk) fp32 scaled logits, columns >= kv_len at -1e9."""
    s = (_heads(q, num_heads) @ _heads(k, num_heads).transpose(-1, -2)) * scale
    sk = k.shape[1]
    if kv_len is not None and kv_len < sk:
        cols = torch.arange(sk, device=q.device)
        s = torch.where(cols < kv_len, s, torch.full_like(s, -1e9))
    return s


def mha_fwd_plain(q, k, v, num_heads: int, kv_len: Optional[int],
                  scale: float):
    """B4 plain: attention on the flat (G, M, H*D) layout -> (o in q.dtype,
    lse (G, M, H) fp32).  o is pallas `_mha_einsum`; lse is the kernel
    body's max + log(sum exp) (`_mha_fwd_kernel`)."""
    g, m, hd = q.shape
    s = _logits(q, k, num_heads, kv_len, scale)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    o = (p.float() @ _heads(v, num_heads)).to(q.dtype)
    lse = torch.logsumexp(s, dim=-1)                     # (G, H, M)
    return o.transpose(1, 2).reshape(g, m, hd), lse.transpose(1, 2).contiguous()


def mha_plain(q, k, v, num_heads: int, kv_len: Optional[int],
              scale: float) -> torch.Tensor:
    """Attention on the flat (G, M, H*D) layout (pallas _mha_einsum)."""
    return mha_fwd_plain(q, k, v, num_heads, kv_len, scale)[0]


def mha_bwd_plain(q, k, v, do, lse, dd, num_heads: int,
                  kv_len: Optional[int], scale: float):
    """B5 plain: the body of pallas `_mha_bwd_kernel` -> (dq, dk, dv).
    P = exp(S - lse); dS = P (dO V^T - dd) scale, rounded to q.dtype, and P
    rounded to v.dtype, before dQ = dS K, dK = dS^T Q, dV = P^T dO, each
    accumulated in fp32 and cast once."""
    g, m, hd = q.shape
    qh, kh, vh, doh = (_heads(t, num_heads) for t in (q, k, v, do))
    s = _logits(q, k, num_heads, kv_len, scale)
    p = torch.exp(s - lse.transpose(1, 2)[..., None])    # (G, H, M, Sk)
    dpv = doh @ vh.transpose(-1, -2)
    ds = (p * (dpv - dd.transpose(1, 2)[..., None]) * scale).to(q.dtype)
    ds = ds.float()
    pb = p.to(v.dtype).float()

    def flat(t, like):
        return t.transpose(1, 2).reshape(like.shape).to(like.dtype)
    return (flat(ds @ kh, q), flat(ds.transpose(-1, -2) @ qh, k),
            flat(pb.transpose(-1, -2) @ doh, v))


def _ln_q(x, ls, lb, wq, eps: float) -> torch.Tensor:
    """The LN + q-projection prefix of the attention sub-layers."""
    return _ln(x, ls, lb, eps) @ wq.to(x.dtype).t()


def _out_proj(x, o, wo, bo) -> torch.Tensor:
    y = o.float() @ wo.to(x.dtype).float().t()
    return x + (y + bo.float()).to(x.dtype)


def ln_attn_plain(x, ls, lb, wq, wo, bo, k, v, eps: float, num_heads: int,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """x (G, M, C) -> x + Wo MHA(Wq LN(x), k, v) + bo; k/v (G, Sk, C)
    pre-projected.  Copy of pallas_fused._ln_attn_reference."""
    c = x.shape[-1]
    q = _ln_q(x, ls, lb, wq, eps)
    o = mha_plain(q, k, v, num_heads, kv_len, 1.0 / math.sqrt(c // num_heads))
    return _out_proj(x, o, wo, bo)


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


def ff_mix_plain(y, kh, kp, kc, bias) -> torch.Tensor:
    """B7 plain: y (B, F, N, C) -> y + y_0 Kh^T + y_{f-1} Kp^T + y_f Kc^T + b,
    the previous frame of frame 0 being frame 0.  Kh/Kp/Kc (C, C) in Linear
    layout (out, in).  The body of pallas `_mix_kernel`: the three products
    accumulate in fp32, y and the bias are added in fp32, one cast (pallas
    `_ff_mix_reference` rounds each product to y.dtype instead)."""
    y32 = y.float()
    kh, kp, kc = (w.to(y.dtype).float() for w in (kh, kp, kc))
    zp = y32 @ kp.t()
    mix = y32[:, :1] @ kh.t() + torch.cat([zp[:, :1], zp[:, :-1]], dim=1)
    mix = mix + y32 @ kc.t()
    return (y32 + mix + bias.to(y.dtype).float().reshape(-1)).to(y.dtype)


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


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def gemm_supported(n: int, k: int, dtype) -> Optional[str]:
    """None when K-gemm takes an output width n and contraction k in
    `dtype`, else why not.  bf16: 64-deep K tiles and N tiles of 160 (every
    SD1.5 width; GEGLU's are 80) or 64 (`tile_n` in csrc/gemm.cu); fp32:
    16-deep K tiles."""
    if dtype == torch.bfloat16:
        if k % 64:
            return f"K-gemm takes K a multiple of 64 in bf16, got {k}"
        if n % 160 and n % 64:
            return f"K-gemm takes N a multiple of 160 or 64 in bf16, got {n}"
        return None
    if k % 16:
        return f"K-gemm takes K a multiple of 16 in {dtype}, got {k}"
    return None


def _gemm(lib, form, a, lnw, lnb, eps, w, bias, res, out):
    m, k = a.shape
    n = out.shape[1]
    why = gemm_supported(n, k, a.dtype)
    if why:
        raise ValueError(why)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.gemm.asva_ln_gemm(
        _DTYPES[a.dtype], _FORMS[form], m, n, k, ptr(a), ptr(lnw), ptr(lnb),
        float(eps), ptr(w), ptr(bias), ptr(res), ptr(out), _stream(a))
    _raise_on(lib, rc, "K-gemm")
    LAUNCHES[f"KG.{form}"] += 1


def ln_gemm(form: str, a, w, bias=None, res=None, ln=None) -> torch.Tensor:
    """K-gemm alone, one launch (`ln_gemm_plain` says what it computes; the
    plain version runs for CPU tensors).  Forward only: it has no autograd
    rule, so inputs that require grad are refused under grad mode."""
    if form not in _FORMS:
        raise ValueError(f"form {form!r} not in {sorted(_FORMS)}")
    if a.device.type == "cpu":
        return ln_gemm_plain(form, a, w, bias, res, ln)
    params = [t for t in (w, bias, res) + tuple(ln or ())[:2]
              if t is not None]
    if torch.is_grad_enabled() and any(t.requires_grad for t in [a] + params):
        raise ValueError("ln_gemm has no autograd rule: call it under "
                         "torch.no_grad() or use the fused wrappers")
    lib = _prepare(a, *params)
    m, k = a.shape
    epi = _FORMS[form]
    n = w.shape[0] // 2 if epi == _EPI_GEGLU else w.shape[0]
    _check_shape("w", w, ((2 if epi == _EPI_GEGLU else 1) * n, k))
    if epi != _EPI_STORE:
        if bias is None:
            raise ValueError(f"form {form!r} needs a bias")
        _check_shape("bias", bias, (w.shape[0],))
    if epi == _EPI_BIAS_RES:
        if res is None:
            raise ValueError(f"form {form!r} needs a residual")
        _check_shape("res", res, (m, n))
    lnw, lnb, eps = ln if ln is not None else (None, None, 0.0)
    if ln is not None:
        _check_shape("ln weight", lnw, (k,))
        _check_shape("ln bias", lnb, (k,))
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    _gemm(lib, form, a, lnw, lnb, eps, w,
          bias if epi != _EPI_STORE else None,
          res if epi == _EPI_BIAS_RES else None, out)
    return out


def _attn_geometry(q, k, v, num_heads: int, kv_len: Optional[int]):
    """Validate the flat attention layout; -> (g, m, sk, d, kv_len)."""
    g, m, c = q.shape
    sk = k.shape[1]
    _check_shape("k", k, (g, sk, c))
    _check_shape("v", v, (g, sk, c))
    if c % num_heads or (c // num_heads) % 8 or c // num_heads > 160:
        raise ValueError(f"K-attn takes head dims that are multiples of 8 "
                         f"up to 160; got C={c}, H={num_heads}")
    kv_len = sk if kv_len is None else int(kv_len)
    if not 1 <= kv_len <= sk:
        raise ValueError(f"kv_len {kv_len} outside [1, {sk}]")
    return g, m, sk, c // num_heads, kv_len


def _mha_fwd_cuda(lib, q, k, v, num_heads, kv_len, scale, with_lse: bool):
    """K-attn on checked tensors -> (o, lse or None)."""
    g, m, sk, d, kv_len = _attn_geometry(q, k, v, num_heads, kv_len)
    o = torch.empty_like(q)
    lse = (torch.empty((g, m, num_heads), dtype=torch.float32,
                       device=q.device) if with_lse else None)
    rc = lib.attn.asva_mha_fwd(
        _DTYPES[q.dtype], g, m, sk, kv_len, num_heads, d, float(scale),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if lse is None else lse.data_ptr(), _stream(q))
    _raise_on(lib, rc, "K-attn")
    return o, lse


def mha_fwd(q, k, v, num_heads: int, kv_len: Optional[int], scale: float):
    """B4: q (G, M, H*D), k/v (G, Sk, H*D) -> (o, lse (G, M, H) fp32)."""
    if q.device.type == "cpu":
        return mha_fwd_plain(q, k, v, num_heads, kv_len, scale)
    lib = _prepare(q, k, v)
    out = _mha_fwd_cuda(lib, q, k, v, num_heads, kv_len, scale, True)
    LAUNCHES["B4"] += 1
    return out


def dkv_split(g: int, m: int, sk: int, num_heads: int, d: int,
              sms: int) -> int:
    """How many query ranges B5's bf16 dK/dV kernel splits into: 1 when its
    grid (a block per 128 K/V rows, or 64 when Sk <= 64, per head-dim
    slice, head and group) fills at least half the SMs, else enough ranges
    for one block per SM (its registers allow one), at most one per 64-row
    query tile.  Few K/V rows (77 text tokens, the 16x16 and 8x8 levels at
    batch 4) make the small grids."""
    dp = -(-d // 16) * 16
    rows = 64 if sk <= 64 else 128
    blocks = -(-sk // rows) * (2 if dp > 96 else 1) * num_heads * g
    if 2 * blocks >= sms:
        return 1
    return max(1, min(-(-m // 64), -(-sms // blocks)))


def mha_bwd(q, k, v, do, lse, dd, num_heads: int, kv_len: Optional[int],
            scale: float, need_dkv: bool = True):
    """B5: -> (dq, dk, dv) in the dtypes of (q, k, v); dk and dv are None
    when `need_dkv` is false (K/V that need no gradient)."""
    if q.device.type == "cpu":
        dq, dk, dv = mha_bwd_plain(q, k, v, do, lse, dd, num_heads, kv_len,
                                   scale)
        return (dq, dk, dv) if need_dkv else (dq, None, None)
    lib = _prepare(q, k, v, do)
    g, m, sk, d, kv_len = _attn_geometry(q, k, v, num_heads, kv_len)
    _check_shape("do", do, q.shape)
    _check((lse, dd), torch.float32, q.device)
    _check_shape("lse", lse, (g, m, num_heads))
    _check_shape("dd", dd, (g, m, num_heads))
    dq = torch.empty_like(q)
    dk = torch.empty_like(k) if need_dkv else None
    dv = torch.empty_like(v) if need_dkv else None
    nsplit, ws = 1, None
    if need_dkv and q.dtype == torch.bfloat16:
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        nsplit = dkv_split(g, m, sk, num_heads, d, sms)
        if nsplit > 1:   # fp32 partial dK/dV of each query range
            ws = torch.empty((2, nsplit) + tuple(k.shape),
                             dtype=torch.float32, device=q.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.attn_bwd.asva_mha_bwd_split(
        _DTYPES[q.dtype], g, m, sk, kv_len, num_heads, d, float(scale),
        ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(dd), ptr(dq), ptr(dk),
        ptr(dv), nsplit, ptr(ws), _stream(q))
    _raise_on(lib, rc, "attention backward")
    LAUNCHES["B5"] += 1
    return dq, dk, dv


def _check_sublayer(x, ls, lb, wq, wo, bo, k, v):
    c = x.shape[-1]
    _check((ls, lb, wq, wo, bo, k, v), x.dtype, x.device)
    for name, t, shape in (("ls", ls, (c,)), ("lb", lb, (c,)),
                           ("wq", wq, (c, c)), ("wo", wo, (c, c)),
                           ("bo", bo, (c,))):
        _check_shape(name, t, shape)


def _q_cuda(lib, x, ls, lb, wq, eps):
    """K-gemm(LN, q): B1's first launch."""
    g, m, c = x.shape
    q = torch.empty_like(x)
    _gemm(lib, "q", x.view(g * m, c), ls, lb, eps, wq, None, None,
          q.view(g * m, c))
    return q


def _out_cuda(lib, x, o, wo, bo, out=None):
    """K-gemm(+bo, +x): B1's last launch, into `out` where given."""
    g, m, c = x.shape
    if out is None:
        out = torch.empty_like(x)
    _gemm(lib, "out", o.view(g * m, c), None, None, 0.0, wo, bo,
          x.view(g * m, c), out.view(g * m, c))
    return out


def _ln_attn_cuda(lib, x, ls, lb, wq, wo, bo, k, v, eps, num_heads, kv_len,
                  out=None):
    """K-gemm(LN, q) -> K-attn -> K-gemm(+bo, +x) -> out."""
    _check_sublayer(x, ls, lb, wq, wo, bo, k, v)
    _attn_geometry(x, k, v, num_heads, kv_len)   # before the first launch
    q = _q_cuda(lib, x, ls, lb, wq, eps)
    o, _ = _mha_fwd_cuda(lib, q, k, v, num_heads, kv_len,
                         1.0 / math.sqrt(x.shape[-1] // num_heads), False)
    return _out_cuda(lib, x, o, wo, bo, out)


def _into(out, x):
    """Check a caller's output buffer: x's shape, dtype and device,
    contiguous (None passes)."""
    if out is not None:
        _check((out,), x.dtype, x.device)
        _check_shape("out", out, x.shape)
    return out


def _plain_into(out, y):
    return y if out is None else out.copy_(y)


def _ln_geglu_fwd(x, ls, lb, wi, bi, wo, bo, eps, out=None):
    if x.device.type == "cpu":
        return _plain_into(_into(out, x),
                           ln_geglu_plain(x, ls, lb, wi, bi, wo, bo, eps))
    lib = _prepare(x, ls, lb, wi, bi, wo, bo)
    m, c = x.shape
    inner = wo.shape[1]
    for name, t, shape in (("ls", ls, (c,)), ("lb", lb, (c,)),
                           ("wi", wi, (2 * inner, c)), ("bi", bi, (2 * inner,)),
                           ("wo", wo, (c, inner)), ("bo", bo, (c,))):
        _check_shape(name, t, shape)
    if _into(out, x) is None:
        out = torch.empty_like(x)
    h = torch.empty((m, inner), dtype=x.dtype, device=x.device)
    _gemm(lib, "ff1", x, ls, lb, eps, wi, bi, None, h)
    _gemm(lib, "ff2", h, None, None, 0.0, wo, bo, x, out)
    LAUNCHES["B3"] += 1
    return out


def _ln_attn_fwd(x, ls, lb, wq, wo, bo, k, v, eps, num_heads, kv_len,
                 out=None):
    """B1's forward without a graph: the attention runs without lse."""
    if x.device.type == "cpu":
        return _plain_into(_into(out, x), ln_attn_plain(
            x, ls, lb, wq, wo, bo, k, v, eps, num_heads, kv_len))
    lib = _prepare(x)
    out = _ln_attn_cuda(lib, x, ls, lb, wq, wo, bo, k, v, eps, num_heads,
                        kv_len, _into(out, x))
    LAUNCHES["B1"] += 1
    return out


def _ln_q_proj(x, ls, lb, wq, eps):
    """B1's LN + q projection (K-gemm's first product)."""
    if x.device.type == "cpu":
        return _ln_q(x, ls, lb, wq, eps)
    return _q_cuda(_prepare(x), x, ls, lb, wq, eps)


def _ln_attn_res(x, ls, lb, wq, k, v, eps, num_heads, kv_len):
    """The differentiated B1's residuals (o, lse): q (a `dot`) -> B4."""
    q = remat.checkpoint_name(remat.DOT, _ln_q_proj, x, ls, lb, wq, eps)
    return mha_fwd(q, k, v, num_heads, kv_len,
                   1.0 / math.sqrt(x.shape[-1] // num_heads))


def _attn_out(x, o, wo, bo):
    """The differentiated B1's output x + o Wo^T + bo: its last K-gemm."""
    if x.device.type == "cpu":
        return _out_proj(x, o, wo, bo)
    out = _out_cuda(_prepare(x), x, o, wo, bo)
    LAUNCHES["B1"] += 1
    return out


def _ln_attn3_fwd(x, ls1, lb1, wq1, wo1, bo1, k1, v1,
                  lsa, lba, wqa, woa, boa, ka, va,
                  lst, lbt, wqt, wot, bot, kt, vt, eps3, num_heads, kv_lens,
                  out=None):
    if x.device.type == "cpu":
        return _plain_into(_into(out, x), ln_attn3_plain(
            x, ls1, lb1, wq1, wo1, bo1, k1, v1, lsa, lba, wqa, woa, boa, ka,
            va, lst, lbt, wqt, wot, bot, kt, vt, eps3, num_heads, kv_lens))
    lib = _prepare(x)
    _into(out, x)
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
                      kt, vt, eps3[2], num_heads, kv_lens[2],
                      None if out is None else out.view(b, f * n, c))
    LAUNCHES["B2"] += 1
    return h.view(b, f, n, c) if out is None else out


# B7's loaders of A in csrc/mix.cu, in order of preference: FRAME (every tile
# of `bm` rows in one frame: one TMA box a tap) and CPASYNC (any N: 16-byte
# cp.async)
MIX_LOADERS = ("FRAME", "CPASYNC")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def ff_mix_loaders(n: int, bm: int) -> list:
    """The loaders of A that a bf16 mix of `n` rows a frame admits in tiles
    of `bm` rows, best first."""
    return ["FRAME", "CPASYNC"] if n % bm == 0 else ["CPASYNC"]


def ff_mix_plan(shape, sms: int) -> dict:
    """The plan of `csrc/mix.cu`'s bf16 launch for y `shape` (B, F, N, C) on
    a card with `sms` SMs, which `asva_ff_mix` is given and checks: column
    tile `tn` (160 where it divides C, else 64), rows a block `bm` (128, or
    64 when 128-row blocks would not fill the card: K-gemm's rule) and the
    best loader of A the shape admits (`ff_mix_loaders`)."""
    b, f, n, c = shape
    tn = 160 if c % 160 == 0 else 64
    bm = 128 if -(-(b * f * n) // 128) * (c // tn) >= sms else 64
    return dict(tn=tn, bm=bm, path=ff_mix_loaders(n, bm)[0])


def ff_mix_launch(y, kh, kp, kc, bias, plan: Optional[dict] = None):
    """B7's forward: one launch of `csrc/mix.cu` on a CUDA tensor (bf16 on
    `plan`, `ff_mix_plan`'s by default), `ff_mix_plain` on a CPU one."""
    if y.device.type == "cpu":
        return ff_mix_plain(y, kh, kp, kc, bias)
    if y.dim() != 4:
        raise ValueError(f"y must be (B, F, N, C), got {tuple(y.shape)}")
    b, f, n, c = y.shape
    bias = bias.reshape(-1)
    lib = _prepare(y, bias)
    _check_shape("bias", bias, (c,))
    tile_k = 64 if y.dtype == torch.bfloat16 else 16
    if c % tile_k:
        raise ValueError(f"K-mix takes a channel count that is a multiple of "
                         f"{tile_k} for {y.dtype} (bf16: its 64-deep K tiles "
                         f"and 64-wide column tiles), got {c}")
    for name, w in (("kh", kh), ("kp", kp), ("kc", kc)):
        # a column block of a Linear(3C, C) weight is read in place
        _check_shape(name, w, (c, c))
        if (w.device != y.device or w.dtype != y.dtype or w.stride(1) != 1
                or w.stride(0) % 8 or w.data_ptr() % 16):
            raise ValueError(f"{name}: needs {y.dtype} on {y.device} with "
                             "unit column stride, a row stride that is a "
                             "multiple of 8 and 16-byte alignment")
    tn = bm = path = 0
    if y.dtype == torch.bfloat16:
        if plan is None:
            plan = ff_mix_plan(y.shape, _sm_count(y.device.index))
        tn, bm, path = (plan["tn"], plan["bm"],
                        MIX_LOADERS.index(plan["path"]))
    out = torch.empty_like(y)
    rc = lib.mix.asva_ff_mix(
        _DTYPES[y.dtype], b, f, n, c, tn, bm, path, y.data_ptr(),
        kh.data_ptr(), kp.data_ptr(), kc.data_ptr(), kh.stride(0),
        kp.stride(0), kc.stride(0), bias.data_ptr(), out.data_ptr(),
        _stream(y))
    _raise_on(lib, rc, "K-mix")
    LAUNCHES["B7"] += 1
    return out


# --------------------------------------------------------------------------
# autograd rules
# --------------------------------------------------------------------------

def _head_rowsum(a, b, num_heads: int) -> torch.Tensor:
    """Per-head rowsum(a * b) in fp32: (G, M, H*D) -> (G, M, H).  With a = dO
    and b = O this is the flash identity rowsum(dP * P)."""
    g, m, hd = a.shape
    shape = (g, m, num_heads, hd // num_heads)
    return (a.float().reshape(shape) * b.float().reshape(shape)).sum(-1)


def _plain_vjp(fn, tensors, needs, grad_out):
    """Gradients of fn(*tensors), recomputed under enable_grad, for the
    inputs that need one (None elsewhere)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(bool(n))
                  for t, n in zip(tensors, needs)]
        out = fn(*leaves)
    wanted = [t for t in leaves if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, grad_out) if wanted else ())
    return tuple(next(grads) if t.requires_grad else None for t in leaves)


class _MhaKvShared(torch.autograd.Function):
    """pallas_fused.mha_kvshared (:834): forward B4, backward dd + B5."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads, kv_len, scale):
        o, lse = mha_fwd(q, k, v, num_heads, kv_len, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.statics = (num_heads, kv_len, scale)
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v, o, lse = ctx.saved_tensors
        num_heads, kv_len, scale = ctx.statics
        dd = _head_rowsum(g, o, num_heads)
        need = ctx.needs_input_grad
        dq, dk, dv = mha_bwd(q, k, v, g.to(q.dtype).contiguous(), lse, dd,
                             num_heads, kv_len, scale, need[1] or need[2])
        return dq, dk, dv, None, None, None


class _LnAttn(torch.autograd.Function):
    """pallas_fused.fused_ln_attn's differentiated form (_attn_fwd :366,
    _attn_bwd :399): q, B4's (o, lse) and the output projection, each a
    tagged value for the remat policies."""

    @staticmethod
    def forward(ctx, x, ls, lb, wq, wo, bo, k, v, eps, num_heads, kv_len):
        if not any(ctx.needs_input_grad):
            return _ln_attn_fwd(x, ls, lb, wq, wo, bo, k, v, eps, num_heads,
                                kv_len)
        if x.device.type != "cpu":       # checked before the first launch
            _prepare(x)
            _check_sublayer(x, ls, lb, wq, wo, bo, k, v)
            _attn_geometry(x, k, v, num_heads, kv_len)
        o, lse = remat.checkpoint_name(remat.ATTN_RES, _ln_attn_res, x, ls,
                                       lb, wq, k, v, eps, num_heads, kv_len)
        out = remat.checkpoint_name((remat.SUBLAYER_X, remat.DOT), _attn_out,
                                    x, o, wo, bo)
        ctx.save_for_backward(x, ls, lb, wq, wo, bo, k, v, o, lse)
        ctx.statics = (eps, num_heads, kv_len)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    @traced("fused.B1")
    def backward(ctx, g):
        x, ls, lb, wq, wo, bo, k, v, o, lse = ctx.saved_tensors
        eps, num_heads, kv_len = ctx.statics
        need = ctx.needs_input_grad
        c = x.shape[-1]
        # only the LN + q-projection prefix is recomputed, for q and its vjp
        with torch.enable_grad():
            prefix_in = [t.detach().requires_grad_(bool(n))
                         for t, n in zip((x, ls, lb, wq), need[:4])]
            q = _ln_q(*prefix_in, eps)
        g32 = g.float()
        # out = x + cast(o @ wo^T + bo): do in fp32, then cast to x.dtype
        do = (g32 @ wo.float()).to(x.dtype)
        dwo = dbo = None
        if need[4]:
            dwo = (g32.reshape(-1, c).t() @ o.float().reshape(-1, c)
                   ).to(wo.dtype)
        if need[5]:
            dbo = g32.sum(dim=(0, 1)).to(bo.dtype)
        dd = _head_rowsum(do, o, num_heads)
        dq, dk, dv = mha_bwd(q.detach(), k, v, do, lse, dd, num_heads, kv_len,
                             1.0 / math.sqrt(c // num_heads),
                             need[6] or need[7])
        wanted = [t for t in prefix_in if t.requires_grad]
        grads = iter(torch.autograd.grad(q, wanted, dq) if wanted else ())
        dx, dls, dlb, dwq = (next(grads) if t.requires_grad else None
                             for t in prefix_in)
        if dx is not None:
            dx = g + dx
        return dx, dls, dlb, dwq, dwo, dbo, dk, dv, None, None, None


class _LnGeglu(torch.autograd.Function):
    """pallas_fused.fused_ln_geglu: kernel forward, backward through the
    plain composite (_ff_bwd :176)."""

    @staticmethod
    def forward(ctx, x, ls, lb, wi, bi, wo, bo, eps):
        ctx.save_for_backward(x, ls, lb, wi, bi, wo, bo)
        ctx.eps = eps
        return remat.checkpoint_name((remat.BLOCK_OUT, remat.DOT),
                                     _ln_geglu_fwd, x, ls, lb, wi, bi, wo,
                                     bo, eps)

    @staticmethod
    @torch.autograd.function.once_differentiable
    @traced("fused.B3")
    def backward(ctx, g):
        eps = ctx.eps
        return _plain_vjp(lambda *a: ln_geglu_plain(*a, eps),
                          ctx.saved_tensors, ctx.needs_input_grad,
                          g) + (None,)


class _LnAttn3(torch.autograd.Function):
    """pallas_fused.fused_ln_attn3: kernel forward, backward through the
    plain composite (_attn3_bwd :566)."""

    @staticmethod
    def forward(ctx, eps3, num_heads, kv_lens, *tensors):
        ctx.save_for_backward(*tensors)
        ctx.statics = (eps3, num_heads, kv_lens)
        return remat.checkpoint_name((remat.SUBLAYER_X, remat.DOT),
                                     _ln_attn3_fwd, *tensors, eps3,
                                     num_heads, kv_lens)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        statics = ctx.statics
        return (None, None, None) + _plain_vjp(
            lambda *a: ln_attn3_plain(*a, *statics), ctx.saved_tensors,
            ctx.needs_input_grad[3:], g)


class _FfMix(torch.autograd.Function):
    """pallas_fused.fused_ff_mix: kernel forward, backward through the plain
    composite (_mix_bwd :964)."""

    @staticmethod
    def forward(ctx, y, kh, kp, kc, bias):
        ctx.save_for_backward(y, kh, kp, kc, bias)
        return ff_mix_launch(y, kh, kp, kc, bias)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _plain_vjp(ff_mix_plain, ctx.saved_tensors,
                          ctx.needs_input_grad, g)


# --------------------------------------------------------------------------
# public wrappers
# --------------------------------------------------------------------------

def _cast(x, *params):
    """Parameters cast at use to the activation dtype."""
    return tuple(p.to(x.dtype) for p in params)


def mha_kvshared(q, k, v, num_heads: int, kv_len: Optional[int],
                 scale: float) -> torch.Tensor:
    """Differentiable attention on the flat layout: q (G, M, H*D), k/v
    (G, Sk, H*D) pre-projected -> o (G, M, H*D).  Forward B4, backward B5."""
    return _MhaKvShared.apply(q, k, v, num_heads, kv_len, scale)


def _no_graph(args):
    """out= writes a caller's buffer, which autograd cannot follow."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in args if torch.is_tensor(t)):
        raise ValueError("out= takes no input that requires grad under grad "
                         "mode")


@traced("fused.B3")
def fused_ln_geglu(x, ls, lb, wi, bi, wo, bo, eps: float,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B3: x (M, C) -> x + FF(LN(x)).  ls/lb (C,), wi (2*inner, C) with
    [value; gate] rows, bi (2*inner,), wo (C, inner), bo (C,).  `out`, a
    contiguous tensor like x, receives the result and is returned (no
    gradient then)."""
    args = (x,) + _cast(x, ls, lb, wi, bi, wo, bo)
    if out is not None:
        _no_graph(args)
        return _ln_geglu_fwd(*args, eps, out=out)
    return _LnGeglu.apply(*args, eps)


@traced("fused.B1")
def fused_ln_attn(x, ls, lb, wq, wo, bo, k, v, eps: float, num_heads: int,
                  kv_len: Optional[int] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B1: x (G, M, C) -> x + Wo MHA(Wq LN(x), k, v) + bo.  wq/wo (C, C)
    in Linear layout, k/v (G, Sk, C) pre-projected; key columns >= kv_len
    are masked (None: all Sk).  When a gradient is needed the attention runs
    as B4 and the backward as B5.  `out` as in fused_ln_geglu."""
    args = (x,) + _cast(x, ls, lb, wq, wo, bo) + (k, v)
    if out is not None:
        _no_graph(args)
        return _ln_attn_fwd(*args, eps, num_heads, kv_len, out=out)
    return _LnAttn.apply(*args, eps, num_heads, kv_len)


@traced("fused.B2")
def fused_ln_attn3(x, ls1, lb1, wq1, wo1, bo1, k1, v1,
                   lsa, lba, wqa, woa, boa, ka, va,
                   lst, lbt, wqt, wot, bot, kt, vt,
                   eps3: Sequence[float], num_heads: int,
                   kv_lens: Sequence[Optional[int]] = (None, None, None),
                   out: Optional[torch.Tensor] = None):
    """B2: attn1 + audio-x + text-x on x (B, F, N, C); see ln_attn3_plain
    for the K/V layouts.  `out` as in fused_ln_geglu."""
    args = ((x,) + _cast(x, ls1, lb1, wq1, wo1, bo1) + (k1, v1)
            + _cast(x, lsa, lba, wqa, woa, boa) + (ka, va)
            + _cast(x, lst, lbt, wqt, wot, bot) + (kt, vt))
    eps3, kv_lens = tuple(eps3), tuple(kv_lens)
    if out is not None:
        _no_graph(args)
        return _ln_attn3_fwd(*args, eps3, num_heads, kv_lens, out=out)
    return _LnAttn3.apply(eps3, num_heads, kv_lens, *args)


def fused_ff_mix(y, kh, kp, kc, bias) -> torch.Tensor:
    """B7: y (B, F, N, C) -> y + the first/previous/current-frame 3-tap
    temporal linear mix.  kh, kp, kc (C, C) in Linear layout (out, in) — the
    column blocks [head | prev | curr] of `conv_temp.weight` (C, 3C), which
    the kernel reads in place; bias (C,) or (1, C).  Not wired into
    FFInflatedConv, as in asva_tpu (primitives.temporal_mix serves it)."""
    return _FfMix.apply(y, *_cast(y, kh, kp, kc, bias))
