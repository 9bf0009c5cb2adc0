"""The kernel tools' kernels: T1 `ln_attn_variant`, T2f `mha_fwd_grouped`,
T2b `mha_bwd_ordered`.

Port of the three Pallas call sites outside asva_tpu/ops: `run_variant`
(tools/attn_experiments.py:304), `fwd_flat` and `bwd_flat`
(tools/mha_phase_bench.py:79, :181).  Each is a hand-written CUDA kernel of
its own (`csrc/attn_variants.cu`, `csrc/attn_grouped.cu`,
`csrc/attn_bwd_fused.cu`), not a call into B1/B4/B5:

  T1   the whole attention sub-layer (LN, q-projection, attention,
       out-projection, residual) in ONE launch, in ten variants of softmax
       arithmetic and schedule (`VARIANTS`), on K-gemm's TMA ring and B4's
       wgmma tile code: the POST class (v2_postnorm, v3_both) is bit-equal
       to `fused.fused_ln_attn` (B1) and the orders of a class to each
       other;
  T2f  the flash forward with `group` heads per block, their logits started
       before any softmax, on B4's wgmma tile code (`hopper.cuh`,
       `wgmma.cuh`) with B4's statements per head: o and lse bit-equal to
       B4's at every group;
  T2b  the flash backward as one kernel of five products on B5's dK/dV
       kernel: dK/dV carried in registers over the query tiles (bit-equal
       across the orders, and to B5's where B5 runs unsplit), dQ = dS K as
       a fifth wgmma, the block's two warpgroups summed in shared memory and
       added into an fp32 buffer with vector atomics, cast once.

Dispatch is by device, as in `fused`: a CPU tensor gets the plain version
(`ln_attn_variant_plain`, `fused.mha_fwd_plain`, `fused.mha_bwd_plain`), a
CUDA tensor launches the kernel or raises.  None of the three has a gradient
(the tools differentiate nothing).  Launches count in `fused.LAUNCHES` under
T1, T2F and T2B.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import fused
from .fused import (LAUNCHES, _DTYPES, _attn_geometry, _check, _check_shape,
                    _heads, _ln_q, _out_proj, _prepare, _raise_on, _stream)

# softmax arithmetic classes and schedules (csrc/attn_variants.cu)
PRE, POST, POSTR, EXP2, BF16EXP, FLOOR = range(6)
SEQ, PHASED, PIPE = range(3)

# name -> (class, order), in the order of tools/attn_experiments.py KERNELS
VARIANTS = {
    "v0": (PRE, SEQ), "v1_phased": (PRE, PHASED), "v2_postnorm": (POST, SEQ),
    "v3_both": (POST, PHASED), "v4_mmfloor": (FLOOR, SEQ),
    "v5_bf16exp": (BF16EXP, PHASED), "v6_stacksm": (PRE, PHASED),
    "v7_exp2": (EXP2, PHASED), "v8_pipe": (PRE, PIPE),
    "v9_mxusum": (POSTR, PHASED)}

# T1: the widths attn_variants.cu is instantiated for
T1_HEAD_DIMS = (24, 32, 40, 48)
T1_MAX_C = 320
# T2: padded head tiles attn_grouped.cu / attn_bwd_fused.cu are instantiated
# for, and the tool's backward variants as (heads per block, exp between the
# two logit products)
T2_HEAD_TILES = (32, 48, 64, 80, 160)
BWD_VARIANTS = {"b0": (1, True), "b1": (1, False), "b2": (2, False),
                "b4": (4, False), "b3": (None, False)}


# --------------------------------------------------------------------------
# plain version of T1 (CPU path; the comparison for the kernel)
# --------------------------------------------------------------------------

def _round(t, dtype):
    return t.to(dtype).float()


def _variant_heads(q, k, v, num_heads: int, cls: int, scale: float):
    """The per-head core of `_k_v0` ... `_k_v9` in fp32 with the Pallas
    bodies' casts: q (G, M, C), k/v (G, Sk, C) -> o (G, M, C) in q.dtype."""
    g, m, c = q.shape
    dt = q.dtype
    qh, kh, vh = (_heads(t, num_heads) for t in (q, k, v))
    s = qh @ kh.transpose(-1, -2)                        # (G, H, M, Sk) fp32
    if cls == FLOOR:                                     # _k_v4: no softmax
        o = _round(s * scale, dt) @ vh
    elif cls in (PRE, EXP2):                             # _k_v0, _k_v7
        if cls == EXP2:
            s = s * (scale * 1.4426950408889634)
            p = torch.exp2(s - s.amax(-1, keepdim=True))
        else:
            s = s * scale
            p = torch.exp(s - s.amax(-1, keepdim=True))
        o = _round(p / p.sum(-1, keepdim=True), dt) @ vh
    else:
        s = s * scale
        z = s - s.amax(-1, keepdim=True)
        if cls == BF16EXP:                               # _k_v5
            p = torch.exp(z.to(torch.bfloat16)).float()
            l, pr = p.sum(-1, keepdim=True), p
        else:
            p = torch.exp(z)
            pr = _round(p, dt)
            # _k_v2: l sums the unrounded p; _k_v9: the rounded, by a product
            l = (pr if cls == POSTR else p).sum(-1, keepdim=True)
        o = (pr @ vh) / l
    return o.to(dt).transpose(1, 2).reshape(g, m, c)


def ln_attn_variant_plain(name: str, x, ls, lb, wq, wo, bo, k, v, eps: float,
                          num_heads: int, block_m: Optional[int] = None):
    """T1 plain: x (G, M, C) -> x + Wo attn_name(Wq LN(x), k, v) + bo with
    the arithmetic of the Pallas body `name` (six classes; the schedules
    and `block_m` do not change the result).  wq/wo (C, C) in Linear
    layout (out, in); ls/lb/bo (C,) or (1, C)."""
    cls, _ = VARIANTS[name]
    ls, lb, bo = (t.reshape(-1) for t in (ls, lb, bo))
    q = _ln_q(x, ls, lb, wq, eps)
    o = _variant_heads(q, k, v, num_heads, cls,
                       1.0 / math.sqrt(x.shape[-1] // num_heads))
    return _out_proj(x, o, wo, bo)


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def t1_supported(c: int, num_heads: int, block_m: int) -> Optional[str]:
    """None when attn_variants.cu takes this geometry, else the reason: the
    block keeps the q/o tile, the xn tile and a ring of 64-deep weight tiles
    in shared memory (C <= 320, a multiple of the 64-wide K tile), its head
    tiles are instantiated for head dims 24-48, and it walks `block_m` rows
    64 or 128 at a time."""
    if c % num_heads:
        return f"C={c} not divisible by {num_heads} heads"
    if c % 64 or c > T1_MAX_C:
        return f"C={c}: T1 takes multiples of 64 up to {T1_MAX_C}"
    if c // num_heads not in T1_HEAD_DIMS:
        return f"head dim {c // num_heads}: T1 takes {T1_HEAD_DIMS}"
    if block_m < 64 or block_m % 64:
        return f"block_m={block_m}: T1 takes multiples of 64 rows per block"
    return None


def ln_attn_variant(name: str, x, ls, lb, wq, wo, bo, k, v, eps: float,
                    num_heads: int, block_m: int = 64) -> torch.Tensor:
    """T1: the attention sub-layer of `fused.fused_ln_attn` in one launch,
    with the softmax arithmetic and schedule of variant `name`
    (`VARIANTS`).  x (G, M, C), k/v (G, Sk, C) pre-projected, wq/wo (C, C) in
    Linear layout, ls/lb/bo (C,) or (1, C); `block_m` is the number of query
    rows one block owns.  Raises ValueError for a geometry the kernel has no
    instantiation for (`t1_supported`)."""
    if name not in VARIANTS:
        raise KeyError(f"unknown variant {name!r}; one of {list(VARIANTS)}")
    if x.device.type == "cpu":
        return ln_attn_variant_plain(name, x, ls, lb, wq, wo, bo, k, v, eps,
                                     num_heads, block_m)
    ls, lb, bo = (t.reshape(-1) for t in (ls, lb, bo))
    lib = _prepare(x)
    g, m, c = x.shape
    fused._check_sublayer(x, ls, lb, wq, wo, bo, k, v)
    sk = k.shape[1]
    _check_shape("k", k, (g, sk, c))
    _check_shape("v", v, (g, sk, c))
    why = t1_supported(c, num_heads, block_m)
    if why:
        raise ValueError(f"ln_attn_variant: {why}")
    cls, order = VARIANTS[name]
    out = torch.empty_like(x)
    rc = lib.attn_variants.asva_ln_attn_variant(
        _DTYPES[x.dtype], cls, order, g, m, sk, c, num_heads, block_m,
        float(eps), 1.0 / math.sqrt(c // num_heads), x.data_ptr(),
        ls.data_ptr(), lb.data_ptr(), wq.data_ptr(), wo.data_ptr(),
        bo.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _stream(x))
    _raise_on(lib, rc, f"T1 {name}")
    LAUNCHES["T1"] += 1
    return out


def _head_tile(d: int) -> int:
    return (d + 15) // 16 * 16


def t2f_supported(d: int, group: int) -> Optional[str]:
    """None when attn_grouped.cu has an instantiation for (head dim, group),
    else the reason.  A head costs a thread 32 words of logits and tile / 2 of
    output accumulator; the instantiations stop at group * (32 + tile / 2)
    <= 256, the register file's share of one thread (group 4 up to head tile
    64, group 2 up to 160).  Every admitted (tile, group) has a shared-memory
    plan: the kernel takes 3 or 2 ring stages and 2 or 1 warpgroups a block
    to fit 227 KB."""
    tile = _head_tile(d)
    if d % 8 or tile not in T2_HEAD_TILES:
        return (f"head dim {d}: T2 takes multiples of 8 whose 16-padded "
                f"width is one of {T2_HEAD_TILES}")
    if group not in (1, 2, 4) or group * (32 + tile // 2) > 256:
        return (f"group {group} at head dim {d}: {group} x (32 + {tile // 2})"
                " words of logits and accumulators exceed 256 registers")
    return None


def mha_fwd_grouped(q, k, v, num_heads: int, kv_len: Optional[int],
                    scale: float, block_m: Optional[int] = None,
                    group: int = 1):
    """T2f: B4's function, q (G, M, H*D), k/v (G, Sk, H*D) -> (o, lse
    (G, M, H) fp32), with `group` heads per block and all their logits
    started before any softmax; bit-equal to `fused.mha_fwd`.  `block_m` is
    the TPU tile height and does not apply: a block owns 64 query rows a
    warpgroup.  Raises ValueError for a (group, head dim) without an
    instantiation (`t2f_supported`)."""
    if q.device.type == "cpu":
        return fused.mha_fwd_plain(q, k, v, num_heads, kv_len, scale)
    lib = _prepare(q, k, v)
    g, m, sk, d, kv_len = _attn_geometry(q, k, v, num_heads, kv_len)
    group = min(int(group), num_heads)
    why = t2f_supported(d, group)
    if why:
        raise ValueError(f"mha_fwd_grouped: {why}")
    o = torch.empty_like(q)
    lse = torch.empty((g, m, num_heads), dtype=torch.float32, device=q.device)
    rc = lib.attn_grouped.asva_mha_fwd_grouped(
        _DTYPES[q.dtype], group, g, m, sk, kv_len, num_heads, d, float(scale),
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _stream(q))
    _raise_on(lib, rc, "T2f")
    LAUNCHES["T2F"] += 1
    return o, lse


def t2b_supported(d: int, num_heads: int, variant: str) -> Optional[str]:
    """None when attn_bwd_fused.cu has an instantiation for (head dim,
    variant), else the reason.  A head costs a thread 64 words of S^T and
    (dO V^T)^T and `tile` words of dK/dV accumulators; the instantiations
    stop at heads * (64 + tile) <= 512 (past 255 registers the rest spills to
    local memory, and ptxas serializes the wgmma of b4).  Every admitted
    (tile, heads) has a shared-memory plan: 3, 2 or 1 ring stages and 2 or
    1 warpgroups a block."""
    tile = _head_tile(d)
    if d % 8 or tile not in T2_HEAD_TILES:
        return (f"head dim {d}: T2 takes multiples of 8 whose 16-padded "
                f"width is one of {T2_HEAD_TILES}")
    heads = BWD_VARIANTS[variant][0] or num_heads
    heads = min(heads, num_heads)
    if heads not in (1, 2, 4) or heads * (64 + tile) > 512:
        return (f"variant {variant} ({heads} heads a block) at head dim {d}: "
                f"{heads} x (64 + {tile}) accumulator words exceed 512")
    return None


def mha_bwd_ordered(q, k, v, do, lse, dd, num_heads: int,
                    kv_len: Optional[int], scale: float,
                    block_m: Optional[int] = None, variant: str = "b0"):
    """T2b: B5's function -> (dq, dk, dv) in the dtypes of (q, k, v), as one
    kernel of five products in the schedule `variant` (`BWD_VARIANTS`).
    dK/dV are B5's statements in B5's order (reproducible; B5's bits where
    `fused.dkv_split` is 1); dQ is added across the K/V blocks with fp32
    atomics and cast once.  `block_m` does not apply.
    Raises ValueError for a (variant, head dim) without an instantiation
    (`t2b_supported`)."""
    if variant not in BWD_VARIANTS:
        raise KeyError(f"unknown variant {variant!r}; one of "
                       f"{list(BWD_VARIANTS)}")
    if q.device.type == "cpu":
        return fused.mha_bwd_plain(q, k, v, do, lse, dd, num_heads, kv_len,
                                   scale)
    lib = _prepare(q, k, v, do)
    g, m, sk, d, kv_len = _attn_geometry(q, k, v, num_heads, kv_len)
    _check_shape("do", do, q.shape)
    _check((lse, dd), torch.float32, q.device)
    _check_shape("lse", lse, (g, m, num_heads))
    _check_shape("dd", dd, (g, m, num_heads))
    why = t2b_supported(d, num_heads, variant)
    if why:
        raise ValueError(f"mha_bwd_ordered: {why}")
    heads, seq = BWD_VARIANTS[variant]
    heads = min(heads or num_heads, num_heads)
    dq32 = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    rc = lib.attn_bwd_fused.asva_mha_bwd_fused(
        _DTYPES[q.dtype], heads, int(seq), g, m, sk, kv_len, num_heads, d,
        float(scale), q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), dd.data_ptr(), dq32.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _stream(q))
    _raise_on(lib, rc, f"T2b {variant}")
    LAUNCHES["T2B"] += 1
    return dq32.to(q.dtype), dk, dv
