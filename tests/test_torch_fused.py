"""Kernels B1-B5 of the port (asva_tpu_torch/ops/fused.py).

On the CPU the wrappers compute their plain versions, which are held here
against asva_tpu's `_ln_*_reference` composites and against the Pallas
kernels in TPU interpret mode; the autograd rules (with the plain B4/B5
inside) are held against `jax.grad` of the Pallas custom_vjp rules and of
the reference composites.  The wrappers must never fall back to the plain
version for a non-CPU tensor.  The CUDA kernels themselves run only on a
card: tests/test_torch_cuda.py and chip_smoke.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from asva_tpu.ops import pallas_fused as pf
from asva_tpu_torch.ops import cuda_build, fused

from test_torch_ops import close, t

torch.set_num_threads(1)


def _sub(rng, c, hd=None):
    """LN scale/bias + wq (C, HD) + wo (HD, C) + bo in JAX layout."""
    hd = hd or c
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa
    return [r(c) + 1.0, r(c), r(c, hd), r(hd, c), r(c)]


def _torch_sub(sub):
    """The same sub-layer in torch layout (Linear weights (out, in))."""
    ls, lb, wq, wo, bo = sub
    return [t(ls), t(lb), t(wq.T), t(wo.T), t(bo)]


def _jax_sub(sub):
    ls, lb, wq, wo, bo = sub
    return [jnp.asarray(ls)[None], jnp.asarray(lb)[None], jnp.asarray(wq),
            jnp.asarray(wo), jnp.asarray(bo)[None]]


def _ff(rng, m, c):
    inner = 4 * c
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa
    return (r(m, c) * 10, r(c) + 1.0, r(c), r(c, 2 * inner), r(2 * inner),
            r(inner, c), r(c))


def _ff_torch(args):
    x, ls, lb, wi, bi, wo, bo = args
    return (t(x), t(ls), t(lb), t(wi.T), t(bi), t(wo.T), t(bo))


def _ff_jax(args):
    x, ls, lb, wi, bi, wo, bo = args
    return (jnp.asarray(x), jnp.asarray(ls)[None], jnp.asarray(lb)[None],
            jnp.asarray(wi), jnp.asarray(bi)[None], jnp.asarray(wo),
            jnp.asarray(bo)[None])


# ------------------------------------------------------------------- B3 ---

@pytest.mark.parametrize("m,c", [(64, 64), (96, 320)])
def test_b3_plain_matches_reference(rng, m, c):
    """fp32, 3e-5: the plain version is a transcription of the composite."""
    args = _ff(rng, m, c)
    want = pf._ln_geglu_reference(*_ff_jax(args), 1e-5)
    close(fused.fused_ln_geglu(*_ff_torch(args), 1e-5), want, 3e-5)


def test_b3_plain_matches_pallas_interpret(rng):
    """Against the Pallas kernel itself (interpret mode), 3e-5: the kernel's
    A&S erf approximation errs by <= 1.5e-7."""
    args = _ff(rng, 256, 64)
    with pltpu.force_tpu_interpret_mode():
        want = pf.fused_ln_geglu(*_ff_jax(args), 1e-5, 128)
    close(fused.fused_ln_geglu(*_ff_torch(args), 1e-5), want, 3e-5)


# ------------------------------------------------------------------- B1 ---

def _attn_case(rng, g, m, c, sk, kv_len):
    x = (rng.standard_normal((g, m, c)) * 2).astype(np.float32)
    sub = _sub(rng, c)
    k = rng.standard_normal((g, sk, c)).astype(np.float32)
    v = rng.standard_normal((g, sk, c)).astype(np.float32)
    if kv_len is not None:  # zero padding past kv_len, as the JAX callers
        k[:, kv_len:] = 0.0
        v[:, kv_len:] = 0.0
    return x, sub, k, v


@pytest.mark.parametrize("c,heads,sk,kv_len", [
    (320, 8, 128, 77),    # d = 40, text K/V padded to 128, masked at 77
    (160, 2, 128, 25),    # d = 80, audio-like 25 tokens
    (320, 8, 64, None),   # d = 40, unmasked
])
def test_b1_plain_matches_reference(rng, c, heads, sk, kv_len):
    """fp32, 3e-5, including kv_len < Sk masking."""
    x, sub, k, v = _attn_case(rng, 2, 48, c, sk, kv_len)
    want = pf._ln_attn_reference(jnp.asarray(x), *_jax_sub(sub),
                                 jnp.asarray(k), jnp.asarray(v), 1e-5, heads,
                                 kv_len)
    got = fused.fused_ln_attn(t(x), *_torch_sub(sub), t(k), t(v), 1e-5,
                              heads, kv_len)
    close(got, want, 3e-5)


def test_b1_unpadded_kv_equals_masked_padding(rng):
    """The port never pads K/V: the unpadded call equals the padded,
    kv_len-masked one (-1e9 mask), 1e-6."""
    x, sub, k, v = _attn_case(rng, 2, 32, 64, 128, 77)
    ts = _torch_sub(sub)
    padded = fused.fused_ln_attn(t(x), *ts, t(k), t(v), 1e-5, 8, 77)
    short = fused.fused_ln_attn(t(x), *ts, t(k[:, :77]), t(v[:, :77]), 1e-5, 8)
    close(short, padded.numpy(), 1e-6)


@pytest.mark.parametrize("c,heads", [(320, 8), (160, 2)])
def test_b1_plain_matches_pallas_interpret(rng, c, heads):
    """Against the Pallas kernel (interpret mode), d = 40 and 80, kv_len <
    Sk, 3e-5: the kernel normalises P before PV, the plain version inside
    the softmax."""
    x, sub, k, v = _attn_case(rng, 1, 128, c, 128, 77)
    with pltpu.force_tpu_interpret_mode():
        want = pf.fused_ln_attn(jnp.asarray(x), *_jax_sub(sub),
                                jnp.asarray(k), jnp.asarray(v), 1e-5, heads,
                                77, 128)
    got = fused.fused_ln_attn(t(x), *_torch_sub(sub), t(k), t(v), 1e-5,
                              heads, 77)
    close(got, want, 3e-5)


# ------------------------------------------------------------------- B2 ---

def _attn3_case(rng, b, f, n, c, ska, skt):
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa
    x = r(b, f, n, c) * 2
    subs = [_sub(rng, c) for _ in range(3)]
    kv = [(r(b, n, c), r(b, n, c)), (r(b, f, ska, c), r(b, f, ska, c)),
          (r(b, skt, c), r(b, skt, c))]
    return x, subs, kv


def _attn3_args(x, subs, kv, sub_fn, arr):
    args = [arr(x)]
    for sub, (k, v) in zip(subs, kv):
        args += sub_fn(sub) + [arr(k), arr(v)]
    return args


def test_b2_plain_matches_reference(rng):
    """fp32, 3e-5, per-(b, f) audio K/V and masked text K/V."""
    x, subs, kv = _attn3_case(rng, 2, 3, 16, 64, 25, 128)
    lens = (None, None, 77)
    want = pf._ln_attn3_reference(
        *_attn3_args(x, subs, kv, _jax_sub, jnp.asarray), (1e-5,) * 3, 8, lens)
    got = fused.fused_ln_attn3(*_attn3_args(x, subs, kv, _torch_sub, t),
                               (1e-5,) * 3, 8, lens)
    close(got, want, 3e-5)


def test_b2_plain_matches_pallas_interpret(rng):
    """Against the Pallas kernel (interpret mode), d = 40, 3e-5."""
    x, subs, kv = _attn3_case(rng, 1, 2, 128, 320, 128, 128)
    lens = (None, 25, 77)
    with pltpu.force_tpu_interpret_mode():
        want = pf.fused_ln_attn3(
            *_attn3_args(x, subs, kv, _jax_sub, jnp.asarray), (1e-5,) * 3, 8,
            lens, 128, (True, True, True))
    got = fused.fused_ln_attn3(*_attn3_args(x, subs, kv, _torch_sub, t),
                               (1e-5,) * 3, 8, lens)
    close(got, want, 3e-5)


# ------------------------------------------------------------ B4 and B5 ---

def _qkv(rng, g, m, sk, hd):
    r = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)  # noqa
    return r(g, m, hd), r(g, sk, hd), r(g, sk, hd)


@pytest.mark.parametrize("kv_len", [None, 77])
def test_b4_plain_matches_pallas_interpret(rng, kv_len):
    """mha_fwd_plain's o and lse against `_mha_fwd_flat` in interpret mode,
    d = 40, with and without kv_len masking; fp32, 2e-5 (the kernel
    normalises P before PV, the plain version inside the softmax)."""
    q, k, v = _qkv(rng, 2, 256, 128, 320)
    scale = 1.0 / 40 ** 0.5
    with pltpu.force_tpu_interpret_mode():
        o, lse = pf._mha_fwd_flat(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), 8, kv_len, scale, 128)
    got_o, got_lse = fused.mha_fwd(t(q), t(k), t(v), 8, kv_len, scale)
    close(got_o, o, 2e-5)
    assert got_lse.shape == (2, 256, 8) and got_lse.dtype == torch.float32
    close(got_lse, lse, 2e-5)


@pytest.mark.parametrize("kv_len", [None, 77])
def test_b5_plain_matches_pallas_interpret(rng, kv_len):
    """mha_bwd_plain's dq, dk, dv against `_mha_bwd_flat` in interpret mode
    on the same (do, lse, dd); masked K/V rows get exactly zero; 2e-5."""
    q, k, v = _qkv(rng, 2, 256, 128, 160)
    do = (rng.standard_normal(q.shape) * 0.5).astype(np.float32)
    scale = 1.0 / 80 ** 0.5
    jq, jk, jv, jdo = map(jnp.asarray, (q, k, v, do))
    with pltpu.force_tpu_interpret_mode():
        o, lse = pf._mha_fwd_flat(jq, jk, jv, 2, kv_len, scale, 128)
        dd = jnp.sum(jdo.reshape(2, 256, 2, 80) * o.reshape(2, 256, 2, 80),
                     axis=-1)
        want = pf._mha_bwd_flat(jq, jk, jv, jdo, lse, dd, 2, kv_len, scale,
                                128)
    got = fused.mha_bwd(t(q), t(k), t(v), t(do), t(lse), t(dd), 2, kv_len,
                        scale)
    for a, b in zip(got, want):
        close(a, b, 2e-5)
    if kv_len is not None:
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()
    dq_only = fused.mha_bwd(t(q), t(k), t(v), t(do), t(lse), t(dd), 2,
                            kv_len, scale, need_dkv=False)
    assert dq_only[1] is None and dq_only[2] is None
    assert torch.equal(dq_only[0], got[0])


@pytest.mark.parametrize("g,m,sk,heads,d,want", [
    (4, 12288, 1024, 8, 40, 1),   # training attn1 at 32x32: 256 blocks
    (48, 1024, 25, 8, 40, 1),     # audio, 64-row blocks: 384 blocks
    (4, 12288, 77, 8, 40, 5),     # text: 32 blocks
    (4, 3072, 256, 8, 80, 3),     # 16x16 attn1: 64 blocks
    (4, 768, 64, 8, 160, 3),      # 8x8 attn1, split head tile: 64 blocks
    (1, 128, 77, 2, 40, 2),       # capped at one range per query tile
])
def test_b5_dkv_split_fills_the_sms(g, m, sk, heads, d, want):
    """B5's dK/dV kernel is split over query ranges only when its grid
    would fill less than half of the 132 SMs of an H100, into enough ranges
    for one block an SM, never more than one per 64-row query tile."""
    assert fused.dkv_split(g, m, sk, heads, d, 132) == want


def test_mha_kvshared_gradients_match_jax(rng):
    """The standalone differentiable attention (forward B4, backward dd +
    B5) against jax.grad of pallas mha_kvshared in interpret mode, 1e-4."""
    q, k, v = _qkv(rng, 1, 128, 128, 64)
    co = rng.standard_normal(q.shape).astype(np.float32)
    scale = 1.0 / 32 ** 0.5

    def loss(q_, k_, v_):
        return jnp.sum(pf.mha_kvshared(q_, k_, v_, 2, 77, scale, 128)
                       * jnp.asarray(co))
    with pltpu.force_tpu_interpret_mode():
        want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = fused.mha_kvshared(*leaves, 2, 77, scale)
    assert type(out.grad_fn).__name__ == "_MhaKvSharedBackward"
    got = torch.autograd.grad((out * t(co)).sum(), leaves)
    for a, b in zip(got, want):
        close(a, b, 1e-4)


# ------------------------------------------------------- autograd rules ---

def _leaves(tensors):
    return [a.requires_grad_(True) for a in tensors]


@pytest.mark.parametrize("ref", ["pallas_flash_bwd", "reference"])
def test_b1_manual_backward_matches_jax(rng, monkeypatch, ref):
    """fused_ln_attn's manual backward (LN + q prefix recomputed, do/dwo/dbo
    in fp32, dd, B5, dx = g + dx_prefix) against jax.grad of the Pallas
    custom_vjp with FORCE on (interpret mode) and of `_ln_attn_reference`,
    for all eight inputs; fp32, 1e-4 (as the JAX package's own test)."""
    x, sub, k, v = _attn_case(rng, 1, 512, 320, 128, None)
    jargs = [jnp.asarray(x)] + _jax_sub(sub) + [jnp.asarray(k),
                                                jnp.asarray(v)]
    if ref == "reference":
        want = jax.grad(lambda *a: jnp.sum(
            pf._ln_attn_reference(*a, 1e-5, 8, None) ** 2),
            argnums=tuple(range(8)))(*jargs)
    else:
        monkeypatch.setattr(pf, "FORCE", True)
        with pltpu.force_tpu_interpret_mode():
            want = jax.grad(lambda *a: jnp.sum(
                pf.fused_ln_attn(*a, 1e-5, 8, None, 256) ** 2),
                argnums=tuple(range(8)))(*jargs)
    leaves = _leaves([t(x)] + _torch_sub(sub) + [t(k), t(v)])
    out = fused.fused_ln_attn(*leaves, 1e-5, 8)
    assert type(out.grad_fn).__name__ == "_LnAttnBackward"
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    ls, lb, wq, wo, bo = want[1:6]
    want = [want[0], ls[0], lb[0], wq.T, wo.T, bo[0], want[6], want[7]]
    for a, b in zip(got, want):
        close(a, b, 1e-4 * max(1.0, float(np.abs(np.asarray(b)).max())))


def test_b1_manual_backward_with_kv_len_and_frozen_kv(rng):
    """kv_len < Sk: equal to autograd of the plain composite, 1e-5; K/V that
    need no gradient get none and leave the others unchanged."""
    x, sub, k, v = _attn_case(rng, 2, 48, 64, 128, 77)
    leaves = _leaves([t(x)] + _torch_sub(sub) + [t(k), t(v)])
    got = torch.autograd.grad(
        (fused.fused_ln_attn(*leaves, 1e-5, 8, 77) ** 2).sum(), leaves)
    want = torch.autograd.grad(
        (fused.ln_attn_plain(*leaves, 1e-5, 8, 77) ** 2).sum(), leaves)
    for a, b in zip(got, want):
        close(a, b.numpy(), 1e-5 * max(1.0, float(b.abs().max())))
    frozen = leaves[:6] + [t(k), t(v)]
    again = torch.autograd.grad(
        (fused.fused_ln_attn(*frozen, 1e-5, 8, 77) ** 2).sum(), leaves[:6])
    for a, b in zip(again, got):
        assert torch.equal(a, b)


def test_b3_gradients_match_jax(rng):
    """fused_ln_geglu's backward (autograd of the plain composite recomputed
    in the backward) against jax.grad of `_ln_geglu_reference`; 1e-4."""
    args = _ff(rng, 64, 64)
    want = jax.grad(lambda *a: jnp.sum(pf._ln_geglu_reference(*a, 1e-5) ** 2),
                    argnums=tuple(range(7)))(*_ff_jax(args))
    leaves = _leaves(list(_ff_torch(args)))
    out = fused.fused_ln_geglu(*leaves, 1e-5)
    assert type(out.grad_fn).__name__ == "_LnGegluBackward"
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    x, ls, lb, wi, bi, wo, bo = want
    want = [x, ls[0], lb[0], wi.T, bi[0], wo.T, bo[0]]
    for a, b in zip(got, want):
        close(a, b, 1e-4 * max(1.0, float(np.abs(np.asarray(b)).max())))


def test_b2_gradients_match_jax(rng):
    """fused_ln_attn3's backward against jax.grad of `_ln_attn3_reference`
    for x, the 15 parameters and the 6 K/V tensors; 1e-4."""
    x, subs, kv = _attn3_case(rng, 2, 3, 16, 64, 25, 128)
    lens = (None, None, 77)
    jargs = _attn3_args(x, subs, kv, _jax_sub, jnp.asarray)
    want = jax.grad(lambda *a: jnp.sum(
        pf._ln_attn3_reference(*a, (1e-5,) * 3, 8, lens) ** 2),
        argnums=tuple(range(22)))(*jargs)
    leaves = _leaves(_attn3_args(x, subs, kv, _torch_sub, t))
    out = fused.fused_ln_attn3(*leaves, (1e-5,) * 3, 8, lens)
    assert type(out.grad_fn).__name__ == "_LnAttn3Backward"
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    for i, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        j = (i - 1) % 7 if i else None   # position inside a sub-layer bundle
        if j in (0, 1, 4):
            b = b[0]                     # (1, C) vectors
        elif j in (2, 3):
            b = b.T                      # Linear layout
        close(a, b, 1e-4 * max(1.0, float(np.abs(b).max())))


def test_wrappers_cast_fp32_parameters_at_use(rng):
    """fp32 parameters under bf16 activations (the training layout): the
    output is bf16, equal to the call with parameters rounded beforehand,
    and the parameters receive fp32 gradients."""
    x, sub, k, v = _attn_case(rng, 1, 16, 64, 8, None)
    xb, kb, vb = (t(a).bfloat16() for a in (x, k, v))
    params = _leaves(_torch_sub(sub))
    out = fused.fused_ln_attn(xb, *params, kb, vb, 1e-5, 8)
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None
    with torch.no_grad():
        rounded = fused.fused_ln_attn(xb, *[p.bfloat16() for p in params],
                                      kb, vb, 1e-5, 8)
    assert torch.equal(out.detach(), rounded)
    out.float().sum().backward()
    for p in params:
        assert p.grad.dtype == torch.float32 and torch.isfinite(p.grad).all()


# ------------------------------------------------------- wrapper dispatch ---

def test_cpu_path_counts_no_launch(rng):
    before = dict(fused.LAUNCHES)
    args = _ff(rng, 32, 64)
    fused.fused_ln_geglu(*_ff_torch(args), 1e-5)
    assert fused.LAUNCHES == before


def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("which", ["B1", "B2", "B3"])
def test_non_cpu_tensor_never_takes_plain_path(which):
    """A tensor off the CPU must reach the kernel path and raise there when
    it cannot launch — never silently compute the plain version."""
    c = 64
    if which == "B3":
        call = lambda: fused.fused_ln_geglu(  # noqa: E731
            _meta(8, c), _meta(c), _meta(c), _meta(8 * c, c), _meta(8 * c),
            _meta(c, 4 * c), _meta(c), 1e-5)
    elif which == "B1":
        call = lambda: fused.fused_ln_attn(  # noqa: E731
            _meta(1, 8, c), _meta(c), _meta(c), _meta(c, c), _meta(c, c),
            _meta(c), _meta(1, 4, c), _meta(1, 4, c), 1e-5, 8)
    else:
        sub = [_meta(c), _meta(c), _meta(c, c), _meta(c, c), _meta(c)]
        call = lambda: fused.fused_ln_attn3(  # noqa: E731
            _meta(1, 2, 4, c), *sub, _meta(1, 4, c), _meta(1, 4, c), *sub,
            _meta(1, 2, 3, c), _meta(1, 2, 3, c), *sub, _meta(1, 5, c),
            _meta(1, 5, c), (1e-5,) * 3, 8)
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_missing_toolchain_raises_not_falls_back(monkeypatch):
    """With the device checks passed (monkeypatched) and no nvcc, the
    wrapper must raise instead of computing the plain version."""
    monkeypatch.setattr(fused, "_prepare",
                        lambda x, *ts: cuda_build.library())
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: None)
    cuda_build.library.cache_clear()
    c = 64
    with pytest.raises(RuntimeError, match="nvcc not found"):
        fused.fused_ln_geglu(_meta(8, c), _meta(c), _meta(c), _meta(8 * c, c),
                             _meta(8 * c), _meta(c, 4 * c), _meta(c), 1e-5)
    cuda_build.library.cache_clear()
