"""Kernels B1-B3 of the port (asva_tpu_torch/ops/fused.py).

On the CPU the wrappers compute their plain versions, which are held here
against asva_tpu's `_ln_*_reference` composites and against the Pallas
kernels in TPU interpret mode.  The wrappers must never fall back to the
plain version for a non-CPU tensor.  The CUDA kernels themselves run only
on a card: tests/test_torch_cuda.py and chip_smoke.py."""
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
