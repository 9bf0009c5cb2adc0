"""Parity of the port's B6 (ops/flat_attention.py) and B7 (fused.fused_ff_mix)
plain versions against asva_tpu on the CPU: the JAX einsum / reference
composites, the Pallas kernels themselves in TPU interpret mode, and the
gradients of the autograd rules against jax.grad.  fp32; tolerances stated
per test."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from asva_tpu.ops import pallas_attn as pa
from asva_tpu.ops import pallas_fused as pf
from asva_tpu_torch.ops import cuda_build, flat_attention, fused

from test_torch_ops import close, t

torch.set_num_threads(1)


def _qkv(rng, bh, sq, sk, d, dtype=np.float32):
    return tuple(rng.standard_normal(s).astype(dtype)
                 for s in ((bh, sq, d), (bh, sk, d), (bh, sk, d)))


def _masked_einsum(q, k, v, kv_len):
    """The masked form inside pallas_attn._cbwd (:113-122)."""
    d = q.shape[-1]
    scale = 1.0 / jnp.sqrt(jnp.asarray(d, jnp.float32))
    s = jnp.einsum("bqd,bkd->bqk", q, k,
                   preferred_element_type=jnp.float32) * scale
    cols = jnp.arange(s.shape[-1])
    s = jnp.where(cols[None, None, :] < kv_len, s, -1e9)
    p = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bqk,bkd->bqd", p.astype(v.dtype), v,
                      preferred_element_type=jnp.float32).astype(q.dtype)


# ------------------------------------------------------------------- B6 ---

@pytest.mark.parametrize("bh,sq,sk,d", [(4, 24, 10, 40), (2, 7, 33, 80),
                                        (3, 16, 16, 160)])
def test_b6_plain_matches_einsum(rng, bh, sq, sk, d):
    """attention_flat_plain and the vmem_attention wrapper (CPU: the plain
    version) against `_einsum_attention`, 1e-5."""
    q, k, v = _qkv(rng, bh, sq, sk, d)
    want = pa._einsum_attention(*map(jnp.asarray, (q, k, v)))
    close(flat_attention.attention_flat_plain(t(q), t(k), t(v)), want, 1e-5)
    close(flat_attention.vmem_attention(t(q), t(k), t(v)), want, 1e-5)


@pytest.mark.parametrize("sk,kv_len", [(16, 9), (128, 77), (12, 12)])
def test_b6_plain_masked_matches_cbwd_form(rng, sk, kv_len):
    """kv_len masking against the masked einsum of `_cbwd`, 1e-5; rows of
    K/V past kv_len hold noise and must not matter."""
    q, k, v = _qkv(rng, 2, 20, sk, 40)
    want = _masked_einsum(*map(jnp.asarray, (q, k, v)), kv_len)
    close(flat_attention.vmem_cross_attention(t(q), t(k), t(v), kv_len),
          want, 1e-5)
    close(flat_attention.vmem_cross_attention(t(q), t(k[:, :kv_len]),
                                              t(v[:, :kv_len]), kv_len),
          want, 1e-5)


def test_b6_plain_matches_pallas_interpret(rng):
    """Against the Pallas kernel itself (`_attention_flat`, interpret mode),
    d = 40, unmasked; 1e-5."""
    q, k, v = _qkv(rng, 4, 512, 128, 40)
    with pltpu.force_tpu_interpret_mode():
        want = pa._attention_flat(*map(jnp.asarray, (q, k, v)), block_q=256)
    close(flat_attention.attention_flat_plain(t(q), t(k), t(v)), want, 1e-5)


def test_b6_plain_masked_matches_pallas_interpret(rng):
    """77 text tokens zero-padded to 128 through `vmem_cross_attention` in
    interpret mode against the port on the unpadded and the padded K/V;
    1e-5."""
    q, k, v = _qkv(rng, 2, 256, 77, 40)
    pad = ((0, 0), (0, 51), (0, 0))
    kp, vp = np.pad(k, pad), np.pad(v, pad)
    with pltpu.force_tpu_interpret_mode():
        want = pa.vmem_cross_attention(*map(jnp.asarray, (q, kp, vp)), 77)
    close(flat_attention.vmem_cross_attention(t(q), t(k), t(v), 77), want,
          1e-5)
    close(flat_attention.vmem_cross_attention(t(q), t(kp), t(vp), 77), want,
          1e-5)


def test_b6_plain_bf16_rounds_after_normalising(rng):
    """bf16: the plain version rounds the normalised P to bf16 as the Pallas
    body does (:38).  Both sides accumulate P V in fp32 and round once, so
    they agree to one bf16 ulp of the output, 2**-7 relative to max|o|."""
    q, k, v = _qkv(rng, 2, 256, 128, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pa._attention_flat(jq, jk, jv, block_q=256)
                          .astype(jnp.float32))
    got = flat_attention.attention_flat_plain(
        *(t(a).to(torch.bfloat16) for a in (q, k, v)))
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * np.abs(
        want).max()


@pytest.mark.parametrize("kv_len", [None, 9])
def test_b6_gradients_match_jax(rng, kv_len):
    """The autograd rule (plain forward on the CPU, backward through the
    plain version with the same mask) against jax.grad of pallas_attn's
    custom_vjp in interpret mode, 1e-4."""
    q, k, v = _qkv(rng, 2, 128, 128, 32)
    w = rng.standard_normal(q.shape).astype(np.float32)

    def loss(q, k, v):
        with pltpu.force_tpu_interpret_mode():
            o = (pa.vmem_attention(q, k, v) if kv_len is None
                 else pa.vmem_cross_attention(q, k, v, kv_len))
        return jnp.sum(o * w)
    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = [t(a).requires_grad_(True) for a in (q, k, v)]
    out = (flat_attention.vmem_attention(*leaves) if kv_len is None
           else flat_attention.vmem_cross_attention(*leaves, kv_len))
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * t(w)).sum(), leaves)
    for a, b in zip(got, want):
        close(a, b, 1e-4)
    if kv_len is not None:
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


# ------------------------------------------------------------------- B7 ---

def _mix_args(rng, b, f, n, c):
    y = (rng.standard_normal((b, f, n, c)) * 0.5).astype(np.float32)
    ws = [(rng.standard_normal((c, c)) * 0.05).astype(np.float32)
          for _ in range(3)]                         # JAX layout (in, out)
    bias = (rng.standard_normal((1, c)) * 0.05).astype(np.float32)
    return y, ws, bias


def _torch_mix_args(y, ws, bias):
    """The port's layout: one Linear(3C, C) weight (C, 3C) = [head | prev |
    curr], its column blocks passed as views."""
    c = y.shape[-1]
    w = t(np.concatenate([k.T for k in ws], axis=1))
    return t(y), w[:, :c], w[:, c:2 * c], w[:, 2 * c:], t(bias)


@pytest.mark.parametrize("b,f,n,c", [(2, 4, 6, 16), (1, 1, 5, 8),
                                     (2, 2, 3, 32)])
def test_b7_plain_matches_reference(rng, b, f, n, c):
    """ff_mix_plain and the wrapper against `_ff_mix_reference`, 1e-5 (fp32:
    the per-product rounding of the reference is the identity); f = 1 makes
    every tap frame 0."""
    y, ws, bias = _mix_args(rng, b, f, n, c)
    want = pf._ff_mix_reference(jnp.asarray(y), *map(jnp.asarray, ws),
                                jnp.asarray(bias))
    args = _torch_mix_args(y, ws, bias)
    close(fused.ff_mix_plain(*args), want, 1e-5)
    close(fused.fused_ff_mix(*args), want, 1e-5)


def test_b7_plain_equals_temporal_mix(rng):
    """The function FFInflatedConv applies (primitives.temporal_mix on the
    (C, 3C) weight) is the same function, 1e-6."""
    from asva_tpu_torch.models.unet3d.primitives import temporal_mix
    y, ws, bias = _mix_args(rng, 2, 3, 4, 16)
    ty, kh, kp, kc, tb = _torch_mix_args(y, ws, bias)
    w = torch.cat([kh, kp, kc], dim=1)
    close(fused.ff_mix_plain(ty, kh, kp, kc, tb),
          temporal_mix(ty, w, tb.reshape(-1)).numpy(), 1e-6)


def test_b7_plain_matches_pallas_interpret(rng):
    """Against the Pallas kernel itself (`fused_ff_mix` in interpret mode),
    2e-5."""
    b, f, n, c = 2, 4, 256, 64
    y, ws, bias = _mix_args(rng, b, f, n, c)
    ok, bn = pf.supports_mix(f, n, c, jnp.float32)
    assert ok
    with pltpu.force_tpu_interpret_mode():
        want = pf.fused_ff_mix(jnp.asarray(y), *map(jnp.asarray, ws),
                               jnp.asarray(bias), bn)
    close(fused.ff_mix_plain(*_torch_mix_args(y, ws, bias)), want, 2e-5)


def test_b7_plain_bf16_accumulates_in_fp32(rng):
    """bf16: three products summed in fp32 with y and the bias, one cast
    (the Pallas body), not `_ff_mix_reference`'s per-product rounding:
    within one bf16 ulp, 2**-7 of max|out|, of the interpret-mode kernel."""
    b, f, n, c = 1, 3, 128, 32
    y, ws, bias = _mix_args(rng, b, f, n, c)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pf.fused_ff_mix(
            jnp.asarray(y, jnp.bfloat16),
            *(jnp.asarray(k, jnp.bfloat16) for k in ws),
            jnp.asarray(bias, jnp.bfloat16), 128).astype(jnp.float32))
    args = [a.to(torch.bfloat16) for a in _torch_mix_args(y, ws, bias)]
    got = fused.ff_mix_plain(*args)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - want).max() <= 2.0 ** -7 * np.abs(
        want).max()


def test_b7_gradients_match_jax(rng):
    """The autograd rule against jax.grad of pallas fused_ff_mix's
    custom_vjp (interpret mode) for y, the three matrices and the bias;
    1e-4."""
    b, f, n, c = 1, 3, 128, 32
    y, ws, bias = _mix_args(rng, b, f, n, c)
    w = rng.standard_normal(y.shape).astype(np.float32)

    def loss(*a):
        with pltpu.force_tpu_interpret_mode():
            return jnp.sum(pf.fused_ff_mix(*a, 128) * w)
    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        jnp.asarray(y), *map(jnp.asarray, ws), jnp.asarray(bias))
    ty, tb = t(y).requires_grad_(True), t(bias).requires_grad_(True)
    wt = t(np.concatenate([k.T for k in ws], axis=1)).requires_grad_(True)
    out = fused.fused_ff_mix(ty, wt[:, :c], wt[:, c:2 * c], wt[:, 2 * c:], tb)
    assert out.grad_fn is not None
    gy, gw, gb = torch.autograd.grad((out * t(w)).sum(), [ty, wt, tb])
    close(gy, want[0], 1e-4)
    for i in range(3):                  # (out, in) blocks vs JAX (in, out)
        close(gw[:, i * c:(i + 1) * c].t(), want[1 + i], 1e-4)
    close(gb, want[4], 1e-4)


def test_b7_casts_fp32_parameters_at_use(rng):
    """fp32 matrices with bf16 activations are cast at use and receive fp32
    gradients."""
    y, ws, bias = _mix_args(rng, 1, 2, 4, 16)
    ty, kh, kp, kc, tb = _torch_mix_args(y, ws, bias)
    leaves = [a.clone().requires_grad_(True) for a in (kh, kp, kc, tb)]
    out = fused.fused_ff_mix(ty.to(torch.bfloat16), *leaves)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert all(p.grad is not None and p.grad.dtype == torch.float32
               for p in leaves)


# ------------------------------------------------------- wrapper dispatch ---

def _meta(*shape):
    return torch.empty(shape, device="meta")


@pytest.mark.parametrize("shape,plan,loaders", [
    # the SD1.5 levels of a request (2 CFG clips of 12 frames) on 132 SMs
    ((2, 12, 1024, 320), (160, 128, "FRAME"), 2),
    ((2, 12, 64, 1280), (160, 64, "FRAME"), 2),
    ((2, 12, 16, 1280), (160, 64, "CPASYNC"), 1),
    ((4, 12, 64, 1280), (160, 128, "CPASYNC"), 1),  # a training batch
    ((2, 5, 37, 320), (160, 64, "CPASYNC"), 1),
    ((2, 4, 24, 64), (64, 64, "CPASYNC"), 1),
])
def test_b7_plan(shape, plan, loaders):
    """ff_mix_plan, the plan csrc/mix.cu is launched on: column tile, rows a
    block and the best of the loaders of A the shape admits."""
    got = fused.ff_mix_plan(shape, 132)
    assert (got["tn"], got["bm"], got["path"]) == plan
    admitted = fused.ff_mix_loaders(shape[2], got["bm"])
    assert admitted[0] == got["path"] and len(admitted) == loaders
    assert admitted[-1] == "CPASYNC"


def test_cpu_path_counts_no_launch(rng):
    before = dict(fused.LAUNCHES)
    assert "B6" in before and "B7" in before
    q, k, v = _qkv(rng, 2, 5, 4, 8)
    flat_attention.vmem_cross_attention(t(q), t(k), t(v), 3)
    fused.fused_ff_mix(*_torch_mix_args(*_mix_args(rng, 1, 2, 3, 8)))
    assert fused.LAUNCHES == before


@pytest.mark.parametrize("which", ["B6", "B7"])
def test_non_cpu_tensor_never_takes_plain_path(which):
    """A tensor off the CPU must reach the kernel path and raise there when
    it cannot launch — never silently compute the plain version."""
    if which == "B6":
        call = lambda: flat_attention.vmem_attention(  # noqa: E731
            _meta(2, 8, 40), _meta(2, 4, 40), _meta(2, 4, 40))
    else:
        call = lambda: fused.fused_ff_mix(  # noqa: E731
            _meta(1, 2, 4, 32), _meta(32, 32), _meta(32, 32), _meta(32, 32),
            _meta(32))
    with pytest.raises(ValueError, match="CUDA"):
        call()


@pytest.mark.parametrize("which", ["B6", "B7"])
def test_missing_toolchain_raises_not_falls_back(monkeypatch, which):
    """With the device checks passed (monkeypatched) and no nvcc, the
    wrapper must raise instead of computing the plain version."""
    monkeypatch.setattr(fused, "_prepare",
                        lambda x, *ts: cuda_build.library())
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: None)
    cuda_build.library.cache_clear()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        if which == "B6":
            flat_attention.vmem_attention(_meta(2, 8, 40), _meta(2, 4, 40),
                                          _meta(2, 4, 40))
        else:
            fused.fused_ff_mix(_meta(1, 2, 4, 32), _meta(32, 32),
                               _meta(32, 32), _meta(32, 32), _meta(32))
    cuda_build.library.cache_clear()
