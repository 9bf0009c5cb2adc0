"""The port's CUDA kernels (B1-B7) against their plain versions, on a card.

Marked `cuda`: each test skips without a CUDA device.  This file imports no
JAX, so it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX.)  chip_smoke.py holds
the kernels against their plain versions at every SD1.5 level; this file
covers what that run does not reach: kv_len < Sk masking, ragged token
counts that are not tile multiples, head dims 40/80/160, and the rule that a
wrapper given an input that requires grad returns a tensor with a grad_fn.

Tolerances: fp32 1e-4 times max(1, max|plain|) (fp32 products; summation
order and the online softmax differ); bf16 2**-6 times max|plain| (two bf16
ulps at the output's largest magnitude: q, P and h round at different
points; the backward rounds dS and P where the Pallas body does).  Gradients
through a whole wrapper in bf16: 2**-5 times max|plain gradient| (the
forward's and the backward's roundings stack)."""
import math

import numpy as np
import pytest
import torch

from asva_tpu_torch.ops import flat_attention, fused

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -6}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _r(gen, shape, dtype, scale=1.0, shift=0.0):
    x = torch.randn(shape, generator=gen, device="cuda") * scale + shift
    return x.to(dtype)


def _sub(gen, c, dtype):
    return [_r(gen, (c,), dtype, 0.1, 1.0), _r(gen, (c,), dtype, 0.1),
            _r(gen, (c, c), dtype, c ** -0.5), _r(gen, (c, c), dtype, c ** -0.5),
            _r(gen, (c,), dtype, 0.1)]


def _check(got, want, dtype):
    got, want = got.float(), want.float()
    scale = want.abs().max().item()
    tol = TOL[dtype] * (max(1.0, scale) if dtype == torch.float32 else scale)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m,c", [(200, 320), (77, 640), (64, 1280)])
def test_b3_on_card(dev, dtype, m, c):
    gen = torch.Generator(device="cuda").manual_seed(0)
    args = [_r(gen, (m, c), dtype), _r(gen, (c,), dtype, 0.1, 1.0),
            _r(gen, (c,), dtype, 0.1), _r(gen, (8 * c, c), dtype, c ** -0.5),
            _r(gen, (8 * c,), dtype, 0.1),
            _r(gen, (c, 4 * c), dtype, (4 * c) ** -0.5),
            _r(gen, (c,), dtype, 0.1)]
    _check(fused.fused_ln_geglu(*args, 1e-5),
           fused.ln_geglu_plain(*args, 1e-5), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,m,sk,kv_len", [
    (320, 8, 130, 128, 77),    # d = 40, masked past kv_len
    (640, 8, 100, 25, None),   # d = 80, ragged M and Sk
    (1280, 8, 70, 200, 150),   # d = 160, Sk past one K/V tile, masked
])
def test_b1_on_card(dev, dtype, c, heads, m, sk, kv_len):
    gen = torch.Generator(device="cuda").manual_seed(1)
    args = ([_r(gen, (3, m, c), dtype)] + _sub(gen, c, dtype)
            + [_r(gen, (3, sk, c), dtype), _r(gen, (3, sk, c), dtype)])
    _check(fused.fused_ln_attn(*args, 1e-5, heads, kv_len),
           fused.ln_attn_plain(*args, 1e-5, heads, kv_len), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_b2_on_card(dev, dtype):
    gen = torch.Generator(device="cuda").manual_seed(2)
    b, f, n, c = 2, 3, 40, 320
    args = [_r(gen, (b, f, n, c), dtype)]
    for shape in ((b, n, c), (b, f, 25, c), (b, 77, c)):
        args += _sub(gen, c, dtype) + [_r(gen, shape, dtype),
                                       _r(gen, shape, dtype)]
    before = dict(fused.LAUNCHES)
    got = fused.fused_ln_attn3(*args, (1e-5,) * 3, 8)
    assert fused.LAUNCHES["B2"] == before["B2"] + 1
    assert fused.LAUNCHES["B1"] == before["B1"]
    _check(got, fused.ln_attn3_plain(*args, (1e-5,) * 3, 8), dtype)


def test_wrapper_rejects_bad_input(dev):
    x = torch.zeros(2, 8, 64, device="cuda")
    sub = [torch.zeros(64, device="cuda"), torch.zeros(64, device="cuda"),
           torch.zeros(64, 64, device="cuda"), torch.zeros(64, 64, device="cuda"),
           torch.zeros(64, device="cuda")]
    kv = torch.zeros(2, 5, 64, device="cuda")
    with pytest.raises(TypeError):
        fused.fused_ln_attn(x.half(), *sub, kv, kv, 1e-5, 8)
    with pytest.raises(ValueError, match="contiguous"):
        fused.fused_ln_attn(x.transpose(1, 2).contiguous().transpose(1, 2),
                            *sub, kv, kv, 1e-5, 8)
    with pytest.raises(ValueError, match="head dims"):
        fused.fused_ln_attn(x, *sub, kv, kv, 1e-5, 5)
    with pytest.raises(ValueError, match="CUDA"):
        fused.fused_ln_attn(x, *sub, kv.cpu(), kv, 1e-5, 8)
    assert np.isfinite(fused.fused_ln_attn(x, *sub, kv, kv, 1e-5, 8)
                       .cpu().numpy()).all()


# ------------------------------------------------------------ B4 and B5 ---

ATTN_SHAPES = [
    # g, m, sk, heads, d, kv_len
    (3, 130, 128, 8, 40, 77),    # d = 40, masked past kv_len, ragged M
    (2, 100, 25, 8, 80, None),   # d = 80, fewer K/V rows than one tile
    (2, 70, 200, 8, 160, 150),   # d = 160 (split dK/dV head tile), masked
    (1, 64, 64, 2, 96, None),    # exact tiles, widest unsplit head tile
]


def _qkv(gen, g, m, sk, c, dtype):
    return (_r(gen, (g, m, c), dtype), _r(gen, (g, sk, c), dtype),
            _r(gen, (g, sk, c), dtype))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,m,sk,heads,d,kv_len", ATTN_SHAPES)
def test_b4_on_card(dev, dtype, g, m, sk, heads, d, kv_len):
    """o and lse against mha_fwd_plain; lse is fp32 in both dtypes and is
    held to 1e-4 (fp32) / 2e-2 (bf16 inputs: logits of rounded products)."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = _qkv(gen, g, m, sk, heads * d, dtype)
    before = fused.LAUNCHES["B4"]
    o, lse = fused.mha_fwd(q, k, v, heads, kv_len, 1 / math.sqrt(d))
    assert fused.LAUNCHES["B4"] == before + 1
    o_ref, lse_ref = fused.mha_fwd_plain(q, k, v, heads, kv_len,
                                         1 / math.sqrt(d))
    _check(o, o_ref, dtype)
    assert lse.dtype == torch.float32 and lse.shape == (g, m, heads)
    lse_tol = 1e-4 if dtype == torch.float32 else 2e-2
    assert (lse - lse_ref).abs().max().item() <= lse_tol


@pytest.mark.parametrize("need_dkv", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,m,sk,heads,d,kv_len", ATTN_SHAPES)
def test_b5_on_card(dev, dtype, g, m, sk, heads, d, kv_len, need_dkv):
    """dq, dk, dv against mha_bwd_plain on the same (lse, dd); rows of dk/dv
    past kv_len are exactly zero; need_dkv=False computes dq alone."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = _qkv(gen, g, m, sk, heads * d, dtype)
    do = _r(gen, q.shape, dtype)
    scale = 1 / math.sqrt(d)
    o, lse = fused.mha_fwd_plain(q, k, v, heads, kv_len, scale)
    dd = fused._head_rowsum(do, o, heads)
    before = fused.LAUNCHES["B5"]
    got = fused.mha_bwd(q, k, v, do, lse, dd, heads, kv_len, scale, need_dkv)
    assert fused.LAUNCHES["B5"] == before + 1
    want = fused.mha_bwd_plain(q, k, v, do, lse, dd, heads, kv_len, scale)
    _check(got[0], want[0], dtype)
    if not need_dkv:
        assert got[1] is None and got[2] is None
        return
    _check(got[1], want[1], dtype)
    _check(got[2], want[2], dtype)
    if kv_len is not None:
        assert not got[1][:, kv_len:].any() and not got[2][:, kv_len:].any()


# ------------------------------------------------- gradients of wrappers ---

def _grad_check(out, ref, inputs, dtype):
    """Same cotangent through the wrapper and through the plain version."""
    assert out.grad_fn is not None
    w = torch.randn(out.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(9)
                    ).to(out.dtype)
    got = torch.autograd.grad((out.float() * w.float()).sum(), inputs)
    want = torch.autograd.grad((ref.float() * w.float()).sum(), inputs)
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        scale = b.abs().max().item()
        tol = (1e-4 * max(1.0, scale) if dtype == torch.float32
               else 2.0 ** -5 * scale)
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= tol


def _leaves(tensors):
    return [t.detach().requires_grad_(True) for t in tensors]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,m,sk,kv_len", [
    (320, 8, 130, 128, 77), (640, 8, 100, 25, None), (1280, 8, 70, 200, 150)])
def test_fused_ln_attn_gradients_on_card(dev, dtype, c, heads, m, sk, kv_len):
    """The manual backward around B5 against autograd of ln_attn_plain, for
    x, every parameter, k and v."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    args = _leaves([_r(gen, (3, m, c), dtype)] + _sub(gen, c, dtype)
                   + [_r(gen, (3, sk, c), dtype), _r(gen, (3, sk, c), dtype)])
    before = dict(fused.LAUNCHES)
    out = fused.fused_ln_attn(*args, 1e-5, heads, kv_len)
    ref = fused.ln_attn_plain(*args, 1e-5, heads, kv_len)
    _check(out, ref, dtype)
    _grad_check(out, ref, args, dtype)
    assert fused.LAUNCHES["B4"] == before["B4"] + 1
    assert fused.LAUNCHES["B5"] == before["B5"] + 1


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_ln_geglu_gradients_on_card(dev, dtype):
    gen = torch.Generator(device="cuda").manual_seed(6)
    m, c = 200, 320
    args = _leaves([_r(gen, (m, c), dtype), _r(gen, (c,), dtype, 0.1, 1.0),
                    _r(gen, (c,), dtype, 0.1),
                    _r(gen, (8 * c, c), dtype, c ** -0.5),
                    _r(gen, (8 * c,), dtype, 0.1),
                    _r(gen, (c, 4 * c), dtype, (4 * c) ** -0.5),
                    _r(gen, (c,), dtype, 0.1)])
    _grad_check(fused.fused_ln_geglu(*args, 1e-5),
                fused.ln_geglu_plain(*args, 1e-5), args, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_ln_attn3_gradients_on_card(dev, dtype):
    gen = torch.Generator(device="cuda").manual_seed(7)
    b, f, n, c = 2, 3, 40, 320
    args = [_r(gen, (b, f, n, c), dtype)]
    for shape in ((b, n, c), (b, f, 25, c), (b, 77, c)):
        args += _sub(gen, c, dtype) + [_r(gen, shape, dtype),
                                       _r(gen, shape, dtype)]
    args = _leaves(args)
    _grad_check(fused.fused_ln_attn3(*args, (1e-5,) * 3, 8),
                fused.ln_attn3_plain(*args, (1e-5,) * 3, 8), args, dtype)


def test_wrappers_keep_the_autograd_graph(dev):
    """A CUDA input that requires grad must come back with a grad_fn: the
    kernels write into fresh buffers, so without an autograd rule the graph
    would be cut silently.  fp32 parameters with bf16 activations (the
    training layout) are cast at use and receive fp32 gradients."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    c = 320
    x = _r(gen, (2, 64, c), torch.bfloat16).requires_grad_(True)
    sub = _leaves(_sub(gen, c, torch.float32))
    kv = _r(gen, (2, 25, c), torch.bfloat16)
    out = fused.fused_ln_attn(x, *sub, kv, kv, 1e-5, 8)
    assert out.grad_fn is not None and out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert x.grad is not None and x.grad.abs().max() > 0
    for p in sub:
        assert p.grad is not None and p.grad.dtype == torch.float32
        assert torch.isfinite(p.grad).all() and p.grad.abs().max() > 0
    ff = _leaves([_r(gen, (c,), torch.float32, 0.1, 1.0),
                  _r(gen, (c,), torch.float32, 0.1),
                  _r(gen, (8 * c, c), torch.float32, c ** -0.5),
                  _r(gen, (8 * c,), torch.float32, 0.1),
                  _r(gen, (c, 4 * c), torch.float32, (4 * c) ** -0.5),
                  _r(gen, (c,), torch.float32, 0.1)])
    y = fused.fused_ln_geglu(x.detach().reshape(-1, c).requires_grad_(True),
                             *ff, 1e-5)
    assert y.grad_fn is not None
    q = _r(gen, (2, 64, c), torch.bfloat16).requires_grad_(True)
    assert fused.mha_kvshared(q, kv, kv, 8, None, 0.2).grad_fn is not None
    with torch.no_grad():
        assert fused.fused_ln_attn(x, *sub, kv, kv, 1e-5, 8).grad_fn is None


# ------------------------------------------------------------ B6 and B7 ---

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("bh,sq,sk,d,kv_len", [
    (6, 130, 128, 40, 77),     # zero-padded K/V, masked past kv_len
    (4, 100, 77, 40, 77),      # unpadded: kv_len == Sk, ragged Sq and Sk
    (3, 200, 25, 80, None),    # fewer K/V rows than one tile
    (2, 70, 200, 160, 150),    # d = 160, Sk past one K/V tile
    (2, 64, 64, 96, 300),      # kv_len >= Sk masks nothing
])
def test_b6_on_card(dev, dtype, bh, sq, sk, d, kv_len):
    """vmem_attention / vmem_cross_attention against attention_flat_plain
    (which normalises P before rounding; the kernel rounds first: the bf16
    tolerance covers the order), and their gradients against autograd of
    the plain version.  K/V rows past kv_len hold garbage, not zeros: they
    must not be read."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v = (_r(gen, (bh, s, d), dtype) for s in (sq, sk, sk))
    masked = kv_len is not None and kv_len < sk
    if masked:                       # a caller's zero padding
        k[:, kv_len:] = 0
        v[:, kv_len:] = 0
    q, k, v = _leaves([q, k, v])

    def run(k, v):
        if kv_len is None:
            return flat_attention.vmem_attention(q, k, v)
        return flat_attention.vmem_cross_attention(q, k, v, kv_len)
    before = fused.LAUNCHES["B6"]
    out = run(k, v)
    assert fused.LAUNCHES["B6"] == before + 1
    ref = flat_attention.attention_flat_plain(q, k, v, kv_len)
    _check(out, ref, dtype)
    _grad_check(out, ref, [q, k, v], dtype)
    if masked:
        with torch.no_grad():
            kn, vn = k.clone(), v.clone()
            kn[:, kv_len:] = float("nan")
            vn[:, kv_len:] = float("nan")
            assert torch.equal(run(kn, vn), out)


def test_b6_rejects_bad_input(dev):
    q = torch.zeros(2, 8, 40, device="cuda")
    kv = torch.zeros(2, 5, 40, device="cuda")
    with pytest.raises(TypeError):
        flat_attention.vmem_attention(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="head dims"):
        flat_attention.vmem_attention(q[..., :36].contiguous(),
                                      kv[..., :36].contiguous(),
                                      kv[..., :36].contiguous())
    with pytest.raises(ValueError, match="CUDA"):
        flat_attention.vmem_attention(q, kv.cpu(), kv)
    with pytest.raises(ValueError, match="kv_len"):
        flat_attention.vmem_cross_attention(q, kv, kv, 0)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,f,n,c", [(2, 5, 37, 320), (1, 1, 64, 64),
                                     (3, 2, 16, 1280)])
def test_b7_on_card(dev, dtype, b, f, n, c):
    """fused_ff_mix against ff_mix_plain on the column blocks of one
    (C, 3C) weight read in place; ragged row counts, one frame (every tap is
    frame 0), and the gradients against autograd of the plain version."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    y, w, bias = _leaves([_r(gen, (b, f, n, c), dtype),
                          _r(gen, (c, 3 * c), dtype, (3 * c) ** -0.5),
                          _r(gen, (1, c), dtype, 0.1)])
    taps = (w[:, :c], w[:, c:2 * c], w[:, 2 * c:])
    before = fused.LAUNCHES["B7"]
    out = fused.fused_ff_mix(y, *taps, bias)
    assert fused.LAUNCHES["B7"] == before + 1
    ref = fused.ff_mix_plain(y, *taps, bias)
    _check(out, ref, dtype)
    _grad_check(out, ref, [y, w, bias], dtype)


def test_b7_frame0_clamp_on_card(dev):
    """Each tap alone, with an identity matrix: head copies frame 0, prev
    copies frame max(f - 1, 0), curr copies frame f."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    b, f, n, c = 2, 4, 24, 64
    y = _r(gen, (b, f, n, c), torch.float32)
    eye, zero = torch.eye(c, device="cuda"), torch.zeros(c, c, device="cuda")
    bias = torch.zeros(c, device="cuda")
    head = fused.fused_ff_mix(y, eye, zero, zero, bias) - y
    prev = fused.fused_ff_mix(y, zero, eye, zero, bias) - y
    curr = fused.fused_ff_mix(y, zero, zero, eye, bias) - y
    assert torch.allclose(head, y[:, :1].expand_as(y), atol=1e-6)
    assert torch.allclose(prev, torch.cat([y[:, :1], y[:, :-1]], 1), atol=1e-6)
    assert torch.allclose(curr, y, atol=1e-6)
