"""The port's CUDA kernels (B1-B7, K-gemm alone and the tools' T1, T2f, T2b)
against their plain versions, on a card.

Marked `cuda`: each test skips without a CUDA device.  This file imports no
JAX, so it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX.)  chip_smoke.py holds
the kernels against their plain versions at every SD1.5 level; this file
covers what that run does not reach: K-gemm at every (N, K) of the SD1.5
sub-layers with and without LN at ragged M, its batch invariance and
repeatability, and its unsupported shapes; kv_len < Sk masking (for B4/B5 at
every position of the last K/V tile), ragged token counts that are not tile
multiples, head dims 40/80/96/160, B5's split dK/dV path for few K/V rows,
o bit-identical with and without lse and on recompute, and the rule that a
wrapper given an input that requires grad returns a tensor with a grad_fn;
B7 on every loader of A (ff_mix_launch), on tap matrices of their own and
with rows independent of the launch; for the tools' kernels every variant
name, group size and schedule, T1's orders bit-equal within a class and its
POST class bit-equal to B1, the rule that excludes an instantiation, T2f's
bit equality with B4 at every group (head dim 160 in group 2 and groups
that do not divide H included), and T2b's dK/dV, bit-equal across its
orders and to B5's where B5 runs its dK/dV kernel unsplit; and
pipelines.generate.generate_videos at a small config on the card from a PNG
and a wav it writes (PIL and scipy; no libav needed), against its CPU run.

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


# --------------------------------------------------------------- K-gemm ---

# every (N, K) of the store and bias + residual launches of the SD1.5
# sub-layers (q / out projections: C x C; the FF's second product: C x 4C),
# and of the LN + GEGLU launch (N = 4C value columns, K = C)
_GEMM_NK = [(n, k) for c in (320, 640, 1280) for n, k in ((c, c), (c, 4 * c))]
GEMM_CASES = ([("q", n, k) for n, k in _GEMM_NK]
              + [("out", n, k) for n, k in _GEMM_NK]
              + [("ff1", 4 * c, c) for c in (320, 640, 1280)])


def _gemm_args(gen, form, m, n, k, with_ln, dtype=torch.bfloat16):
    """(form, a, w, bias, res, ln) for fused.ln_gemm; ff1's weight holds
    the value and gate rows (2N, K)."""
    rows = 2 * n if form == "ff1" else n
    bias = _r(gen, (rows,), dtype, 0.1) if form != "q" else None
    res = _r(gen, (m, n), dtype) if form == "out" else None
    ln = ((_r(gen, (k,), dtype, 0.1, 1.0), _r(gen, (k,), dtype, 0.1), 1e-5)
          if with_ln else None)
    return (form, _r(gen, (m, k), dtype), _r(gen, (rows, k), dtype, k ** -0.5),
            bias, res, ln)


@pytest.mark.parametrize("m", [1, 77, 200, 384, 24576])
@pytest.mark.parametrize("with_ln", [True, False])
@pytest.mark.parametrize("form,n,k", GEMM_CASES)
def test_k_gemm_on_card(dev, form, n, k, with_ln, m):
    """bf16 K-gemm alone, each epilogue with and without the LN prologue,
    ragged M included, against ln_gemm_plain."""
    args = _gemm_args(torch.Generator(device="cuda").manual_seed(20), form,
                      m, n, k, with_ln)
    before = fused.LAUNCHES[f"KG.{form}"]
    with torch.no_grad():
        got = fused.ln_gemm(*args)
    assert fused.LAUNCHES[f"KG.{form}"] == before + 1
    assert got.shape == (m, n)
    _check(got, fused.ln_gemm_plain(*args), torch.bfloat16)


@pytest.mark.parametrize("with_ln", [True, False])
@pytest.mark.parametrize("form", ["q", "out", "ff1"])
def test_k_gemm_fp32_on_card(dev, form, with_ln):
    n = 1280 if form == "ff1" else 320
    args = _gemm_args(torch.Generator(device="cuda").manual_seed(21), form,
                      200, n, 320, with_ln, torch.float32)
    with torch.no_grad():
        _check(fused.ln_gemm(*args), fused.ln_gemm_plain(*args),
               torch.float32)


@pytest.mark.parametrize("form,n,k,with_ln", [
    ("q", 320, 320, True), ("ff1", 1280, 320, True), ("out", 320, 1280, False),
    ("out", 640, 640, True)])
def test_k_gemm_rows_do_not_depend_on_the_launch(dev, form, n, k, with_ln):
    """Batch invariance: rows of a 24576-row launch equal, bit for bit, the
    same rows launched alone (the first 77, and 200 rows from row 100, the
    middle of a block's tile), and a repeated call gives the same bits."""
    args = list(_gemm_args(torch.Generator(device="cuda").manual_seed(22),
                           form, 24576, n, k, with_ln))
    with torch.no_grad():
        full = fused.ln_gemm(*args)
        assert torch.equal(fused.ln_gemm(*args), full)
        a, res = args[1], args[4]
        for lo, hi in ((0, 77), (100, 300)):
            args[1] = a[lo:hi].contiguous()
            if res is not None:
                args[4] = res[lo:hi].contiguous()
            assert torch.equal(fused.ln_gemm(*args), full[lo:hi])


def test_b3_repeats_bit_for_bit(dev):
    gen = torch.Generator(device="cuda").manual_seed(23)
    m, c = 384, 640
    args = [_r(gen, (m, c), torch.bfloat16),
            _r(gen, (c,), torch.bfloat16, 0.1, 1.0),
            _r(gen, (c,), torch.bfloat16, 0.1),
            _r(gen, (8 * c, c), torch.bfloat16, c ** -0.5),
            _r(gen, (8 * c,), torch.bfloat16, 0.1),
            _r(gen, (c, 4 * c), torch.bfloat16, (4 * c) ** -0.5),
            _r(gen, (c,), torch.bfloat16, 0.1)]
    with torch.no_grad():
        assert torch.equal(fused.fused_ln_geglu(*args, 1e-5),
                           fused.fused_ln_geglu(*args, 1e-5))


def test_k_gemm_unsupported_shape_raises(dev):
    """The wrapper names the rule; under it the kernel's own check returns
    an error that _raise_on turns into a RuntimeError."""
    from asva_tpu_torch.ops import cuda_build
    gen = torch.Generator(device="cuda").manual_seed(24)
    with pytest.raises(ValueError, match="K-gemm takes K"):
        fused.ln_gemm(*_gemm_args(gen, "q", 64, 320, 96, False))
    with pytest.raises(ValueError, match="K-gemm takes N"):
        fused.ln_gemm(*_gemm_args(gen, "out", 64, 100, 320, False))
    _, a, w, bias, res, _ = _gemm_args(gen, "out", 64, 100, 320, False)
    out = torch.empty_like(res)
    lib = cuda_build.library()
    for n, k in ((100, 320), (320, 96)):
        rc = lib.gemm.asva_ln_gemm(1, 2, 64, n, k, a.data_ptr(), None, None,
                                   0.0, w.data_ptr(), bias.data_ptr(),
                                   res.data_ptr(), out.data_ptr(),
                                   torch.cuda.current_stream().cuda_stream)
        with pytest.raises(RuntimeError, match="K-gemm kernel launch failed"):
            fused._raise_on(lib, rc, "K-gemm")


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


# ---------------------------------------- B4 / B5 on wgmma: the edges ---

def _fwd_bwd(gen, g, m, sk, heads, d, kv_len, need_dkv=True):
    """B4 and B5 on bf16 inputs against their plain versions; the plain B5
    gets the kernel's own lse, as the autograd rule gives it."""
    q, k, v = _qkv(gen, g, m, sk, heads * d, torch.bfloat16)
    do = _r(gen, q.shape, torch.bfloat16)
    scale = 1 / math.sqrt(d)
    o, lse = fused.mha_fwd(q, k, v, heads, kv_len, scale)
    o_ref, lse_ref = fused.mha_fwd_plain(q, k, v, heads, kv_len, scale)
    _check(o, o_ref, torch.bfloat16)
    assert (lse - lse_ref).abs().max().item() <= 2e-2
    dd = fused._head_rowsum(do, o, heads)
    got = fused.mha_bwd(q, k, v, do, lse, dd, heads, kv_len, scale, need_dkv)
    want = fused.mha_bwd_plain(q, k, v, do, lse, dd, heads, kv_len, scale)
    _check(got[0], want[0], torch.bfloat16)
    if not need_dkv:
        assert got[1] is None and got[2] is None
        return
    for a, b in zip(got[1:], want[1:]):
        _check(a, b, torch.bfloat16)
        if kv_len is not None:
            assert not a[:, kv_len:].any()


@pytest.mark.parametrize("d", [40, 96])
def test_b4_b5_kv_len_at_every_position_of_the_last_tile(dev, d):
    """kv_len = 64 + r for r = 1..63: the last K/V tile is masked from every
    column on; M = 70 is no multiple of the 64-row query tile."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    for r in range(1, 64):
        _fwd_bwd(gen, 2, 70, 128, 2, d, 64 + r)


@pytest.mark.parametrize("need_dkv", [True, False])
@pytest.mark.parametrize("d", [40, 80, 96, 160])
@pytest.mark.parametrize("sk,kv_len", [(25, None), (77, None), (128, 77),
                                       (1024, None)])
def test_b4_b5_head_dims_and_kv_lengths(dev, sk, kv_len, d, need_dkv):
    """The SD1.5 head dims, the widest unsplit tile (96), audio (25), text
    (77, and 77 of 128) and frame-0 (1024) K/V lengths; M = 200."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    _fwd_bwd(gen, 2, 200, sk, 2, d, kv_len, need_dkv)


@pytest.mark.parametrize("sk,kv_len", [(130, 100), (40, None)])
@pytest.mark.parametrize("d", [8, 24, 48, 56, 64, 104, 128, 136, 152])
def test_b4_b5_every_head_tile(dev, d, sk, kv_len):
    """Every padded head tile the kernels instantiate (16 to 160 in steps of
    16; those above 96 split B5's dK/dV head dim), with three masked K/V
    tiles or one short one."""
    _fwd_bwd(torch.Generator(device="cuda").manual_seed(16), 2, 100, sk, 2,
             d, kv_len)


@pytest.mark.parametrize("g,m,sk,heads,d,kv_len", [
    (1, 1000, 77, 2, 40, None),    # text: 4 dK/dV blocks
    (2, 300, 25, 2, 160, None),    # audio, split head tile
    (1, 640, 128, 1, 80, 100),     # two K/V tiles, the second masked
])
def test_b5_split_dkv_path(dev, g, m, sk, heads, d, kv_len):
    """Few K/V rows: B5 splits its dK/dV kernel over query ranges and sums
    the fp32 partials in a second pass; the result stays within tolerance
    and repeats bit for bit."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fused.dkv_split(g, m, sk, heads, d, sms) > 1
    gen = torch.Generator(device="cuda").manual_seed(13)
    _fwd_bwd(gen, g, m, sk, heads, d, kv_len)
    q, k, v = _qkv(gen, g, m, sk, heads * d, torch.bfloat16)
    do = _r(gen, q.shape, torch.bfloat16)
    o, lse = fused.mha_fwd(q, k, v, heads, kv_len, 1 / math.sqrt(d))
    dd = fused._head_rowsum(do, o, heads)
    args = (q, k, v, do, lse, dd, heads, kv_len, 1 / math.sqrt(d))
    first, again = fused.mha_bwd(*args), fused.mha_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("g,m,sk,heads,d,kv_len", [
    (48, 130, 25, 2, 40, None),    # audio: 96 dK/dV blocks
    (40, 100, 64, 2, 160, 50),     # one masked K/V tile, split head tile
])
def test_b5_one_warpgroup_dkv_blocks(dev, g, m, sk, heads, d, kv_len):
    """Sk <= 64: one K/V tile a head, so B5's dK/dV blocks are one
    warpgroup; with enough of them there is no split."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert fused.dkv_split(g, m, sk, heads, d, sms) == 1
    _fwd_bwd(torch.Generator(device="cuda").manual_seed(15), g, m, sk, heads,
             d, kv_len)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_b4_o_without_lse_and_recompute_bit_identical(dev, d):
    """o is the same bits with and without lse (generation vs training), a
    second call (remat's recompute) repeats o and lse bit for bit, and a
    group's rows do not depend on the other groups of the launch."""
    from asva_tpu_torch.ops import cuda_build
    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = _qkv(gen, 3, 200, 1024, 8 * d, torch.bfloat16)
    scale = 1 / math.sqrt(d)
    lib = cuda_build.library()
    o_gen, none = fused._mha_fwd_cuda(lib, q, k, v, 8, 900, scale, False)
    o, lse = fused.mha_fwd(q, k, v, 8, 900, scale)
    assert none is None and torch.equal(o_gen, o)
    o2, lse2 = fused.mha_fwd(q, k, v, 8, 900, scale)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    o1, lse1 = fused.mha_fwd(q[1:2].contiguous(), k[1:2].contiguous(),
                             v[1:2].contiguous(), 8, 900, scale)
    assert torch.equal(o1, o[1:2]) and torch.equal(lse1, lse[1:2])


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
def test_fused_ln_attn_backward_on_saved_o_lse(dev, dtype):
    """A rematerialised B1 sub-layer under saveconv's saves: B4 runs once
    and B5 reads the first forward's o and lse, with the same output and the
    same gradient bits for x, every parameter, k and v as under a full
    recompute (B1 and B4 twice)."""
    from torch.utils.checkpoint import checkpoint
    from asva_tpu_torch.models.unet3d.model import remat_saves_at
    from asva_tpu_torch.ops import remat
    gen = torch.Generator(device="cuda").manual_seed(16)
    c, heads, m, sk = 320, 8, 130, 77
    args = _leaves([_r(gen, (3, m, c), dtype)] + _sub(gen, c, dtype)
                   + [_r(gen, (3, sk, c), dtype), _r(gen, (3, sk, c), dtype)])
    w = torch.randn((3, m, c), device="cuda", generator=gen)

    def sublayer(*a):
        return fused.fused_ln_attn(*a, 1e-5, heads, 60)

    def run(**kw):
        before = dict(fused.LAUNCHES)
        out = checkpoint(sublayer, *args, use_reentrant=False, **kw)
        grads = torch.autograd.grad((out.float() * w).sum(), args)
        return out, grads, {k: fused.LAUNCHES[k] - before[k]
                            for k in ("B1", "B4", "B5")}
    out_s, grads_s, n_s = run(
        context_fn=remat.policy(remat_saves_at("saveconv", 0)))
    out_f, grads_f, n_f = run()
    assert n_s == {"B1": 1, "B4": 1, "B5": 1}
    assert n_f == {"B1": 2, "B4": 2, "B5": 1}
    assert torch.equal(out_s, out_f)
    for a, b in zip(grads_s, grads_f):
        assert torch.equal(a, b)


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


# B7's loaders of A (fused.MIX_LOADERS), each launched on a shape that admits
# it: FRAME (every tile in one frame) and CPASYNC (any N: tiles across
# frames and clips, ragged N); the first of a shape's loaders is the one
# ff_mix_plan picks on a 132-SM card
B7_LOADER_SHAPES = [
    ((2, 12, 1024, 320), "FRAME"),    # the four SD1.5 levels of a request
    ((2, 12, 1024, 320), "CPASYNC"),
    ((2, 12, 256, 640), "FRAME"),
    ((2, 12, 64, 1280), "FRAME"),     # 64-row tiles: one frame each
    ((2, 12, 64, 1280), "CPASYNC"),
    ((2, 12, 16, 1280), "CPASYNC"),   # N 16: 4 frames a tile
    ((4, 12, 64, 1280), "CPASYNC"),   # N 64 in 128-row tiles, across clips
    ((2, 5, 37, 320), "CPASYNC"),     # ragged N
    ((3, 4, 24, 640), "CPASYNC"),     # N 24: tiles across frames and clips
    ((1, 1, 128, 64), "FRAME"),       # one frame: every tap is the row
    ((1, 1, 200, 64), "CPASYNC"),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,loader", B7_LOADER_SHAPES)
def test_b7_loaders_on_card(dev, dtype, shape, loader):
    """ff_mix_launch on the given loader of A against ff_mix_plain, on the
    column blocks of one (C, 3C) weight; in bf16 the bits of the launch on
    ff_mix_plan's loader (the loaders fill the same tiles for the same
    products)."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    b, f, n, c = shape
    y = _r(gen, shape, dtype)
    w = _r(gen, (c, 3 * c), dtype, (3 * c) ** -0.5)
    bias = _r(gen, (c,), dtype, 0.1)
    taps = (w[:, :c], w[:, c:2 * c], w[:, 2 * c:])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = fused.ff_mix_plan(shape, sms)
    assert loader in fused.ff_mix_loaders(n, plan["bm"])
    with torch.no_grad():
        out = fused.ff_mix_launch(y, *taps, bias, dict(plan, path=loader))
        ref = fused.ff_mix_plain(y, *taps, bias)
        best = fused.fused_ff_mix(y, *taps, bias)
    _check(out, ref, dtype)
    assert torch.equal(out, best)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 12, 64, 1280), (2, 5, 37, 320)])
def test_b7_separate_tap_matrices_on_card(dev, dtype, shape):
    """Three tap matrices of their own give the bits of the column blocks of
    one weight (each tap one tensor map, with its own row stride)."""
    gen = torch.Generator(device="cuda").manual_seed(14)
    c = shape[-1]
    y = _r(gen, shape, dtype)
    w = _r(gen, (c, 3 * c), dtype, (3 * c) ** -0.5)
    bias = _r(gen, (c,), dtype, 0.1)
    blocks = (w[:, :c], w[:, c:2 * c], w[:, 2 * c:])
    own = tuple(t.contiguous() for t in blocks)
    with torch.no_grad():
        got = fused.fused_ff_mix(y, *own, bias)
        want = fused.fused_ff_mix(y, *blocks, bias)
    assert torch.equal(got, want)


def test_b7_rows_do_not_depend_on_the_launch(dev):
    """No split-K and a tile width fixed by C: clip 0's rows are the same
    bits whether the launch holds 1 or 4 clips (other grids, warpgroups a
    block and loaders: FRAME with 64-row tiles against CPASYNC with 128)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    b, f, n, c = 4, 12, 64, 1280
    y = _r(gen, (b, f, n, c), torch.bfloat16)
    w = _r(gen, (c, 3 * c), torch.bfloat16, (3 * c) ** -0.5)
    bias = _r(gen, (c,), torch.bfloat16, 0.1)
    taps = (w[:, :c], w[:, c:2 * c], w[:, 2 * c:])
    with torch.no_grad():
        whole = fused.fused_ff_mix(y, *taps, bias)
        one = fused.fused_ff_mix(y[:1].contiguous(), *taps, bias)
    assert torch.equal(whole[:1], one)


# ------------------------------------------------ the kernel tools' kernels

def _t1_args(gen, g, m, sk, c, dtype):
    return ([_r(gen, (g, m, c), dtype)] + _sub(gen, c, dtype)
            + [_r(gen, (g, sk, c), dtype), _r(gen, (g, sk, c), dtype)])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c,heads,m,sk,block_m", [
    (320, 8, 200, 150, 128),   # the tool's width, ragged M and Sk
    (64, 2, 64, 64, 64),       # head dim 32, exact tiles
    (192, 4, 70, 200, 64),     # head dim 48
])
@pytest.mark.parametrize("name", ["v0", "v1_phased", "v2_postnorm", "v3_both",
                                  "v4_mmfloor", "v5_bf16exp", "v6_stacksm",
                                  "v7_exp2", "v8_pipe", "v9_mxusum"])
def test_t1_on_card(dev, dtype, name, c, heads, m, sk, block_m):
    """T1 against its plain version, every name.  v5_bf16exp in bf16: 0.05
    absolute, the tolerance tools/attn_experiments.py gives it."""
    from asva_tpu_torch.ops import variants
    gen = torch.Generator(device="cuda").manual_seed(7)
    args = _t1_args(gen, 2, m, sk, c, dtype)
    before = fused.LAUNCHES["T1"]
    got = variants.ln_attn_variant(name, *args, 1e-5, heads, block_m)
    assert fused.LAUNCHES["T1"] == before + 1
    want = variants.ln_attn_variant_plain(name, *args, 1e-5, heads)
    if name == "v5_bf16exp" and dtype == torch.bfloat16:
        assert (got.float() - want.float()).abs().max().item() <= 0.05
    else:
        _check(got, want, dtype)


T1_CLASSES = {"PRE": ["v0", "v1_phased", "v6_stacksm", "v8_pipe"],
              "POST": ["v2_postnorm", "v3_both"]}


@pytest.mark.parametrize("g,c,heads,m,sk,block_m", [
    (2, 320, 8, 200, 150, 128),
    (2, 64, 2, 64, 64, 64),
    (2, 192, 4, 70, 200, 64),
    (2, 320, 8, 12288, 1024, 64),   # the tool's shape, one warpgroup a block
    (2, 320, 8, 12288, 1024, 128),  # ... two
])
def test_t1_orders_bit_equal_on_card(dev, g, c, heads, m, sk, block_m):
    """bf16: the orders of a class are one arithmetic (v0 = v1_phased =
    v6_stacksm = v8_pipe, v2_postnorm = v3_both), and the POST class is
    B1's (fused_ln_attn: K-gemm q, B4, K-gemm out) bit for bit."""
    from asva_tpu_torch.ops import variants
    gen = torch.Generator(device="cuda").manual_seed(16)
    args = _t1_args(gen, g, m, sk, c, torch.bfloat16)
    with torch.no_grad():
        b1 = fused.fused_ln_attn(*args, 1e-5, heads)
        for names in T1_CLASSES.values():
            outs = [variants.ln_attn_variant(n, *args, 1e-5, heads, block_m)
                    for n in names]
            assert all(torch.equal(o, outs[0]) for o in outs[1:]), names
        assert torch.equal(outs[0], b1)


def test_t1_unsupported_geometry_raises(dev):
    from asva_tpu_torch.ops import variants
    gen = torch.Generator(device="cuda").manual_seed(8)
    args = _t1_args(gen, 1, 64, 64, 640, torch.bfloat16)
    with pytest.raises(ValueError, match="T1 takes"):
        variants.ln_attn_variant("v0", *args, 1e-5, 8, 64)
    args = _t1_args(gen, 1, 64, 64, 320, torch.bfloat16)
    with pytest.raises(ValueError, match="block_m"):
        variants.ln_attn_variant("v0", *args, 1e-5, 8, 96)


T2_SHAPES = [(2, 130, 128, 320, 8, 77),    # d = 40, masked past kv_len
             (3, 100, 25, 640, 8, None),   # d = 80, ragged M and Sk
             (2, 70, 200, 1280, 8, 150),   # d = 160, two K/V tiles, masked
             (2, 64, 128, 320, 8, 25),     # a K/V tile of masked keys only
             (2, 256, 1024, 320, 8, None)]  # d = 40, B5's dK/dV unsplit


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,m,sk,c,heads,kv_len", T2_SHAPES)
def test_t2f_on_card(dev, dtype, g, m, sk, c, heads, kv_len):
    """T2f: every supported group size within tolerance of the plain
    version and bit-equal to B4 (o and lse): group 1 is B4's schedule and
    every group runs B4's statements per head in B4's order; groups 1 and 2
    are supported at every head dim."""
    from asva_tpu_torch.ops import variants
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (_r(gen, s, dtype) for s in ((g, m, c), (g, sk, c), (g, sk, c)))
    scale = 1.0 / math.sqrt(c // heads)
    o4, lse4 = fused.mha_fwd(q, k, v, heads, kv_len, scale)
    o_p, lse_p = fused.mha_fwd_plain(q, k, v, heads, kv_len, scale)
    ran = []
    for group in (1, 2, 4, heads):
        if variants.t2f_supported(c // heads, group):
            with pytest.raises(ValueError):
                variants.mha_fwd_grouped(q, k, v, heads, kv_len, scale, None,
                                         group)
            continue
        before = fused.LAUNCHES["T2F"]
        o, lse = variants.mha_fwd_grouped(q, k, v, heads, kv_len, scale, None,
                                          group)
        assert fused.LAUNCHES["T2F"] == before + 1
        _check(o, o_p, dtype)
        _check(lse, lse_p, torch.float32)
        assert torch.equal(o, o4) and torch.equal(lse, lse4), group
        ran.append(group)
    assert ran[:2] == [1, 2]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("g,m,sk,c,heads,kv_len", T2_SHAPES)
def test_t2b_on_card(dev, dtype, g, m, sk, c, heads, kv_len):
    """T2b: every supported variant within tolerance of the plain version;
    dK and dV (summed in a fixed order) bit-equal across the variants and,
    in bf16 where B5 runs its dK/dV kernel unsplit (`fused.dkv_split` 1), to
    B5's: the same statements in the same order; b0, b1 and b2 are
    supported at every head dim."""
    from asva_tpu_torch.ops import variants
    gen = torch.Generator(device="cuda").manual_seed(10)
    q, k, v, do = (_r(gen, s, dtype) for s in
                   ((g, m, c), (g, sk, c), (g, sk, c), (g, m, c)))
    scale = 1.0 / math.sqrt(c // heads)
    o, lse = fused.mha_fwd(q, k, v, heads, kv_len, scale)
    dd = fused._head_rowsum(do, o, heads)
    want = fused.mha_bwd_plain(q, k, v, do, lse, dd, heads, kv_len, scale)
    b5 = fused.mha_bwd(q, k, v, do, lse, dd, heads, kv_len, scale)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    unsplit = (dtype == torch.bfloat16
               and fused.dkv_split(g, m, sk, heads, c // heads, sms) == 1)
    ran, first = [], None
    for variant in ("b0", "b1", "b2", "b4", "b3"):
        if variants.t2b_supported(c // heads, heads, variant):
            with pytest.raises(ValueError):
                variants.mha_bwd_ordered(q, k, v, do, lse, dd, heads, kv_len,
                                         scale, None, variant)
            continue
        before = fused.LAUNCHES["T2B"]
        got = variants.mha_bwd_ordered(q, k, v, do, lse, dd, heads, kv_len,
                                       scale, None, variant)
        assert fused.LAUNCHES["T2B"] == before + 1
        for a, b in zip(got, want):
            _check(a, b, dtype)
        if first is None:
            first = got
        assert torch.equal(got[1], first[1]) and torch.equal(got[2], first[2])
        if unsplit:
            assert torch.equal(got[1], b5[1]) and torch.equal(got[2], b5[2])
        ran.append(variant)
    assert ran[:3] == ["b0", "b1", "b2"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads,kv_len", [(8, None), (6, 150)])
def test_t2_wide_heads_on_card(dev, dtype, heads, kv_len):
    """Head dim 160: T2f group 2 (one warpgroup a block, two ring stages:
    the plan chosen for shared memory) bit-equal to B4, and T2b b2 (one
    stage, no ring) within tolerance of the plain version with dK/dV equal
    to b0's; at 8 heads over every key, and at 6 heads with kv_len 150
    masking the last of four K/V tiles."""
    from asva_tpu_torch.ops import variants
    gen = torch.Generator(device="cuda").manual_seed(11)
    g, m, sk, c = 2, 200, 256, 160 * heads
    q, k, v, do = (_r(gen, s, dtype) for s in
                   ((g, m, c), (g, sk, c), (g, sk, c), (g, m, c)))
    scale = 1.0 / math.sqrt(160)
    o4, lse4 = fused.mha_fwd(q, k, v, heads, kv_len, scale)
    o, lse = variants.mha_fwd_grouped(q, k, v, heads, kv_len, scale, None, 2)
    assert torch.equal(o, o4) and torch.equal(lse, lse4)
    dd = fused._head_rowsum(do, o4, heads)
    want = fused.mha_bwd_plain(q, k, v, do, lse4, dd, heads, kv_len, scale)
    b0, b2 = (variants.mha_bwd_ordered(q, k, v, do, lse4, dd, heads, kv_len,
                                       scale, None, var) for var in ("b0", "b2"))
    for a, b in zip(b2, want):
        _check(a, b, dtype)
    assert torch.equal(b0[1], b2[1]) and torch.equal(b0[2], b2[2])


@pytest.mark.parametrize("dtype", DTYPES)
def test_t2_uneven_groups_on_card(dev, dtype):
    """Six heads at d = 40: T2f group 4 and T2b b4 leave two spare head
    slots in their last block, which compute head 5 again and store
    nothing: o/lse still B4's, dq/dk/dv still within tolerance, dK/dV equal
    to b1's."""
    from asva_tpu_torch.ops import variants
    gen = torch.Generator(device="cuda").manual_seed(12)
    g, m, sk, heads, c = 2, 130, 200, 6, 240
    q, k, v, do = (_r(gen, s, dtype) for s in
                   ((g, m, c), (g, sk, c), (g, sk, c), (g, m, c)))
    scale = 1.0 / math.sqrt(40)
    o4, lse4 = fused.mha_fwd(q, k, v, heads, None, scale)
    o, lse = variants.mha_fwd_grouped(q, k, v, heads, None, scale, None, 4)
    assert torch.equal(o, o4) and torch.equal(lse, lse4)
    dd = fused._head_rowsum(do, o4, heads)
    want = fused.mha_bwd_plain(q, k, v, do, lse4, dd, heads, None, scale)
    b1, b4 = (variants.mha_bwd_ordered(q, k, v, do, lse4, dd, heads, None,
                                       scale, None, var) for var in ("b1", "b4"))
    for a, b in zip(b4, want):
        _check(a, b, dtype)
    assert torch.equal(b1[1], b4[1]) and torch.equal(b1[2], b4[2])


# ------------------------------------------------------- generate_videos ---

class _Drawn:
    """A pipeline handed fixed noise draws (made on the CPU, so that the
    card and the CPU see the same ones); its float videos are kept."""

    def __init__(self, pipe, noise):
        self.pipe, self.noise, self.videos = pipe, noise, []

    @property
    def device(self):
        return self.pipe.device

    def __call__(self, *args, generator=None, **kw):
        out = self.pipe(*args, vae_noise=self.noise[0],
                        latent_noise=self.noise[1], **kw)
        self.videos.append(out.float().cpu())
        return out


def _small_pipeline(device, dtype):
    """The tiny UNet at widths 64 / 128 (the smallest K-gemm takes in bf16:
    K a multiple of 64), the tiny VAE and audio tower, seeded on the CPU
    (a CUDA generator draws other numbers) and moved to `device`."""
    from asva_tpu_torch import runtime
    from asva_tpu_torch.diffusion.schedules import DiffusionSchedule
    from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig
    from asva_tpu_torch.models.unet3d import UNet3DConfig
    from asva_tpu_torch.models.vae import VAEConfig
    from asva_tpu_torch.pipelines.animation import AnimationPipeline
    ucfg = UNet3DConfig.tiny(block_out_channels=(64, 128),
                             audio_cross_attention_dim=32)
    null = torch.randn((1, 77, 768), generator=torch.Generator().manual_seed(
        9))
    return AnimationPipeline(
        runtime.build_unet(ucfg, "cpu", dtype, 0,
                           randomize_all=True).to(device),
        runtime.build_vae(VAEConfig.tiny(), "cpu", dtype, 1,
                          randomize_all=True).to(device),
        runtime.build_audio_encoder(4, ImageBindAudioConfig.tiny(), "cpu",
                                    dtype, 2, randomize_all=True).to(device),
        DiffusionSchedule(), null_text_encoding=null.to(device))


def test_generate_videos_on_card(dev, tmp_path):
    """Two clips in one batched call, DDIM 3 steps: B2 and B3 launch once per
    audio / transformer block per UNet call, and in bf16 the video's
    relative RMS distance from the CPU's fp32 run is within 1.5x that of
    the CPU's bf16 run through the plain versions (chip_smoke.py phase 4's
    gate)."""
    from PIL import Image
    from scipy.io import wavfile
    from asva_tpu_torch.models.unet3d.transformer import (
        SpatioAudioTempTransformerBlock)
    from asva_tpu_torch.pipelines.generate import generate_videos
    gen = torch.Generator().manual_seed(4)
    image = (torch.rand((20, 24, 3), generator=gen) * 255).to(torch.uint8)
    Image.fromarray(image.numpy()).save(tmp_path / "cond.png")
    s = torch.arange(int(2.5 * 44100)) / 44100
    wave = torch.stack([0.5 * torch.sin(2 * math.pi * 440 * s),
                        0.3 * torch.sin(2 * math.pi * 97 * s)], -1)
    wavfile.write(tmp_path / "cond.wav", 44100,
                  (wave * 32767).to(torch.int16).numpy())
    noise = (torch.randn((1, 8, 8, 4), generator=gen),
             torch.randn((1, 3, 8, 8, 4), generator=gen))
    kw = dict(image_path=str(tmp_path / "cond.png"),
              audio_path=str(tmp_path / "cond.wav"), image_size=(16, 16),
              video_fps=6, video_num_frame=4, num_clips_per_video=2,
              num_inference_steps=3, sampler="ddim",
              audio_guidance_scale=4.0, seed=0)
    videos = {}
    for name, device, dtype in (("card", dev, torch.bfloat16),
                                ("cpu32", "cpu", torch.float32),
                                ("cpu16", "cpu", torch.bfloat16)):
        pipe = _Drawn(_small_pipeline(device, dtype), noise)
        for k in fused.LAUNCHES:
            fused.LAUNCHES[k] = 0
        out = generate_videos(pipe, **kw)
        assert [f.shape for f, _ in out] == [(4, 16, 16, 3)] * 2
        videos[name] = pipe.videos[0]
        if name == "card":
            blocks = [m for m in pipe.pipe.unet.modules()
                      if isinstance(m, SpatioAudioTempTransformerBlock)]
            assert fused.LAUNCHES["B2"] == 3 * sum(b.use_audio
                                                   for b in blocks) > 0
            assert fused.LAUNCHES["B3"] == 3 * len(blocks)
    ref = videos["cpu32"]

    def rel_rms(v):
        return ((v - ref).norm() / ref.norm()).item()
    assert torch.isfinite(videos["card"]).all()
    assert rel_rms(videos["card"]) <= 1.5 * rel_rms(videos["cpu16"])


# ------------------------------------------------------- data to the card ---

class _Items:
    """(seed, epoch, index)-deterministic items of the given shapes; the
    values name the item, so an overwritten or misplaced row shows."""

    def __init__(self, n, shapes, seed=0):
        self.n, self.shapes, self.seed, self.epoch = n, shapes, seed, 0

    def __len__(self):
        return self.n

    def set_epoch(self, e):
        self.epoch = e

    def __getitem__(self, i):
        rng = np.random.default_rng((self.seed, self.epoch, i))
        out = {"index": np.int64(i)}
        for k, shape in self.shapes.items():
            a = np.empty(shape, np.float32)
            a[...] = i + 1000 * self.epoch
            a.reshape(-1)[:64] = rng.standard_normal(64)
            out[k] = a
        return out


def test_process_loader_batches_to_card(dev):
    """The process loader's pinned batches, copied to the card without
    blocking, equal the batches the same loader drains on the CPU, over
    two epochs."""
    from asva_tpu_torch.data.loader import DataLoader
    from asva_tpu_torch.parallel.multihost import make_global_batch

    def run(to_card):
        dl = DataLoader(_Items(14, {"x": (3, 40, 40, 3), "y": (500,)}), 4,
                        shuffle=True, seed=3, num_workers=3,
                        worker_mode="process", prefetch=1)
        try:
            out = []
            for _ in range(2):
                for b in dl:
                    assert all(v.is_pinned() for v in b.values())
                    out.append(make_global_batch(b, dev) if to_card else b)
            torch.cuda.synchronize()
            return out
        finally:
            dl.close()
    card, host = run(True), run(False)
    assert len(card) == len(host) == 6
    for c, h in zip(card, host):
        for k in h:
            assert c[k].device.type == "cuda"
            assert torch.equal(c[k].cpu(), h[k])


def test_full_width_global_batch_while_next_is_made(dev):
    """A multipair training batch at full width (4 items of 21 clips of
    12x224x224 frames and 2 s of audio, 607 MB) lands on the card intact
    while the loader's workers write the next batches into the slabs."""
    from asva_tpu_torch.data.loader import DataLoader
    from asva_tpu_torch.parallel.multihost import make_global_batch
    ds = _Items(12, {"videos": (21, 12, 224, 224, 3),
                     "waveforms": (21, 32000)})
    dl = DataLoader(ds, 4, shuffle=True, seed=1, num_workers=4,
                    worker_mode="process", prefetch=1)
    try:
        sent = []
        for b in dl:
            sent.append((b["index"].tolist(), make_global_batch(b, dev)))
        torch.cuda.synchronize()
    finally:
        dl.close()
    assert len(sent) == 3
    for ids, batch in sent:
        assert batch["index"].tolist() == ids
        for row, i in enumerate(ids):
            want = ds[i]
            for k in ("videos", "waveforms"):
                assert torch.equal(batch[k][row].cpu(),
                                   torch.from_numpy(want[k]))
