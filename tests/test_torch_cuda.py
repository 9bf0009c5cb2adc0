"""The port's CUDA kernels (B1-B3) against their plain versions, on a card.

Marked `cuda`: each test skips without a CUDA device.  This file imports no
JAX, so it runs on a machine with only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py configures JAX.)  chip_smoke.py holds
the kernels against their plain versions at every SD1.5 level; this file
covers what that run does not reach: kv_len < Sk masking, ragged token
counts that are not tile multiples, and head dims 40/80/160.

Tolerances: fp32 1e-4 times max(1, max|plain|) (fp32 products; summation
order and the online softmax differ); bf16 2**-6 times max|plain| (two bf16
ulps at the output's largest magnitude: q, P and h round at different
points)."""
import numpy as np
import pytest
import torch

from asva_tpu_torch.ops import fused

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
