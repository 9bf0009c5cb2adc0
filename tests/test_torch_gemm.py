"""K-gemm (`csrc/gemm.cu`) on the CPU: the generated `wgmma.cuh` is what
`gen_wgmma.py` writes, the shapes the kernel takes, and its plain version
`fused.ln_gemm_plain`, whose four forms compose B3 and the projections of
B1, against `asva_tpu`'s reference composites in fp32.  The kernel itself
runs in tests/test_torch_cuda.py on the card."""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asva_tpu.ops import pallas_fused as pf
from asva_tpu_torch.ops import fused

from test_torch_ops import close, t

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "asva_tpu_torch", "csrc")
# SD1.5's transformer widths by level, and K-gemm's four launches in a
# sub-layer: (form, weight rows per C, contraction per C)
LEVELS = {"32x32": 320, "16x16": 640, "8x8": 1280, "4x4": 1280}
FORMS = (("q", 1, 1), ("out", 1, 1), ("ff1", 8, 1), ("ff2", 1, 4))


def test_wgmma_header_is_what_the_generator_writes():
    spec = importlib.util.spec_from_file_location(
        "gen_wgmma", os.path.join(CSRC, "gen_wgmma.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    with open(os.path.join(CSRC, "wgmma.cuh")) as f:
        assert f.read() == gen.render()
    assert {64, 80, 160} <= set(gen.SS_WIDTHS)    # K-gemm's N tiles


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("form,wn,wk", FORMS)
def test_every_sd15_launch_is_supported(level, form, wn, wk):
    c = LEVELS[level]
    n = wn * c // (2 if form == "ff1" else 1)
    for dtype in (torch.bfloat16, torch.float32):
        assert fused.gemm_supported(n, wk * c, dtype) is None


@pytest.mark.parametrize("n,k,dtype", [
    (320, 32, torch.bfloat16),     # K not a multiple of 64
    (320, 100, torch.bfloat16),
    (100, 320, torch.bfloat16),    # N neither a multiple of 160 nor of 64
    (80, 64, torch.bfloat16),
    (64, 40, torch.float32),       # fp32: K not a multiple of 16
])
def test_unsupported_shapes_are_named(n, k, dtype):
    assert "K-gemm takes" in fused.gemm_supported(n, k, dtype)


def _ff(rng, m, c):
    inner = 4 * c
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa
    return (r(m, c) * 10, r(c) + 1.0, r(c), r(c, 2 * inner), r(2 * inner),
            r(inner, c), r(c))


@pytest.mark.parametrize("m,c", [(64, 64), (40, 320)])
def test_ff1_then_ff2_is_b3(rng, m, c):
    """fp32, 3e-5: the LN + GEGLU form then the bias + residual form is
    pallas_fused._ln_geglu_reference."""
    x, ls, lb, wi, bi, wo, bo = _ff(rng, m, c)
    want = pf._ln_geglu_reference(
        jnp.asarray(x), jnp.asarray(ls)[None], jnp.asarray(lb)[None],
        jnp.asarray(wi), jnp.asarray(bi)[None], jnp.asarray(wo),
        jnp.asarray(bo)[None], 1e-5)
    h = fused.ln_gemm("ff1", t(x), t(wi.T), t(bi), ln=(t(ls), t(lb), 1e-5))
    assert h.shape == (m, 4 * c)
    close(fused.ln_gemm("ff2", h, t(wo.T), t(bo), res=t(x)), want, 3e-5)


def test_q_and_out_forms_are_b1_projections(rng):
    """fp32, 3e-5: q = LN(x) Wq^T, then the reference attention, then x +
    o Wo^T + bo is pallas_fused._ln_attn_reference."""
    g, m, c, sk, heads = 2, 24, 64, 16, 2
    r = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)  # noqa
    x, k, v = r(g, m, c) * 20, r(g, sk, c) * 10, r(g, sk, c) * 10
    ls, lb, wq, wo, bo = r(c) + 1.0, r(c), r(c, c), r(c, c), r(c)
    want = pf._ln_attn_reference(
        jnp.asarray(x), jnp.asarray(ls)[None], jnp.asarray(lb)[None],
        jnp.asarray(wq), jnp.asarray(wo), jnp.asarray(bo)[None],
        jnp.asarray(k), jnp.asarray(v), 1e-5, heads, None)
    q = fused.ln_gemm("q", t(x).reshape(g * m, c), t(wq.T),
                      ln=(t(ls), t(lb), 1e-5))
    o = fused.mha_plain(q.reshape(g, m, c), t(k), t(v), heads, None,
                        (c // heads) ** -0.5)
    got = fused.ln_gemm("out", o.reshape(g * m, c), t(wo.T), t(bo),
                        res=t(x).reshape(g * m, c))
    close(got.reshape(g, m, c), want, 3e-5)


def test_ln_gemm_cpu_path_counts_no_launch_and_checks_its_form(rng):
    before = dict(fused.LAUNCHES)
    a, w = t(rng.standard_normal((8, 64)).astype(np.float32)), torch.eye(64)
    assert torch.equal(fused.ln_gemm("q", a, w), a)
    assert fused.LAUNCHES == before
    with pytest.raises(ValueError, match="form"):
        fused.ln_gemm("geglu", a, w)


def test_ln_gemm_off_the_cpu_never_takes_the_plain_path():
    meta = lambda *s: torch.empty(s, device="meta")  # noqa: E731
    with pytest.raises(ValueError, match="CUDA"):
        fused.ln_gemm("out", meta(8, 64), meta(64, 64), meta(64),
                      res=meta(8, 64))
