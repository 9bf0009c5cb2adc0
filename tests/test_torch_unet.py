"""Parity of the port's UNet (asva_tpu_torch/models/unet3d) against
asva_tpu on the CPU: primitives, resnet, transformer block, and the tiny
AudioUNet3D in both fuse_blocks variants.  fp32 throughout; the full-size
UNet parity is `slow`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from torch import nn

from asva_tpu.models.imagebind_audio import (segment_masks,
                                             segment_token_indices)
from asva_tpu.models.unet3d import primitives as jp
from asva_tpu.models.unet3d import resnet as jr
from asva_tpu.models.unet3d import transformer as jt
from asva_tpu.ops.norms import LayerNormParams as JLN
from asva_tpu_torch.models.unet3d import primitives as tp
from asva_tpu_torch.models.unet3d import resnet as tr
from asva_tpu_torch.models.unet3d import transformer as tt
from asva_tpu_torch.ops.norms import LayerNormParams as TLN

from test_torch_ops import close, port, randomize, t

torch.set_num_threads(1)


def _run(jm, tm, rng, *inputs, tol=3e-5, **jkw):
    p = randomize(jm.init(jax.random.PRNGKey(0), *inputs, **jkw), rng)
    want = jm.apply(p, *inputs, **jkw)
    tm = port(tm, p)
    with torch.no_grad():
        got = tm(*[t(a) if isinstance(a, np.ndarray) else a for a in inputs])
    close(got, want, tol)


def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------- primitives ---

@pytest.mark.parametrize("k,s,p", [(3, 1, 1), (1, 1, 0), (3, 2, 1)])
def test_ff_inflated_conv(rng, k, s, p):
    """conv + [head|prev|curr] temporal mix, prev of frame 0 = frame 0."""
    x = _x(rng, 2, 3, 8, 8, 6)
    _run(jp.FFInflatedConv(10, k, s, p), tp.FFInflatedConv(6, 10, k, s, p),
         rng, x)


def test_inflated_conv(rng):
    x = _x(rng, 2, 3, 6, 6, 4)
    _run(jp.InflatedConv(5), tp.InflatedConv(4, 5), rng, x)


def test_ff_upsample_conv(rng):
    """nearest-up + conv vs the JAX pre-upsample kernel fold: equal up to
    one rounding of the folded taps, 3e-5."""
    x = _x(rng, 1, 3, 4, 5, 6)
    _run(jp.FFInflatedUpsample2xConv(6), tp.FFInflatedUpsample2xConv(6, 6),
         rng, x)


def test_temporal_attention(rng):
    x = _x(rng, 2, 5, 6, 16)
    _run(jp.TemporalAttention(2, 8), tp.TemporalAttention(16, 2, 8), rng, x)


class _JSub(fnn.Module):
    """An attention sub-layer with its LayerNorm, as the block calls it."""
    kind: str
    dim: int = 16

    @fnn.compact
    def __call__(self, x, ctx=None, mask=None):
        ln = JLN(self.dim, name="norm")
        if self.kind == "spatial":
            return jp.FFSpatialAttention(2, 8, name="attn")(x, ln=ln)
        return jp.CrossAttention(2, 8, name="attn")(x, ctx, mask=mask, ln=ln)


class _TSub(nn.Module):
    def __init__(self, kind, dim=16, ctx_dim=None, indices=None):
        super().__init__()
        self.kind, self.indices = kind, indices
        self.norm = TLN(dim)
        self.attn = (tp.FFSpatialAttention(dim, 2, 8) if kind == "spatial"
                     else tp.CrossAttention(dim, 2, 8, ctx_dim))

    def forward(self, x, ctx=None):
        if self.kind == "spatial":
            return self.attn(x, self.norm)
        return self.attn(x, ctx, self.norm, context_indices=self.indices)


def test_ff_spatial_attention(rng):
    """K/V from the normed frame 0, every frame's queries (B1 plain)."""
    x = _x(rng, 2, 3, 10, 16)
    _run(_JSub("spatial"), _TSub("spatial"), rng, x)


def test_text_cross_attention(rng):
    x, ctx = _x(rng, 2, 3, 10, 16), _x(rng, 2, 7, 12)
    _run(_JSub("cross"), _TSub("cross", ctx_dim=12), rng, x, ctx)


def test_ff_spatial_attention_without_ln(rng):
    """ln=None: the bare attention of x, no LayerNorm and no residual
    (JAX `_attend`), through the plain version of B6; 3e-5."""
    x = _x(rng, 2, 3, 10, 16)
    _run(jp.FFSpatialAttention(2, 8), tp.FFSpatialAttention(16, 2, 8), rng, x)


@pytest.mark.parametrize("form", ["text", "masked", "per_frame",
                                  "per_frame_masked", "gathered"])
def test_cross_attention_without_ln(rng, form):
    """ln=None in every form of JAX `CrossAttention._attend`: an unmasked
    shared context (B6's plain version), a boolean (b, f, m) mask, a
    per-frame 4-D context with and without a mask, and a static gather;
    3e-5."""
    b, f, n, m = 2, 3, 10, 7
    x = _x(rng, b, f, n, 16)
    ctx = _x(rng, b, f, m, 12) if form.startswith("per_frame") else _x(
        rng, b, m, 12)
    mask = idx = None
    if form.endswith("masked"):
        mask = rng.random((b, f, m)) > 0.4
        mask[..., 0] = True
    if form == "gathered":
        idx = np.stack([rng.permutation(m)[:4] for _ in range(f)])
    jm = jp.CrossAttention(2, 8)
    jkw = dict(mask=None if mask is None else jnp.asarray(mask),
               context_indices=idx)
    p = randomize(jm.init(jax.random.PRNGKey(0), x, ctx, **jkw), rng)
    want = jm.apply(p, x, ctx, **jkw)
    tm = port(tp.CrossAttention(16, 2, 8, 12), p)
    with torch.no_grad():
        got = tm(t(x), t(ctx), mask=None if mask is None else t(mask),
                 context_indices=idx)
    assert got.shape == (b, f, n, 16)
    close(got, want, 3e-5)


def test_attend_dispatches_by_function(rng, monkeypatch):
    """`_attend` reaches B6 exactly where the JAX modules reach pallas_attn:
    frame-0 self-attention -> vmem_attention on (b*H, f*n, D) against
    (b*H, n, D); unmasked 3-D context -> vmem_cross_attention with the true
    token count; gathered, masked or 4-D context -> dot_product_attention.
    The fused residual form (with ln) never reaches B6."""
    calls = []
    real_self, real_cross = (tp.flat_attention.vmem_attention,
                             tp.flat_attention.vmem_cross_attention)

    def rec_self(q, k, v):
        calls.append(("self", tuple(q.shape), tuple(k.shape)))
        return real_self(q, k, v)

    def rec_cross(q, k, v, kv_len):
        calls.append(("cross", tuple(q.shape), tuple(k.shape), kv_len))
        return real_cross(q, k, v, kv_len)
    monkeypatch.setattr(tp.flat_attention, "vmem_attention", rec_self)
    monkeypatch.setattr(tp.flat_attention, "vmem_cross_attention", rec_cross)
    b, f, n, m = 2, 3, 10, 7
    x, ctx = t(_x(rng, b, f, n, 16)), t(_x(rng, b, m, 12))
    sa, ca, ln = (tp.FFSpatialAttention(16, 2, 8),
                  tp.CrossAttention(16, 2, 8, 12), TLN(16))
    with torch.no_grad():
        sa(x)
        ca(x, ctx)
        assert calls == [("self", (4, 30, 8), (4, 10, 8)),
                         ("cross", (4, 30, 8), (4, 7, 8), 7)]
        ca(x, ctx, mask=torch.ones(b, f, m, dtype=torch.bool))
        ca(x, ctx[:, None].expand(b, f, m, 12))
        ca(x, ctx, context_indices=np.zeros((f, 2), np.int64))
        sa(x, ln)
        ca(x, ctx, ln)
        ca(x, ctx, ln, context_indices=np.zeros((f, 2), np.int64))
        assert len(calls) == 2
        with pytest.raises(ValueError, match="ln=None"):
            ca(x, ctx, ln, mask=torch.ones(b, f, m, dtype=torch.bool))
        with pytest.raises(ValueError, match="ln=None"):
            ca(x, ctx[:, None].expand(b, f, m, 12), ln)


def test_segment_gather_equals_masked_cross_attention(rng):
    """The port's static per-frame token gather equals the JAX masked
    audio cross-attention with the segment masks, 3e-5."""
    f = 4
    masks = segment_masks(f, (12, 19))
    mask = np.broadcast_to(masks[None], (2,) + masks.shape)
    idx = tp.mask_to_token_indices(mask)
    np.testing.assert_array_equal(idx, segment_token_indices(f, (12, 19)))
    x, ctx = _x(rng, 2, f, 10, 16), _x(rng, 2, 229, 12)
    jm = _JSub("cross")
    p = randomize(jm.init(jax.random.PRNGKey(0), x, ctx, jnp.asarray(mask)),
                  rng)
    want = jm.apply(p, x, ctx, jnp.asarray(mask))
    tm = port(_TSub("cross", ctx_dim=12, indices=idx), p)
    with torch.no_grad():
        close(tm(t(x), t(ctx)), want, 3e-5)


def test_geglu_feed_forward(rng):
    class J(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            return jt.GEGLUFeedForward(16, name="ff")(
                x, ln=JLN(16, name="norm3"))

    class T(nn.Module):
        def __init__(self):
            super().__init__()
            self.ff, self.norm3 = tt.GEGLUFeedForward(16), TLN(16)

        def forward(self, x):
            return self.ff(x, self.norm3)

    _run(J(), T(), rng, _x(rng, 2, 3, 5, 16))


# --------------------------------------------------------------- resnet ---

@pytest.mark.parametrize("cin,cout", [(8, 16), (16, 16)])
def test_ff_resnet_block(rng, cin, cout):
    """VideoGroupNorm over all frames, per-frame temb, shortcut conv."""
    x, temb = _x(rng, 2, 3, 6, 6, cin), _x(rng, 2, 3, 12)
    jm = jr.FFResnetBlock(cout, temb_channels=12, groups=4)
    p = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), x, temb), rng)
    tm = port(tr.FFResnetBlock(cin, cout, 12, groups=4), p)
    with torch.no_grad():
        close(tm(t(x), t(temb)), jax.jit(jm.apply)(p, x, temb), 3e-5)


@pytest.mark.parametrize("kind", ["down", "up"])
def test_ff_down_up_sample(rng, kind):
    x = _x(rng, 1, 3, 6, 6, 8)
    if kind == "down":
        _run(jr.FFDownsample(8), tr.FFDownsample(8), rng, x)
    else:
        _run(jr.FFUpsample(8), tr.FFUpsample(8), rng, x)


# ---------------------------------------------------------- transformer ---

@pytest.mark.parametrize("fuse", [False, True])
def test_transformer3d(rng, fuse):
    """GroupNorm -> proj_in -> block (B2 or B1s + B3) -> proj_out."""
    f = 4
    x, text, aud = _x(rng, 2, f, 4, 4, 16), _x(rng, 2, 7, 12), _x(rng, 2, 229, 10)
    idx = segment_token_indices(f, (12, 19))
    jm = jt.SpatioAudioTempTransformer3D(2, 8, norm_num_groups=4,
                                         fuse_blocks=fuse)
    p = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), x, text, aud, None,
                                   idx), rng)
    want = jax.jit(jm.apply)(p, x, text, aud, None, idx)
    tm = port(tt.SpatioAudioTempTransformer3D(
        2, 8, 16, norm_num_groups=4, cross_attention_dim=12,
        audio_cross_attention_dim=10), p)
    with torch.no_grad():
        got = tm(t(x), t(text), t(aud), idx, fuse_blocks=fuse)
    close(got, want, 3e-5)


# ----------------------------------------------------------------- UNet ---

def _unet_case(rng, jcfg, tcfg, f=4, hw=8, text_len=7):
    """(JAX UNet, its randomised params, the ported torch UNet, numpy
    inputs, the JAX output with the segment token gather)."""
    from asva_tpu.models.unet3d import AudioUNet3D as JU
    from asva_tpu_torch.models.unet3d import AudioUNet3D as TU
    x = _x(rng, 2, f, hw, hw, 4)
    ts = np.array([10, 700], np.int32)
    text = _x(rng, 2, text_len, jcfg.cross_attention_dim)
    aud = _x(rng, 2, 229, jcfg.audio_cross_attention_dim)
    idx = segment_token_indices(f, (12, 19))
    jm = JU(jcfg)
    # jit: one compiled init and apply instead of thousands of eager ops
    p = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), x, ts, text, aud,
                                   None, idx), rng)
    want = jax.jit(jm.apply)(p, x, ts, text, aud, None, idx)
    return jm, p, port(TU(tcfg), p), (x, ts, text, aud), want


@pytest.fixture(scope="module")
def tiny_unet():
    """One tiny UNet pair shared by the tests below (one JAX init)."""
    from asva_tpu.models.unet3d import UNet3DConfig as JC
    from asva_tpu_torch.models.unet3d import UNet3DConfig as TC
    return _unet_case(np.random.default_rng(5), JC.tiny(), TC.tiny())


@pytest.mark.parametrize("fuse", [False, True])
def test_tiny_unet_both_variants(tiny_unet, fuse):
    """UNet3DConfig.tiny(): fuse_blocks True (B2 + B3) and False (B1 + B3)
    compute the JAX UNet's function, 5e-5 on outputs of magnitude ~3."""
    _, _, tm, inputs, want = tiny_unet
    with torch.no_grad():
        got = tm(*map(t, inputs),
                 audio_token_indices=segment_token_indices(4, (12, 19)),
                 fuse_blocks=fuse)
    close(got, want, 5e-5)


def test_build_unet_loads_a_reference_directory_like_asva_tpu(tiny_unet,
                                                              tmp_path):
    """A diffusers-layout directory written from the JAX parameters: the
    port's build_unet(weights_dir=...) computes the JAX UNet's function
    (1e-4 max(1, |ref|)), in fp32 and, held to its own fp32 load, in bf16
    as weights.to(bf16); asva_tpu's loader (`runtime._maybe_convert`, what
    its build_unet runs after its init) reads the same file back into the
    parameters it was written from."""
    import os
    from asva_tpu import runtime as jrt
    from asva_tpu.convert.jax_to_torch import export_state_dict
    from asva_tpu.convert.torch_to_jax import unet_key_map
    from asva_tpu_torch import runtime
    from asva_tpu_torch.models.unet3d import UNet3DConfig as TC
    _, p, _, (x, ts, text, aud), want = tiny_unet
    d = tmp_path / "unet"
    d.mkdir()
    torch.save(export_state_dict(p, unet_key_map, to_torch=True),
               str(d / "diffusion_pytorch_model.bin"))
    zeros = jax.tree_util.tree_map(jnp.zeros_like, p)
    back = jrt._maybe_convert(zeros, str(d), unet_key_map, "unet")
    assert all(np.array_equal(a, b) for a, b in zip(
        jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)))
    tm = runtime.build_unet(TC.tiny(), device="cpu", dtype=torch.float32,
                            weights_dir=str(d))
    idx = segment_token_indices(4, (12, 19))
    with torch.no_grad():
        got = tm(*map(t, (x, ts, text, aud)), audio_token_indices=idx)
    close(got, want, 1e-4 * max(1.0, float(np.abs(want).max())))
    bf = runtime.build_unet(TC.tiny(), device="cpu", dtype=torch.bfloat16,
                            weights_dir=os.path.join(str(d), ""))
    assert all(torch.equal(a, b.to(torch.bfloat16)) for a, b in
               zip(bf.state_dict().values(), tm.state_dict().values()))


def test_tiny_unet_mask_input_equals_gather(tiny_unet):
    """A boolean audio_mask input (JAX masked attention) gives the same
    output as the port's token gather built from it, 5e-5."""
    jm, p, tm, (x, ts, text, aud), _ = tiny_unet
    m = np.broadcast_to(segment_masks(4, (12, 19))[None], (2, 4, 229))
    want = jax.jit(jm.apply)(p, x, ts, text, aud, jnp.asarray(m))
    with torch.no_grad():
        close(tm(t(x), t(ts), t(text), t(aud), audio_mask=t(m)), want, 5e-5)


@pytest.mark.slow
def test_full_size_unet_parity(rng):
    """Full SD1.5 widths at a small latent (b=2, f=4, 16x16), fp32, 2e-4
    relative to the output scale (deep fp32 network, 1.3B parameters)."""
    from asva_tpu.models.unet3d import UNet3DConfig as JC
    from asva_tpu_torch.models.unet3d import UNet3DConfig as TC
    _, _, tm, inputs, want = _unet_case(rng, JC(), TC(), hw=16, text_len=77)
    with torch.no_grad():
        got = tm(*map(t, inputs),
                 audio_token_indices=segment_token_indices(4, (12, 19)),
                 fuse_blocks=True).numpy()
    want = np.asarray(want)
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
