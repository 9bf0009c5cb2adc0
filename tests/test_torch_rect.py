"""TheGreatestHits' rectangular configuration through the port, against
asva_tpu on the CPU.

TheGreatestHits generates and trains at 128x256 frames
(configs/audio-cond_animation/thegreatesthits_audio-cond_cfg.yaml,
scripts/animation_test_thegreatesthits.sh).  Every layer that flattens or
rebuilds the spatial axes is held here at h != w, in both orientations
(16x32 and 32x16 pixels at the tiny size; latents 8x16 and 16x8): a swap
of h and w shows in only one of them.  The layers, in the order of the
path: the SD transform and `load_image` (at 128x256 itself), the VAE, the
UNet's primitives, resnet, transformer and the whole AudioUNet3D (both
fuse_blocks), the fused wrappers' plain versions at the token counts of
128x256 latents, the pipeline (DDIM and PLMS, audio guidance 4.0,
broadcast_rng), the dataset with the single-tensor text encoding, a
trainer step, the train CLI from a TheGreatestHits-shaped YAML and its
resume, the recipe CLIs' default image size, the judge's harness and the
frame-sharded pipeline at seq 2 (two gloo ranks: this file run as a
script, `python tests/test_torch_rect.py <dir>`).

The port's modules are seeded; asva_tpu gets the same weights through
its converter into trees shaped by `jax.eval_shape`, so no JAX init is
compiled.  Tolerances are those of the square tests each case mirrors
(stated per test).  fp32 throughout."""
import json
import os
import sys

import numpy as np
import pytest
import torch

import test_torch_parallel as tp
import test_torch_parallel_gen as tpg
from asva_tpu_torch.data import media
from test_torch_cli_train import tiny_towers  # noqa: F401 (a fixture)
from test_torch_scripts import towers  # noqa: F401 (a fixture)

torch.set_num_threads(1)

# (h, w) pixels of the tiny frames: TheGreatestHits' orientation and its swap
ORIENTS = [(16, 32), (32, 16)]
ORIENT_IDS = ["16x32", "32x16"]
F = 4                                   # video length at the tiny size
STEPS = 3                               # sampler steps
GEN_KW = dict(video_length=F, num_inference_steps=STEPS,
              audio_guidance_scale=4.0, text_guidance_scale=1.0)
needs_media = pytest.mark.skipif(not media.headers_available(),
                                 reason="libav development files missing")


# test_torch_ops.py's helpers, here without its JAX import: the rank
# processes run this file as a script and never import JAX
def _x(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


# ------------------------------------------------------------- weights ---

def port_modules(weights):
    """The tiny port UNet, VAE and audio tower of `weights` (state dicts)."""
    from asva_tpu_torch.models.imagebind_audio import (
        ImageBindAudioConfig, SegmaskAudioEncoder)
    from asva_tpu_torch.models.unet3d import AudioUNet3D, UNet3DConfig
    from asva_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    modules = (AudioUNet3D(UNet3DConfig.tiny(audio_cross_attention_dim=32)),
               AutoencoderKL(VAEConfig.tiny()),
               SegmaskAudioEncoder(ImageBindAudioConfig.tiny(), n_segment=F))
    for m, name in zip(modules, ("unet", "vae", "audio")):
        m.load_state_dict(weights[name])
        m.eval()
    return modules


def port_pipeline(weights, mesh=None):
    from asva_tpu_torch.pipelines.animation import AnimationPipeline
    return AnimationPipeline(*port_modules(weights),
                             null_text_encoding=weights["null"], mesh=mesh)


def _inputs(rng, orient, b=2):
    h, w = orient
    return dict(images=rng.random((b, h, w, 3)).astype(np.float32),
                mels=_x(rng, b, 128, 204, 1), text=_x(rng, b, 7, 768))


class World:
    """The port's tiny modules on seeded weights, the same weights as
    asva_tpu trees, asva_tpu's modules and pipeline, and every JAX result
    the tests compare with, computed once (one compile per shape)."""

    def __init__(self):
        import jax
        import jax.numpy as jnp
        from asva_tpu.convert.torch_to_jax import (convert_state_dict,
                                                   imagebind_audio_key_map,
                                                   unet_key_map, vae_key_map)
        from asva_tpu.models.imagebind_audio import (
            ImageBindAudioConfig as JAC, SegmaskAudioEncoder as JAE)
        from asva_tpu.models.unet3d import AudioUNet3D as JU
        from asva_tpu.models.unet3d import UNet3DConfig as JC
        from asva_tpu.models.vae import AutoencoderKL as JV, VAEConfig as JVC
        from asva_tpu.pipelines.animation import AnimationPipeline as JP
        from asva_tpu_torch import runtime
        from asva_tpu_torch.models.imagebind_audio import (
            ImageBindAudioConfig as TAC)
        from asva_tpu_torch.models.unet3d import UNet3DConfig as TC
        from asva_tpu_torch.models.vae import VAEConfig as TVC
        cpu = dict(device="cpu", dtype=torch.float32, randomize_all=True)
        mods = {"unet": runtime.build_unet(
                    TC.tiny(audio_cross_attention_dim=32), seed=31, **cpu),
                "vae": runtime.build_vae(TVC.tiny(), seed=32, **cpu),
                "audio": runtime.build_audio_encoder(F, TAC.tiny(), seed=33,
                                                     **cpu)}
        self.junet, self.jvae = JU(JC.tiny()), JV(JVC.tiny())
        self.jaud = JAE(JAC.tiny(), n_segment=F)
        key = jax.random.PRNGKey(0)
        shapes = {
            "unet": jax.eval_shape(
                self.junet.init, key, jnp.zeros((1, F, 8, 8, 4)),
                jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, 768)),
                jnp.zeros((1, 229, 32)), jnp.ones((1, F, 229), bool)),
            "vae": jax.eval_shape(self.jvae.init, key,
                                  jnp.zeros((1, 16, 16, 3)), key),
            "audio": jax.eval_shape(self.jaud.init, key,
                                    jnp.zeros((1, 128, 204, 1)))}
        maps = {"unet": unet_key_map, "vae": vae_key_map,
                "audio": imagebind_audio_key_map}
        self.params = {}
        for name, module in mods.items():
            state = {k: v.numpy() for k, v in module.state_dict().items()}
            self.params[name], report = convert_state_dict(
                shapes[name], state, maps[name], strict=True)
            assert not report["unused"], report["unused"][:5]
        rng = np.random.default_rng(41)
        self.null = rng.standard_normal((1, 7, 768)).astype(np.float32)
        self.weights = {name: m.state_dict() for name, m in mods.items()}
        self.weights["null"] = torch.from_numpy(self.null)
        self.jpipe = JP(unet=self.junet, vae=self.jvae,
                        audio_encoder=self.jaud,
                        unet_params=self.params["unet"],
                        vae_params=self.params["vae"],
                        audio_encoder_params=self.params["audio"],
                        null_text_encoding=jnp.asarray(self.null))
        self._cache = {}

    def cached(self, key, fn):
        if key not in self._cache:
            self._cache[key] = fn()
        return self._cache[key]

    def request(self, orient, sampler):
        """A request's inputs, JAX's two draws under PRNGKey(5) (shared by
        the clips under PLMS, as broadcast_rng does) and asva_tpu's
        videos."""
        def run():
            import jax
            import jax.numpy as jnp
            rng = np.random.default_rng(50 + ORIENTS.index(orient))
            x = _inputs(rng, orient)
            broadcast = sampler == "plms"
            kw = dict(GEN_KW, sampler=sampler)
            want = self.jpipe(*(jnp.asarray(x[k]) for k in
                                ("images", "mels", "text")),
                              rng=jax.random.PRNGKey(5),
                              broadcast_rng=broadcast, **kw)
            rng_vae, rng_noise = jax.random.split(jax.random.PRNGKey(5))
            mean, _ = jax.eval_shape(
                lambda p, x: self.jvae.apply(p, x, method=self.jvae.encode),
                self.params["vae"], x["images"])
            nb = 1 if broadcast else mean.shape[0]
            x["vae_noise"] = np.asarray(jax.random.normal(
                rng_vae, (nb,) + mean.shape[1:]))
            x["latent_noise"] = np.asarray(jax.random.normal(
                rng_noise, (nb, F - 1) + mean.shape[1:]))
            return x, broadcast, np.asarray(want)
        return self.cached(("request", orient, sampler), run)


@pytest.fixture(scope="module")
def world():
    """The World, with asva_tpu's programs compiled by XLA at its lowest
    optimisation level for this module (the same functions; their compile
    time is most of this file's)."""
    import jax
    old = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield World()
    jax.config.update("jax_disable_most_optimizations", old)


def _port_request(pipe, x, broadcast, sampler, decode=True):
    return pipe(*(t(x[k]) for k in ("images", "mels", "text")),
                vae_noise=t(x["vae_noise"]), latent_noise=t(x["latent_noise"]),
                broadcast_rng=broadcast, decode=decode, sampler=sampler,
                **GEN_KW)


# -------------------------------------------- 1-2. transforms, load_image ---

@pytest.mark.parametrize("size", [(128, 256), (256, 128)],
                         ids=["128x256", "256x128"])
@pytest.mark.parametrize("aspect", [(3, 4), (9, 16)], ids=["4:3", "16:9"])
def test_sd_video_transform_rect(rng, size, aspect):
    """The recipe's trim to the target aspect and the antialias resize to
    (128, 256) and its swap, from 4:3 and 16:9 frames; with the flip;
    1e-5 (test_torch_eval.py's)."""
    import jax.numpy as jnp
    from asva_tpu.data import transforms as jtr
    from asva_tpu_torch.data import transforms as ttr
    x = rng.random((2, 12 * aspect[0], 12 * aspect[1], 3)).astype(np.float32)
    for flip in (False, True):
        want = jtr.sd_video_transform(jnp.asarray(x), size, flip, True)
        got = ttr.sd_video_transform(t(x), size, flip, True)
        assert tuple(got.shape) == (2,) + size + (3,)
        close(got, want, 1e-5)


@pytest.mark.parametrize("size", [(128, 256), (256, 128)],
                         ids=["128x256", "256x128"])
def test_load_image_rect(tmp_path, rng, size):
    """A 4:3 PNG at the recipe's (128, 256) and its swap, 1e-6
    (test_torch_generate.py's)."""
    from PIL import Image
    from asva_tpu.pipelines import generate as jg
    from asva_tpu_torch.pipelines import generate as tg
    path = str(tmp_path / "img.png")
    Image.fromarray((rng.random((96, 128, 3)) * 255).astype(np.uint8)).save(
        path)
    got = tg.load_image(path, size)
    assert got.shape == size + (3,)
    np.testing.assert_allclose(got, jg.load_image(path, size), atol=1e-6)


# ------------------------------------------------------------- 3. VAE ---

@pytest.mark.parametrize("orient", ORIENTS, ids=ORIENT_IDS)
def test_vae_rect(world, rng, orient):
    """Encode (its mid attention flattens h * w) and decode at h != w:
    mean and logvar 3e-5, the decoded frames 5e-5
    (test_torch_vae_audio.py's)."""
    import jax
    _, vae, _ = port_modules(world.weights)
    h, w = orient
    img = (rng.random((2, h, w, 3)) * 2 - 1).astype(np.float32)
    jm, p = world.jvae, world.params["vae"]
    jmean, jlogvar = jax.jit(lambda p, x: jm.apply(p, x, method=jm.encode))(
        p, img)
    with torch.no_grad():
        mean, logvar = vae.encode(t(img))
        assert tuple(mean.shape) == (2, h // 2, w // 2, 4)
        close(mean, jmean, 3e-5)
        close(logvar, jlogvar, 3e-5)
        z = _x(rng, 2, h // 2, w // 2, 4)
        got = vae.decode(t(z))
    assert tuple(got.shape) == (2, h, w, 3)
    close(got, jax.jit(lambda p, z: jm.apply(p, z, method=jm.decode))(p, z),
          5e-5)


# -------------------------------------- 4-5. primitives, resnet, blocks ---

def _seeded_pair(tm, jm, seed, *inputs):
    """The port module `tm` on seeded random weights (every parameter
    drawn) and the same weights as a tree of the JAX module `jm`, shaped by
    `jax.eval_shape` (no JAX init is compiled)."""
    import jax
    from asva_tpu.convert.torch_to_jax import convert_state_dict, unet_key_map
    from asva_tpu_torch.runtime import _build
    tm = _build(lambda: tm, "cpu", torch.float32, seed, True)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *inputs)
    params, report = convert_state_dict(
        shapes, {k: v.numpy() for k, v in tm.state_dict().items()},
        unet_key_map, strict=True)
    assert not report["unused"] and not report["fresh"], report
    return tm, params


def _module_pair(jm, tm, seed, *inputs, tol=3e-5):
    """The JAX module's jitted forward against the port module's on the
    same seeded weights."""
    import jax
    tm, p = _seeded_pair(tm, jm, seed, *inputs)
    want = jax.jit(jm.apply)(p, *inputs)
    with torch.no_grad():
        got = tm(*map(t, inputs))
    assert tuple(got.shape) == tuple(np.shape(want))
    close(got, want, tol)


@pytest.mark.parametrize("orient", [(4, 8), (8, 4)], ids=["4x8", "8x4"])
def test_primitives_rect(rng, orient):
    """FFInflatedConv at stride 2 (the downsample), the nearest x2
    upsample + conv (repeat_interleave on dims 2 and 3) and the temporal
    attention over h * w tokens, 3e-5 (test_torch_unet.py's)."""
    from asva_tpu.models.unet3d import primitives as jp
    from asva_tpu_torch.models.unet3d import primitives as tpm
    x = _x(rng, 2, 3, *orient, 6)
    _module_pair(jp.FFInflatedConv(10, 3, 2, 1),
                 tpm.FFInflatedConv(6, 10, 3, 2, 1), 1, x)
    _module_pair(jp.FFInflatedUpsample2xConv(6),
                 tpm.FFInflatedUpsample2xConv(6, 6), 2, x)
    tokens = _x(rng, 2, 5, orient[0] * orient[1], 16)
    _module_pair(jp.TemporalAttention(2, 8),
                 tpm.TemporalAttention(16, 2, 8), 3, tokens)


@pytest.mark.parametrize("orient", [(4, 8), (8, 4)], ids=["4x8", "8x4"])
def test_resnet_rect(rng, orient):
    """FFResnetBlock (VideoGroupNorm, per-frame temb, shortcut conv),
    FFDownsample and FFUpsample at h != w, 3e-5."""
    from asva_tpu.models.unet3d import resnet as jr
    from asva_tpu_torch.models.unet3d import resnet as tr
    x, temb = _x(rng, 2, 3, *orient, 8), _x(rng, 2, 3, 12)
    _module_pair(jr.FFResnetBlock(16, temb_channels=12, groups=4),
                 tr.FFResnetBlock(8, 16, 12, groups=4), 4, x, temb)
    _module_pair(jr.FFDownsample(8), tr.FFDownsample(8), 5, x)
    _module_pair(jr.FFUpsample(8), tr.FFUpsample(8), 6, x)


@pytest.mark.parametrize("orient", [(4, 8), (8, 4)], ids=["4x8", "8x4"])
def test_transformer3d_rect(rng, orient):
    """GroupNorm -> proj_in -> (b, f, h * w, c) tokens -> block -> back to
    (b, f, h, w, c) -> proj_out, with fuse_blocks True (B2 + B3) and False
    (B1 + B3), 3e-5 (test_torch_unet.py's)."""
    import jax
    from asva_tpu.models.imagebind_audio import segment_token_indices
    from asva_tpu.models.unet3d import transformer as jt
    from asva_tpu_torch.models.unet3d import transformer as tt
    f = 4
    x, text = _x(rng, 2, f, *orient, 16), _x(rng, 2, 7, 12)
    aud = _x(rng, 2, 229, 10)
    idx = segment_token_indices(f, (12, 19))
    tm, p = _seeded_pair(
        tt.SpatioAudioTempTransformer3D(2, 8, 16, norm_num_groups=4,
                                        cross_attention_dim=12,
                                        audio_cross_attention_dim=10),
        jt.SpatioAudioTempTransformer3D(2, 8, norm_num_groups=4), 7, x,
        text, aud, None, idx)
    for fuse in (False, True):
        jm = jt.SpatioAudioTempTransformer3D(2, 8, norm_num_groups=4,
                                             fuse_blocks=fuse)
        want = jax.jit(jm.apply)(p, x, text, aud, None, idx)
        with torch.no_grad():
            got = tm(t(x), t(text), t(aud), idx, fuse_blocks=fuse)
        close(got, want, 3e-5)


# ------------------------------------------------------ 6. AudioUNet3D ---

@pytest.mark.parametrize("fuse", [True, False], ids=["fused", "b1"])
@pytest.mark.parametrize("orient", ORIENTS, ids=ORIENT_IDS)
def test_unet_rect(world, rng, orient, fuse):
    """The tiny AudioUNet3D on latents of 16x32 / 32x16 frames (8x16 /
    16x8, down to 4x8 / 8x4): its down and up blocks, the mid block and
    every spatial attention, in both fuse_blocks variants; 5e-5 on outputs
    of magnitude ~3 (test_torch_unet.py's)."""
    import jax
    from asva_tpu.models.imagebind_audio import segment_token_indices
    unet, _, _ = port_modules(world.weights)
    idx = segment_token_indices(F, (12, 19))

    def run():
        r = np.random.default_rng(60 + ORIENTS.index(orient))
        hh, ww = orient[0] // 2, orient[1] // 2
        inputs = (_x(r, 2, F, hh, ww, 4), np.array([10, 700], np.int32),
                  _x(r, 2, 7, 768), _x(r, 2, 229, 32))
        want = jax.jit(world.junet.apply)(world.params["unet"], *inputs,
                                          None, idx)
        return inputs, np.asarray(want)
    inputs, want = world.cached(("unet", orient), run)
    with torch.no_grad():
        got = unet(*map(t, inputs), audio_token_indices=idx,
                   fuse_blocks=fuse)
    assert tuple(got.shape) == want.shape
    close(got, want, 5e-5)


# ------------------------------------------------- 7. the fused wrappers ---

# the token counts of 128x256 latents (16x32) by level, SD1.5's head dims
RECT_LEVELS = [(512, 40), (128, 80), (32, 160), (8, 160)]


@pytest.mark.parametrize("n,d", RECT_LEVELS,
                         ids=[f"n{n}" for n, _ in RECT_LEVELS])
def test_fused_wrappers_at_rect_token_counts(rng, n, d):
    """The wrappers' plain versions at 128x256's token counts per level
    (512, 128, 32 and the mid block's 8, where attn1's K/V is shorter than
    one 64-row tile) with SD1.5's head dims, 2 heads: B2 (attn1 on frame
    0, per-frame audio, text) and B3 against asva_tpu's `_reference`
    composites, 3e-5; B1's manual backward (the plain B4 and B5 inside)
    against jax.grad of `_ln_attn_reference`, 1e-4 of the largest entry
    (test_torch_fused.py's)."""
    import jax
    import jax.numpy as jnp
    from asva_tpu.ops import pallas_fused as pf
    from asva_tpu_torch.ops import fused
    from test_torch_fused import (_attn3_args, _attn3_case, _attn_case,
                                  _ff, _ff_jax, _ff_torch, _jax_sub,
                                  _torch_sub)
    heads, f = 2, 2
    c = heads * d
    x, subs, kv = _attn3_case(rng, 1, f, n, c, 25, 77)
    want = jax.jit(lambda *a: pf._ln_attn3_reference(
        *a, (1e-5,) * 3, heads, (None, None, None)))(
        *_attn3_args(x, subs, kv, _jax_sub, jnp.asarray))
    got = fused.fused_ln_attn3(*_attn3_args(x, subs, kv, _torch_sub, t),
                               (1e-5,) * 3, heads, (None, None, None))
    close(got, want, 3e-5)
    ff = _ff(rng, f * n, c)
    close(fused.fused_ln_geglu(*_ff_torch(ff), 1e-5),
          jax.jit(lambda *a: pf._ln_geglu_reference(*a, 1e-5))(
              *_ff_jax(ff)), 3e-5)
    # attn1 of a training batch of 2: G 2, M f * n, Sk n
    x, sub, k, v = _attn_case(rng, 2, f * n, c, n, None)
    jargs = [jnp.asarray(x)] + _jax_sub(sub) + [jnp.asarray(k),
                                                jnp.asarray(v)]
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(
        pf._ln_attn_reference(*a, 1e-5, heads, None) ** 2),
        argnums=tuple(range(8))))(*jargs)
    leaves = [a.requires_grad_(True) for a in
              [t(x)] + _torch_sub(sub) + [t(k), t(v)]]
    out = fused.fused_ln_attn(*leaves, 1e-5, heads)
    got = torch.autograd.grad((out ** 2).sum(), leaves)
    ls, lb, wq, wo, bo = grads[1:6]
    for a, b in zip(got, [grads[0], ls[0], lb[0], wq.T, wo.T, bo[0],
                          grads[6], grads[7]]):
        close(a, b, 1e-4 * max(1.0, float(np.abs(np.asarray(b)).max())))


# --------------------------------------------------------- 8. pipeline ---

# (orientation, sampler): each orientation and each sampler once (the
# samplers act on the latents elementwise; the layers that see h and w are
# the VAE's and the UNet's, which both samplers call alike)
REQUESTS = [((16, 32), "ddim"), ((32, 16), "plms")]


@pytest.mark.parametrize("orient,sampler", REQUESTS,
                         ids=["16x32-ddim", "32x16-plms"])
def test_pipeline_rect(world, orient, sampler):
    """Two clips at 16x32 with DDIM (a draw a clip) and at 32x16 with PLMS
    (broadcast_rng), 3 steps, audio guidance 4.0 and text guidance 1.0 (the
    recipe's: audio CFG, 2 UNet rows a clip), JAX's draws handed to the
    port: the videos within 1e-4 of asva_tpu's (test_torch_pipeline.py's);
    frame 0's latent is the pinned image latent."""
    x, broadcast, want = world.request(orient, sampler)
    pipe = port_pipeline(world.weights)
    got = _port_request(pipe, x, broadcast, sampler)
    assert tuple(got.shape) == (2, F) + orient + (3,) == want.shape
    close(got, want, 1e-4)
    lat = _port_request(pipe, x, broadcast, sampler, decode=False)
    assert tuple(lat.shape) == (2, F, orient[0] // 2, orient[1] // 2, 4)
    assert torch.equal(lat[:, 0], pipe.encode_image(
        t(x["images"]), noise=t(x["vae_noise"])))


# ---------------------------------------------------------- 9. dataset ---

def _write_clip(path, n, hw, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:hw[0], 0:hw[1]]
    frames = np.stack([np.stack([(xx * 3 + i * 7 + seed) % 256,
                                 (yy * 5 + i * 3) % 256,
                                 (xx + yy + 40 * seed) % 256], -1)
                       for i in range(n)]).astype(np.uint8)
    frames = np.clip(frames + rng.integers(0, 8, frames.shape), 0,
                     255).astype(np.uint8)
    s = np.arange(int(n / 12.0 * 44100)) / 44100
    audio = np.stack([0.4 * np.sin(2 * np.pi * (300 + 50 * seed) * s),
                      0.2 * np.sin(2 * np.pi * 90 * s)]).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    media.write_video(path, frames, 12.0, audio, 44100)


@pytest.fixture(scope="module")
def ghits(tmp_path_factory):
    """A TheGreatestHits-like tree: 4:3 clips (48x64, 12 fps, stereo 44.1
    kHz) under one folder, train.txt, and the text encoding as ONE tensor
    in a .pt (no class mapping)."""
    root = tmp_path_factory.mktemp("ghits")
    names = [f"hits/v{i}.mp4" for i in range(6)]
    for i, name in enumerate(names):
        _write_clip(str(root / name), 36, (48, 64), i)
    (root / "train.txt").write_text("\n".join(names))
    rng = np.random.default_rng(2)
    torch.save(torch.from_numpy(rng.standard_normal((1, 77, 768)).astype(
        np.float32)), root / "single.pt")
    return root


@needs_media
@pytest.mark.parametrize("orient", ORIENTS, ids=ORIENT_IDS)
def test_dataset_rect_single_encoding(ghits, orient):
    """AudioVideoDataset at img_size [16, 32] (and its swap) with
    class_mapping_json "" and the single-tensor .pt, as the YAML has them:
    every item of two epochs equals asva_tpu's, video and waveform within
    1e-6, the text encoding exactly (test_torch_data.py's)."""
    from asva_tpu_torch.data.datasets import AudioVideoDataset
    from test_torch_data import _same_item
    from test_torch_media import jax_media
    jax_media()
    from asva_tpu.data import datasets as jd
    kw = dict(example_list_path=str(ghits / "train.txt"),
              data_root=str(ghits), mode="train", img_size=orient,
              video_fps=6, video_num_frame=F, randflip=True,
              class_mapping_json="",
              class_text_encoding_mapping_path=str(ghits / "single.pt"),
              seed=4)
    ours, ref = AudioVideoDataset(**kw), jd.AudioVideoDataset(**kw)
    enc = torch.load(ghits / "single.pt").numpy()[0]
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        for i in range(len(ref)):
            got = ours[i]
            assert got["video"].shape == (F,) + orient + (3,)
            np.testing.assert_array_equal(got["text_encoding"], enc)
            _same_item(got, ref[i])


# ---------------------------------------------------------- 10. trainer ---

@pytest.mark.parametrize("orient", ORIENTS, ids=ORIENT_IDS)
def test_trainer_step_rect(world, rng, orient):
    """One step at a batch of 2 clips of 16x32 / 32x16, asva_tpu's five
    draws handed to the port: the loss to 1e-5 relative in both
    orientations; at 16x32 (the configuration's) every trainable gradient
    to 2e-4 of its largest entry against asva_tpu's grad step
    (test_torch_train.py's), and frozen parameters get none.  The 32x16
    loss is asva_tpu's jitted forward: its gradient program would double
    this file's time, and autograd mirrors the forward's reshapes."""
    import jax
    import jax.numpy as jnp
    from asva_tpu.convert.jax_to_torch import export_state_dict
    from asva_tpu.convert.torch_to_jax import unet_key_map
    from asva_tpu.training import (AnimationTrainConfig as JTC,
                                   AnimationTrainer as JTrainer)
    from asva_tpu.training import optim as joptim
    from asva_tpu_torch.training import (AnimationTrainConfig,
                                         AnimationTrainer, TrainState,
                                         build_optimizer, trainable_mask)
    from asva_tpu_torch.training.optim import apply_trainable_mask
    conf = dict(text_cond_drop_prob=0.3, audio_cond_drop_prob=0.4,
                prediction_type="epsilon")
    jtrainer = JTrainer(
        unet=world.junet, vae=world.jvae, audio_encoder=world.jaud,
        vae_params=world.params["vae"],
        audio_encoder_params=world.params["audio"],
        null_text_encoding=jnp.asarray(world.null), config=JTC(**conf))
    params = world.params["unet"]
    batch = {"videos": rng.random((2, F) + orient + (3,)).astype(np.float32),
             "mels": _x(rng, 2, 128, 204, 1),
             "text_encodings": _x(rng, 2, 7, 768)}
    key = jax.random.PRNGKey(7)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    with_grads = orient == ORIENTS[0]
    if with_grads:
        jloss, jgrads = jtrainer.make_grad_step(
            mask=joptim.trainable_mask(params))(params, jbatch, key)
    else:
        jtrainer.null_audio_encoding()      # cached outside the trace
        jloss = jax.jit(jtrainer.loss_fn)(params, jbatch, key)

    # the five draws of asva_tpu's `_loss` under `key`
    r_vae, r_t, r_noise, r_tdrop, r_adrop = jax.random.split(key, 5)
    mean, _ = jax.eval_shape(
        lambda p, x: world.jvae.apply(p, x, method=world.jvae.encode),
        world.params["vae"], batch["videos"].reshape((2 * F,) + orient + (3,)))
    draws = {"vae_noise": t(jax.random.normal(r_vae, mean.shape)),
             "t": t(jax.random.randint(r_t, (2,), 0, 1000)).long(),
             "noise": t(jax.random.normal(r_noise, (2, F) + mean.shape[1:])),
             "text_keep": t(jax.random.uniform(r_tdrop, (2, 1, 1))),
             "audio_keep": t(jax.random.uniform(r_adrop, (2, 1, 1)))}
    unet, vae, audio = port_modules(world.weights)
    unet.train()
    apply_trainable_mask(unet, trainable_mask(unet))
    trainer = AnimationTrainer(unet=unet, vae=vae, audio_encoder=audio,
                               null_text_encoding=t(world.null),
                               config=AnimationTrainConfig(**conf))
    state = TrainState(0, unet, build_optimizer(unet, 1e-3))
    loss, grads = trainer.grad_step(
        state, {k: t(v) for k, v in batch.items()}, draws=draws)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    if not with_grads:
        assert all(float(g.abs().max()) > 0 for g in grads)
        return
    want = export_state_dict(jgrads, unet_key_map)
    assert set(want) == set(state.optimizer.names)
    for name, g in zip(state.optimizer.names, grads):
        w = np.asarray(want[name])
        scale = max(1e-3, float(np.abs(w).max()))
        assert float(g.abs().max()) > 0, name
        assert float(np.abs(g.numpy() - w).max()) <= 2e-4 * scale, name


# -------------------------------------------------------- 11. train CLI ---

UNET_TINY = dict(
    down_block_types=["FFSpatioAudioTempCrossAttnDownBlock3D",
                      "FFSpatioTempResDownBlock3D"],
    up_block_types=["FFSpatioTempResUpBlock3D",
                    "FFSpatioAudioTempCrossAttnUpBlock3D"],
    mid_block_type="FFSpatioAudioTempCrossAttnUNetMidBlock3D",
    block_out_channels=[32, 64], layers_per_block=1, norm_num_groups=8,
    attention_head_dim=2, audio_cross_attention_dim=32)
GHITS_YAML = os.path.join(tp.REPO, "configs", "audio-cond_animation",
                          "thegreatesthits_audio-cond_cfg.yaml")


def ghits_yaml(root, out, orient):
    """The repository's TheGreatestHits YAML cut to the tiny size: its
    batch of 16 to 2, 12 frames to 4, the UNet tiny; the data at `root`
    (img_size `orient`, the single-tensor encoding, class_mapping_json
    ""), checkpoints every 2 steps kept as milestones, no wandb.  Its
    accumulation 1, remat, scheduler, optimizer and drop rates stay."""
    import yaml
    with open(GHITS_YAML) as f:
        raw = yaml.safe_load(f)
    raw["exp"].update(output_dir=str(out), log_with=None)
    raw["model"]["audio_encoder"]["n_segment"] = F
    raw["model"]["unet"].update(UNET_TINY)
    raw["train"].update(batch_size=2, log_steps=1)
    raw["train"]["dataset"].update(
        data_root=str(root), example_list_path=str(root / "train.txt"),
        img_size=list(orient), video_num_frame=F,
        class_text_encoding_mapping_pt=str(root / "single.pt"))
    raw["optim"].update(checkpointing_steps=2, checkpointing_milestones=2)
    path = out.parent / f"{out.name}.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


@needs_media
@pytest.mark.parametrize("orient", ORIENTS, ids=ORIENT_IDS)
def test_train_cli_ghits_yaml_resumes(ghits, tmp_path, tiny_towers, orient):
    """animation_train from the TheGreatestHits-shaped YAML: batch 2 of
    4x16x32 (or 32x16) clips, accumulation 1, the single-tensor encoding,
    3 steps writing checkpoint-2 and -3; a run resumed from checkpoint-2
    takes step 3 with the same loss, parameters and moments, bit for bit."""
    import shutil

    from asva_tpu_torch.config import AnimationJobConfig
    from asva_tpu_torch.scripts import animation_train
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    full_yaml = ghits_yaml(ghits, tmp_path / "full", orient)
    cfg = AnimationJobConfig.from_yaml(str(full_yaml))
    assert (cfg.batch_size, cfg.optim.gradient_accumulation_steps) == (2, 1)
    assert cfg.dataset.img_size == orient and cfg.unet.remat
    assert cfg.dataset.class_mapping_json == ""
    argv = ["--max_steps_override", "3", "--device", "cpu"]
    full = animation_train.main(["--config_file", str(full_yaml)] + argv)
    mgr = CheckpointManager(str(tmp_path / "full" / "ckpts"))
    assert mgr.existing_steps() == [2, 3]
    assert len(full["losses"]) == 3 and np.isfinite(full["losses"]).all()
    assert mgr.restore_extra(2)["loader"]["cursor"] == 2
    shutil.copytree(mgr._path(2),
                    tmp_path / "resumed" / "ckpts" / "checkpoint-2")
    resumed = animation_train.main(["--config_file", str(ghits_yaml(
        ghits, tmp_path / "resumed", orient))] + argv)
    assert resumed["resumed_from"] == 2 and resumed["state"].step == 3
    assert resumed["losses"] == full["losses"][2:]
    assert resumed["loader"] == full["loader"]
    want = full["state"].unet.state_dict()
    got = resumed["state"].unet.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    for kind in ("mu", "nu"):
        a = full["state"].optimizer.state_dict()[kind]
        b = resumed["state"].optimizer.state_dict()[kind]
        assert all(torch.equal(a[k], b[k]) for k in a)


# ------------------------------------------------------ 12. recipe CLIs ---

@pytest.mark.parametrize("dataset,flag,want", [
    ("TheGreatestHits", None, (128, 256)),
    ("TheGreatestHits", ["256", "128"], (256, 128)),
    ("AVSync15", None, (256, 256))], ids=["ghits", "ghits_swapped",
                                          "avsync15"])
def test_recipe_image_size_reaches_generation_and_eval(tmp_path, monkeypatch,
                                                       dataset, flag, want):
    """animation_gen and animation_eval without --image_size take the
    dataset's recipe size, (h, w) = (128, 256) for TheGreatestHits, and
    hand it to generate_videos and evaluate_generation_results as (h, w);
    an explicit --image_size keeps its order; animation_test's
    TheGreatestHits recipe passes 128 256 through both steps."""
    from asva_tpu_torch import runtime
    from asva_tpu_torch.eval.harness import EvalModels
    from asva_tpu_torch.pipelines import generate
    from asva_tpu_torch.scripts import (animation_eval, animation_gen,
                                        animation_test)
    droot = tmp_path / "datasets" / dataset
    droot.mkdir(parents=True)
    (droot / "test.txt").write_text("a/v0.mp4\n")
    seen = []
    monkeypatch.setattr(runtime, "load_animation_pipeline",
                        lambda **kw: "pipeline")
    monkeypatch.setattr(generate, "generate_videos", lambda pipe, **kw:
                        seen.append(("gen", kw["image_size"])))
    monkeypatch.setattr(animation_eval, "build_eval_models",
                        lambda args: EvalModels())
    monkeypatch.setattr(animation_eval, "evaluate_generation_results",
                        lambda *a, **kw: seen.append(("eval", a[7])) or {})
    argv = ["--exp_root", str(tmp_path / "exp"), "--checkpoint", "5",
            "--dataset", dataset, "--dataset_root",
            str(tmp_path / "datasets"), "--device", "cpu"]
    if flag:
        argv += ["--image_size"] + flag
    animation_gen.main(argv)
    animation_eval.main(argv)
    assert seen == [("gen", want), ("eval", want)]
    if dataset == "TheGreatestHits" and flag is None:
        gen_argv, eval_argv = animation_test.recipe_argvs(
            dataset, "exp", "5", "4.0")
        for a in (gen_argv, eval_argv):
            at = a.index("--image_size")
            assert a[at + 1:at + 3] == ["128", "256"]
        seen.clear()
        monkeypatch.setattr(animation_gen, "main", lambda a: seen.append(
            ("gen", tuple(animation_gen.parser().parse_args(a).image_size))))
        monkeypatch.setattr(animation_eval, "main", lambda a: seen.append(
            ("eval", tuple(animation_eval.parser().parse_args(
                a).image_size))))
        animation_test.main(["--dataset", dataset, "exp", "5", "4.0"])
        assert seen == [("gen", (128, 256)), ("eval", (128, 256))]


# --------------------------------------------------------- 13. the judge ---

@pytest.fixture(scope="module")
def judge_tree(tmp_path_factory):
    """A 4:3 ground-truth video (3 s) and its three generated 4-frame clips
    at 16x32, named as generate_videos names them."""
    root = tmp_path_factory.mktemp("judge")
    _write_clip(str(root / "gt" / "hits" / "x.mp4"), 36, (48, 64), 0)
    for k in range(3):
        _write_clip(str(root / "gen" / "hits" / f"x_clip-{k:02d}.mp4"), 8,
                    (16, 32), 10 + k)
    return str(root / "gt"), str(root / "gen"), ["hits/x.mp4"]


@needs_media
@pytest.mark.parametrize("orient", ORIENTS, ids=ORIENT_IDS)
def test_judge_rect(judge_tree, towers, tmp_path, orient):
    """The harness at image_size (16, 32) and its swap: the port's
    evaluate_generation_results (its metric step, evaluate_arrays, on the
    decoded rectangular clips; the judge's transforms resize them to 224^2
    and 229^2) against asva_tpu's on the same files and tiny towers, FID /
    FVD within 1e-4 relative, the rest 1e-5 (test_torch_scripts.py's); and
    evaluate_arrays called on the decoded arrays gives the same metrics."""
    import jax
    import jax.numpy as jnp
    from asva_tpu.eval import harness as jh
    from asva_tpu_torch.eval import harness as th
    from test_torch_media import jax_media
    from test_torch_scripts import _ids, _stub_nets
    jax_media()
    gt_root, gen_root, names = judge_tree
    (tv, jv, pv), (ta_, ja_, pa), (tt_, jt_, pt_) = (
        towers["vision"], towers["audio"], towers["text"])

    @jax.jit
    def jia(frames, mels):
        v = jv.apply(pv, frames)
        a, _ = ja_.apply(pa, mels, normalize=True)
        return jnp.sum(v * a / 20.0, axis=-1)

    @jax.jit
    def jit_sim(frames, ids):
        return jnp.sum(jv.apply(pv, frames)
                       * jt_.apply(pt_, ids.astype(jnp.int32)), axis=-1)

    jfid, jfvd, jscore = _stub_nets(jnp)
    jmodels = jh.EvalModels(
        fid_features=lambda x: jfid(jnp.asarray(x)),
        fvd_features=lambda v: jfvd(jnp.asarray(v)),
        avsync_score=lambda m, v: jscore(jnp.asarray(m), jnp.asarray(v)),
        ia_sim=jia, it_sim=jit_sim)
    tmodels = th.eval_models_from_nets("cpu", vision=tv, audio=ta_, text=tt_)
    tmodels.fid_features, tmodels.fvd_features, tmodels.avsync_score = \
        _stub_nets(torch)
    kw = dict(image_size=orient, video_fps=6, video_num_frame=F)
    want = jh.evaluate_generation_results(
        jmodels, gt_root, names, ["hits"], 3, gen_root,
        str(tmp_path / "jax.json"), text_ids_for_category=_ids, **kw)
    got = th.evaluate_generation_results(
        tmodels, gt_root, names, ["hits"], 3, gen_root,
        str(tmp_path / "port.json"),
        text_ids_for_category=lambda c: torch.from_numpy(_ids(c)),
        device="cpu", **kw)
    metrics = [k for k in want if isinstance(want[k], float)]
    assert {"FID", "FVD", "IA_mean", "IT_mean", "RelSync_mean",
            "AlignSync_mean"} <= set(metrics)
    for key in metrics:
        tol = dict(rtol=1e-4) if key in ("FID", "FVD") else dict(
            rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got[key], want[key], **tol, err_msg=key)

    gt = th.load_av_clips_uniformly(os.path.join(gt_root, names[0]), 6, F,
                                    orient, 3)
    gen = [th.load_av_clips_uniformly(path, 6, F, orient, 1) for _, path in
           th.generated_clip_paths(gen_root, "hits/x")]
    assert gt[0].shape == (3, F) + orient + (3,)
    arrays, _ = th.evaluate_arrays(
        tmodels, [gt], [(np.concatenate([v for v, _ in gen]),
                         np.concatenate([m for _, m in gen]))],
        ids=[torch.from_numpy(_ids("hits"))], device="cpu")
    assert arrays == {k: got[k] for k in arrays}


# ------------------------------------------------- 14. seq 2 on two ranks ---

def rank_main(out):
    """One rank: the request of each orientation (REQUESTS) on
    make_gen_mesh at seq 2 (2 of 4 frames a rank), latents and videos
    saved."""
    import torch.distributed as dist

    from asva_tpu_torch.parallel import make_gen_mesh, multihost
    multihost.maybe_initialize_distributed("cpu")
    rank = dist.get_rank()
    w = torch.load(os.path.join(out, "rect.pt"), weights_only=True)
    mesh = make_gen_mesh("cpu", seq=2)
    pipe = port_pipeline(w, mesh)
    res = {"coords": list(mesh.coords), "seq": mesh.size("seq")}
    for (orient, sampler), tag in zip(REQUESTS, ORIENT_IDS):
        x = {k: v.numpy() for k, v in w[tag].items()}
        broadcast = sampler == "plms"
        torch.save({"latents": _port_request(pipe, x, broadcast, sampler,
                                             False),
                    "videos": _port_request(pipe, x, broadcast, sampler)},
                   os.path.join(out, f"seq2_{tag}.{rank}.pt"))
    with open(os.path.join(out, f"ranks.{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def seq_ranks(world, tmp_path_factory):
    """Both ranks' results and one process's latents and videos of the
    same requests, computed while the ranks run."""
    out = tmp_path_factory.mktemp("rect_ranks")
    requests = {tag: world.request(*req)[0]
                for req, tag in zip(REQUESTS, ORIENT_IDS)}
    w = dict(world.weights, **{tag: {k: t(v) for k, v in x.items()}
                               for tag, x in requests.items()})
    torch.save(w, out / "rect.pt")
    started = tpg._start(out, os.path.abspath(__file__))
    pipe = port_pipeline(world.weights)
    solo = {}
    for (_, sampler), tag in zip(REQUESTS, ORIENT_IDS):
        x, broadcast = requests[tag], sampler == "plms"
        solo[tag] = {
            "latents": _port_request(pipe, x, broadcast, sampler, False),
            "videos": _port_request(pipe, x, broadcast, sampler)}
    return tpg._wait(out, started), out, solo


@pytest.mark.parametrize("orient", ORIENTS, ids=ORIENT_IDS)
def test_seq2_rect_equals_one_process_and_asva_tpu(world, seq_ranks, orient):
    """seq 2 at rectangular frames, DDIM at 16x32 and PLMS at 32x16 (the frame-0 broadcast and the previous
    frame's halo of parallel/reduce.py across the ranks): both ranks
    return the same global latents and videos; the latents within 1e-4 *
    max(1, max|ref|) of one process, the videos within 1e-4 of one process
    and of asva_tpu's unsharded pipeline with JAX's draws
    (test_torch_parallel_gen.py's)."""
    results, out, solo = seq_ranks
    tag = ORIENT_IDS[ORIENTS.index(orient)]
    for rank, res in enumerate(results):
        assert res["seq"] == 2 and res["coords"] == [0, rank]
    zero, one = (torch.load(out / f"seq2_{tag}.{r}.pt", weights_only=True)
                 for r in range(2))
    ref = solo[tag]
    for key in ("latents", "videos"):
        assert torch.equal(zero[key], one[key])
        assert zero[key].shape == ref[key].shape
    assert tuple(ref["videos"].shape) == (2, F) + orient + (3,)
    tol = 1e-4 * max(1.0, float(ref["latents"].abs().max()))
    assert float((zero["latents"] - ref["latents"]).abs().max()) <= tol
    close(zero["videos"], ref["videos"].numpy(), 1e-4)
    close(zero["videos"], world.request(*REQUESTS[ORIENTS.index(
        orient)])[2], 1e-4)


if __name__ == "__main__":
    rank_main(sys.argv[1])
