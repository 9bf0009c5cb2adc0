"""AnimationPipeline end to end: the port against asva_tpu at tiny size
on the CPU, with JAX's own noise draws handed to the port; and the port's
runtime builders."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asva_tpu.convert.torch_to_jax import (imagebind_audio_key_map,
                                           unet_key_map, vae_key_map)
from asva_tpu.models.imagebind_audio import (ImageBindAudioConfig as JAC,
                                             SegmaskAudioEncoder as JAE)
from asva_tpu.models.unet3d import AudioUNet3D as JU, UNet3DConfig as JC
from asva_tpu.models.vae import AutoencoderKL as JV, VAEConfig as JVC
from asva_tpu.pipelines.animation import AnimationPipeline as JP
from asva_tpu_torch import runtime
from asva_tpu_torch.models.imagebind_audio import (ImageBindAudioConfig as TAC,
                                                   SegmaskAudioEncoder as TAE)
from asva_tpu_torch.models.unet3d import AudioUNet3D as TU, UNet3DConfig as TC
from asva_tpu_torch.models.vae import AutoencoderKL as TV, VAEConfig as TVC
from asva_tpu_torch.pipelines.animation import AnimationPipeline as TP

from test_torch_ops import close, port, randomize, t

torch.set_num_threads(1)
F = 4  # video length


@pytest.fixture(scope="module")
def pipelines():
    rng = np.random.default_rng(11)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    unet, vae, aud = JU(JC.tiny()), JV(JVC.tiny()), JAE(JAC.tiny(), n_segment=F)
    # jit: one compiled init instead of thousands of eager init ops
    up = randomize(jax.jit(unet.init)(
        k1, jnp.zeros((1, F, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 7, 768)), jnp.zeros((1, 229, 32)),
        jnp.ones((1, F, 229), bool)), rng)
    vp = randomize(jax.jit(vae.init)(k2, jnp.zeros((1, 16, 16, 3)), k2), rng)
    ap = randomize(jax.jit(aud.init)(k3, jnp.zeros((1, 128, 204, 1))), rng)
    null_text = rng.standard_normal((1, 7, 768)).astype(np.float32)
    jpipe = JP(unet=unet, vae=vae, audio_encoder=aud, unet_params=up,
               vae_params=vp, audio_encoder_params=ap,
               null_text_encoding=jnp.asarray(null_text))
    tpipe = TP(port(TU(TC.tiny(audio_cross_attention_dim=32)), up),
               port(TV(TVC.tiny()), vp, vae_key_map),
               port(TAE(TAC.tiny(), n_segment=F), ap,
                    imagebind_audio_key_map),
               null_text_encoding=t(null_text))
    return jpipe, tpipe


def _jax_draws(jpipe, images, seed, broadcast):
    """The two noise tensors JAX's __call__ draws from PRNGKey(seed)."""
    rng_vae, rng_noise = jax.random.split(jax.random.PRNGKey(seed))
    mean, _ = jpipe.vae.apply(jpipe.vae_params, jnp.asarray(images),
                              method=jpipe.vae.encode)
    nb = 1 if broadcast else images.shape[0]
    vae_noise = jax.random.normal(rng_vae, (nb,) + mean.shape[1:])
    latent_noise = jax.random.normal(rng_noise, (nb, F - 1) + mean.shape[1:])
    return t(vae_noise), t(latent_noise)


@pytest.mark.parametrize("sampler,tg,ag,broadcast", [
    ("ddim", 1.0, 4.0, False),   # k = 2 (audio CFG)
    ("ddim", 7.5, 4.0, False),   # k = 3 (dual CFG)
    ("ddim", 1.0, 1.0, True),    # k = 1, broadcast_rng
])
def test_pipeline_matches_jax(pipelines, rng, sampler, tg, ag, broadcast):
    """Three DDIM steps, decode on: videos agree to 1e-4 (fp32, values in
    [0, 1]); frame 0's latent is the pinned image latent."""
    jpipe, tpipe = pipelines
    images = rng.random((2, 16, 16, 3)).astype(np.float32)
    mels = rng.standard_normal((2, 128, 204, 1)).astype(np.float32)
    text = rng.standard_normal((2, 7, 768)).astype(np.float32)
    kw = dict(video_length=F, num_inference_steps=3, sampler=sampler,
              text_guidance_scale=tg, audio_guidance_scale=ag)
    want = jpipe(jnp.asarray(images), jnp.asarray(mels), jnp.asarray(text),
                 rng=jax.random.PRNGKey(5), broadcast_rng=broadcast, **kw)
    vae_noise, latent_noise = _jax_draws(jpipe, images * 2 - 1, 5, broadcast)
    got = tpipe(t(images), t(mels), t(text), vae_noise=vae_noise,
                latent_noise=latent_noise, broadcast_rng=broadcast, **kw)
    assert got.shape == (2, F, 16, 16, 3)
    close(got, want, 1e-4)
    lat = tpipe(t(images), t(mels), t(text), vae_noise=vae_noise,
                latent_noise=latent_noise, decode=False,
                broadcast_rng=broadcast, **kw)
    pinned = tpipe.encode_image(t(images), noise=vae_noise)
    assert torch.equal(lat[:, 0], pinned)


def test_pipeline_plms_generator_draws(pipelines, rng):
    """PLMS with the port's own torch.Generator draws: finite, in [0, 1],
    and the same seed gives the same video."""
    _, tpipe = pipelines
    images = t(rng.random((1, 16, 16, 3)).astype(np.float32))
    wave = rng.standard_normal((1, 32000)).astype(np.float32) * 0.1
    mels = tpipe.encode_audio_waveform([wave])
    text = t(rng.standard_normal((1, 7, 768)).astype(np.float32))
    runs = [tpipe(images, mels, text, video_length=F, num_inference_steps=3,
                  sampler="plms", text_guidance_scale=7.5,
                  generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    v = runs[0].numpy()
    assert v.shape == (1, F, 16, 16, 3)
    assert np.isfinite(v).all() and v.min() >= 0.0 and v.max() <= 1.0
    assert torch.equal(runs[0], runs[1])


def test_null_audio_encoding_is_cached(pipelines):
    _, tpipe = pipelines
    assert tpipe.null_audio_encoding() is tpipe.null_audio_encoding()


def test_runtime_builders_and_modules_config(tmp_path):
    """load_animation_pipeline reads modules_config.json for the UNet and
    audio architectures and builds seeded, reproducible random weights."""
    mods = tmp_path / "checkpoint-1" / "modules"
    mods.mkdir(parents=True)
    cfg = {"unet": {"block_out_channels": [32, 64], "layers_per_block": 1,
                    "down_block_types": list(TC.tiny().down_block_types),
                    "up_block_types": list(TC.tiny().up_block_types),
                    "norm_num_groups": 8, "attention_head_dim": 2,
                    "audio_cross_attention_dim": 32, "unknown_key": 1},
           "audio_encoder": {"embed_dim": 32, "out_embed_dim": 16,
                             "num_blocks": 2, "num_heads": 2}}
    (tmp_path / "checkpoint-1" / "modules_config.json").write_text(
        json.dumps(cfg))
    kw = dict(checkpoint_modules_dir=str(mods), n_segment=F, device="cpu",
              dtype=torch.float32, vae_config=TVC.tiny(), seed=4,
              null_text_encoding=torch.zeros(1, 7, 768))
    pipe = runtime.load_animation_pipeline(**kw)
    assert pipe.unet.config.block_out_channels == (32, 64)
    again = runtime.load_animation_pipeline(**kw)
    for a, b in zip(pipe.unet.parameters(), again.unet.parameters()):
        assert torch.equal(a, b)
    assert not pipe.unet.conv_in.conv_temp.weight.any()   # zero init kept
    rand = runtime.load_animation_pipeline(**kw, randomize_all=True)
    assert rand.unet.conv_in.conv_temp.weight.abs().min() > 0
    out = rand(torch.rand(1, 16, 16, 3), torch.zeros(1, 128, 204, 1),
               torch.randn(1, 7, 768), video_length=F, num_inference_steps=2,
               sampler="ddim", generator=torch.Generator().manual_seed(0))
    assert out.shape == (1, F, 16, 16, 3) and torch.isfinite(out).all()
