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


# ------------------------------------------------------ generate_videos ---

class _Recorded:
    """A pipeline whose float videos are kept; for the port's, the noise
    draws are JAX's (shared by the clips, as broadcast_rng shares them)."""

    def __init__(self, pipe, noise=None):
        self.pipe, self.noise, self.videos = pipe, noise, []

    @property
    def device(self):
        return self.pipe.device

    def __call__(self, *args, generator=None, **kw):
        if self.noise is not None:
            kw.update(vae_noise=self.noise[0], latent_noise=self.noise[1])
        out = self.pipe(*args, **kw)
        self.videos.append(np.asarray(out))
        return out


@pytest.fixture(scope="module")
def cond_files(tmp_path_factory):
    """A 20x24 PNG and 2.5 s of stereo 44.1 kHz int16 wav."""
    from PIL import Image
    from scipy.io import wavfile
    root = tmp_path_factory.mktemp("cond")
    rng = np.random.default_rng(12)
    Image.fromarray((rng.random((20, 24, 3)) * 255).astype(np.uint8)).save(
        root / "cond.png")
    s = np.arange(int(2.5 * 44100)) / 44100
    wave = np.stack([0.5 * np.sin(2 * np.pi * 440 * s),
                     0.3 * np.sin(2 * np.pi * 97 * s)], -1)
    wavfile.write(root / "cond.wav", 44100, (wave * 32767).astype(np.int16))
    return str(root / "cond.png"), str(root / "cond.wav")


GEN_KW = dict(image_size=(16, 16), video_fps=6, video_num_frame=F,
              num_clips_per_video=2, num_inference_steps=3, sampler="ddim",
              audio_guidance_scale=4.0, text_guidance_scale=1.0, seed=5)


def _port_noise(jpipe, image_path):
    from asva_tpu.pipelines.generate import load_image
    image = load_image(image_path, GEN_KW["image_size"])[None]
    return _jax_draws(jpipe, image * 2 - 1, GEN_KW["seed"], True)


def test_generate_videos_matches_jax(pipelines, cond_files, rng):
    """PNG + stereo 44.1 kHz wav -> two clips in one batched call: the float
    videos within 1e-4 of asva_tpu's generate_videos, the uint8 frames (a
    truncating cast) within one level, the audio the same."""
    from asva_tpu.pipelines.generate import generate_videos as jgen
    from asva_tpu_torch.pipelines.generate import generate_videos as tgen
    jpipe, tpipe = pipelines
    enc = rng.standard_normal((77, 768)).astype(np.float32)
    jrec = _Recorded(jpipe)
    want = jgen(jrec, *cond_files, category_text_encoding=enc, **GEN_KW)
    trec = _Recorded(tpipe, _port_noise(jpipe, cond_files[0]))
    got = tgen(trec, *cond_files, category_text_encoding=enc, **GEN_KW)
    assert len(got) == len(want) == 2
    close(trec.videos[0], jrec.videos[0], 1e-4)
    for (gf, ga), (wf, wa) in zip(got, want):
        assert gf.shape == (F, 16, 16, 3) and gf.dtype == np.uint8
        assert np.abs(gf.astype(int) - wf.astype(int)).max() <= 1
        assert ga.shape == (2, 10666)
        np.testing.assert_allclose(ga, wa, atol=1e-6)


def test_generate_videos_batched_equals_per_clip(pipelines, cond_files):
    """One batched call with broadcast_rng and the per-clip loop, each clip
    with the same draws: the same frames, bit for bit on the CPU.  Without a
    text encoding the zeros context is used (with a warning) in both."""
    from asva_tpu_torch.pipelines.generate import generate_videos as tgen
    jpipe, tpipe = pipelines
    noise = _port_noise(jpipe, cond_files[0])
    batched = tgen(_Recorded(tpipe, noise), *cond_files, **GEN_KW)
    per_clip = tgen(_Recorded(tpipe, noise), *cond_files, batch_clips=False,
                    **GEN_KW)
    for (bf, ba), (pf, pa) in zip(batched, per_clip):
        np.testing.assert_array_equal(bf, pf)
        np.testing.assert_array_equal(ba, pa)


def test_generate_videos_own_draws_and_mp4(pipelines, cond_files, tmp_path):
    """The port's own generator draws: a seed gives the same clips twice;
    with a save_template the clips are written as <template>_clip-kk.mp4
    (16 kHz audio) and nothing is returned."""
    from asva_tpu_torch.data import media
    from asva_tpu_torch.pipelines.generate import generate_videos as tgen
    _, tpipe = pipelines
    runs = [tgen(tpipe, *cond_files, **GEN_KW) for _ in range(2)]
    for (a, _), (b, _) in zip(*runs):
        np.testing.assert_array_equal(a, b)
    if not media.headers_available():
        return
    tmpl = str(tmp_path / "out" / "gen")
    assert tgen(tpipe, *cond_files, save_template=tmpl, **GEN_KW) is None
    for k, (frames, _) in enumerate(runs[0]):
        with media.MediaReader(f"{tmpl}_clip-{k:02d}.mp4") as r:
            assert r.size == (16, 16) and r.audio_sample_rate == 16000
            clip = r.read_video_clip(0, F / 6, 6, F)
        assert clip.shape == frames.shape
