"""Parity of the port's VAE and ImageBind audio tower against asva_tpu on
the CPU (tiny configs, fp32), and the strict key-space load."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asva_tpu.convert.torch_to_jax import imagebind_audio_key_map, vae_key_map
from asva_tpu.models import imagebind_audio as ja
from asva_tpu.models import vae as jv
from asva_tpu_torch.convert import load_exported
from asva_tpu_torch.models import imagebind_audio as ta
from asva_tpu_torch.models import vae as tv

from test_torch_ops import close, port, randomize, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def vae_pair():
    rng = np.random.default_rng(3)
    jm = jv.AutoencoderKL(jv.VAEConfig.tiny())
    img = rng.random((2, 16, 16, 3)).astype(np.float32)
    # jit: one compiled init instead of hundreds of eager init ops
    p = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), img,
                                   jax.random.PRNGKey(1)), rng)
    return jm, p, port(tv.AutoencoderKL(tv.VAEConfig.tiny()), p, vae_key_map)


def test_vae_encode(vae_pair, rng):
    """mean and clipped logvar after quant_conv (a 1x1 conv here), 3e-5."""
    jm, p, tm = vae_pair
    img = (rng.random((2, 16, 24, 3)) * 2 - 1).astype(np.float32)
    jmean, jlogvar = jm.apply(p, img, method=jm.encode)
    with torch.no_grad():
        mean, logvar = tm.encode(t(img))
    assert mean.shape == (2, 8, 12, 4)
    close(mean, jmean, 3e-5)
    close(logvar, jlogvar, 3e-5)


def test_vae_decode(vae_pair, rng):
    """Decoder with nearest-up + conv upsampling, 5e-5."""
    jm, p, tm = vae_pair
    z = rng.standard_normal((2, 8, 12, 4)).astype(np.float32)
    with torch.no_grad():
        got = tm.decode(t(z))
    assert got.shape == (2, 16, 24, 3)
    close(got, jm.apply(p, z, method=jm.decode), 5e-5)


def test_vae_sample_latents_with_jax_noise(vae_pair, rng):
    """sample_latents = (mean + std * noise) * scaling_factor, with JAX's
    own draw handed to the port, 3e-5."""
    jm, p, tm = vae_pair
    img = rng.random((2, 16, 16, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    want = jm.apply(p, img, key, method=jm.sample_latents)
    noise = jax.random.normal(key, (2, 8, 8, 4), jnp.float32)
    with torch.no_grad():
        got = tm.sample_latents(t(img), t(noise))
    assert tm.scaling_factor == jm.config.scaling_factor
    close(got, want, 3e-5)


def test_load_exported_is_strict(vae_pair):
    from asva_tpu.convert.jax_to_torch import export_state_dict
    _, p, _ = vae_pair
    state = export_state_dict(p, vae_key_map)
    state.pop("decoder.conv_out.bias")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_exported(tv.AutoencoderKL(tv.VAEConfig.tiny()), state)


def test_builders_load_reference_directories_like_asva_tpu(vae_pair, rng,
                                                           tmp_path):
    """Reference-layout directories written from JAX parameters: the port's
    build_vae(weights_dir=...) holds the file's tensors (as (o, i, 1, 1)
    where the file's 1x1 convolutions are (o, i)); asva_tpu's
    build_audio_encoder and the port's on the same directory compute the
    same function at a tiny config, 1e-4 max(1, |ref|)."""
    from asva_tpu import runtime as jrt
    from asva_tpu.convert.jax_to_torch import export_state_dict
    from asva_tpu_torch import runtime
    _, p, _ = vae_pair
    state = export_state_dict(p, vae_key_map, to_torch=True)
    (tmp_path / "vae").mkdir()
    torch.save(state, str(tmp_path / "vae" / "diffusion_pytorch_model.bin"))
    got = runtime.build_vae(tv.VAEConfig.tiny(), device="cpu",
                            dtype=torch.float32,
                            weights_dir=str(tmp_path / "vae")).state_dict()
    assert set(got) == set(state)
    for k, v in state.items():
        assert torch.equal(got[k], v.reshape(got[k].shape)), k

    _, ap = jrt.build_audio_encoder(4, jnp.float32,
                                    config=ja.ImageBindAudioConfig.tiny())
    ap = randomize(ap, rng)
    (tmp_path / "audio").mkdir()
    torch.save(export_state_dict(ap, imagebind_audio_key_map, to_torch=True),
               str(tmp_path / "audio" / "pytorch_model.bin"))
    jm, jp = jrt.build_audio_encoder(4, jnp.float32, str(tmp_path / "audio"),
                                     config=ja.ImageBindAudioConfig.tiny())
    tm = runtime.build_audio_encoder(4, ta.ImageBindAudioConfig.tiny(),
                                     device="cpu", dtype=torch.float32,
                                     weights_dir=str(tmp_path / "audio"))
    mel = rng.standard_normal((1, 128, 204, 1)).astype(np.float32)
    want = jax.jit(jm.apply)(jp, mel)
    with torch.no_grad():
        got = tm(t(mel))
    for a, b in zip(got[:2], want[:2]):
        close(a, b, 1e-4 * max(1.0, float(np.abs(np.asarray(b)).max())))


@pytest.mark.parametrize("normalize", [False, True])
def test_segmask_audio_encoder(rng, normalize):
    """Tiny ImageBind audio tower with bias_k/v, final LayerNorm and the
    segment masks: cls embeds and token encodings, 5e-5."""
    cfg_j, cfg_t = ja.ImageBindAudioConfig.tiny(), ta.ImageBindAudioConfig.tiny()
    jm = ja.SegmaskAudioEncoder(cfg_j, n_segment=4)
    mel = rng.standard_normal((2, 128, 204, 1)).astype(np.float32)
    p = randomize(jm.init(jax.random.PRNGKey(0), mel), rng)
    jcls, jenc, jmask = jm.apply(p, mel, normalize)
    tm = port(ta.SegmaskAudioEncoder(cfg_t, n_segment=4), p,
              imagebind_audio_key_map)
    with torch.no_grad():
        tcls, tenc, tmask = tm(t(mel), normalize)
    close(tcls, jcls, 5e-5)
    close(tenc, jenc, 5e-5)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


@pytest.mark.parametrize("n", [4, 12])
def test_segment_masks_and_indices(n):
    np.testing.assert_array_equal(ta.segment_masks(n, (12, 19)),
                                  ja.segment_masks(n, (12, 19)))
    np.testing.assert_array_equal(ta.segment_token_indices(n, (12, 19)),
                                  ja.segment_token_indices(n, (12, 19)))
