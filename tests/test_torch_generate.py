"""The file-reading side of generation and evaluation against asva_tpu on
the CPU: `load_image`, `load_audio_clips_uniformly` (mono and stereo wav at
16 and 44.1 kHz, one clip from the centre and three spread by linspace,
short audio padded with zeros, an mp4 source), `load_av_clips_uniformly`
of both the pipeline and the eval harness, `load_text_encoding_mapping`,
and the mel provenance label.  Equal where no resampling happens, within
1e-6 where it does (two implementations of one polyphase filter), mels
within test_torch_ops.py's 1e-3."""
import numpy as np
import pytest
import torch

from asva_tpu.data.datasets import load_text_encoding_mapping as jload_enc
from asva_tpu.eval import harness as jh
from asva_tpu.ops import mel as jmel
from asva_tpu.pipelines import generate as jg
from asva_tpu_torch.data import media
from asva_tpu_torch.data.datasets import load_text_encoding_mapping
from asva_tpu_torch.eval import harness as th
from asva_tpu_torch.ops import mel as tmel
from asva_tpu_torch.pipelines import generate as tg
from test_torch_media import jax_media

torch.set_num_threads(1)

needs_media = pytest.mark.skipif(not media.headers_available(),
                                 reason="libav development files missing")


def _write_wav(path, sr, channels, seconds, kind):
    from scipy.io import wavfile
    n = int(seconds * sr)
    t = np.arange(n) / sr
    waves = [0.5 * np.sin(2 * np.pi * (300 + 170 * c) * t + c)
             for c in range(channels)]
    data = np.stack(waves, -1) if channels > 1 else waves[0]
    if kind == "int16":
        data = (data * 32767).astype(np.int16)
    else:
        data = data.astype(np.float32)
    wavfile.write(path, sr, data)
    return path


def test_load_image(tmp_path, rng):
    """A non-square PNG: trimmed to the target aspect, resized."""
    from PIL import Image
    path = str(tmp_path / "img.png")
    Image.fromarray((rng.random((40, 56, 3)) * 255).astype(np.uint8)).save(
        path)
    got = tg.load_image(path, (16, 24))
    assert got.shape == (16, 24, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, jg.load_image(path, (16, 24)), atol=1e-6)


@pytest.mark.parametrize("sr,channels,kind", [(16000, 1, "float32"),
                                              (16000, 2, "int16"),
                                              (44100, 1, "int16"),
                                              (44100, 2, "int16")])
@pytest.mark.parametrize("num_clips", [1, 3])
def test_load_audio_clips_uniformly_wav(tmp_path, sr, channels, kind,
                                        num_clips):
    """Channels are kept; clip starts at the centre (one clip) or on
    linspace(0, duration - clip, n)."""
    path = _write_wav(str(tmp_path / "a.wav"), sr, channels, 2.3, kind)
    got = tg.load_audio_clips_uniformly(path, 2 / 3, num_clips)
    want = jg.load_audio_clips_uniformly(path, 2 / 3, num_clips)
    assert len(got) == num_clips
    for g, w in zip(got, want):
        assert g.shape == (channels, 10666) and g.dtype == np.float32
        if sr == 16000:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-6)


def test_load_audio_clips_short_audio_is_zero_padded(tmp_path):
    """0.5 s of audio for 2 s clips: each clip ends in zeros."""
    path = _write_wav(str(tmp_path / "s.wav"), 44100, 2, 0.5, "int16")
    got = tg.load_audio_clips_uniformly(path, 2.0, 3)
    want = jg.load_audio_clips_uniformly(path, 2.0, 3)
    for g, w in zip(got, want):
        assert g.shape == (2, 32000) and not g[:, 8000:].any()
        np.testing.assert_allclose(g, w, atol=1e-6)


@pytest.fixture(scope="module")
def av_file(tmp_path_factory):
    """3 s mp4, 12 fps, 40x56 frames, stereo 44.1 kHz AAC, written by the
    port's writer."""
    path = str(tmp_path_factory.mktemp("av") / "v.mp4")
    rng = np.random.default_rng(3)
    frames = (rng.random((36, 40, 56, 3)) * 255).astype(np.uint8)
    t = np.arange(3 * 44100) / 44100
    audio = np.stack([0.3 * np.sin(2 * np.pi * 220 * t),
                      0.3 * np.sin(2 * np.pi * 330 * t)]).astype(np.float32)
    media.write_video(path, frames, 12.0, audio, 44100)
    return path


@needs_media
@pytest.mark.parametrize("num_clips", [1, 3])
def test_load_audio_clips_from_mp4(av_file, num_clips):
    jax_media()
    got = tg.load_audio_clips_uniformly(av_file, 2.0, num_clips)
    want = jg.load_audio_clips_uniformly(av_file, 2.0, num_clips)
    for g, w in zip(got, want):
        assert g.shape == (2, 32000)
        np.testing.assert_allclose(g, w, atol=1e-6)


@needs_media
def test_load_av_clips_uniformly(av_file):
    """The pipeline's loader (frames in [0, 1] and padded waveforms) and the
    harness's (the same frames and their mels)."""
    jax_media()
    videos, waves = tg.load_av_clips_uniformly(av_file, 6, 4, (16, 24), 3)
    jvideos, jwaves = jg.load_av_clips_uniformly(av_file, 6, 4, (16, 24), 3)
    assert videos.shape == (3, 4, 16, 24, 3)
    np.testing.assert_allclose(videos, jvideos, atol=1e-6)
    for w, j in zip(waves, jwaves):
        assert w.shape == (2, 10666)
        np.testing.assert_allclose(w, j, atol=1e-6)
    hv, hm = th.load_av_clips_uniformly(av_file, 6, 4, (16, 24), 1)
    jv, jm = jh.load_av_clips_uniformly(av_file, 6, 4, (16, 24), 1)
    np.testing.assert_allclose(hv, jv, atol=1e-6)
    assert hm.shape == (1, 128, 204, 1)
    np.testing.assert_allclose(hm, jm, atol=1e-3)


@pytest.mark.parametrize("suffix", [".npz", ".pt", "_single.pt"])
def test_load_text_encoding_mapping(tmp_path, rng, suffix):
    enc = {"dog": rng.standard_normal((77, 768)).astype(np.float32),
           "cat": rng.standard_normal((77, 768)).astype(np.float32)}
    path = str(tmp_path / f"enc{suffix}")
    if suffix == ".npz":
        np.savez(path, **enc)
    elif suffix == ".pt":
        torch.save({k: torch.from_numpy(v) for k, v in enc.items()}, path)
    else:
        torch.save(torch.from_numpy(enc["dog"]), path)
    got, want = load_text_encoding_mapping(path), jload_enc(path)
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(got, want)


def test_goldens_status_matches_jax(tmp_path, monkeypatch):
    """The same label as asva_tpu's, with the fixture absent and with a
    recorded one (the port's own fbank output as the goldens)."""
    assert tmel.goldens_status() == jmel.goldens_status()
    sr, waves = tmel.golden_waveforms()
    _, jwaves = jmel.golden_waveforms()
    for k in waves:
        np.testing.assert_array_equal(waves[k], jwaves[k])
    path = str(tmp_path / "goldens.npz")
    np.savez(path, **{k: tmel.fbank(torch.from_numpy(w), sr).numpy()
                      for k, w in waves.items()})
    monkeypatch.setenv("ASVA_MEL_GOLDENS", path)
    tmel.goldens_status.cache_clear()
    try:
        assert tmel.goldens_status() == "verified vs torchaudio goldens"
    finally:
        tmel.goldens_status.cache_clear()
