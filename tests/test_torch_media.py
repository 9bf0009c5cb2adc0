"""The port's media layer (asva_tpu_torch/data/media.py over its own copy of
media_io.cc) against asva_tpu's on the CPU: clips written by either
package's writer decode to the same uint8 frames and float32 samples through
either reader, off-grid starts and seeks that need a keyframe preroll
included; the library build is atomic and fails loudly.

Skips only where the libav development files are missing (the port's own
pkg-config condition); where they exist, a failed build fails the tests."""
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from asva_tpu_torch.data import media

pytestmark = pytest.mark.skipif(not media.headers_available(),
                                reason="libav development files missing "
                                       "(pkg-config --exists fails)")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, H, W, FPS = 36, 48, 64, 12.0


def jax_media():
    """asva_tpu's media module, its library loaded.  Its lazy `make` links
    straight onto the final file name, so a process that looks while another
    builds sees a partial library: wait for that build to finish."""
    from asva_tpu.data.media import reader
    for _ in range(40):
        if reader._load() is not None:
            return reader
        time.sleep(0.5)
    pytest.fail("asva_tpu's libasva_media.so did not load")


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """The same 3 s clip (12 fps, 48x64, a moving gradient so that frames
    differ; stereo 16 kHz tones) written once by each package."""
    root = tmp_path_factory.mktemp("media")
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[0:H, 0:W]
    frames = np.stack([
        np.stack([(xx * 3 + i * 7) % 256, (yy * 5 + i * 3) % 256,
                  np.full_like(xx, 20 + i * 6)], -1)
        for i in range(N)]).astype(np.uint8)
    t = np.arange(int(N / FPS * 16000)) / 16000
    audio = np.stack([0.4 * np.sin(2 * np.pi * 440 * t),
                      0.2 * np.sin(2 * np.pi * 660 * t)
                      + 0.01 * rng.standard_normal(t.shape)]).astype(
                          np.float32)
    paths = {}
    for name, write in (("port", media.write_video),
                        ("jax", jax_media().write_video)):
        paths[name] = str(root / f"{name}.mp4")
        write(paths[name], frames, FPS, audio, 16000)
    return paths


# (start, duration, fps, num_frames): on the frame grid; off it; a seek far
# from the first keyframe (preroll decode); one running past the end (pads)
READS = [(0.0, 1.0, 6.0, 6), (0.37, 1.0, 6.0, 6), (1.9, 0.5, 12.0, 6),
         (2.5, 1.0, 6.0, 6)]


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("read", READS, ids=["grid", "off_grid", "preroll",
                                             "past_end"])
def test_readers_bit_equal(clips, writer, read):
    """Both readers on one file: the same metadata, bit-equal frames and
    audio samples."""
    ref = jax_media()
    start, duration, fps, n = read
    with media.MediaReader(clips[writer]) as r, \
            ref.MediaReader(clips[writer]) as j:
        assert (r.size, r.video_fps, r.video_duration, r.audio_duration,
                r.audio_sample_rate, r.audio_channels) == (
            j.size, j.video_fps, j.video_duration, j.audio_duration,
            j.audio_sample_rate, j.audio_channels)
        got = r.read_video_clip(start, duration, fps, n)
        want = j.read_video_clip(start, duration, fps, n)
        assert got.dtype == np.uint8 and got.shape == (n, H, W, 3)
        np.testing.assert_array_equal(got, want)
        a, b = r.read_audio(start, duration), j.read_audio(start, duration)
        assert a.dtype == np.float32 and a.shape[0] == 2
        np.testing.assert_array_equal(a, b)


def test_writers_agree(clips):
    """The two writers' files decode to the same frames and samples."""
    with media.MediaReader(clips["port"]) as a, \
            media.MediaReader(clips["jax"]) as b:
        np.testing.assert_array_equal(a.read_video_clip(0.0, 3.0, FPS, N),
                                      b.read_video_clip(0.0, 3.0, FPS, N))
        np.testing.assert_array_equal(a.read_audio(0.0, 3.0),
                                      b.read_audio(0.0, 3.0))


def test_build_is_atomic(tmp_path):
    """Two processes build into one empty build directory at once: both
    load the library (one links under the lock, the other waits for it) and
    no temporary file is left behind."""
    code = ("from asva_tpu_torch.data import media; "
            "assert media.media_available(); "
            "print(media.library()._name)")
    env = dict(os.environ, ASVA_TORCH_BUILD_DIR=str(tmp_path),
               PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, "-c", code], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    paths = {o.strip() for o, _ in outs}
    assert len(paths) == 1
    assert sorted(os.listdir(tmp_path)) == sorted(
        [os.path.basename(paths.pop()), "media.lock"])


def test_build_failure_raises(tmp_path, monkeypatch):
    """With the headers present, a source that does not compile raises
    with g++'s message, and media_available() raises too: it never turns a
    failed build into False."""
    bad = tmp_path / "media_io.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(media, "SOURCE", str(bad))
    monkeypatch.setenv("ASVA_TORCH_BUILD_DIR", str(tmp_path / "build"))
    media.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            media.build()
        with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
            media.media_available()
        assert not [f for f in os.listdir(tmp_path / "build")
                    if f.endswith(".tmp")]
    finally:
        media.library.cache_clear()


def test_without_headers(monkeypatch, tmp_path):
    """Where pkg-config finds no libav: media_available() is False, the
    reader and writer raise, and generate_videos refuses a save_template
    before it runs the pipeline."""
    from asva_tpu_torch.pipelines.generate import generate_videos
    monkeypatch.setattr(media, "headers_available", lambda: False)
    monkeypatch.setenv("ASVA_TORCH_BUILD_DIR", str(tmp_path))
    media.library.cache_clear()
    try:
        assert media.media_available() is False
        with pytest.raises(RuntimeError, match="libav"):
            media.MediaReader(str(tmp_path / "x.mp4"))
        with pytest.raises(RuntimeError, match="libav"):
            media.write_video(str(tmp_path / "x.mp4"),
                              np.zeros((1, 16, 16, 3), np.uint8), 6.0)

        class NeverCalled:
            device = "cpu"

            def __call__(self, *a, **k):
                raise AssertionError("the pipeline ran")
        with pytest.raises(RuntimeError, match="save_template"):
            generate_videos(NeverCalled(), save_template=str(tmp_path / "g"))
    finally:
        media.library.cache_clear()
