"""ctypes binding for the port's C++ media layer (`csrc/media_io.cc`).

Port of asva_tpu/data/media/reader.py: the same ten C entry points,
`MediaReader`, `write_video` and `media_available`.  The library is built
at first use with g++ (the flags of asva_tpu/data/media/Makefile and
pkg-config's libav libraries) into the port's build directory
(`ops/cuda_build.build_dir()`, git-ignored), under a file lock, linked to a
temporary name and renamed into place: concurrent processes never load a
half-written library.  Its file name carries a hash of the source and the
flags, so an edited source is rebuilt.

`media_available()` is False only where the libav development files are
missing (`pkg-config --exists` fails); where they exist and the build
fails, the build raises.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import numpy as np

from ..ops.cuda_build import CSRC, build_dir

SOURCE = os.path.join(CSRC, "media_io.cc")
PKG_MODULES = ("libavformat", "libavcodec", "libswscale", "libswresample",
               "libavutil")
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-Wall")


@functools.cache
def headers_available() -> bool:
    """True where pkg-config finds the libav development files."""
    if shutil.which("pkg-config") is None:
        return False
    proc = subprocess.run(["pkg-config", "--exists", *PKG_MODULES])
    return proc.returncode == 0


def _pkg_config(flag: str) -> list:
    return subprocess.run(["pkg-config", flag, *PKG_MODULES], check=True,
                          capture_output=True, text=True).stdout.split()


def _lib_path(cflags, libs) -> str:
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read())
    digest.update(" ".join((*CXX_FLAGS, *cflags, *libs)).encode())
    return os.path.join(build_dir(),
                        f"libasva_media_{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the library unless it is built; returns its path.  Raises
    RuntimeError when the libav files are missing or g++ fails."""
    if not headers_available():
        raise RuntimeError(
            "the libav development files are missing (pkg-config --exists "
            + " ".join(PKG_MODULES) + " fails): the media layer cannot be "
            "built")
    cflags, libs = _pkg_config("--cflags"), _pkg_config("--libs")
    path = _lib_path(cflags, libs)
    if os.path.isfile(path):
        return path
    os.makedirs(build_dir(), exist_ok=True)
    with open(os.path.join(build_dir(), "media.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.isfile(path):          # built while we waited
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [os.environ.get("CXX", "g++"), *CXX_FLAGS, *cflags, "-shared",
             "-o", tmp, SOURCE, *libs], capture_output=True, text=True)
        if proc.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed to build {SOURCE} (exit "
                               f"{proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, path)
    return path


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded media library (built first if missing)."""
    lib = ctypes.CDLL(build())
    lib.mr_open.restype = ctypes.c_void_p
    lib.mr_open.argtypes = [ctypes.c_char_p]
    lib.mr_close.argtypes = [ctypes.c_void_p]
    for name in ("mr_width", "mr_height", "mr_audio_sample_rate",
                 "mr_audio_channels"):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("mr_video_fps", "mr_video_duration", "mr_audio_duration"):
        getattr(lib, name).restype = ctypes.c_double
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.mr_read_video_clip.restype = ctypes.c_int
    lib.mr_read_video_clip.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte)]
    lib.mr_read_audio.restype = ctypes.c_long
    lib.mr_read_audio.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long]
    lib.mw_write_video.restype = ctypes.c_int
    lib.mw_write_video.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.POINTER(ctypes.c_float), ctypes.c_long, ctypes.c_int,
        ctypes.c_int]
    return lib


def media_available() -> bool:
    """False where the libav files are missing; else builds and loads the
    library (raising if that fails) and returns True."""
    if not headers_available():
        return False
    library()
    return True


class MediaReader:
    """Video/audio clip reader with the reference's pts-sampling semantics."""

    def __init__(self, path: str):
        self._lib = library()
        self._h = self._lib.mr_open(path.encode())
        if not self._h:
            raise IOError(f"cannot open {path}")
        self.path = path

    def close(self):
        if self._h:
            self._lib.mr_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- metadata --
    @property
    def video_duration(self) -> float:
        return self._lib.mr_video_duration(self._h)

    @property
    def video_fps(self) -> float:
        return self._lib.mr_video_fps(self._h)

    @property
    def size(self) -> Tuple[int, int]:
        return (self._lib.mr_height(self._h), self._lib.mr_width(self._h))

    @property
    def audio_duration(self) -> float:
        return self._lib.mr_audio_duration(self._h)

    @property
    def audio_sample_rate(self) -> int:
        return self._lib.mr_audio_sample_rate(self._h)

    @property
    def audio_channels(self) -> int:
        return self._lib.mr_audio_channels(self._h)

    # -- decode --
    def read_video_clip(self, start: float, duration: float, fps: float,
                        num_frames: int) -> np.ndarray:
        """(num_frames, H, W, 3) uint8; short reads padded with the last
        frame (reference avgen/data/utils.py:219-222)."""
        h, w = self.size
        out = np.empty((num_frames, h, w, 3), np.uint8)
        got = self._lib.mr_read_video_clip(
            self._h, float(start), float(duration), float(fps),
            int(num_frames),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if got <= 0:
            raise IOError(f"video decode failed for {self.path} @ {start}s")
        if got < num_frames:
            out[got:] = out[got - 1:got]
        return out

    def read_audio(self, start: float, duration: float) -> np.ndarray:
        """(channels, T) float32 at the native sample rate."""
        sr = self.audio_sample_rate
        ch = self.audio_channels
        if sr <= 0 or ch <= 0:
            raise IOError(f"no audio stream in {self.path}")
        max_samples = int((duration + 1.0) * sr)
        buf = np.empty((max_samples, ch), np.float32)
        got = self._lib.mr_read_audio(
            self._h, float(start), float(duration),
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            max_samples)
        if got <= 0:
            raise IOError(f"audio decode failed for {self.path} @ {start}s")
        return np.ascontiguousarray(buf[:got].T)


def write_video(path: str, frames: np.ndarray, fps: float,
                audio: Optional[np.ndarray] = None,
                audio_sr: int = 16000) -> None:
    """frames (n, h, w, 3) uint8 RGB; audio (c, T) float32 -> mp4 (+AAC)."""
    lib = library()
    frames = np.ascontiguousarray(frames, np.uint8)
    n, h, w, _ = frames.shape
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if audio is not None:
        audio = np.asarray(audio, np.float32)
        if audio.ndim == 1:
            audio = audio[None]
        inter = np.ascontiguousarray(audio.T)  # (T, c) interleaved
        aptr = inter.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
        asamp, ach = inter.shape[0], inter.shape[1]
    else:
        aptr, asamp, ach = None, 0, 0
    rc = lib.mw_write_video(
        path.encode(), frames.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        n, h, w, float(fps), aptr, asamp, ach, int(audio_sr))
    if rc != 0:
        raise IOError(f"write_video({path}) failed with code {rc}")
