"""Build the CUDA kernels in `asva_tpu_torch/csrc/` and load them with ctypes.

Each `.cu` source becomes its own shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o <build>/lib<name>_<hash>.so csrc/<name>.cu

The sources are compiled in parallel, one nvcc each, at first use, into
`asva_tpu_torch/_build/` (git-ignored) or `$ASVA_TORCH_BUILD_DIR`.  A
library's file name carries a hash of its source, so an edited kernel is
rebuilt and a stale one is never loaded.  Nothing here runs at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import types

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
SOURCES = ("gemm", "attn", "attn_bwd", "mix")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def build_dir() -> str:
    return os.environ.get("ASVA_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(CSRC), "_build")


def nvcc_path():
    """The nvcc to use, or None when no CUDA toolkit is installed."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.isfile(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    return None


def _lib_path(name: str) -> str:
    with open(os.path.join(CSRC, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(build_dir(), f"lib{name}_{digest.hexdigest()[:12]}.so")


def build() -> dict:
    """Compile every missing library, one nvcc per source, all at once.
    Returns {name: (path, ptxas report)}; raises RuntimeError on failure."""
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): the CUDA "
            "kernels of asva_tpu_torch cannot be built")
    os.makedirs(build_dir(), exist_ok=True)
    procs = {}
    out = {}
    for name in SOURCES:
        path = _lib_path(name)
        if os.path.isfile(path):
            out[name] = (path, "")
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        procs[name] = (path, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (path, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, path)
        out[name] = (path, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


@functools.cache
def library() -> types.SimpleNamespace:
    """The loaded kernel libraries (built first if missing)."""
    paths = build()
    gemm = ctypes.CDLL(paths["gemm"][0])
    gemm.asva_ln_gemm.argtypes = [_I, _I, _I, _I, _I, _VP, _VP, _VP, _F, _VP,
                                  _VP, _VP, _VP, _VP]
    gemm.asva_ln_gemm.restype = _I
    gemm.asva_error_string.argtypes = [_I]
    gemm.asva_error_string.restype = ctypes.c_char_p
    attn = ctypes.CDLL(paths["attn"][0])
    attn.asva_mha_fwd.argtypes = [_I, _I, _I, _I, _I, _I, _I, _F, _VP, _VP,
                                  _VP, _VP, _VP, _VP]
    attn.asva_mha_fwd.restype = _I
    attn.asva_flat_attn.argtypes = [_I, _I, _I, _I, _I, _I, _F, _VP, _VP, _VP,
                                    _VP, _VP]
    attn.asva_flat_attn.restype = _I
    attn_bwd = ctypes.CDLL(paths["attn_bwd"][0])
    attn_bwd.asva_mha_bwd.argtypes = [_I, _I, _I, _I, _I, _I, _I, _F] \
        + [_VP] * 10
    attn_bwd.asva_mha_bwd.restype = _I
    mix = ctypes.CDLL(paths["mix"][0])
    mix.asva_ff_mix.argtypes = [_I, _I, _I, _I, _I, _VP, _VP, _VP, _VP, _I, _I,
                                _I, _VP, _VP, _VP]
    mix.asva_ff_mix.restype = _I
    return types.SimpleNamespace(gemm=gemm, attn=attn, attn_bwd=attn_bwd,
                                 mix=mix)
