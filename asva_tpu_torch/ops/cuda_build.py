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
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# One row per library: source name -> (headers it includes, {C entry point:
# (argtypes, restype)}).  A new kernel is one row (or one entry of a row).
KERNEL_TABLE = {
    "gemm": (("hopper.cuh", "tma.cuh", "wgmma.cuh"), {
        "asva_ln_gemm": ([_I] * 5 + [_VP] * 3 + [_F] + [_VP] * 5, _I),
        "asva_error_string": ([_I], ctypes.c_char_p)}),
    "attn": (("hopper.cuh", "wgmma.cuh"), {
        "asva_mha_fwd": ([_I] * 7 + [_F] + [_VP] * 6, _I),
        "asva_flat_attn": ([_I] * 6 + [_F] + [_VP] * 5, _I)}),
    "attn_bwd": (("hopper.cuh", "wgmma.cuh"), {
        "asva_mha_bwd": ([_I] * 7 + [_F] + [_VP] * 10, _I),
        "asva_mha_bwd_split": ([_I] * 7 + [_F] + [_VP] * 9 + [_I, _VP, _VP],
                               _I)}),
    "mix": (("hopper.cuh", "tma.cuh", "wgmma.cuh"), {
        "asva_ff_mix": ([_I] * 8 + [_VP] * 4 + [_I] * 3 + [_VP] * 3, _I)}),
    "attn_variants": (("hopper.cuh", "tma.cuh", "wgmma.cuh"), {
        "asva_ln_attn_variant": ([_I] * 9 + [_F] * 2 + [_VP] * 10, _I)}),
    "attn_grouped": (("hopper.cuh", "wgmma.cuh"), {
        "asva_mha_fwd_grouped": ([_I] * 8 + [_F] + [_VP] * 6, _I)}),
    "attn_bwd_fused": (("hopper.cuh", "wgmma.cuh"), {
        "asva_mha_bwd_fused": ([_I] * 9 + [_F] + [_VP] * 10, _I)}),
}
SOURCES = tuple(KERNEL_TABLE)


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
    for header in KERNEL_TABLE[name][0]:
        with open(os.path.join(CSRC, header), "rb") as f:
            digest.update(f.read())
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


@functools.cache
def library() -> types.SimpleNamespace:
    """The loaded kernel libraries (built first if missing), one attribute
    per source of KERNEL_TABLE."""
    paths = build()
    libs = {}
    for name, (_, entries) in KERNEL_TABLE.items():
        lib = libs[name] = ctypes.CDLL(paths[name][0])
        for entry, (argtypes, restype) in entries.items():
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = argtypes, restype
    return types.SimpleNamespace(**libs)
