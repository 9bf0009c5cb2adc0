"""asva_tpu_torch — the PyTorch/CUDA port of asva_tpu for NVIDIA Hopper.

Module paths mirror `asva_tpu` so each counterpart is easy to find.  The
package imports `torch` and never `jax`, `flax` or `asva_tpu`.  Public
functions keep the JAX package's layouts: channels-last (b, f, h, w, c)
video and (b, 128, 204, 1) mels.

The UNet transformer blocks' fused sub-layers run through hand-written
CUDA kernels (`csrc/`, bound in `ops/fused.py`) on CUDA tensors, and
through their plain PyTorch versions on CPU tensors.
"""

__version__ = "0.1.0"
