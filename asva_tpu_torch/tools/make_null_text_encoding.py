"""Mint the null ("") CLIP text encoding that the trainer and the pipeline
read (the counterpart of tools/make_null_text_encoding.py).

The published artifact, pretrained/openai-clip-l_null_text_encoding.pt, is
the (1, 77, 768) last hidden state of the empty prompt through SD1.5's CLIP
text encoder.  Run once after placing the SD1.5 checkpoint (its
text_encoder/ and tokenizer/) under --sd_root:

    python3 -m asva_tpu_torch.tools.make_null_text_encoding \
        [--sd_root pretrained/stable-diffusion-v1-5] \
        [--out pretrained/openai-clip-l_null_text_encoding.npy] [--device cpu]

The encoding is computed in float32 and written as `.npy` (as the JAX tool
writes it) or, when the name ends in `.pt`, as a torch tensor (the
published file's format); `runtime.load_null_text_encoding` reads either.
"""
from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..scripts.common import add_device_flag


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--sd_root", default="pretrained/stable-diffusion-v1-5")
    p.add_argument("--out", default="pretrained/"
                   "openai-clip-l_null_text_encoding.npy")
    add_device_flag(p)
    args = p.parse_args(argv)

    from ..models import clip_text
    from ..runtime import build_text_encoder

    model = build_text_encoder(
        clip_text.CLIPTextConfig(), device=args.device, dtype=torch.float32,
        weights_dir=os.path.join(args.sd_root, "text_encoder"))
    ids = clip_text.tokenize([""], tokenizer_path=os.path.join(
        args.sd_root, "tokenizer"))
    with torch.no_grad():
        enc = model(ids.to(args.device)).float().cpu()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    if args.out.endswith(".pt"):
        torch.save(enc, args.out)
    else:
        np.save(args.out, enc.numpy())
    print(f"wrote {args.out} shape={tuple(enc.shape)}")
    return enc.numpy()


if __name__ == "__main__":
    main()
