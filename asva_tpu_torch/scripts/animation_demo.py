"""Single-sample AVSyncD demo: one image + one audio -> animated mp4 clips.

Port of scripts/animation_demo.py (the reference's animation_demo CLI:
dataset-specific checkpoints, image+audio or video conditioning, CFG
scales), plus `--device`:

    python3 -m asva_tpu_torch.scripts.animation_demo --image_path cond.png \
        --audio_path cond.wav --save_template out/demo [--device cpu]
"""
from __future__ import annotations

import argparse
import os

from .common import add_device_flag, compute_dtype


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--image_path", default="")
    p.add_argument("--audio_path", default="")
    p.add_argument("--video_path", default="")
    p.add_argument("--checkpoint_modules_dir", default=None,
                   help=".../ckpts/checkpoint-N/modules with unet + "
                        "audio_encoder exports")
    p.add_argument("--sd_root", default="pretrained/stable-diffusion-v1-5")
    p.add_argument("--null_text_encoding_path",
                   default="pretrained/openai-clip-l_null_text_encoding.pt")
    p.add_argument("--category_text_encoding_path", default=None)
    p.add_argument("--category", default=None,
                   help="free-form class prompt; needs the SD1.5 tokenizer "
                        "and text_encoder under --sd_root")
    p.add_argument("--image_size", type=int, nargs=2, default=[256, 256])
    p.add_argument("--video_fps", type=int, default=6)
    p.add_argument("--video_num_frame", type=int, default=12)
    p.add_argument("--num_clips", type=int, default=3)
    p.add_argument("--audio_guidance_scale", type=float, default=4.0)
    p.add_argument("--text_guidance_scale", type=float, default=1.0)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--sampler", default="plms", choices=["plms", "ddim"])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_template", required=True,
                   help="output path prefix; _clip-XX.mp4 is appended")
    add_device_flag(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)

    import torch
    from ..pipelines.generate import generate_videos
    from ..runtime import load_animation_pipeline, load_null_text_encoding

    dtype = compute_dtype(args.device)
    pipeline = load_animation_pipeline(
        checkpoint_modules_dir=args.checkpoint_modules_dir,
        sd_root=args.sd_root or None,
        null_text_encoding_path=args.null_text_encoding_path,
        n_segment=args.video_num_frame, device=args.device, dtype=dtype)

    enc = None
    if args.category_text_encoding_path:
        enc = load_null_text_encoding(args.category_text_encoding_path,
                                      args.device)
    elif args.category:
        from ..models.clip_text import tokenize
        from ..runtime import build_text_encoder
        text_model = build_text_encoder(
            device=args.device, dtype=dtype,
            weights_dir=os.path.join(args.sd_root, "text_encoder"))
        ids = tokenize([args.category],
                       tokenizer_path=os.path.join(args.sd_root, "tokenizer"))
        with torch.no_grad():
            enc = text_model(ids.to(args.device)).float()

    generate_videos(
        pipeline,
        image_path=args.image_path,
        audio_path=args.audio_path,
        video_path=args.video_path,
        category_text_encoding=enc,
        image_size=tuple(args.image_size),
        video_fps=args.video_fps,
        video_num_frame=args.video_num_frame,
        num_clips_per_video=args.num_clips,
        audio_guidance_scale=args.audio_guidance_scale,
        text_guidance_scale=args.text_guidance_scale,
        num_inference_steps=args.num_inference_steps,
        seed=args.seed,
        save_template=args.save_template,
        sampler=args.sampler)
    print(f"wrote {args.num_clips} clips to {args.save_template}_clip-*.mp4")


if __name__ == "__main__":
    main()
