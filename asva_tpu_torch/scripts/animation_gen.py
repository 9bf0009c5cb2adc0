"""Batched test-set generation (port of scripts/animation_gen.py, the
reference's animation_gen CLI), plus `--device`.

For every test video of the dataset: sample `num_clips_per_video` clips,
animate each first frame with its audio, write
<exp_root>/evaluations/checkpoint-<N>/AG-<ag>_TG-<tg>/seed-<s>/videos/...

    python3 -m asva_tpu_torch.scripts.animation_gen --exp_root exps/run \
        --checkpoint 40000 --dataset AVSync15 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os

from .common import add_device_flag, compute_dtype


def get_evaluation_data(dataset: str, dataset_root: str = "./datasets"):
    """(video root, test video names, categories) of a dataset tree."""
    root = os.path.join(dataset_root, dataset)
    if dataset == "Landscapes":
        video_root = os.path.join(root, "videos", "test")
    else:
        video_root = os.path.join(root, "videos")
    with open(os.path.join(root, "test.txt")) as f:
        names = [line.strip() for line in f if line.strip()]
    if dataset == "TheGreatestHits":
        cats = ["hitting with a stick"] * len(names)
    else:
        cats = [n.split("/")[0] for n in names]
    return video_root, names, cats


def generation_root(args) -> str:
    """<exp_root>/evaluations/checkpoint-N/AG-.._TG-../seed-S/videos."""
    return os.path.join(
        args.exp_root, "evaluations", f"checkpoint-{args.checkpoint}",
        f"AG-{args.audio_guidance_scale}_TG-{args.text_guidance_scale}",
        f"seed-{args.random_seed}", "videos")


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--exp_root", required=True)
    p.add_argument("--checkpoint", type=int, required=True)
    p.add_argument("--dataset", default="AVSync15",
                   choices=["AVSync15", "Landscapes", "TheGreatestHits"])
    p.add_argument("--dataset_root", default="./datasets")
    p.add_argument("--image_size", type=int, nargs=2, default=None)
    p.add_argument("--video_fps", type=int, default=6)
    p.add_argument("--video_num_frame", type=int, default=12)
    p.add_argument("--num_clips_per_video", type=int, default=3)
    p.add_argument("--audio_guidance_scale", type=float, default=4.0)
    p.add_argument("--text_guidance_scale", type=float, default=1.0)
    p.add_argument("--num_inference_steps", type=int, default=50)
    p.add_argument("--sampler", default="plms", choices=["plms", "ddim"])
    p.add_argument("--random_seed", type=int, default=0)
    add_device_flag(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if args.image_size is None:
        args.image_size = ([128, 256] if args.dataset == "TheGreatestHits"
                           else [256, 256])

    from ..data.datasets import load_text_encoding_mapping
    from ..pipelines.generate import generate_videos
    from ..runtime import load_animation_pipeline

    ckpt_dir = os.path.join(args.exp_root, "ckpts",
                            f"checkpoint-{args.checkpoint}", "modules")
    save_root = generation_root(args)

    video_root, names, cats = get_evaluation_data(args.dataset,
                                                  args.dataset_root)
    droot = os.path.join(args.dataset_root, args.dataset)
    mapping_path = os.path.join(droot, "class_mapping.json")
    mapping = None
    if os.path.isfile(mapping_path):
        with open(mapping_path) as f:
            mapping = json.load(f)
    enc_path = os.path.join(
        droot, "class_clip_text_encodings_stable-diffusion-v1-5.pt")
    enc_map = (load_text_encoding_mapping(enc_path)
               if os.path.isfile(enc_path) else None)

    pipeline = load_animation_pipeline(
        checkpoint_modules_dir=ckpt_dir,
        sd_root="pretrained/stable-diffusion-v1-5",
        null_text_encoding_path="pretrained/"
                                "openai-clip-l_null_text_encoding.pt",
        n_segment=args.video_num_frame, device=args.device,
        dtype=compute_dtype(args.device))

    for name, cat in zip(names, cats):
        if mapping is not None:
            cat = mapping.get(cat, cat)
        enc = None
        if enc_map is not None:
            enc = enc_map if not isinstance(enc_map, dict) else enc_map[cat]
        generate_videos(
            pipeline,
            video_path=os.path.join(video_root, name),
            category_text_encoding=enc,
            image_size=tuple(args.image_size),
            video_fps=args.video_fps,
            video_num_frame=args.video_num_frame,
            num_clips_per_video=args.num_clips_per_video,
            audio_guidance_scale=args.audio_guidance_scale,
            text_guidance_scale=args.text_guidance_scale,
            num_inference_steps=args.num_inference_steps,
            seed=args.random_seed,
            save_template=os.path.join(save_root, name.replace(".mp4", "")),
            sampler=args.sampler)
        print("generated", name)


if __name__ == "__main__":
    main()
