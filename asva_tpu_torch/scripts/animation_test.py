"""The paper's two-step generate -> evaluate recipe per dataset, over the
audio guidance sweep (the counterpart of scripts/animation_test_{avsync15,
landscapes,thegreatesthits}.sh, in one table):

    python3 -m asva_tpu_torch.scripts.animation_test --dataset AVSync15 \
        <exp_root> <checkpoint> [audio_guidance ...] [--device cpu]

For each audio guidance (default the sweep 1.0, 4.0, 8.0) it runs
`animation_gen.main` and then `animation_eval.main` with the flags of the
dataset's shell recipe: its image size, 3 clips a video, text guidance
1.0, seed 0, and all five metrics.
"""
from __future__ import annotations

import argparse

from . import animation_eval, animation_gen

# dataset -> image size (h, w) of its recipe
RECIPES = {"AVSync15": ("256", "256"), "Landscapes": ("256", "256"),
           "TheGreatestHits": ("128", "256")}
SWEEP = ("1.0", "4.0", "8.0")
METRICS = ("--eval_fid", "--eval_fvd", "--eval_clipsim", "--eval_relsync",
           "--eval_alignsync")


def recipe_argvs(dataset: str, exp_root: str, checkpoint: str,
                 audio_guidance: str):
    """(animation_gen argv, animation_eval argv) of one sweep point."""
    common = ["--exp_root", exp_root, "--checkpoint", str(checkpoint),
              "--dataset", dataset, "--image_size", *RECIPES[dataset],
              "--num_clips_per_video", "3",
              "--audio_guidance_scale", str(audio_guidance),
              "--text_guidance_scale", "1.0", "--random_seed", "0"]
    return common, common + list(METRICS)


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--dataset", required=True, choices=sorted(RECIPES))
    p.add_argument("exp_root")
    p.add_argument("checkpoint")
    p.add_argument("audio_guidance", nargs="*", default=list(SWEEP),
                   help="audio guidance scales (default the sweep "
                        f"{' '.join(SWEEP)})")
    p.add_argument("--device", default=None,
                   help="passed on to both steps (their default: cuda)")
    args = p.parse_args(argv)
    device = ["--device", args.device] if args.device else []
    results = []
    for ag in args.audio_guidance:
        gen_argv, eval_argv = recipe_argvs(args.dataset, args.exp_root,
                                           args.checkpoint, ag)
        animation_gen.main(gen_argv + device)
        results.append(animation_eval.main(eval_argv + device))
    return results


if __name__ == "__main__":
    main()
