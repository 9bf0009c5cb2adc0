"""Generation metric evaluation: FID / FVD / IA / IT / RelSync / AlignSync
over a generated-video directory.  Port of scripts/animation_eval.py (the
reference's animation_eval CLI), plus `--device`:

    python3 -m asva_tpu_torch.scripts.animation_eval --exp_root exps/run \
        --checkpoint 40000 --eval_fid --eval_fvd --eval_clipsim \
        --eval_relsync --eval_alignsync [--device cpu]

The metric nets load the published weights from `--pretrained_root` (the
reference's pretrained/ layout) and refuse to run without them unless
`--allow_random_eval_nets` is given, which labels each random net in the
result JSON.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..convert import extract_state_and_eps, load_source_state
from ..eval.harness import eval_models_from_nets, evaluate_generation_results
from ..models.evalnets import InceptionI3D, InceptionV3FID
from ..models.imagebind_audio import (ImageBindAudioConfig,
                                      ImageBindAudioEncoder)
from ..models.imagebind_extra import (ImageBindTextConfig,
                                      ImageBindTextEncoder,
                                      ImageBindVisionConfig,
                                      ImageBindVisionEncoder)
from ..runtime import (_RELU_GAIN, _build, build_avsync_classifier,
                       load_torch_state)
from .animation_gen import generation_root, get_evaluation_data
from .common import add_device_flag

# the metric nets at their published sizes: (factory, seed, init gain)
NETS = {
    "fid_inception_v3": (InceptionV3FID, 10, _RELU_GAIN),
    "fvd_i3d": (lambda eps: InceptionI3D(400, eps), 11, _RELU_GAIN),
    "imagebind_vision": (lambda: ImageBindVisionEncoder(
        ImageBindVisionConfig()), 13, 1.0),
    "imagebind_audio": (lambda: ImageBindAudioEncoder(
        ImageBindAudioConfig()), 14, 1.0),
    "imagebind_text": (lambda: ImageBindTextEncoder(
        ImageBindTextConfig()), 15, 1.0),
}


def _find_file(*candidates):
    for p in candidates:
        if p and os.path.isfile(p):
            return p
    return None


def _load_or_refuse(module, space, path, candidates, label, args,
                    random_nets):
    """Load published weights of key space `space` into `module`, refusing
    to run random nets.

    Reference behaviour: metric nets always load published weights
    (avgen/evaluations/models/inception_v3.py:13 FID_WEIGHTS_URL,
    models/download.py:48-55 i3d_torchscript, clip.py:27 imagebind_huge).
    With no weights on disk this either aborts (default) or clearly labels
    the net as random (--allow_random_eval_nets)."""
    if path is None:
        msg = (f"{label}: no weights found (looked for: "
               f"{', '.join(c for c in candidates if c)})")
        if not args.allow_random_eval_nets:
            sys.exit(msg + "\nRefusing to compute metrics with randomly "
                     "initialized nets — results would be meaningless. "
                     "Pass --allow_random_eval_nets to override.")
        print(f"WARNING: {msg} — RUNNING WITH RANDOM WEIGHTS; "
              f"'{label}' numbers are meaningless.")
        random_nets.append(label)
        return
    try:
        load_source_state(module, load_torch_state(path), space)
    except KeyError as e:
        sys.exit(f"{label}: {path} does not match the net "
                 f"(converter/key-map mismatch): {e}")
    print(f"{label}: loaded {len(module.state_dict())} tensors from {path}")


def _net(label, args, *factory_args, load=None):
    """The metric net `label` in float32 on the device, seeded, with
    `load` applied before it is frozen."""
    factory, seed, gain = NETS[label]
    return _build(lambda: factory(*factory_args), args.device, torch.float32,
                  seed, False, gain=gain, load=load)


def _i3d_eps(args, root):
    """(i3d weights path, eps, where eps came from): an explicit flag > the
    value read out of the TorchScript blob (or its extraction sidecar) >
    the reference pytorch_i3d source default 1e-5."""
    i3d_path = _find_file(os.path.join(root, "i3d_state.pt"))
    detected_eps = None
    if i3d_path is None:
        blob = _find_file(os.path.join(root, "i3d_torchscript.pt"))
        if blob is not None:      # extract the blob's state dict once
            state, detected_eps = extract_state_and_eps(blob)
            i3d_path = os.path.join(root, "i3d_state.pt")
            torch.save(state, i3d_path)
            with open(i3d_path + ".eps.json", "w") as f:
                json.dump({"bn_eps": detected_eps, "source_blob": blob}, f)
            print(f"fvd_i3d: extracted {len(state)} tensors from {blob}"
                  f" (detected bn_eps={detected_eps})")
    elif os.path.isfile(i3d_path + ".eps.json"):
        with open(i3d_path + ".eps.json") as f:
            detected_eps = json.load(f).get("bn_eps")
    if args.i3d_bn_eps is not None:
        return i3d_path, args.i3d_bn_eps, "flag"
    if detected_eps is not None:
        return i3d_path, float(detected_eps), "auto-detected from blob"
    return i3d_path, 1e-5, "source default (no blob to detect from)"


def build_eval_models(args):
    """The metric callables the flags ask for, loading the published
    checkpoints from the reference's pretrained/ layout."""
    root = args.pretrained_root
    random_nets, provenance, nets = [], {}, {}
    imagebind_path = _find_file(
        os.path.join(root, ".checkpoints", "imagebind_huge.pth"),
        os.path.join(root, "imagebind_huge.pth"))
    imagebind_candidates = [os.path.join(root, ".checkpoints",
                                         "imagebind_huge.pth")]

    def loader(label, space, path, candidates):
        return lambda m: _load_or_refuse(m, space, path, candidates, label,
                                         args, random_nets)

    if args.eval_fid:
        fid_path = _find_file(
            os.path.join(root, "pt_inception-2015-12-05-6726825d.pth"),
            os.path.join(root, "pt_inception.pth"))
        nets["fid_net"] = _net("fid_inception_v3", args, load=loader(
            "fid_inception_v3", "inception_v3", fid_path,
            [os.path.join(root, "pt_inception-2015-12-05-6726825d.pth")]))

    if args.eval_fvd:
        i3d_path, eps, eps_src = _i3d_eps(args, root)
        provenance["I3D_BN_EPS"] = eps
        provenance["I3D_BN_EPS_SOURCE"] = eps_src
        nets["i3d_net"] = _net("fvd_i3d", args, eps, load=loader(
            "fvd_i3d", "i3d", i3d_path,
            [os.path.join(root, "i3d_torchscript.pt")]))

    if args.eval_relsync or args.eval_alignsync:
        wd = None
        if args.avsync_checkpoint and os.path.isdir(args.avsync_checkpoint):
            wd = {m: os.path.join(args.avsync_checkpoint, m)
                  for m in ("audio_encoder", "video_encoder", "head")}
        elif not args.allow_random_eval_nets:
            sys.exit(f"avsync classifier checkpoint not found at "
                     f"{args.avsync_checkpoint}; pass --avsync_checkpoint "
                     "or --allow_random_eval_nets")
        else:
            print("WARNING: avsync classifier running with RANDOM weights")
            random_nets.append("avsync_classifier")
        nets["classifier"] = build_avsync_classifier(wd, device=args.device)

    if args.eval_clipsim or args.eval_alignsync:
        for key, label in (("vision", "imagebind_vision"),
                           ("audio", "imagebind_audio"),
                           ("text", "imagebind_text")):
            nets[key] = _net(label, args, load=loader(
                label, label, imagebind_path, imagebind_candidates))

    models = eval_models_from_nets(args.device, **nets)
    models.random_nets = random_nets
    models.provenance = provenance
    return models


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--exp_root", required=True)
    p.add_argument("--checkpoint", type=int, required=True)
    p.add_argument("--dataset", default="AVSync15")
    p.add_argument("--dataset_root", default="./datasets")
    p.add_argument("--image_size", type=int, nargs=2, default=None)
    p.add_argument("--video_fps", type=int, default=6)
    p.add_argument("--video_num_frame", type=int, default=12)
    p.add_argument("--num_clips_per_video", type=int, default=3)
    p.add_argument("--audio_guidance_scale", type=float, default=4.0)
    p.add_argument("--text_guidance_scale", type=float, default=1.0)
    p.add_argument("--random_seed", type=int, default=0)
    p.add_argument("--avsync_checkpoint", default=
                   "checkpoints/avsync/vggss_sync_contrast/ckpts/"
                   "checkpoint-40000/modules")
    for flag in ("fid", "fvd", "clipsim", "relsync", "alignsync"):
        p.add_argument(f"--eval_{flag}", action="store_true")
    p.add_argument("--record_instance_metrics", action="store_true")
    p.add_argument("--pretrained_root", default="pretrained",
                   help="directory holding the published metric-net weights "
                        "(pt_inception-2015-12-05-6726825d.pth, "
                        "i3d_torchscript.pt, .checkpoints/imagebind_huge.pth)")
    p.add_argument("--allow_random_eval_nets", action="store_true",
                   help="compute metrics even when a metric net's weights "
                        "are missing (CLEARLY LABELED; numbers meaningless)")
    p.add_argument("--i3d_bn_eps", type=float, default=None,
                   help="BatchNorm epsilon inside the FVD I3D.  Default: "
                        "auto-detect from the i3d_torchscript.pt blob (or "
                        "its extraction sidecar i3d_state.pt.eps.json), "
                        "falling back to the reference pytorch_i3d source "
                        "value 1e-5.  Pass explicitly to override")
    add_device_flag(p)
    return p


def main(argv=None):
    args = parser().parse_args(argv)
    if args.image_size is None:
        args.image_size = ([128, 256] if args.dataset == "TheGreatestHits"
                           else [256, 256])

    video_root, names, cats = get_evaluation_data(args.dataset,
                                                  args.dataset_root)
    gen_root = generation_root(args)
    # NOT str.replace("/videos", ...): exp_root or dataset paths holding
    # "/videos" elsewhere would be mangled
    result_path = os.path.join(os.path.dirname(gen_root), "result.json")

    models = build_eval_models(args)

    text_ids_for_category = None
    if models.it_sim is not None:
        from ..models.clip_bpe import ClipBPETokenizer
        tok_path = _find_file(
            os.path.join(args.pretrained_root, "bpe_simple_vocab_16e6.txt.gz"),
            os.path.join(args.pretrained_root, "stable-diffusion-v1-5",
                         "tokenizer", "vocab.json"))
        if tok_path is None:
            msg = ("it_sim: no CLIP BPE files found (looked for "
                   f"{args.pretrained_root}/bpe_simple_vocab_16e6.txt.gz and "
                   f"{args.pretrained_root}/stable-diffusion-v1-5/tokenizer/)")
            if not args.allow_random_eval_nets:
                sys.exit(msg)
            print(f"WARNING: {msg} — IT disabled")
            models.it_sim = None
        else:
            if tok_path.endswith("vocab.json"):
                tok_path = os.path.dirname(tok_path)
            tok = ClipBPETokenizer.from_pretrained(tok_path)
            cache = {}

            def text_ids_for_category(cat):
                if cat not in cache:
                    cache[cat] = torch.from_numpy(tok([cat])[0]).long()
                return cache[cat]

    result = evaluate_generation_results(
        models, video_root, names, cats, args.num_clips_per_video,
        gen_root, result_path, tuple(args.image_size), args.video_fps,
        args.video_num_frame,
        text_ids_for_category=text_ids_for_category,
        record_instance_metrics=args.record_instance_metrics,
        device=args.device)
    print({k: v for k, v in result.items() if isinstance(v, (int, float))})
    return result


if __name__ == "__main__":
    main()
