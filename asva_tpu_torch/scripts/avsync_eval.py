"""VGGSoundSync-protocol sync accuracy.  Port of scripts/avsync_eval.py (the
reference's avsync_eval), plus `--device`: 31 clips 0.04 s apart per video;
the centre audio is scored against all 31 video clips (A2V) and the centre
video against all 31 audio clips (V2A); a predicted index within
`--tolerance` of the centre counts as correct.  Records are gathered with
each example index once (a decode failure moves an item to the next
example, which another position may also read).  Under torchrun each rank
evaluates its shard (`--shard` defaults to (rank, world)), the records of
all ranks are merged, and rank 0 prints the accuracies.

    python3 -m asva_tpu_torch.scripts.avsync_eval --data_root <videos> \
        --example_list_path <test.txt> --checkpoint_modules_dir <modules> \
        [--device cpu]
"""
from __future__ import annotations

import argparse

from .common import add_device_flag


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--data_root", required=True)
    p.add_argument("--example_list_path", required=True)
    p.add_argument("--checkpoint_modules_dir", default=None)
    p.add_argument("--num_clips", type=int, default=31)
    p.add_argument("--shift_time", type=float, default=0.04)
    p.add_argument("--tolerance", type=int, default=5)
    p.add_argument("--image_size", type=int, default=224)
    p.add_argument("--video_fps", type=int, default=6)
    p.add_argument("--video_num_frames", type=int, default=12)
    p.add_argument("--max_examples", type=int, default=None)
    p.add_argument("--shard", type=int, nargs=2, default=None,
                   metavar=("INDEX", "COUNT"),
                   help="evaluate examples[INDEX::COUNT]; defaults to "
                        "(rank, world size) — the records of all ranks are "
                        "gathered, each example index once")
    add_device_flag(p)
    return p


def main(argv=None):
    """Prints (rank 0) and returns, on every rank, {"indices", "hits" (n,
    2), "a2v", "v2a"} of all ranks' records."""
    args = parser().parse_args(argv)

    import os

    import numpy as np
    import torch

    from ..data.multipair import MultiPairAVDataset
    from ..ops.mel import waveform_to_mel
    from ..parallel import batch_sharding, make_mesh
    from ..parallel.multihost import (gather_metric_records,
                                      maybe_initialize_distributed)
    from ..runtime import build_avsync_classifier

    maybe_initialize_distributed(args.device)
    mesh = make_mesh(args.device)
    args.device = mesh.device
    if args.shard is None:
        args.shard = batch_sharding(mesh)

    wd = None
    if args.checkpoint_modules_dir:
        wd = {m: os.path.join(args.checkpoint_modules_dir, m)
              for m in ("audio_encoder", "video_encoder", "head")}
    clf = build_avsync_classifier(wd, device=args.device)

    ds = MultiPairAVDataset(
        args.example_list_path, args.data_root, mode="test",
        image_size=args.image_size, video_fps=args.video_fps,
        video_num_frames=args.video_num_frames, randflip=False,
        shift_time=args.shift_time, num_clips=args.num_clips,
        sampling_type="center-compact", seed=0)

    center = args.num_clips // 2
    indices, hits, seen = [], [], set()
    n = min(len(ds), args.max_examples or len(ds))
    for i in range(args.shard[0], n, args.shard[1]):
        item = ds[i]
        if item["index"] in seen:  # decode-failure fallback dedup
            continue
        seen.add(item["index"])
        with torch.no_grad():
            wav = torch.from_numpy(item["waveforms"]).to(args.device)
            mels = torch.stack([waveform_to_mel(w) for w in wav])
            a_emb, v_emb = clf.encode(
                mels, torch.from_numpy(item["videos"]).to(args.device))
            k, c = a_emb.shape
            scores = clf.score_pairs(
                a_emb[:, None].expand(k, k, c).reshape(k * k, c),
                v_emb[None].expand(k, k, c).reshape(k * k, c))
        scores = scores.reshape(k, k).float().cpu().numpy()  # (a, v)
        a2v = int(np.argmax(scores[center]))
        v2a = int(np.argmax(scores[:, center]))
        indices.append(item["index"])
        hits.append((abs(a2v - center) <= args.tolerance,
                     abs(v2a - center) <= args.tolerance))
        if (i + 1) % 50 == 0:
            acc = np.mean(hits, axis=0)
            print(f"{i + 1}/{n}  A2V {acc[0]:.4f}  V2A {acc[1]:.4f}")

    uniq, merged = gather_metric_records(np.asarray(indices, np.int64),
                                         np.asarray(hits, np.float64),
                                         value_shape=(2,))
    if len(merged) == 0:
        raise SystemExit("no examples evaluated (empty dataset shard?)")
    acc = merged.mean(axis=0)
    if mesh.rank == 0:
        print(f"A2V sync acc: {float(acc[0]):.4f} over {len(merged)} "
              "examples")
        print(f"V2A sync acc: {float(acc[1]):.4f}")
    return {"indices": uniq, "hits": merged, "a2v": float(acc[0]),
            "v2a": float(acc[1])}


if __name__ == "__main__":
    main()
