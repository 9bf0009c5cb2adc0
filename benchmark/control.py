"""The control of a cell's `correct`: the plain reference in the program's
place, its products in float8 (reference/ops.py), held to the float32
reference by the cell's own numbers, at the cell's own size.  It has to
come out not correct.  The benchmark's runs never run it.

    python3 benchmark/control.py --workload <name> --seed <n> [--seed ...]

prints one JSON line per seed with the numbers and whether the cell's
limits pass them.  A cell on several cards starts its ranks as run.py
does; rank 0 prints.
"""
import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from benchmark import harness, media, weights  # noqa: E402
from benchmark.kinds import finetune, generate  # noqa: E402
from benchmark.reference.ops import no_tf32  # noqa: E402
from benchmark.reference.pipeline import Generator  # noqa: E402
from benchmark.reference.train import Trainer  # noqa: E402


def _generation(cell, seed, device):
    cfg, tr = cell.config, cell.traffic
    null, texts = generate.conditions(cfg, tr, seed, device)
    frames = {}
    with tempfile.TemporaryDirectory() as tmp, no_tf32():
        png, wav = media.write_pool(tmp, seed, 1, cfg["image_size"],
                                    tr["audio_seconds"])[0]
        for precision in ("fp32", "fp8"):
            ref = Generator(cfg, weights.draw_all(cfg, seed, device), device,
                            precision)
            frames[precision] = ref.request(png, wav, texts[0], null,
                                            generate.request_seed(seed, 0),
                                            tr)
            del ref
            torch.cuda.empty_cache()
    return {"worst_clip_rms": generate.worst_clip_rms(frames["fp8"],
                                                      frames["fp32"])}


def _steps(cell, seed, device, rank, world):
    cfg, tr = cell.config, cell.traffic
    n = tr["checked_steps"] * tr["gradient_accumulation_steps"]
    mean_across = None
    if world > 1:
        import torch.distributed as dist

        def mean_across(tensors):
            for t in tensors:
                dist.all_reduce(t)
                t.div_(world)
    out = {}
    with no_tf32():
        for precision in ("fp32", "fp8"):
            ref = Trainer(cfg, weights.draw_all(cfg, seed, device), tr,
                          device, precision)
            out[precision] = ref.steps(
                [finetune.as_batch(finetune.micro_batch(cfg, tr, seed, rank,
                                                        i, device))
                 for i in range(n)],
                [lambda i=i: finetune.draw_generator(seed, i, device)
                 for i in range(n)],
                finetune.null_text(cfg, seed, device), tr["checked_steps"],
                world, rank, mean_across)
            del ref
            torch.cuda.empty_cache()
    got = finetune.numbers(out["fp8"], out["fp32"],
                           tr["gradient_accumulation_steps"])
    if world > 1:
        import torch.distributed as dist
        t = torch.tensor(list(got.values()), dtype=torch.float64,
                         device=device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        got = dict(zip(got, t.tolist()))
    return got


def control_readings(cell, seed: int, device, rank: int = 0,
                     world: int = 1) -> dict:
    if cell.traffic["kind"] == "generate":
        return _generation(cell, seed, device)
    return _steps(cell, seed, device, rank, world)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    rank, device, procs = harness.start_ranks(
        cell, os.path.abspath(__file__), argv)
    for seed in args.seed:
        t0 = time.perf_counter()
        got = control_readings(cell, seed, device, rank, cell.chips)
        if rank == 0:
            print(json.dumps({
                "workload": cell.name, "seed": seed, "control": "fp8",
                "numbers": got, "limits": cell.limits,
                "correct": harness.correct({k: (got[k], lim) for k, lim
                                            in cell.limits.items()}),
                "seconds": time.perf_counter() - t0,
                "card": harness.power_limit()}), flush=True)
    harness.end_ranks(cell, procs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
