"""Run one cell of the benchmark of asva_tpu_torch on the CUDA cards of this
machine and print its result as the last line of standard output.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (BENCHMARK.json's `workloads`) names its configuration and
traffic; see benchmark/harness.py for the files found by name.  A cell on
several cards starts one process a card from this one (it is rank 0),
joined over NCCL by env:// on a free localhost port; rank 0 prints.  With
no card, or fewer than the cell asks for, it exits 2 and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# kernel caches of the libraries the program may use, at fixed paths inside
# the checkout (the program's own CUDA libraries build into
# asva_tpu_torch/_build/)
for _var, _dir in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[_var] = os.path.join(ROOT, ".bench_cache", _dir)


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2):
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    args = parse(argv)
    try:
        import torch
    except ImportError as e:
        fail(f"no torch: {e}")
    try:
        import asva_tpu_torch  # noqa: F401
    except ImportError as e:
        fail(f"the program asva_tpu_torch is not in this checkout: {e}")
    from benchmark import harness
    cell = harness.load_cell(args.workload)
    rank, device, procs = harness.start_ranks(
        cell, os.path.abspath(__file__), argv)
    if rank == 0:
        print(f"card: {harness.power_limit()}", file=sys.stderr, flush=True)
    with tempfile.TemporaryDirectory(prefix="asva_bench_") as tmp:
        run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device, t0=T0,
                          tmpdir=tmp, rank=rank, world=cell.chips)
        outcome = harness.kind_module(cell).run(run)
    harness.end_ranks(cell, procs)
    if rank != 0:
        return 0
    found = harness.forbidden_modules()
    if found:
        fail(f"modules that the program must not load are loaded: {found}",
             3)
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(device),
                   "count": cell.chips,
                   "memory_peak_bytes": int(outcome.peak_bytes),
                   "power_limit": harness.power_limit()}
    if args.trace and outcome.record.trace is not None:
        device_info["busy_s"] = outcome.record.trace["busy_s"]
        device_info["window_s"] = outcome.record.trace["window_s"]
    line = harness.result_line(cell, outcome, bool(args.trace), device_info)
    for text in harness.check_lines(outcome.checks):
        print(text, file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
