"""The benchmark's general part: a cell resolved by name from
BENCHMARK.json into its configuration, traffic, limits and metric
readers; the record that the metric readers read; the checks on the
process; and the result line.

Files found by name (a later cell adds files and entries, and edits none):
  benchmark/configs/<config>.json   the configuration as it is run; the
                                    cell's kind reads the groups it needs
                                    (a model without an audio tower has
                                    no "audio" group)
  benchmark/traffic/<traffic>.json  the mix; its "kind" names the driver
                                    benchmark/kinds/<kind>.py
  benchmark/limits/<workload>.json  each compared number's limit
  benchmark/metrics/<metric>.py     a per-layer metric's reader,
                                    read(record) -> float or None
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import re
import socket
import subprocess
import sys
import threading
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# compared with the top-level name of every loaded module, as whole words
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "asva_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names among the loaded modules."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _checked(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"{name!r} is not a benchmark name")
    return name


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _mine(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


# what the port's mel and the reference's take as fixed where a
# configuration has an audio tower: one that states otherwise, or leaves a
# key out, is refused, not run as these
FIXED = {"audio_sample_rate": 16000, "audio_seconds_per_clip": 2.0}


def load_cell(workload: str, root: str = ROOT) -> Cell:
    spec = _json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = _json(os.path.join(root, cfg_entry["file"]))
    for key, value in (FIXED.items() if "audio" in config else ()):
        if config.get(key) != value:
            raise ValueError(f"{cfg_entry['name']}: {key} "
                             f"{config.get(key, 'left out')}; the port and "
                             f"the reference take {value}")
    traffic = _json(os.path.join(BENCH, "traffic",
                                 _checked(w["traffic"]) + ".json"))
    limits = _json(os.path.join(BENCH, "limits", _checked(workload) + ".json"))
    return Cell(workload, int(w["chips"]), config, traffic, limits,
                [m for m in spec["end_to_end"] if _mine(m, workload)],
                [m for m in spec["per_layer"] if _mine(m, workload)])


def kind_module(cell: Cell):
    """The driver of the cell's traffic kind."""
    return importlib.import_module(
        f"benchmark.kinds.{_checked(cell.traffic['kind'])}")


def metric_reader(name: str):
    path = os.path.join(BENCH, "metrics", _checked(name) + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Record:
    """What a traced run measured, for the per-layer readers.

    events: {name: [milliseconds]} from CUDA-event pairs;
    values: {name: number} (window seconds, clips, steps, model FLOPs);
    trace:  the profiled stretch's summary (trace.py), or None;
    spans:  its fourth segment with the program's spans and counters
            (spans.reduce_spans, the ranks merged), or None;
    request_spans: one whole generation request the same way, or None."""

    def __init__(self):
        self.events: Dict[str, List[float]] = defaultdict(list)
        self.values: Dict[str, float] = {}
        self.trace = None
        self.spans = None
        self.request_spans = None


def per_layer_metrics(cell: Cell, rec: Record) -> dict:
    out = {}
    for m in cell.per_layer:
        value = metric_reader(m["name"])(rec)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


@dataclasses.dataclass
class Outcome:
    """What a kind's run hands back to the harness."""
    end_to_end: Dict[str, float]
    checks: Dict[str, Tuple[float, float]]      # name -> (value, limit)
    attempted: int
    failed: int
    peak_bytes: int
    record: Record
    breakdown: Optional[dict] = None


def correct(checks: Dict[str, Tuple[float, float]]) -> bool:
    return bool(checks) and all(math.isfinite(v) and v <= lim
                                for v, lim in checks.values())


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else f"not read (exit {out.returncode})"


def result_line(cell: Cell, outcome: Outcome, trace: bool,
                device: dict) -> dict:
    """The last line's object; its metrics are the cell's end-to-end ones
    (trace 0) or its per-layer ones (trace 1); `checks` comes last."""
    if trace:
        metrics = per_layer_metrics(cell, outcome.record)
    else:
        values = outcome.end_to_end
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
    line = {"correct": correct(outcome.checks),
            "attempted": outcome.attempted, "failed": outcome.failed,
            "metrics": metrics, "device": device}
    if trace and outcome.breakdown is not None:
        line["breakdown"] = outcome.breakdown
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in outcome.checks.items()}
    return line


def check_lines(checks: Dict[str, Tuple[float, float]]) -> List[str]:
    return [f"check {k}: {v!r} against the limit {lim!r} "
            f"({'ok' if math.isfinite(v) and v <= lim else 'FAILED'})"
            for k, (v, lim) in checks.items()]


def sub_seed(seed: int, *keys: int) -> int:
    """A generator seed for one purpose of run `seed`."""
    s = seed
    for k in keys:
        s = (s * 1_000_003 + k) % (1 << 62)
    return s


def dataclass_kwargs(group: dict) -> dict:
    """A configuration group as dataclass keyword arguments."""
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in group.items()}


class Timer:
    """Start/stop pairs on the device's clock (CUDA events) or, on the
    CPU, the host's; `ms()` reads every pair once the work is done."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.pairs = []

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def start(self):
        self.pairs.append([self._mark(), None])

    def stop(self):
        self.pairs[-1][1] = self._mark()

    def ms(self) -> List[float]:
        if self.cuda:
            return [a.elapsed_time(b) for a, b in self.pairs]
        return [(b - a) * 1e3 for a, b in self.pairs]


@dataclasses.dataclass
class Run:
    """One run of a cell in one process (a rank of it)."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: str
    t0: float                 # the process's start, on perf_counter
    tmpdir: str
    rank: int = 0
    world: int = 1

    def sync(self):
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize(self.device)

    def log(self, msg: str):
        print(f"[{time.perf_counter() - self.t0:8.2f}s rank {self.rank}] "
              f"{msg}", file=sys.stderr, flush=True)


def _free_port() -> int:
    """A port that no socket on any address holds now: the store's server
    listens on every address, so a port free on the loopback alone (one
    that a finished run's connection still holds elsewhere) can refuse it."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("", 0))
        return s.getsockname()[1]


def spawn_ranks(world: int, script: str, argv):
    """Ranks 1 .. world-1 of `script` with `argv`, one card each; this process
    becomes rank 0.  Their standard output goes to this one's standard
    error, so that the last line of standard output stays rank 0's."""
    env = dict(os.environ, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE=str(world),
               LOCAL_WORLD_SIZE=str(world))
    procs = []
    for rank in range(1, world):
        procs.append(subprocess.Popen(
            [sys.executable, script, *argv],
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
            stdout=sys.stderr, cwd=os.getcwd()))
    os.environ.update(env, RANK="0", LOCAL_RANK="0")
    return procs


def watch(procs):
    """End this process when a rank fails, so that no collective waits
    for it forever."""
    def loop():
        while True:
            for p in procs:
                rc = p.poll()
                if rc not in (None, 0):
                    for q in procs:
                        if q.poll() is None:
                            q.kill()
                    print(f"benchmark: a rank exited {rc}", file=sys.stderr,
                          flush=True)
                    os._exit(1)
            if all(p.poll() is not None for p in procs):
                return
            time.sleep(0.5)
    threading.Thread(target=loop, daemon=True).start()


def start_ranks(cell: Cell, script: str, argv) -> Tuple[int, str, list]:
    """(rank, device, the other ranks' processes) of a run of `cell` by
    `script` with `argv`: exits 2 without enough CUDA cards; a cell on
    several cards builds the kernel libraries once, starts ranks 1.. from
    rank 0 and joins them over NCCL (`multihost`)."""
    if not torch.cuda.is_available():
        print("benchmark: no CUDA card is visible; the benchmark runs only "
              "on a card", file=sys.stderr, flush=True)
        sys.exit(2)
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} cards, "
              f"{torch.cuda.device_count()} are visible", file=sys.stderr,
              flush=True)
        sys.exit(2)
    procs = []
    if cell.chips > 1 and "RANK" not in os.environ:
        from asva_tpu_torch.ops import cuda_build
        cuda_build.build()
        procs = spawn_ranks(cell.chips, script, argv)
        watch(procs)
    rank = int(os.environ.get("RANK", "0"))
    if cell.chips > 1:
        from asva_tpu_torch.parallel import multihost
        try:
            multihost.maybe_initialize_distributed("cuda")
        except BaseException:
            for p in procs:              # none waits for this rank forever
                p.kill()
                p.wait()
            raise
    device = f"cuda:{rank}"
    torch.cuda.set_device(device)
    return rank, device, procs


def end_ranks(cell: Cell, procs) -> None:
    """Leave the process group and wait for the other ranks."""
    if cell.chips > 1:
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
    for p in procs:
        p.wait()
