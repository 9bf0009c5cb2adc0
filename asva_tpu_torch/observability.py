"""Metrics, profiling and preemption handling for the training loops.  Port
of asva_tpu/observability.py:

  * MetricsLogger — append-only JSONL metrics stream, optionally mirrored to
    wandb when it is importable;
  * profile_steps — a torch.profiler trace around the enclosed steps
    (a Chrome trace in `logdir`);
  * GracefulShutdown — SIGTERM/SIGINT set `.requested`, so the train loop
    writes a last checkpoint instead of losing its progress.

Single-process behaviour only: the cross-process agreement on the shutdown
flag (`requested_global` across ranks) belongs with the multi-process
training of the `parallel/` package and is not ported yet; here
`requested_global()` and `poll()` return the local flag.
"""
from __future__ import annotations

import contextlib
import json
import logging
import os
import signal
import time
from typing import Optional


class MetricsLogger:
    """JSONL metrics sink; `log_with="wandb"` mirrors every record when wandb
    is importable and degrades to JSONL only, with a warning, otherwise."""

    def __init__(self, path: str, log_with: Optional[str] = None,
                 run_name: Optional[str] = None, config: Optional[dict] = None):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
        self._wandb = None
        if log_with == "wandb":
            try:
                import wandb
                self._wandb = wandb.init(project="asva_tpu_torch",
                                         name=run_name, config=config or {})
            except Exception as e:  # wandb absent / offline: JSONL still on
                logging.getLogger("asva_tpu_torch").warning(
                    "wandb logging disabled (%s); JSONL only", e)

    def log(self, step: int, **metrics):
        if self._f is None:
            return
        rec = {"step": int(step), "time": time.time()}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v)
                    for k, v in metrics.items()})
        self._f.write(json.dumps(rec) + "\n")
        if self._wandb is not None:
            self._wandb.log({k: v for k, v in rec.items()
                             if k not in ("step", "time")}, step=int(step))

    def close(self):
        if self._f is not None:
            self._f.close()
            self._f = None
        if self._wandb is not None:
            self._wandb.finish()
            self._wandb = None


@contextlib.contextmanager
def profile_steps(logdir: Optional[str]):
    """Capture a torch.profiler trace (host, and the card when there is one)
    of the enclosed steps into `logdir`/trace.json; no-op if logdir is
    falsy."""
    if not logdir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class GracefulShutdown:
    """Set .requested when SIGTERM/SIGINT arrives; the train loop checks it
    each step and checkpoints before exiting.

    The FIRST signal flips the flag and restores the previous handlers, so a
    second Ctrl-C force-quits instead of being swallowed while the final
    (possibly slow) checkpoint write runs."""

    def __init__(self):
        self.requested = False
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not main thread
                pass

    def _handler(self, signum, frame):
        self.requested = True
        self.restore()  # second signal terminates normally

    def poll(self, sync_point: bool = True) -> bool:
        """Checkpoint-worthy shutdown check for train loops (one process:
        the local flag, whatever `sync_point`)."""
        return self.requested

    def requested_global(self) -> bool:
        """One process: the local flag."""
        return self.requested

    def restore(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
