"""Metrics, spans, profiling and preemption handling.  Port of
asva_tpu/observability.py, and the port's own spans:

  * MetricsLogger — append-only JSONL metrics stream, optionally mirrored to
    wandb when it is importable; written by rank 0 only;
  * span / traced / count / tracing — the program's spans at its layer
    boundaries and its counters, recorded in memory only inside
    `tracing()`, on the clock of torch.profiler's traces (Unix ns);
  * profile_steps — a torch.profiler trace around the enclosed steps
    (a Chrome trace in `logdir`) that carries the program's spans;
  * GracefulShutdown — SIGTERM/SIGINT set `.requested`, so the train loop
    writes a last checkpoint instead of losing its progress; with several
    processes the ranks agree on the flag through the torch.distributed
    store, so that all of them stop at the same step.
"""
from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import signal
import threading
import time
from datetime import timedelta
from typing import List, Optional


class MetricsLogger:
    """JSONL metrics sink; `log_with="wandb"` mirrors every record when wandb
    is importable and degrades to JSONL only, with a warning, otherwise.

    Across processes only rank 0 opens the file and wandb, and `log` is a
    no-op elsewhere: the logged values are the cross-rank means already,
    and several ranks appending one record each would repeat it."""

    def __init__(self, path: str, log_with: Optional[str] = None,
                 run_name: Optional[str] = None, config: Optional[dict] = None):
        from .parallel.multihost import process_index
        self._f = self._wandb = None
        if process_index() != 0:
            return
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a", buffering=1)
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


# ---------------------------------------------------------------- spans ---
#
# Off unless a `tracing()` is open: `span` then returns one shared no-op
# after one check of _RECORD, and `count` returns at once.  A span never
# opens a profiler range, so spans cost a profiled run no ranges; the
# fused sub-layers' launches are counted by ops/fused.LAUNCHES alone.

_RECORD = None      # the open tracing()'s Record, or None


def _unix_offset_ns() -> int:
    """Unix ns minus perf_counter ns, from the closest of a few paired
    reads: added to a perf_counter_ns reading it gives the clock of
    torch.profiler's traces (an event's ts in us plus the trace's
    baseTimeNanoseconds / 1e3)."""
    best = None
    for _ in range(5):
        p0 = time.perf_counter_ns()
        unix = time.time_ns()
        p1 = time.perf_counter_ns()
        if best is None or p1 - p0 < best[0]:
            best = (p1 - p0, unix - (p0 + p1) // 2)
    return best[1]


class Record:
    """What one `tracing()` recorded, in memory.

    spans: [name, start_ns, end_ns, parent, thread, unit] per span, its id
    its index; start and end on the profiler's clock (Unix ns, from
    perf_counter_ns and an offset read once at switch-on; end None while
    open); parent the id of the enclosing span on the same thread, -1 for
    none (the fused sub-layers' backward runs on autograd's thread); thread
    the native thread id, as the profiler's tid; unit the id of the
    outermost span on that thread (a request or a step).
    counts: (name, n, t_ns) samples."""

    def __init__(self):
        self.offset_ns = _unix_offset_ns()
        self.spans: List[list] = []
        self.counts: List[tuple] = []
        self._lock = threading.Lock()
        self._local = threading.local()

    def now_ns(self) -> int:
        return time.perf_counter_ns() + self.offset_ns

    def _thread(self):
        """This thread's open spans and native id, the id read once a
        thread: it is a system call, microseconds on some hosts."""
        local = self._local
        try:
            return local.stack, local.tid
        except AttributeError:
            local.stack, local.tid = [], threading.get_native_id()
            return local.stack, local.tid

    def count(self, name: str, n) -> None:
        self.counts.append((name, int(n), self.now_ns()))

    def trace_events(self, base_ns: int = 0) -> list:
        """The closed spans as Chrome-trace complete events (category
        "program_span") and each counter's running total as counter
        events, at ts = (t - base_ns) / 1e3 us: the frame of a
        torch.profiler trace whose baseTimeNanoseconds is base_ns."""
        pid = os.getpid()
        out = []
        for i, (name, start, end, parent, tid, _) in enumerate(
                list(self.spans)):
            if end is not None:
                out.append({"ph": "X", "cat": "program_span", "name": name,
                            "pid": pid, "tid": tid,
                            "ts": (start - base_ns) / 1e3,
                            "dur": (end - start) / 1e3,
                            "args": {"id": i, "parent": parent}})
        running = {}
        for name, n, t in list(self.counts):
            running[name] = running.get(name, 0) + n
            out.append({"ph": "C", "cat": "program_counter", "name": name,
                        "pid": pid, "ts": (t - base_ns) / 1e3,
                        "args": {name: running[name]}})
        return out


class _Span:
    __slots__ = ("record", "name", "id")

    def __init__(self, record: Record, name: str):
        self.record, self.name = record, name

    def __enter__(self):
        rec = self.record
        stack, tid = rec._thread()
        parent = stack[-1] if stack else -1
        with rec._lock:
            self.id = len(rec.spans)
            unit = rec.spans[parent][5] if parent >= 0 else self.id
            rec.spans.append([self.name, rec.now_ns(), None, parent, tid,
                              unit])
        stack.append(self.id)
        return self

    def __exit__(self, *exc):
        # into its own record, even where tracing() has closed meanwhile
        self.record.spans[self.id][2] = self.record.now_ns()
        self.record._thread()[0].pop()
        return False


class _Off:
    """The shared no-op that `span` returns while tracing is off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A context manager: a span of the program named `name` while a
    `tracing()` is open, else the shared no-op (`traced` decorates)."""
    if _RECORD is None:
        return _OFF
    return _Span(_RECORD, name)


def traced(name: str):
    """A decorator: each call of the function inside `span(name)`.  (The
    no-op that `span` returns while off carries no name, so it cannot
    stand for a decoration made at import.)"""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if _RECORD is None:
                return fn(*args, **kwargs)
            with _Span(_RECORD, name):
                return fn(*args, **kwargs)
        return call
    return wrap


def count(name: str, n=1) -> None:
    """Add n to the counter `name` while a `tracing()` is open."""
    if _RECORD is None:
        return
    _RECORD.count(name, n)


@contextlib.contextmanager
def tracing():
    """Record the program's spans and counters for the extent of the
    block, and yield the Record.  Inside an open one, the same Record,
    which the outer block closes."""
    global _RECORD
    if _RECORD is not None:
        yield _RECORD
        return
    _RECORD = record = Record()
    try:
        yield record
    finally:
        _RECORD = None


def add_spans_to_trace(path: str, record: Record) -> None:
    """Append the record's spans and counters to the Chrome trace at
    `path` (torch.profiler's export), in its frame of time."""
    with open(path) as f:
        trace = json.load(f)
    trace["traceEvents"].extend(record.trace_events(
        int(trace.get("baseTimeNanoseconds", 0))))
    with open(path, "w") as f:
        json.dump(trace, f)


@contextlib.contextmanager
def profile_steps(logdir: Optional[str]):
    """Capture a torch.profiler trace (host, and the card when there is one)
    of the enclosed steps into `logdir`/trace.json, with the program's
    spans and counters of the same steps (`tracing()` is on for the
    extent); no-op if logdir is falsy."""
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
    path = os.path.join(logdir, "trace.json")
    prof.start()
    try:
        with tracing() as record:
            yield
    finally:
        prof.stop()
        prof.export_chrome_trace(path)
        add_spans_to_trace(path, record)


class GracefulShutdown:
    """Set .requested when SIGTERM/SIGINT arrives; the train loop checks it
    each step and checkpoints before exiting.

    The FIRST signal flips the flag and restores the previous handlers, so a
    second Ctrl-C force-quits instead of being swallowed while the final
    (possibly slow) checkpoint write runs.

    With several processes every rank must poll at the same steps, or some
    ranks keep training while others save and the fleet deadlocks in the
    next collective.  `store`, `rank`, `world_size`: the torch.distributed
    store the ranks agree through and this process's place among them; by
    default those of the default process group once torch.distributed is
    initialized (a test can drive two ranks as two threads on one
    HashStore).

    Each instance agrees under a key prefix of its own,
    `asva/graceful_shutdown/<generation>/`, the generation counted per rank
    in the store (the ranks' k-th instances share k), so a second train
    loop in the same process group never reads a key that an earlier
    loop's rounds left behind (asva_tpu/observability.py:140-199 starts
    every instance at round 0 under one prefix).  `restore()` deletes this
    instance's keys that no peer can still read; the last round's key
    stays, because a slower peer may still be reading it."""

    #: bound on how long a rank waits for its peers' shutdown flags before
    #: raising (instead of hanging forever on a dead peer)
    agreement_timeout_s: float = 600.0

    def __init__(self, store=None, rank: Optional[int] = None,
                 world_size: Optional[int] = None):
        self.requested = False
        self._round = 0      # store agreement round (requested_global)
        self._group = (store, rank, world_size)
        self._prefix = None  # this instance's keys, at its first round
        self._prev = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                self._prev[sig] = signal.signal(sig, self._handler)
            except ValueError:  # not main thread
                pass

    def _handler(self, signum, frame):
        self.requested = True
        self._restore_signals()  # second signal terminates normally

    def _peers(self):
        """(store, rank, world size) when more than one process takes part,
        else None."""
        store, rank, world = self._group
        if store is None:
            import torch.distributed as dist
            if not (dist.is_available() and dist.is_initialized()):
                return None
            store = dist.distributed_c10d._get_default_store()
            rank, world = dist.get_rank(), dist.get_world_size()
        return (store, rank, world) if world > 1 else None

    def poll(self, sync_point: bool = True) -> bool:
        """Checkpoint-worthy shutdown check for train loops.

        One process: the local flag, checked every call.  Several: the
        agreement runs only when `sync_point` is True — pass a condition
        that evaluates identically on every rank (e.g. step % log_steps ==
        0), because all ranks must take part in each round."""
        if self._peers() is None:
            return self.requested
        if not sync_point:
            return False
        return self.requested_global()

    def requested_global(self) -> bool:
        """True iff ANY process got the signal; one process: the local
        flag.  Each round every rank sets `asva/graceful_shutdown/<round>/
        <rank>` in the store and reads every peer's key, waiting at most
        `agreement_timeout_s` for each: a missing peer raises TimeoutError
        instead of hanging (asva_tpu/observability.py:140-199)."""
        peers = self._peers()
        if peers is None:
            return self.requested
        store, rank, world = peers
        if self._prefix is None:
            generation = store.add(
                f"asva/graceful_shutdown/generation/{rank}", 1)
            self._prefix = f"asva/graceful_shutdown/{generation}"
        n = self._round
        self._round += 1
        prefix = f"{self._prefix}/{n}"
        store.set(f"{prefix}/{rank}", "1" if self.requested else "0")
        got = False
        for r in range(world):
            key = f"{prefix}/{r}"
            try:
                store.wait([key], timedelta(seconds=self.agreement_timeout_s))
            except RuntimeError as e:   # DistStoreError: the wait timed out
                raise TimeoutError(
                    f"shutdown agreement round {n}: rank {r} did not "
                    f"publish its flag within {self.agreement_timeout_s}s — "
                    "peer dead or wedged; aborting instead of hanging"
                ) from e
            got = got or store.get(key) == b"1"
        # this rank's key from two rounds back is dead: a rank in round n has
        # read all of round n - 1, which every rank set only after reading
        # all of round n - 2
        if n >= 2:
            store.delete_key(f"{self._prefix}/{n - 2}/{rank}")
        if got:
            self.requested = True
        return got

    def restore(self):
        """Restore the signal handlers and delete this instance's dead
        keys: those of its rounds before the last (a peer that finished
        round n has read all of round n - 1)."""
        self._restore_signals()
        peers = self._peers()
        if peers is not None and self._prefix is not None:
            store, rank, _ = peers
            for n in range(max(0, self._round - 2), self._round - 1):
                store.delete_key(f"{self._prefix}/{n}/{rank}")

    def _restore_signals(self):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
