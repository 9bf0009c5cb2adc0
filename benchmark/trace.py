"""The profiled stretches of a cell's own work and what the per-layer
readers take from them.

A kind reports the boundaries of its units of work (UNet calls, optimizer
steps) to a `Stretch` of n units, which runs over 4n + 2 units in four
segments:

  units [0, n)        unprofiled, between CUDA events: the device-clock
                      time of n units without the profiler, which the
                      profiled span is held against in the run's log;
  unit n              the device-only profiler starts: its set-up and its
                      first launches fall here, outside the span;
  units [n+1, 2n+1)   the span.  A mark kernel at each boundary
                      (`torch.cuda._sleep`'s spin_kernel, which the
                      program never launches) places the span and each
                      unit on the trace's own clock: from the end of the
                      first mark to the start of the last.  The profiler
                      stops after a synchronize past the last mark, so
                      neither its start nor its flush lies in the span.
                      Read: the busy time (union of the device
                      operations' intervals), the launches, the device
                      time by operation, the NCCL kernels' time per unit;
  units [2n+1, 3n+1)  the host profiler (CPU and CUDA) inside the range
                      "bench.stretch": the fused sub-layers' ranges and
                      what the host was inside during each idle gap,
                      under the profiler's own load;
  unit 3n+1           a fresh device-only profiler starts and the
                      program's recorder is switched on
                      (`observability.tracing()`);
  units [3n+2, 4n+2)  the fourth segment, between mark kernels as in the
                      second and bracketed by two calibration points
                      (`spans.align`): each idle gap of the device put
                      down to the program's spans (benchmark/spans.py).
                      Where it reads nothing on some rank, every rank
                      takes it again over the next n + 1 units, twice at
                      most.

Segments 1-3 come first, so the program's recorder is off in all of them.
A generation run reads one more whole request in the same way
(`spans.request_segment`).  An untraced run takes no stretch.

On several ranks every rank profiles the same units; the busy time and
the span are their means, and each unit's NCCL time the least over the
ranks: the rank that reaches a collective last waits for no other, so
its kernels time the exchange alone.
"""
from __future__ import annotations

import bisect
import json
import os
from collections import defaultdict

import torch

from . import spans
from .harness import Timer

STRETCH = "bench.stretch"
MARK = "spin_kernel"          # torch.cuda._sleep's kernel
MARK_CYCLES = 1000
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the autograd nodes of the fused sub-layers' backward (ops/fused.py)
SUBLAYER_BACKWARD = ("_LnAttnBackward", "_LnAttn3Backward",
                     "_LnGegluBackward")


def profiler(host: bool):
    """A profiler of the device's operations and, with `host`, of the host's
    operations and ranges too (which slows the host several fold)."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host or not torch.cuda.is_available():   # (a rehearsal on the CPU)
        acts.append(torch.profiler.ProfilerActivity.CPU)
    return torch.profiler.profile(activities=acts)


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def _complete(events):
    return [e for e in events if e.get("ph") == "X"]


def _device(xs):
    return [e for e in xs if e.get("cat") in DEVICE_CATS]


def _is_mark(e) -> bool:
    return e.get("cat") == "kernel" and MARK in e["name"]


def _busy(dev, s0, s1):
    """The union of the device operations' intervals, cut to [s0, s1]."""
    return _union([(max(float(e["ts"]), s0),
                    min(float(e["ts"]) + float(e["dur"]), s1)) for e in dev
                   if float(e["ts"]) < s1
                   and float(e["ts"]) + float(e["dur"]) > s0])


def reduce_device(events, units: int) -> dict:
    """The span's numbers from a device-only trace (times in seconds), or
    None where it holds other than `units` + 1 marks or no kernel between
    them."""
    dev = _device(_complete(events))
    marks = sorted((e for e in dev if _is_mark(e)),
                   key=lambda e: float(e["ts"]))
    if len(marks) != units + 1:
        return None
    edges = ([float(marks[0]["ts"]) + float(marks[0]["dur"])]
             + [float(m["ts"]) for m in marks[1:]])
    s0, s1 = edges[0], edges[-1]
    dev = [e for e in dev if not _is_mark(e)
           and s0 <= float(e["ts"]) < s1]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    if not kernels:
        return None
    busy = _busy(dev, s0, s1)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += float(e["dur"]) * 1e-6
    nccl = [0.0] * (len(edges) - 1)
    for k in kernels:
        if "nccl" in k["name"].lower():
            unit = bisect.bisect_right(edges, float(k["ts"])) - 1
            nccl[unit] += float(k["dur"]) * 1e-6
    ops_top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"window_s": (s1 - s0) * 1e-6,
            "busy_s": sum(e - s for s, e in busy) * 1e-6,
            "launches": len(kernels), "units": len(edges) - 1,
            "nccl_unit_s": nccl,
            "device_ops": [[n, s] for n, s in ops_top]}


def reduce_host(events) -> dict:
    """From a trace with the host's ranges, inside the "bench.stretch"
    range: the idle gaps by the innermost host range around each, and the
    device time of the kernels launched inside the fused sub-layers'
    ranges and their autograd backward nodes.  None without the range."""
    xs = _complete(events)
    stretch = [e for e in xs if e.get("name") == STRETCH]
    if not stretch:
        return None
    s0 = float(stretch[0]["ts"])
    s1 = s0 + float(stretch[0]["dur"])
    dev = [e for e in _device(xs) if s0 <= float(e["ts"]) < s1]
    kernels = [e for e in dev if e.get("cat") == "kernel"]
    busy = _busy(dev, s0, s1)

    host = [e for e in xs if e.get("cat") in ("cpu_op", "user_annotation")]
    runtime = {e["args"]["correlation"]: (float(e["ts"]), e.get("tid"))
               for e in xs if e.get("cat") in ("cuda_runtime", "cuda_driver")
               and "correlation" in e.get("args", {})}

    # each idle gap, named by the innermost host range around its middle:
    # on each thread a sweep over its nested ranges, and of the threads'
    # innermost ranges the one that opened last
    edges = list(zip([s0] + [e for _, e in busy], [s for s, _ in busy] + [s1]))
    mids = sorted(((a + b) / 2, b - a) for a, b in edges if b > a)
    inner = [(-1.0, "none")] * len(mids)
    threads = defaultdict(list)
    for e in host:
        if e["name"] != STRETCH:
            threads[e.get("tid")].append((float(e["ts"]), -float(e["dur"]),
                                          e["name"]))
    for ranges in threads.values():
        ranges.sort()
        stack, j = [], 0

        def resolve(upto):
            nonlocal j
            while j < len(mids) and mids[j][0] < upto:
                while stack and stack[-1][0] < mids[j][0]:
                    stack.pop()
                if stack and stack[-1][1] > inner[j][0]:
                    inner[j] = (stack[-1][1], stack[-1][2])
                j += 1
        for ts, neg_dur, name in ranges:
            resolve(ts)
            while stack and stack[-1][0] <= ts:
                stack.pop()
            stack.append((ts - neg_dur, ts, name))
        resolve(float("inf"))
    gaps = defaultdict(float)
    for (_, width), (_, name) in zip(mids, inner):
        gaps[f"host:{name}"] += width * 1e-6

    launches = []
    for k in kernels:
        launch = runtime.get(k.get("args", {}).get("correlation"))
        if launch is not None:
            launches.append((launch, float(k["dur"]) * 1e-6))

    def in_ranges(pred, skip=frozenset()):
        """Indices and device seconds of the kernels launched inside host
        ranges whose name satisfies pred (ranges that do not overlap on
        one thread), and how many such ranges there are."""
        ranges = defaultdict(list)
        for e in host:
            if pred(e["name"]):
                ranges[e.get("tid")].append(
                    (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
        for rs in ranges.values():
            rs.sort()
        hit, total = set(), 0.0
        for i, ((ts, tid), dur) in enumerate(launches):
            rs = ranges.get(tid)
            if not rs or i in skip:
                continue
            r = bisect.bisect_right(rs, (ts, float("inf"))) - 1
            if r >= 0 and rs[r][1] >= ts:
                hit.add(i)
                total += dur
        return hit, total, sum(len(r) for r in ranges.values())

    fwd, fwd_s, fwd_ranges = in_ranges(
        lambda n: n.startswith("bench.sublayer."))
    _, bwd_s, bwd_ranges = in_ranges(
        lambda n: n.startswith("autograd::engine::evaluate_function")
        and any(b in n for b in SUBLAYER_BACKWARD), skip=fwd)
    gap_top = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"sublayer_fwd_s": fwd_s, "sublayer_fwd_ranges": fwd_ranges,
            "sublayer_bwd_s": bwd_s, "sublayer_bwd_ranges": bwd_ranges,
            "idle_gaps": [[n, s] for n, s in gap_top]}


def stop_and_read(R, prof, name: str):
    """Stop a profiler after the device is done, and read its trace at once
    (before the next profiler starts): its events and its
    baseTimeNanoseconds, the frame the program's spans go in."""
    R.sync()
    prof.stop()
    path = os.path.join(R.tmpdir, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    os.remove(path)
    return data["traceEvents"], int(data.get("baseTimeNanoseconds", 0))


class Stretch:
    """The four segments over 4n + 2 units of work (module docstring).  The
    kind calls `boundary()` before every unit and once after the last, and
    then `result()`; `subs` (sublayers.Sublayers, active) records during
    the host profile."""

    def __init__(self, R, n: int, subs, tag: str):
        self.R, self.n, self.subs, self.tag = R, n, subs, tag
        self.b = 0
        self.unprofiled = Timer(R.device)
        self.prof = self.range = None
        self.device = self.host = self.spans = None
        self._tracing = self._record = None
        self._points, self._launches = [], []
        self.retries = 2

    @property
    def done(self) -> bool:
        return self.b > 4 * self.n + 2

    def boundary(self):
        b, n = self.b, self.n
        if self.done:
            return
        if b == 0:
            self.unprofiled.start()
        if b == n:
            self.unprofiled.stop()
            self.prof = profiler(host=False)
            self.prof.start()
        if n + 1 <= b <= 2 * n + 1 and self.unprofiled.cuda:
            torch.cuda._sleep(MARK_CYCLES)
        if b == 2 * n + 1:
            self.device = reduce_device(self._stop("d"), n)
            self.prof = profiler(host=True)
            self.prof.start()
            self.range = torch.profiler.record_function(STRETCH)
            self.range.__enter__()
            self.subs.recording = True
        if b == 3 * n + 1:
            self.host = reduce_host(self._stop("h"))
            self._start_fourth()
        if b > 3 * n + 1 and self._record is not None:
            spans._launch_mark(self.R, self._record, self._launches)
        if b == 4 * n + 2:
            self._read_fourth()
            if self.retries and not _on_every_rank(self.spans is not None,
                                                   self.R):
                # again over the next n + 1 units; this one is the
                # fresh profiler's first
                self.retries -= 1
                self.R.log("the fourth segment again")
                self._start_fourth()
                self.b = 3 * n + 2
                return
        self.b += 1

    def _start_fourth(self):
        self.prof = profiler(host=False)
        self.prof.start()
        self._trace_on()
        self._points, self._launches = [], []
        if self._record is not None:
            spans._calibrate(self.R, self._record, self._points)

    def _stop(self, which: str):
        """Stop the running profiler after the device is done; its trace's
        events."""
        if self.range is not None:
            self.R.sync()
            self.subs.recording = False
            self.range.__exit__(None, None, None)
            self.range = None
        events, _ = stop_and_read(
            self.R, self.prof, f"trace_{self.tag}{self.R.rank}{which}.json")
        self.prof = None
        return events

    def _trace_on(self):
        from asva_tpu_torch import observability
        tracing = getattr(observability, "tracing", None)
        if tracing is not None:
            self._tracing = tracing()
            self._record = self._tracing.__enter__()

    def _trace_off(self):
        record, self._record = self._record, None
        if self._tracing is not None:
            self._tracing.__exit__(None, None, None)
            self._tracing = None
        return record

    def _read_fourth(self):
        record = self._trace_off()
        if record is not None:
            spans._calibrate(self.R, record, self._points)
        events, base_ns = stop_and_read(
            self.R, self.prof, f"trace_{self.tag}{self.R.rank}s.json")
        self.prof = None
        if record is None:
            self.R.log("the fourth segment: the program has no recorder")
        else:
            self.spans = spans.read_segment(
                self.R, "the fourth segment", events, record, base_ns,
                self.n, self._points, self._launches)

    def result(self):
        """(summary for the readers, the fourth segment reduced with the
        program's spans, breakdown for the result line); the first and the
        last are None where a profile of segments 2-3 read nothing, the
        second where the fourth read nothing.  On several ranks every rank
        has to call it."""
        self._trace_off()                # the work ended inside segment 4
        if self.prof is not None:        # the work ended inside a profile
            self._stop("x")
        summary = None
        if self.device is not None and self.host is not None:
            summary = dict(self.host, **self.device)
            summary["unprofiled_s"] = self.unprofiled.ms()[0] * 1e-3
            summary.update(
                sublayer_bound_s=self.subs.fwd_s + self.subs.bwd_s,
                sublayer_graphs=self.subs.graphs,
                sublayer_calls=sum(self.subs.calls.values()))
        summary = _across_ranks(summary, self.R, self.n)
        if summary is None:
            self.R.log("the profiled stretch read nothing")
            return None, None, None
        self.R.log(f"stretch of {self.n} units: span {summary['window_s']} s "
                   f"profiled, {summary['unprofiled_s']} s unprofiled "
                   f"(CUDA events), busy {summary['busy_s']} s, NCCL a unit "
                   f"{summary['nccl_unit_s']} s")
        breakdown = {"device_ops": summary["device_ops"],
                     "idle_gaps": summary["idle_gaps"]}
        got = spans._across_ranks(self.spans, self.R, self.n)
        if got is None:
            self.R.log("the fourth segment read no program span")
            return summary, None, breakdown
        spans.log_segment(self.R, f"fourth segment, {self.n} units", got,
                          summary["window_s"])
        breakdown["idle_by_span"] = got["idle_by_span"][:10]
        return summary, got, breakdown


def _on_every_rank(flag: bool, R) -> bool:
    """Whether `flag` holds on every rank."""
    if R.world == 1:
        return flag
    import torch.distributed as dist
    t = torch.tensor([float(flag)], device=R.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())


def _across_ranks(summary, R, n: int):
    """The ranks' mean busy time and span, and each unit's least NCCL
    time; None on every rank where any rank read nothing."""
    if R.world == 1:
        return summary
    import torch.distributed as dist
    nan = float("nan")
    total = torch.tensor([summary["busy_s"], summary["window_s"]]
                         if summary else [nan, nan], dtype=torch.float64,
                         device=R.device)
    least = torch.tensor(summary["nccl_unit_s"] if summary else [nan] * n,
                         dtype=torch.float64, device=R.device)
    dist.all_reduce(total)
    dist.all_reduce(least, op=dist.ReduceOp.MIN)
    # a rank that read nothing leaves NaN in the sum
    if summary is None or not torch.isfinite(total).all():
        return None
    summary = dict(summary, nccl_unit_s=least.tolist())
    summary["busy_s"], summary["window_s"] = (total / R.world).tolist()
    return summary
