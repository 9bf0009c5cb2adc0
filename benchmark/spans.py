"""The program's own spans read against the device trace: a fourth segment
of trace.Stretch, a segment of one whole request, and the reducer that
puts each idle gap of the device down to a span of the program
(asva_tpu_torch/observability.py).

SpanStretch runs trace.Stretch's 3n + 1 units unchanged, then n + 1 more:

  unit 3n + 1         a fresh device-only profiler starts, as segment 2's
                      does, and the program's recorder is switched on
                      (`observability.tracing()`), so that the spans open
                      when the span below starts are recorded too;
  units [3n+2, 4n+2)  the span, between mark kernels as in segment 2.  Each
                      idle gap of the device (the span less the union of
                      the device operations) is put down to the innermost
                      program span open at the gap's middle, on the
                      profiler's clock: on each thread the innermost open
                      one, and of the threads' the one opened last (the
                      fused sub-layers' backward runs on autograd's
                      thread).

request_segment runs one more whole generation request between two mark
kernels, device-only profiled with the recorder on: the idle time under
loading, the encoders and the decode, which the UNet calls of the fourth
segment do not reach.

Both segments are bracketed by two calibration points, and the program's
times are mapped onto the trace's clock by the line through them
(`align`).  Each mark kernel's launch is read on the recorder's clock
too: a kernel starts after its launch, so a negative lead after the fit
says the two clocks still disagree there on that rank.

benchmark/run.py does not run them yet: trace.Stretch and the kinds would
take them in a later change of the benchmark.  benchmark/idle_by_span.py
runs a cell with them.  A program without the recorder leaves both
unread (None) and raises nothing.
"""
from __future__ import annotations

import bisect
import json
import os
import statistics
from collections import defaultdict

import torch

from . import trace

SPAN_CAT = "program_span"
COUNTER_CAT = "program_counter"
BYTES = "comm.bytes"
# a unit's idle time under these spans (on any thread): name -> (spans of
# which one must be open, spans of which none may be)
UNDER = {"unet": ({"unet.call"}, set()),
         "sampler": ({"sampler.step"}, set()),
         "forward": ({"train.grad_step"}, {"train.backward"}),
         "backward": ({"train.backward"}, set()),
         "optim": ({"train.apply_step"}, set())}


def _innermost(spans, mids):
    """For each gap middle (sorted), the id of the innermost span of one
    thread's nested spans (sorted by start) open there, else -1."""
    out, stack, j = [], [], 0
    for m in mids:
        while j < len(spans) and spans[j][0] <= m:
            while stack and stack[-1][1] <= spans[j][0]:
                stack.pop()
            stack.append(spans[j])
            j += 1
        while stack and stack[-1][1] <= m:
            stack.pop()
        out.append(stack[-1][2] if stack else -1)
    return out


def reduce_spans(events, units: int):
    """From a device-only trace with the program's spans and counters
    merged in (`Record.trace_events` in the trace's frame): the span's
    device numbers (trace.reduce_device) and the idle gaps by span, in
    seconds.  None where the device part reads nothing or no program span
    lies in the span.

    idle_by_span: [[innermost span name or "none", seconds]], largest
    first; within: the same of every span open over a gap, its children
    included; covered_s: the idle time under some span; under: {UNDER key:
    [seconds a unit]}; unet_host_s: each unet.call span's host duration
    that starts in the span; comm_bytes: comm.bytes added in each unit."""
    device = trace.reduce_device(events, units)
    if device is None:
        return None
    xs = trace._complete(events)
    dev = trace._device(xs)
    marks = sorted((e for e in dev if trace._is_mark(e)),
                   key=lambda e: float(e["ts"]))
    edges = ([float(marks[0]["ts"]) + float(marks[0]["dur"])]
             + [float(m["ts"]) for m in marks[1:]])
    s0, s1 = edges[0], edges[-1]
    busy = trace._busy([e for e in dev if not trace._is_mark(e)
                        and s0 <= float(e["ts"]) < s1], s0, s1)
    gaps = sorted(((a + b) / 2, b - a) for a, b in zip(
        [s0] + [e for _, e in busy], [s for s, _ in busy] + [s1]) if b > a)
    mids = [m for m, _ in gaps]

    spans = {}
    threads = defaultdict(list)
    for e in xs:
        if e.get("cat") == SPAN_CAT:
            i = e["args"]["id"]
            start = float(e["ts"])
            end = start + float(e["dur"])
            spans[i] = (e["name"], start, end, e["args"]["parent"])
            threads[e.get("tid")].append((start, end, i))
    if not any(start < s1 and end > s0 for _, start, end, _
               in spans.values()):
        return None
    inner = []
    for ranges in threads.values():
        ranges.sort(key=lambda r: (r[0], -r[1]))    # a parent first
        inner.append(_innermost(ranges, mids))

    chains = {}

    def chain(i):
        """The names of span i and its ancestors on its thread."""
        if i not in chains:
            name, _, _, parent = spans[i]
            chains[i] = ({name} | chain(parent) if parent in spans
                         else {name})
        return chains[i]

    by_name, within = defaultdict(float), defaultdict(float)
    under = {k: [0.0] * units for k in UNDER}
    covered = 0.0
    for g, (m, width) in enumerate(gaps):
        open_ids = [ids[g] for ids in inner if ids[g] >= 0]
        width *= 1e-6
        if not open_ids:
            by_name["none"] += width
            continue
        covered += width
        last = max(open_ids, key=lambda i: spans[i][1])
        by_name[spans[last][0]] += width
        names = set().union(*(chain(i) for i in open_ids))
        for name in names:
            within[name] += width
        unit = min(bisect.bisect_right(edges, m) - 1, units - 1)
        for key, (need, forbid) in UNDER.items():
            if names & need and not names & forbid:
                under[key][unit] += width

    host = [float(e["dur"]) * 1e-6 for e in xs
            if e.get("cat") == SPAN_CAT and e["name"] == "unet.call"
            and s0 <= float(e["ts"]) < s1]
    comm = [0] * units
    last_total = 0
    for e in sorted((e for e in events if e.get("cat") == COUNTER_CAT
                     and e.get("name") == BYTES),
                    key=lambda e: float(e["ts"])):
        total = int(e["args"][BYTES])
        t = float(e["ts"])
        if s0 <= t < s1:
            comm[bisect.bisect_right(edges, t) - 1] += total - last_total
        last_total = total
    return dict(device, idle_by_span=_largest_first(by_name),
                within=_largest_first(within), covered_s=covered,
                under=under, unet_host_s=host, comm_bytes=comm)


def _largest_first(seconds: dict) -> list:
    return sorted(([n, s] for n, s in seconds.items()), key=lambda kv: -kv[1])


def mark_leads(events, launches_us) -> list:
    """Each mark kernel's start less its launch (on the trace's clock, in
    us), in order ([] where their counts differ).  At or above 0 wherever
    the two clocks agree: a kernel starts after its launch."""
    marks = sorted(float(e["ts"]) for e in _spins(events))
    if len(marks) != len(launches_us):
        return []
    return [m - t for m, t in zip(marks, launches_us)]


def _spins(events):
    return [e for e in trace._device(trace._complete(events))
            if trace._is_mark(e)]


def align(events, record, base_ns: int, points, launches):
    """A segment's trace and the program's record on one clock.

    The record's times (Unix ns from perf_counter_ns) and the trace's
    (CUPTI's device timestamps) can start a millisecond apart and drift by
    up to about a hundred ppm (H100 hosts, torch 2.11).  So each segment
    is bracketed by two calibration points (`_calibrate`): a mark kernel
    on an idle card, whose end the recorder's clock reads a few us later,
    when the synchronize after it returns.  The recorder's times are
    mapped by the line through the two (offset and rate).  Where the
    clocks wander between the points, as they did by milliseconds during
    training on those hosts, the marks' leads (`mark_leads`) show it.

    Returns (the device events less the two calibration kernels, the
    program's events, the marks' launches in us, the fit), all on the
    trace's clock; without both points and their kernels the events as
    they are, the record's unmapped and the fit None."""
    mine = record.trace_events(base_ns)
    launch_us = [(t - base_ns) / 1e3 for t in launches]
    spins = sorted(_spins(events), key=lambda e: float(e["ts"]))
    if len(points) != 2 or len(spins) != len(launches) + 2:
        return events, mine, launch_us, None
    cal = (spins[0], spins[-1])
    h = [(t - base_ns) / 1e3 for t in points]
    k = [float(e["ts"]) + float(e["dur"]) for e in cal]
    rate = (k[1] - k[0]) / (h[1] - h[0])

    def at(x):
        return k[0] + (x - h[0]) * rate
    events = [e for e in events if e is not cal[0] and e is not cal[1]]
    out = []
    for e in mine:
        e = dict(e, ts=at(e["ts"]))
        if "dur" in e:
            e["dur"] *= rate
        out.append(e)
    fit = {"offset_us": k[0] - h[0], "drift_ppm": (rate - 1) * 1e6,
           "over_s": (h[1] - h[0]) * 1e-6}
    return events, out, [at(x) for x in launch_us], fit


def _stop_and_read(R, prof, name: str):
    """Stop a device-only profiler after the device is done; its trace's
    events and baseTimeNanoseconds (the frame the program's spans go
    in)."""
    R.sync()
    prof.stop()
    path = os.path.join(R.tmpdir, name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    os.remove(path)
    return data["traceEvents"], int(data.get("baseTimeNanoseconds", 0))


# the profiler's first launches, before a segment's first calibration point
LEAD_LAUNCHES = 64


def _calibrate(R, record, points: list):
    """One calibration point of `align` on a card: after a few launches
    (the profiler's first), a mark kernel between synchronizes, and the
    recorder's clock read when the second returns."""
    if torch.device(R.device).type != "cuda":
        return
    lead = torch.zeros(1, device=R.device)
    for _ in range(LEAD_LAUNCHES):
        lead.add_(1)
    R.sync()
    torch.cuda._sleep(trace.MARK_CYCLES)
    R.sync()
    points.append(record.now_ns())


def _launch_mark(R, record, launches: list):
    """A mark kernel on a card, its launch time on the recorder's clock
    kept in `launches`."""
    if torch.device(R.device).type == "cuda":
        launches.append(record.now_ns())
        torch.cuda._sleep(trace.MARK_CYCLES)


def read_segment(R, what: str, events, record, base_ns: int, units: int,
                 points, launches):
    """A segment's trace and record aligned (`align`) and reduced
    (`reduce_spans`), or None; the log gets the fit, the marks' leads
    before and after it, and, where it read nothing, what it held."""
    events, mine, launch_us, fit = align(events, record, base_ns, points,
                                         launches)
    raw = mark_leads(events, [(t - base_ns) / 1e3 for t in launches])
    leads = mark_leads(events, launch_us)
    R.log(f"{what}: clock fit {fit}; the marks start "
          f"{min(raw, default=None)}..{max(raw, default=None)} us after "
          f"their launches on the recorder's clock, "
          f"{[round(x, 1) for x in leads]} us after the fit")
    got = reduce_spans(events + mine, units)
    if got is None:
        spans = [e["ts"] for e in mine if e["cat"] == SPAN_CAT]
        marks = sorted(float(e["ts"]) for e in _spins(events))
        R.log(f"{what} read nothing: {len(marks)} mark kernels for {units}"
              f" units" + (f" at {marks[0]}..{marks[-1]} us" if marks else "")
              + f", {len(spans)} closed spans of the program"
              + (f" at {min(spans)}..{max(spans)} us" if spans else "")
              + f", {len(events)} trace events")
        return None
    return got


def figures(s: dict) -> dict:
    """The per-layer numbers of a reduced segment (None where it holds
    nothing of them): milliseconds are medians over the units."""
    def ms(values):
        return 1e3 * statistics.median(values) if values else None

    def ms_under(key, needs):
        return ms(s["under"][key]) if needs else None
    gen = bool(s["unet_host_s"])
    train = any(s["under"]["optim"]) or any(s["under"]["forward"])
    rates = [b / t * 1e-9 for b, t in zip(s["comm_bytes"], s["nccl_unit_s"])
             if b > 0 and t > 0]
    return {"unet_host_ms.gen": ms(s["unet_host_s"]),
            "unet_idle_ms.gen": ms_under("unet", gen),
            "sampler_idle_ms.gen": ms_under("sampler", gen),
            "forward_idle_ms.train": ms_under("forward", train),
            "backward_idle_ms.train": ms_under("backward", train),
            "optim_idle_ms.train": ms_under("optim", train),
            "allreduce_gbps.train": (statistics.median(rates) if rates
                                     else None)}


def _across_ranks(s, R, n: int):
    """trace._across_ranks for the span, the busy time and the NCCL time;
    the ranks' mean of the idle times and host spans; each rank's
    comm.bytes a unit kept as `comm_bytes_ranks`.  None on every rank
    where any rank read nothing."""
    s = trace._across_ranks(s, R, n)
    if s is None or R.world == 1:
        return None if s is None else dict(s, comm_bytes_ranks=[
            s["comm_bytes"]])
    import torch.distributed as dist
    got = [None] * R.world
    dist.all_gather_object(got, s)

    def mean(values):
        return sum(values) / R.world

    def mean_by_name(key):
        names = {name for g in got for name, _ in g[key]}
        return _largest_first({name: mean([dict(g[key]).get(name, 0.0)
                                           for g in got]) for name in names})
    return dict(
        s, covered_s=mean([g["covered_s"] for g in got]),
        idle_by_span=mean_by_name("idle_by_span"),
        within=mean_by_name("within"),
        under={k: [mean([g["under"][k][u] for g in got]) for u in range(n)]
               for k in UNDER},
        unet_host_s=[mean(v) for v in zip(*(g["unet_host_s"] for g in got))],
        comm_bytes_ranks=[g["comm_bytes"] for g in got])


def _log_table(R, spans: dict):
    for name, s in spans["idle_by_span"]:
        R.log(f"  idle under {name}: {s} s")
    for name, s in spans["within"]:
        R.log(f"  idle within {name} (its children included): {s} s")


class SpanStretch(trace.Stretch):
    """trace.Stretch and a fourth segment of n units read with the
    program's spans (module docstring)."""

    def __init__(self, R, n: int, subs, tag: str):
        super().__init__(R, n, subs, tag)
        self.spans = None
        self._tracing = self._record = None
        self._points, self._launches = [], []

    @property
    def done(self) -> bool:
        return self.b > 4 * self.n + 2

    def boundary(self):
        b, n = self.b, self.n
        if self.done:
            return
        if b <= 3 * n + 1:
            super().boundary()
            if b == 3 * n + 1:
                self.prof = trace.profiler(host=False)
                self.prof.start()
                self._trace_on()
                if self._record is not None:
                    _calibrate(self.R, self._record, self._points)
            return
        if self._record is not None:
            _launch_mark(self.R, self._record, self._launches)
        if b == 4 * n + 2:
            record = self._trace_off()
            if record is not None:
                _calibrate(self.R, record, self._points)
            events, base_ns = _stop_and_read(
                self.R, self.prof, f"trace_{self.tag}{self.R.rank}s.json")
            self.prof = None
            if record is None:
                self.R.log("the fourth segment: the program has no recorder")
            else:
                self.spans = read_segment(
                    self.R, "the fourth segment", events, record, base_ns,
                    n, self._points, self._launches)
        self.b += 1

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

    def result(self):
        """trace.Stretch.result, with the fourth segment's figures in the
        summary (`span_figures`), its idle time by span in the breakdown
        (`idle_by_span`, the top 10) and its tables in the log."""
        self._trace_off()            # the work ended inside segment 4
        summary, breakdown = super().result()
        if summary is None:
            return summary, breakdown
        spans = _across_ranks(self.spans, self.R, self.n)
        if spans is None:
            self.R.log("the fourth segment read no program span")
            return summary, breakdown
        idle = spans["window_s"] - spans["busy_s"]
        on_cost = spans["window_s"] / summary["window_s"]
        coverage = spans["covered_s"] / idle if idle > 0 else None
        got = figures(spans)
        self.R.log(
            f"fourth segment, {self.n} units with the program's spans: "
            f"span {spans['window_s']} s, {on_cost} of the second "
            f"segment's {summary['window_s']} s; busy {spans['busy_s']} s, "
            f"idle {idle} s, under a program span {spans['covered_s']} s "
            f"({coverage} of the idle time); comm.bytes a unit by rank "
            f"{spans['comm_bytes_ranks']}")
        _log_table(self.R, spans)
        self.R.log(f"span figures: {got}")
        summary = dict(summary, span_figures=got)
        breakdown = dict(breakdown,
                         idle_by_span=spans["idle_by_span"][:10])
        return summary, breakdown


def request_segment(R, request, index: int):
    """One more whole request, `request(index)`, between two mark kernels,
    device-only profiled with the recorder on (module docstring).  The
    segment reduced as one unit (`read_segment`), or None where the
    program has no recorder or the segment read nothing; its tables go to
    the log."""
    from asva_tpu_torch import observability
    tracing = getattr(observability, "tracing", None)
    if tracing is None:
        R.log("the request segment: the program has no recorder")
        return None
    prof = trace.profiler(host=False)
    prof.start()
    points, launches = [], []
    with tracing() as record:
        _calibrate(R, record, points)
        _launch_mark(R, record, launches)
        request(index)
        _launch_mark(R, record, launches)
        _calibrate(R, record, points)
    events, base_ns = _stop_and_read(R, prof, f"trace_req{R.rank}.json")
    got = read_segment(R, "the request segment", events, record, base_ns,
                       1, points, launches)
    if got is None:
        return None
    idle = got["window_s"] - got["busy_s"]
    R.log(f"request segment, one request with the program's spans: span "
          f"{got['window_s']} s, busy {got['busy_s']} s, idle {idle} s, "
          f"under a program span {got['covered_s']} s "
          f"({got['covered_s'] / idle if idle > 0 else None} of the idle "
          f"time)")
    _log_table(R, got)
    return got


def with_request_segment(stretch):
    """kinds/generate.py's `stretch`, then request_segment on the same
    request index; the breakdown gains `request_idle_by_span` (the top
    10)."""
    def call(R, pipe, fused, request, index, first, n):
        summary, breakdown = stretch(R, pipe, fused, request, index, first,
                                     n)
        got = request_segment(R, request, index)
        if breakdown is not None and got is not None:
            breakdown = dict(breakdown,
                             request_idle_by_span=got["idle_by_span"][:10])
        return summary, breakdown
    return call
