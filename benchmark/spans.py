"""The program's own spans read against the device trace: the reducer that
puts each idle gap of the device down to the spans of the program
(asva_tpu_torch/observability.py) open over it, the clock fit it needs,
and the segment of one whole generation request.

trace.Stretch runs the fourth segment of every traced run with these
(trace.py's docstring): its units are device-only profiled between mark
kernels with the program's recorder on, and each idle gap of the device
(the span less the union of the device operations) is put down to the
program's spans open at one instant, on the profiler's clock: on each
thread the innermost open one, and of the threads' the one opened last
(the fused sub-layers' backward runs on autograd's thread).  The instant
is the gap's middle where the card waited for the host to launch the
operation that ends the gap, and that launch where the operation was
queued before the gap began (a card ahead of its host: the gap lies
between operations that those spans sent).  The reduced segment, the
ranks merged, is the `Record`'s `spans`, which the per-layer readers
read (`idle_ms`).

request_segment runs one more whole generation request between two mark
kernels, device-only profiled with the recorder on: the idle time under
loading, the encoders and the decode, which the UNet calls of the fourth
segment do not reach (the `Record`'s `request_spans`).

Both segments are bracketed by two calibration points, and the program's
times are mapped onto the trace's clock by the line through them
(`align`).  Each mark kernel's launch is read on the recorder's clock
too: a kernel starts after its launch, so a negative lead after the fit
says the two clocks still disagree there on that rank.  A program without
the recorder leaves both unread (None) and raises nothing.
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

import torch

from . import trace

SPAN_CAT = "program_span"
COUNTER_CAT = "program_counter"
LAUNCHES = ("cuda_runtime", "cuda_driver")    # a launch's host event


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
    first; within: {name: [seconds a unit]}, the idle time under each
    span, its children included; covered_s: the idle time under some
    span; queued_s: the idle time before operations launched before it
    began, put down at their launch; host_s: {name: [host seconds of each
    span of that name that starts in the span]}; counts: {counter: [added
    in each unit]}."""
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
    # each gap at its middle, or at the launch of the operation that ends
    # it where that came before the gap began (module docstring)
    launched = {e["args"]["correlation"]: float(e["ts"]) for e in xs
                if e.get("cat") in LAUNCHES
                and "correlation" in e.get("args", {})}
    starts = {}
    for e in dev:
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is not None:
            ts = float(e["ts"])
            starts[ts] = min(t, starts.get(ts, t))
    gaps = []                   # (middle, width, the launch or None)
    for a, b in zip([s0] + [e for _, e in busy], [s for s, _ in busy] + [s1]):
        if b > a:
            t = starts.get(b)
            gaps.append(((a + b) / 2, b - a,
                         t if t is not None and t < a else None))
    at = [m if t is None else t for m, _, t in gaps]
    order = sorted(range(len(gaps)), key=at.__getitem__)
    at = [at[g] for g in order]

    spans = {}
    threads = defaultdict(list)
    host = defaultdict(list)
    for e in xs:
        if e.get("cat") == SPAN_CAT:
            i = e["args"]["id"]
            start = float(e["ts"])
            end = start + float(e["dur"])
            spans[i] = (e["name"], start, end, e["args"]["parent"])
            threads[e.get("tid")].append((start, end, i))
            if s0 <= start < s1:
                host[e["name"]].append(float(e["dur"]) * 1e-6)
    if not any(start < s1 and end > s0 for _, start, end, _
               in spans.values()):
        return None
    inner = []
    for ranges in threads.values():
        ranges.sort(key=lambda r: (r[0], -r[1]))    # a parent first
        ids = [-1] * len(gaps)
        for g, i in zip(order, _innermost(ranges, at)):
            ids[g] = i
        inner.append(ids)

    chains = {}

    def chain(i):
        """The names of span i and its ancestors on its thread."""
        if i not in chains:
            name, _, _, parent = spans[i]
            chains[i] = ({name} | chain(parent) if parent in spans
                         else {name})
        return chains[i]

    by_name = defaultdict(float)
    within = defaultdict(lambda: [0.0] * units)
    covered = queued = 0.0
    for g, (m, width, t) in enumerate(gaps):
        open_ids = [ids[g] for ids in inner if ids[g] >= 0]
        width *= 1e-6
        if t is not None:
            queued += width
        if not open_ids:
            by_name["none"] += width
            continue
        covered += width
        last = max(open_ids, key=lambda i: spans[i][1])
        by_name[spans[last][0]] += width
        unit = min(bisect.bisect_right(edges, m) - 1, units - 1)
        for name in set().union(*(chain(i) for i in open_ids)):
            within[name][unit] += width

    counts = defaultdict(lambda: [0] * units)
    last_total = defaultdict(int)
    for e in sorted((e for e in events if e.get("cat") == COUNTER_CAT),
                    key=lambda e: float(e["ts"])):
        name, t = e["name"], float(e["ts"])
        total = int(e["args"][name])
        if s0 <= t < s1:
            counts[name][bisect.bisect_right(edges, t) - 1] += (
                total - last_total[name])
        last_total[name] = total
    return dict(device, idle_by_span=_largest_first(by_name),
                within=dict(within), covered_s=covered, queued_s=queued,
                host_s=dict(host), counts=dict(counts))


def idle_ms(segment, name: str, less: str = None):
    """The median over a reduced segment's units of the idle milliseconds
    under the span `name`, its children included, less those under
    `less`; None where the segment was not read or no span `name` starts
    in it."""
    if segment is None or name not in segment["host_s"]:
        return None
    zero = [0.0] * segment["units"]
    total = segment["within"].get(name, zero)
    part = segment["within"].get(less, zero) if less else zero
    return 1e3 * statistics.median(a - b for a, b in zip(total, part))


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
              f" units and 2 calibration points at {marks} us, launched at "
              f"{launch_us} us, the points at "
              f"{[(t - base_ns) / 1e3 for t in points]} us"
              + f", {len(spans)} closed spans of the program"
              + (f" at {min(spans)}..{max(spans)} us" if spans else "")
              + f", {len(events)} trace events")
        return None
    R.log(f"{what}: counters added a unit {got['counts']}")
    return got


def _across_ranks(s, R, n: int):
    """trace._across_ranks for the span, the busy time and the NCCL time;
    the ranks' mean of the idle times and host spans; this rank's counts
    (its log has them).  None on every rank where any rank read nothing."""
    s = trace._across_ranks(s, R, n)
    if s is None or R.world == 1:
        return s
    import torch.distributed as dist
    got = [None] * R.world
    dist.all_gather_object(got, s)

    def mean(values):
        return sum(values) / R.world

    def names(key):
        return {name for g in got for name in dict(g[key])}
    zero = [0.0] * n
    return dict(
        s, covered_s=mean([g["covered_s"] for g in got]),
        queued_s=mean([g["queued_s"] for g in got]),
        idle_by_span=_largest_first({
            name: mean([dict(g["idle_by_span"]).get(name, 0.0)
                        for g in got]) for name in names("idle_by_span")}),
        within={name: [mean([g["within"].get(name, zero)[u] for g in got])
                       for u in range(n)] for name in names("within")},
        host_s={name: [mean(v) for v in zip(*(g["host_s"].get(name, [])
                                              for g in got))]
                for name in names("host_s")})


def log_segment(R, what: str, s: dict, second_s: float = None):
    """A reduced segment's span, idle time and its share under a program
    span, and its tables, in the log; with `second_s`, the span over the
    second segment's (the recorder's on-cost)."""
    idle = s["window_s"] - s["busy_s"]
    R.log(f"{what} with the program's spans: span {s['window_s']} s"
          + (f", {s['window_s'] / second_s} of the second segment's "
             f"{second_s} s" if second_s else "")
          + f"; busy {s['busy_s']} s, idle {idle} s, under a program span "
          f"{s['covered_s']} s ({s['covered_s'] / idle if idle > 0 else None}"
          f" of the idle time), {s['queued_s']} s of it before queued work, "
          f"put down at its launch")
    for name, sec in s["idle_by_span"]:
        R.log(f"  idle under {name}: {sec} s")
    for name, sec in _largest_first({name: sum(v) for name, v
                                     in s["within"].items()}):
        R.log(f"  idle within {name} (its children included): {sec} s")


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
    events, base_ns = trace.stop_and_read(R, prof,
                                          f"trace_req{R.rank}.json")
    got = read_segment(R, "the request segment", events, record, base_ns,
                       1, points, launches)
    if got is not None:
        log_segment(R, "request segment, one request", got)
    return got
