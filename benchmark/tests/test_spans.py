"""CPU tests of benchmark/spans.py: the reducer that puts the device's idle
gaps down to the program's spans, the per-layer readers of the segment it
reduces, the walk of the four-segment stretch, and (on a card) the shared
clock.

python -m pytest benchmark/tests/test_spans.py -q
python -m pytest benchmark/tests/test_spans.py -m cuda -s   (on a card)
"""
from __future__ import annotations

import json
import os
import tempfile
import time
import types

import pytest
import torch

from benchmark import harness, spans, sublayers, trace
from benchmark.kinds import finetune, generate
from test_bench_harness import _run, tiny  # noqa: F401

MARK = "at::cuda::(anonymous namespace)::spin_kernel(long)"


def _k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _span(i, name, ts, end, parent=-1, tid=1):
    return {"ph": "X", "cat": "program_span", "name": name, "tid": tid,
            "ts": ts, "dur": end - ts,
            "args": {"id": i, "parent": parent}}


def _bytes(ts, total):
    return {"ph": "C", "cat": "program_counter", "name": "comm.bytes",
            "ts": ts, "args": {"comm.bytes": total}}


def _close(table):
    """A {name: [numbers]} table to compare to within rounding."""
    return {name: pytest.approx(v) for name, v in table.items()}


def _training_trace():
    """Two steps between marks: a gap under a fused backward on another
    thread (opened last), one under the grad step outside its backward,
    one under the optimizer, one under no span; bytes and NCCL time in
    the second step."""
    return [_k(MARK, 1000, 1), _k("gemm", 1001, 100),
            _k("add", 1301, 200), _k(MARK, 2000, 1),
            _k("mul", 2101, 200), _k("ncclDevKernel_AllReduce", 2701, 100),
            _k(MARK, 3001, 1), _k("late", 4000, 10),
            _span(0, "train.grad_step", 1050, 1900),
            _span(1, "train.backward", 1150, 1700, parent=0),
            _span(2, "fused.B1", 1180, 1250, tid=2),
            _span(3, "train.apply_step", 2200, 2700),
            _span(4, "comm.all_reduce", 2550, 2590, parent=3),
            _bytes(900, 100), _bytes(2560, 1100)]


def test_each_gap_goes_to_the_innermost_span_opened_last():
    got = spans.reduce_spans(_training_trace(), units=2)
    assert got["window_s"] == pytest.approx(2000e-6)
    assert got["busy_s"] == pytest.approx(600e-6)
    by_name = dict(got["idle_by_span"])
    assert by_name == pytest.approx({
        "fused.B1": 200e-6,          # [1101, 1301]: B1 opened after bwd
        "train.grad_step": 600e-6,   # [1501, 2101]: past the backward
        "train.apply_step": 400e-6,  # [2301, 2701]: mid 2501, no child
        "none": 200e-6})             # [2801, 3001]: under no span
    assert [n for n, _ in got["idle_by_span"]][:2] == ["train.grad_step",
                                                       "train.apply_step"]
    assert got["covered_s"] == pytest.approx(1200e-6)
    within = got["within"]
    assert within["train.backward"] == pytest.approx([200e-6, 0.0])
    assert within["fused.B1"] == pytest.approx([200e-6, 0.0])
    assert within["train.grad_step"] == pytest.approx([800e-6, 0.0])
    assert within["train.apply_step"] == pytest.approx([0.0, 400e-6])
    assert "comm.all_reduce" not in within and "unet.call" not in within
    assert got["counts"] == {"comm.bytes": [0, 1000]}
    assert got["nccl_unit_s"] == pytest.approx([0.0, 100e-6])
    assert got["host_s"] == _close({
        "train.grad_step": [850e-6], "train.backward": [550e-6],
        "fused.B1": [70e-6], "train.apply_step": [500e-6],
        "comm.all_reduce": [40e-6]})
    assert _read_all(got) == pytest.approx({
        "backward_idle_ms.train": 0.1, "forward_idle_ms.train": 0.3,
        "optim_idle_ms.train": 0.2,
        "allreduce_gbps.train": 1000 / 100e-6 / 1e9})


def _generation_trace():
    """Two UNet calls between marks, a UNet call opened at the instant its
    denoise did.  Gaps [1, 11) [21, 41) [61, 111) | [121, 171) [181, 201)."""
    return [_k(MARK, 0, 1), _k("conv", 11, 10), _k("conv", 41, 20),
            _k(MARK, 100, 1), _k("conv", 111, 10), _k("conv", 171, 10),
            _k(MARK, 201, 1),
            _span(0, "pipe.denoise", 1, 300),
            _span(1, "unet.call", 1, 60, parent=0),
            _span(2, "unet.down.0", 25, 40, parent=1),
            _span(3, "sampler.step", 60, 110, parent=0),
            _span(4, "unet.call", 110, 180, parent=0),
            _span(5, "sampler.step", 180, 230, parent=0)]


def test_generation_figures_and_nested_spans_of_one_start():
    """The child opened at its parent's instant is the innermost."""
    got = spans.reduce_spans(_generation_trace(), units=2)
    assert dict(got["idle_by_span"]) == pytest.approx({
        "unet.call": 60e-6, "unet.down.0": 20e-6, "sampler.step": 70e-6})
    assert got["covered_s"] == pytest.approx(150e-6)
    assert got["within"] == _close({
        "pipe.denoise": [80e-6, 70e-6], "unet.call": [30e-6, 50e-6],
        "sampler.step": [50e-6, 20e-6], "unet.down.0": [20e-6, 0.0]})
    assert got["counts"] == {}
    assert _read_all(got) == pytest.approx({
        "unet_host_ms.gen": 64.5e-3, "unet_idle_ms.gen": 40e-3,
        "sampler_idle_ms.gen": 35e-3})


READERS = ("unet_host_ms.gen", "unet_idle_ms.gen", "sampler_idle_ms.gen",
           "forward_idle_ms.train", "backward_idle_ms.train",
           "optim_idle_ms.train", "allreduce_gbps.train")


def _read_all(segment):
    """Each span reader's number of a Record that carries `segment`, where
    it reads one."""
    rec = harness.Record()
    rec.spans = segment
    got = {name: harness.metric_reader(name)(rec) for name in READERS}
    return {name: value for name, value in got.items() if value is not None}


@pytest.mark.parametrize("name", READERS)
def test_each_span_reader_reads_the_records_segment(name):
    """Every reader returns its number from a Record that carries a
    synthetic trace's reduced segment, its cell's kind's, and None from one
    whose recorder was off."""
    read = harness.metric_reader(name)
    assert read(harness.Record()) is None
    trace_of = _generation_trace if name.endswith(".gen") \
        else _training_trace
    rec = harness.Record()
    rec.spans = spans.reduce_spans(trace_of(), units=2)
    value = read(rec)
    assert isinstance(value, float) and value > 0, value
    assert harness.per_layer_metrics(
        types.SimpleNamespace(per_layer=[{"name": name, "unit": "u"}]),
        rec) == {name: {"value": value, "unit": "u"}}
    spec = json.load(open(os.path.join(harness.ROOT, "BENCHMARK.json")))
    entry = {m["name"]: m for m in spec["per_layer"]}[name]
    assert all(w.startswith("gen_" if name.endswith(".gen") else "train_")
               for w in entry["workloads"])


def test_no_program_span_in_the_span_reads_nothing():
    events = [_k(MARK, 0, 1), _k("conv", 11, 10), _k(MARK, 100, 1),
              _span(0, "gen.load", 200, 300)]
    assert spans.reduce_spans(events, units=1) is None
    assert spans.reduce_spans(events[1:], units=1) is None


def test_the_four_segment_stretch_walks_its_units_on_the_cpu():
    """4n + 2 units, the fourth segment's profiler and the program's
    recorder on for its extent; on the CPU no mark is launched, so it
    reads nothing and takes the fourth segment twice more."""
    from asva_tpu_torch import observability
    with tempfile.TemporaryDirectory() as tmp:
        r = harness.Run(cell=None, seed=0, seconds=0, trace=True,
                        device="cpu", t0=time.perf_counter(), tmpdir=tmp)
        subs = sublayers.Sublayers(None)
        st = trace.Stretch(r, 2, subs, "t")
        units, recording = 0, []
        while not st.done:
            st.boundary()
            if not st.done:
                with observability.span("unit"):
                    torch.ones(4).add_(1)
                recording.append(observability._RECORD is not None)
                units += 1
        assert units == 16 and st.prof is None and not subs.recording
        assert recording == [False] * 7 + [True] * 9
        assert observability._RECORD is None and st.spans is None
        assert st.result() == (None, None, None)


def test_a_program_without_the_recorder_leaves_the_segment_unread(
        monkeypatch):
    from asva_tpu_torch import observability
    monkeypatch.delattr(observability, "tracing")
    with tempfile.TemporaryDirectory() as tmp:
        r = harness.Run(cell=None, seed=0, seconds=0, trace=True,
                        device="cpu", t0=time.perf_counter(), tmpdir=tmp)
        st = trace.Stretch(r, 1, sublayers.Sublayers(None), "t")
        while not st.done:
            st.boundary()
        assert st.spans is None and st.result() == (None, None, None)


def test_a_gap_before_queued_work_goes_to_the_spans_that_launched_it():
    """The operation after [20, 50) was launched at 10, before the gap: the
    gap goes to the span open then, not to the one open at its middle.
    The last mark was launched at 95, inside [60, 100): its middle rules."""
    def launch(ts, c):
        return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": ts, "dur": 2, "args": {"correlation": c}}
    events = [_k(MARK, 0, 1), _k("a", 1, 19),
              dict(_k("b", 50, 10), args={"correlation": 7}), launch(10, 7),
              dict(_k(MARK, 100, 1), args={"correlation": 8}), launch(95, 8),
              _span(0, "fused.B2", 5, 15), _span(1, "sampler.step", 30, 40),
              _span(2, "unet.call", 70, 90)]
    got = spans.reduce_spans(events, units=1)
    assert dict(got["idle_by_span"]) == pytest.approx({
        "fused.B2": 30e-6, "unet.call": 40e-6})
    assert got["queued_s"] == pytest.approx(30e-6)
    assert got["covered_s"] == pytest.approx(70e-6)
    assert "sampler.step" not in got["within"]


@pytest.mark.parametrize("workload,kind", [("gen_256_plms50", generate),
                                           ("train_256_b4a2", finetune)])
def test_the_kinds_run_the_four_segment_stretch(tiny, workload,  # noqa
                                                kind):
    """On the CPU no segment reads a number, so the span readers leave
    their metrics out of the line."""
    from asva_tpu_torch import observability
    cell = tiny(workload, num_inference_steps=8) if kind is generate \
        else tiny(workload)
    out = _run(cell, kind, trace=True)
    line = harness.result_line(cell, out, True, {"platform": "cpu"})
    assert line["correct"] is True, line["checks"]
    assert observability._RECORD is None
    assert out.record.spans is out.record.request_spans is None
    assert not set(line["metrics"]) & set(READERS)


def _gather_rank(rank, world, port, out):
    import torch.distributed as dist
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    dist.init_process_group("gloo", rank=rank, world_size=world)
    got = spans.reduce_spans(_training_trace(), units=2)
    # rank r: its times scaled by r + 1, a span of its own, its own NCCL
    got = dict(got, window_s=got["window_s"] * (rank + 1),
               busy_s=got["busy_s"] * (rank + 1),
               covered_s=got["covered_s"] * (rank + 1),
               idle_by_span=got["idle_by_span"] + [[f"r{rank}", 1.0]],
               nccl_unit_s=[0.0, 1e-4 * (world - rank)],
               counts={"comm.bytes": [0, 1000 + rank]},
               host_s=dict(got["host_s"], only=[float(rank)]))
    merged = spans._across_ranks(got, types.SimpleNamespace(
        world=world, rank=rank, device="cpu"), 2)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(merged, f)
    dist.destroy_process_group()


def test_the_ranks_mean_their_times_and_keep_the_least_nccl(tmp_path):
    import torch.multiprocessing as mp
    out = str(tmp_path / "merged.json")
    mp.start_processes(_gather_rank, args=(4, harness._free_port(), out),
                       nprocs=4, join=True, start_method="spawn")
    got = json.load(open(out))
    assert got["window_s"] == pytest.approx(2000e-6 * 2.5)
    assert got["covered_s"] == pytest.approx(1200e-6 * 2.5)
    by_name = dict(got["idle_by_span"])
    assert by_name["r3"] == pytest.approx(0.25)
    assert by_name["train.grad_step"] == pytest.approx(600e-6)
    assert got["nccl_unit_s"] == pytest.approx([0.0, 1e-4])
    assert got["counts"] == {"comm.bytes": [0, 1000]}      # rank 0's own
    assert got["within"]["train.apply_step"] == pytest.approx([0.0, 400e-6])
    assert got["host_s"]["train.apply_step"] == pytest.approx([500e-6])
    assert got["host_s"]["only"] == pytest.approx([1.5])


def test_the_fit_puts_the_record_on_the_traces_clock():
    """The trace's clock runs 100 ppm fast and 300 us ahead of the
    recorder's: the two calibration kernels, each ending 5 us before its
    point, bring a span and the marks' launches onto it, and drop out."""
    base = 5_000_000_000

    def on_trace(t_ns):              # a recorder time on the trace's clock
        return (t_ns - base) / 1e3 * (1 + 1e-4) + 300.0

    def ns(us):                      # a recorder time at `us` after base
        return base + int(us * 1e3)
    events = [_k(MARK, on_trace(ns(1000)) - 6, 1),          # calibration
              _k(MARK, on_trace(ns(2010)), 1), _k("conv", 2400, 50),
              _k(MARK, on_trace(ns(9_000_010)), 1),
              _k(MARK, on_trace(ns(10_000_000)) - 6, 1)]    # calibration
    record = types.SimpleNamespace(trace_events=lambda b: [
        _span(0, "unet.call", (ns(2100) - b) / 1e3, (ns(2300) - b) / 1e3),
        _bytes((ns(3000) - b) / 1e3, 8)])
    kept, mine, launch_us, fit = spans.align(
        events, record, base, [ns(1000), ns(10_000_000)],
        [ns(2000), ns(9_000_000)])
    assert kept == events[1:4]
    assert fit["offset_us"] == pytest.approx(300.1 - 5, abs=1e-6)
    assert fit["drift_ppm"] == pytest.approx(100.0, abs=1e-6)
    assert mine[0]["ts"] == pytest.approx(on_trace(ns(2100)) - 5, abs=1e-6)
    assert mine[0]["dur"] == pytest.approx(200 * (1 + 1e-4), abs=1e-6)
    assert mine[1]["ts"] == pytest.approx(on_trace(ns(3000)) - 5, abs=1e-6)
    assert spans.mark_leads(kept, launch_us) == pytest.approx(
        [15.001, 15.001], abs=1e-6)
    # without both points: the events as they are, the record unmapped
    kept, mine, launch_us, fit = spans.align(events, record, base,
                                             [ns(1000)], [ns(2000)])
    assert kept is events and fit is None
    assert mine[0]["ts"] == pytest.approx(2100.0)
    assert launch_us == [2000.0]
    assert spans.mark_leads(events, [0.0]) == []


def test_the_request_segment_walks_one_request_on_the_cpu():
    """The recorder is on for the whole request and off after; on the CPU
    no mark is launched, so the segment reads nothing."""
    from asva_tpu_torch import observability
    seen = []

    def request(i):
        with observability.span("gen.request"):
            torch.ones(4).add_(i)
        seen.append((i, observability._RECORD is not None))
    with tempfile.TemporaryDirectory() as tmp:
        r = harness.Run(cell=None, seed=0, seconds=0, trace=True,
                        device="cpu", t0=time.perf_counter(), tmpdir=tmp)
        assert spans.request_segment(r, request, 3) is None
        assert os.listdir(tmp) == []
    assert seen == [(3, True)] and observability._RECORD is None


@pytest.mark.cuda
def test_a_span_contains_its_kernel_on_the_traces_clock(tmp_path):
    """The shared clock on a card: a span around torch.cuda._sleep and a
    synchronize contains the spin kernel on the trace's clock; prints the
    offsets at both ends."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from asva_tpu_torch import observability as obs
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    prof = trace.profiler(host=False)
    prof.start()
    with obs.tracing() as rec:
        for _ in range(5):
            with obs.span("spin"):
                torch.cuda._sleep(1_000_000)
                torch.cuda.synchronize()
    prof.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    obs.add_spans_to_trace(path, rec)
    events = json.load(open(path))["traceEvents"]
    kernels = sorted((e for e in events if e.get("cat") == "kernel"
                      and trace.MARK in e["name"]), key=lambda e: e["ts"])
    marked = sorted((e for e in events if e.get("cat") == "program_span"),
                    key=lambda e: e["ts"])
    assert len(kernels) == len(marked) == 5
    for k, s in zip(kernels, marked):
        before = k["ts"] - s["ts"]
        after = s["ts"] + s["dur"] - (k["ts"] + k["dur"])
        print(f"span {s['dur']:.1f} us, kernel {k['dur']:.1f} us: starts "
              f"{before:.1f} us after the span, ends {after:.1f} us before "
              f"its end")
        assert before >= 0 and after >= 0, (k, s)
