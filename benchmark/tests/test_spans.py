"""CPU tests of benchmark/spans.py: the reducer that puts the device's idle
gaps down to the program's spans, the per-layer figures, the walk of the
four-segment stretch, and (on a card) the shared clock.

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
from test_bench_harness import (_data_parallel_rank, _run,  # noqa: F401
                                tiny)

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
    under = got["under"]
    assert under["backward"] == pytest.approx([200e-6, 0.0])
    assert under["forward"] == pytest.approx([600e-6, 0.0])
    assert under["optim"] == pytest.approx([0.0, 400e-6])
    assert under["unet"] == under["sampler"] == [0.0, 0.0]
    assert got["comm_bytes"] == [0, 1000]
    assert got["nccl_unit_s"] == pytest.approx([0.0, 100e-6])
    fig = spans.figures(got)
    assert fig["backward_idle_ms.train"] == pytest.approx(0.1)
    assert fig["forward_idle_ms.train"] == pytest.approx(0.3)
    assert fig["optim_idle_ms.train"] == pytest.approx(0.2)
    assert fig["allreduce_gbps.train"] == pytest.approx(1000 / 100e-6 / 1e9)
    assert fig["unet_host_ms.gen"] is None
    assert fig["unet_idle_ms.gen"] is fig["sampler_idle_ms.gen"] is None


def test_generation_figures_and_nested_spans_of_one_start():
    """A UNet call opened at the instant its denoise did: the child is the
    innermost.  Gaps [1, 11) [21, 41) [61, 111) | [121, 171) [181, 201)."""
    events = [_k(MARK, 0, 1), _k("conv", 11, 10), _k("conv", 41, 20),
              _k(MARK, 100, 1), _k("conv", 111, 10), _k("conv", 171, 10),
              _k(MARK, 201, 1),
              _span(0, "pipe.denoise", 1, 300),
              _span(1, "unet.call", 1, 60, parent=0),
              _span(2, "unet.down.0", 25, 40, parent=1),
              _span(3, "sampler.step", 60, 110, parent=0),
              _span(4, "unet.call", 110, 180, parent=0),
              _span(5, "sampler.step", 180, 230, parent=0)]
    got = spans.reduce_spans(events, units=2)
    assert dict(got["idle_by_span"]) == pytest.approx({
        "unet.call": 60e-6, "unet.down.0": 20e-6, "sampler.step": 70e-6})
    assert got["covered_s"] == pytest.approx(150e-6)
    assert dict(got["within"]) == pytest.approx({
        "pipe.denoise": 150e-6, "unet.call": 80e-6, "sampler.step": 70e-6,
        "unet.down.0": 20e-6})
    assert got["within"][0][0] == "pipe.denoise"
    assert got["under"]["unet"] == pytest.approx([30e-6, 50e-6])
    assert got["under"]["sampler"] == pytest.approx([50e-6, 20e-6])
    fig = spans.figures(got)
    assert fig["unet_host_ms.gen"] == pytest.approx(64.5e-3)
    assert fig["unet_idle_ms.gen"] == pytest.approx(40e-3)
    assert fig["sampler_idle_ms.gen"] == pytest.approx(35e-3)
    assert fig["forward_idle_ms.train"] is None
    assert fig["allreduce_gbps.train"] is None


def test_no_program_span_in_the_span_reads_nothing():
    events = [_k(MARK, 0, 1), _k("conv", 11, 10), _k(MARK, 100, 1),
              _span(0, "gen.load", 200, 300)]
    assert spans.reduce_spans(events, units=1) is None
    assert spans.reduce_spans(events[1:], units=1) is None


def test_the_four_segment_stretch_walks_its_units_on_the_cpu():
    """4n + 2 units, the fourth segment's profiler and the program's
    recorder on for its extent; on the CPU no mark is launched, so it
    reads nothing."""
    from asva_tpu_torch import observability
    with tempfile.TemporaryDirectory() as tmp:
        r = harness.Run(cell=None, seed=0, seconds=0, trace=True,
                        device="cpu", t0=time.perf_counter(), tmpdir=tmp)
        subs = sublayers.Sublayers(None)
        st = spans.SpanStretch(r, 2, subs, "t")
        units, recording = 0, []
        while not st.done:
            st.boundary()
            if not st.done:
                with observability.span("unit"):
                    torch.ones(4).add_(1)
                recording.append(observability._RECORD is not None)
                units += 1
        assert units == 10 and st.prof is None and not subs.recording
        assert recording == [False] * 7 + [True] * 3
        assert observability._RECORD is None and st.spans is None
        assert st.result() == (None, None)


def test_a_program_without_the_recorder_leaves_the_segment_unread(
        monkeypatch):
    from asva_tpu_torch import observability
    monkeypatch.delattr(observability, "tracing")
    with tempfile.TemporaryDirectory() as tmp:
        r = harness.Run(cell=None, seed=0, seconds=0, trace=True,
                        device="cpu", t0=time.perf_counter(), tmpdir=tmp)
        st = spans.SpanStretch(r, 1, sublayers.Sublayers(None), "t")
        while not st.done:
            st.boundary()
        assert st.spans is None and st.result() == (None, None)


@pytest.mark.parametrize("workload,kind", [("gen_256_plms50", generate),
                                           ("train_256_b4a2", finetune)])
def test_the_kinds_run_the_four_segment_stretch(tiny, monkeypatch,  # noqa
                                                workload, kind):
    from asva_tpu_torch import observability
    monkeypatch.setattr(trace, "Stretch", spans.SpanStretch)
    monkeypatch.setattr(generate, "stretch",
                        spans.with_request_segment(generate.stretch))
    cell = tiny(workload, num_inference_steps=8) if kind is generate \
        else tiny(workload)
    out = _run(cell, kind, trace=True)
    line = harness.result_line(cell, out, True, {"platform": "cpu"})
    assert line["correct"] is True, line["checks"]
    assert observability._RECORD is None


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
               comm_bytes=[0, 1000 + rank])
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
    assert got["comm_bytes_ranks"] == [[0, 1000 + r] for r in range(4)]
    assert got["under"]["optim"] == pytest.approx([0.0, 400e-6])
    assert dict(got["within"])["train.apply_step"] == pytest.approx(400e-6)


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


def _span_rank(rank, world, port, out):
    trace.Stretch = spans.SpanStretch
    _data_parallel_rank(rank, world, port, out, False, True)


def test_data_parallel_ranks_walk_the_four_segment_stretch(tmp_path):
    import torch.multiprocessing as mp
    out = str(tmp_path / "rank0.json")
    mp.start_processes(_span_rank, args=(2, harness._free_port(), out),
                       nprocs=2, join=True, start_method="spawn")
    got = json.load(open(out))
    assert got["correct"] is True, got


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
