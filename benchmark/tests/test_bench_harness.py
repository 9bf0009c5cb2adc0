"""CPU tests of the benchmark's harness, reference and yardstick.

python -m pytest benchmark/tests -q        (the card's tests skip here)
python -m pytest benchmark/tests -m cuda   (on a card)

The tiny configuration keeps the published structure (audio, text and
plain blocks, first-frame, audio and temporal attention) at small widths;
the port runs its plain sub-layers on the CPU.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import pytest
import torch

from benchmark import (faults, harness, media, sublayers, trace, weights,
                       work)
from benchmark.kinds import finetune, generate
from benchmark.reference.pipeline import Generator
from benchmark.reference.train import Trainer

ROOT = harness.ROOT


def _group(dc, drop=()):
    return {k: list(v) if isinstance(v, tuple) else v
            for k, v in dataclasses.asdict(dc).items() if k not in drop}


@pytest.fixture
def tiny(monkeypatch):
    """A cell factory at tiny widths; the port's default audio tower is the
    tiny one for the test's duration."""
    from asva_tpu_torch import runtime
    from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig
    from asva_tpu_torch.models.unet3d import UNet3DConfig
    from asva_tpu_torch.models.vae import VAEConfig
    audio = ImageBindAudioConfig.tiny()
    monkeypatch.setattr(runtime, "ImageBindAudioConfig", lambda: audio)

    def make(workload, size=(16, 16), **traffic):
        cell = harness.load_cell(workload)
        cell.config.update(
            unet=_group(UNet3DConfig.tiny(audio_cross_attention_dim=32),
                        ("remat", "remat_policy")),
            vae=_group(VAEConfig.tiny()), audio=_group(audio),
            image_size=list(size))
        small = ({"num_inference_steps": 4, "pool": 2,
                  "stretch_first_call": 1, "stretch_units": 1}
                 if cell.traffic["kind"] == "generate"
                 else {"batch_size": 2, "pool_micro_batches": 8,
                       "stretch_units": 1})
        cell.traffic.update(small, **traffic)
        return cell
    return make


def _run(cell, kind, trace=False, seed=2**31 + 11, rank=0, world=1):
    with tempfile.TemporaryDirectory() as tmp:
        r = harness.Run(cell=cell, seed=seed, seconds=0.2, trace=trace,
                        device="cpu", t0=time.perf_counter(), tmpdir=tmp,
                        rank=rank, world=world)
        return kind.run(r)


# ------------------------------------------------------------ the spec ---

def test_every_cell_resolves_to_its_files():
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        cell = harness.load_cell(w["name"])
        assert harness.kind_module(cell).run
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                        "peak_gib"}
        assert cell.per_layer, w["name"]
        reported = {m["name"] for m in cell.end_to_end}
        for m in cell.per_layer:
            assert callable(harness.metric_reader(m["name"]))
            assert m["moves"] in reported, (w["name"], m["name"])
        assert set(cell.limits) and all(v > 0 for v in cell.limits.values())
    for m in spec["per_layer"] + spec["end_to_end"]:
        assert harness.NAME.match(m["name"]), m["name"]
    assert all(m["moves"] in e2e for m in spec["per_layer"])
    for c in spec["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert c["file"].startswith("benchmark/")
        assert isinstance(c["reduced"], list)
        assert all(key in cfg for key in c["reduced"]), c["reduced"]
        assert cfg["name"] == c["name"]


def test_bounds_reproduce_the_kernel_table():
    """B2 and B3 at a request's 32x32 level (2 CFG rows of 12 frames):
    0.0663 and 0.0611 ms (PERF.md's kernel table)."""
    def t(*shape):
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    b, f, n, c = 2, 12, 1024, 320
    sub = [t(c), t(c), t(c, c), t(c, c), t(c)]
    x = t(b, f, n, c)
    args = ([x] + sub + [t(b, n, c)] * 2 + sub + [t(b, f, 25, c)] * 2
            + sub + [t(b, 77, c)] * 2)
    fwd, bwd = sublayers._b2(args, x)
    assert abs(fwd * 1e3 - 0.0663) < 5e-5 and bwd == 0
    m = b * f * n
    ff = [t(m, c), t(c), t(c), t(8 * c, c), t(8 * c), t(c, 4 * c), t(c)]
    fwd, _ = sublayers._b3(ff, t(m, c))
    assert abs(fwd * 1e3 - 0.0611) < 5e-5


@pytest.mark.parametrize("workload", ["gen_256_plms50", "gen_tgh_plms50",
                                      "train_256_b4a2"])
def test_model_flops_are_stable(workload):
    cell = harness.load_cell(workload)
    count = (work.request_flops if cell.traffic["kind"] == "generate"
             else work.step_flops)
    first = count(cell.config, cell.traffic)
    assert first > 0 and count(cell.config, cell.traffic) == first


def test_the_rectangular_request_has_half_the_work():
    a, b = (harness.load_cell(w) for w in ("gen_256_plms50",
                                           "gen_tgh_plms50"))
    ratio = (work.request_flops(b.config, b.traffic)
             / work.request_flops(a.config, a.traffic))
    assert 0.45 < ratio < 0.55


def test_weights_draw_the_same_tensors_for_a_seed():
    cfg = harness.load_cell("gen_256_plms50").config
    a = weights.draw(cfg, "vae", 2**31 + 3, "cpu")
    b = weights.draw(cfg, "vae", 2**31 + 3, "cpu")
    c = weights.draw(cfg, "vae", 2**31 + 4, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["decoder.conv_in.weight"],
                           c["decoder.conv_in.weight"])
    assert float(a["decoder.mid_block.resnets.0.norm1.weight"].mean()) \
        == pytest.approx(1.0, abs=0.05)


# --------------------------------------------- reference against port ---

@pytest.mark.parametrize("guidance", [(4.0, 1.0), (4.0, 3.0), (1.0, 1.0)])
@pytest.mark.parametrize("size", [(16, 16), (16, 24)])
def test_reference_request_matches_the_port_in_float32(tiny, guidance,
                                                       size):
    """One batched request from files through generate_videos on the
    port's float32 CPU path and through the plain reference: equal but
    for uint8 truncation of values a rounding apart."""
    from asva_tpu_torch.pipelines.generate import generate_videos
    cell = tiny("gen_256_plms50", size, audio_guidance_scale=guidance[0],
                text_guidance_scale=guidance[1])
    cfg, tr, seed = cell.config, cell.traffic, 2**31 + 21
    pipe = generate.build(harness.Run(cell=cell, seed=seed, seconds=0,
                                      trace=False, device="cpu", t0=0.0,
                                      tmpdir=""), torch.float32)
    null, texts = generate.conditions(cfg, tr, seed, "cpu")
    pipe.null_text_encoding = null
    with tempfile.TemporaryDirectory() as tmp:
        png, wav = media.write_pool(tmp, seed, 1, size, 6.5)[0]
        out = generate_videos(
            pipe, image_path=png, audio_path=wav,
            category_text_encoding=texts[0], image_size=size,
            num_inference_steps=tr["num_inference_steps"], seed=5,
            audio_guidance_scale=guidance[0],
            text_guidance_scale=guidance[1])
        program = np.stack([frames for frames, _ in out])
        ref = Generator(cfg, weights.draw_all(cfg, seed, "cpu"), "cpu")
        reference = ref.request(png, wav, texts[0], null, 5, tr)
    gap = np.abs(program.astype(int) - reference.astype(int))
    assert program.shape == reference.shape == (3, 12) + size + (3,)
    assert gap.max() <= 1 and (gap > 0).mean() < 1e-3
    assert reference.std() > 10      # the frames are not flat


def test_reference_steps_match_the_port_in_float32(tiny):
    """Three accumulated steps of the port's trainer in float32 on the CPU
    against the plain reference: losses, the first clipped gradient and
    the change of every trainable leaf."""
    cell = tiny("train_256_b4a2")
    seed = 2**31 + 31
    r = harness.Run(cell=cell, seed=seed, seconds=0, trace=False,
                    device="cpu", t0=0.0, tmpdir="")
    trainer, state, start = finetune.build(r, torch.float32)
    assert all(p.dtype == torch.float32 for p in trainer.unet.parameters())
    tr, cfg = cell.traffic, cell.config
    n = tr["checked_steps"] * tr["gradient_accumulation_steps"]
    batches = [finetune.as_batch(finetune.micro_batch(cfg, tr, seed, 0, i,
                                                      "cpu"))
               for i in range(n)]
    opt = state.optimizer
    program = {"losses": []}
    for k in range(tr["checked_steps"]):
        acc = None
        for j in range(tr["gradient_accumulation_steps"]):
            i = k * tr["gradient_accumulation_steps"] + j
            loss, grads = trainer.grad_step(
                state, batches[i], finetune.draw_generator(seed, i, "cpu"))
            program["losses"].append(float(loss))
            acc = grads if acc is None else [a + g for a, g in zip(acc,
                                                                   grads)]
        trainer.apply_step(state, [g / 2 for g in acc])
        if k == 0:
            program["first_grad"] = {
                nm: float((m / (1 - opt.b1)).norm())
                for nm, m in zip(opt.names, opt.mu)}
    program["change"] = {nm: float((p.detach() - start[nm]).norm())
                         for nm, p in zip(opt.names, opt.params)}
    ref = Trainer(cfg, weights.draw_all(cfg, seed, "cpu"), tr, "cpu")
    reference = ref.steps(
        batches, [lambda i=i: finetune.draw_generator(seed, i, "cpu")
                  for i in range(n)],
        finetune.null_text(cfg, seed, "cpu"), tr["checked_steps"])
    assert sorted(ref.names) == sorted(opt.names)
    got = finetune.numbers(program, reference, 2)
    assert got["first_loss_gap"] < 1e-5 and got["later_loss_gap"] < 1e-5
    assert got["worst_grad_gap"] < 1e-4 and got["change_gap"] < 1e-4, got


# ------------------------------------------------ rehearsals on the CPU ---

@pytest.mark.parametrize("trace", [False, True])
def test_generation_rehearsal(tiny, trace):
    cell = tiny("gen_256_plms50")
    out = _run(cell, generate, trace)
    line = harness.result_line(cell, out, trace,
                               {"platform": "cpu"})
    assert out.attempted >= 1 and out.failed == 0
    assert line["correct"] is True, line["checks"]
    assert list(line)[-1] == "checks"
    if trace:
        assert set(line["metrics"]) >= {"denoise_share.gen",
                                        "unet_call_ms.gen", "mfu.gen"}
        assert 0 < line["metrics"]["denoise_share.gen"]["value"] <= 100
    else:
        assert set(line["metrics"]) == {"gen_clips_per_s", "peak_gib",
                                        "setup_s"}


@pytest.mark.parametrize("trace", [False, True])
def test_finetune_rehearsal(tiny, trace):
    cell = tiny("train_256_b4a2")
    out = _run(cell, finetune, trace)
    line = harness.result_line(cell, out, trace,
                               {"platform": "cpu"})
    assert out.attempted >= 1 and line["correct"] is True, line["checks"]
    if trace:
        assert set(line["metrics"]) >= {"grad_step_ms.train",
                                        "optim_ms.train", "mfu.train"}


@pytest.mark.parametrize("fault", ["altered_answer", "half_clips"])
def test_generation_faults_are_not_correct(tiny, monkeypatch, fault):
    cell = tiny("gen_256_plms50")
    faults.FAULTS[fault](monkeypatch.setattr)
    line = harness.result_line(cell, _run(cell, generate), False,
                               {"platform": "cpu"})
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_update"])
def test_finetune_faults_are_not_correct(tiny, monkeypatch, fault):
    cell = tiny("train_256_b4a2")
    faults.FAULTS[fault](monkeypatch.setattr)
    line = harness.result_line(cell, _run(cell, finetune), False,
                               {"platform": "cpu"})
    assert line["correct"] is False, line["checks"]


# ------------------------------------------------- the trace's span ---

def _k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_the_span_lies_between_the_marks():
    """The profiler's first launches and its flush lie outside the span;
    busy time, launches and each unit's NCCL time come from inside it."""
    mark = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [_k("warm", 0, 5000),                  # under the start-up
              _k(mark, 10000, 1), _k("gemm", 10011, 40),
              _k("add", 10031, 30),                 # overlaps gemm
              _k("ncclDevKernel_AllReduce", 10100, 20),
              _k(mark, 10200, 1), _k("Memset", 10210, 10, "gpu_memset"),
              _k("ncclDevKernel_AllReduce", 10300, 50),
              _k(mark, 10401, 1), _k("late", 20000, 100),   # the flush
              {"ph": "i", "name": "instant", "ts": 10050}]
    got = trace.reduce_device(events, units=2)
    assert got["window_s"] == pytest.approx(400e-6)
    assert got["busy_s"] == pytest.approx((50 + 20 + 10 + 50) * 1e-6)
    assert got["launches"] == 4 and got["units"] == 2
    assert got["nccl_unit_s"] == pytest.approx([20e-6, 50e-6])
    assert trace.reduce_device(events, units=3) is None
    assert trace.reduce_device([_k(mark, 0, 1), _k(mark, 10, 1)], 1) is None


def test_the_stretch_walks_its_units_on_the_cpu():
    """4n + 2 units and, where the fourth segment read nothing, twice n + 1
    more, the profilers started and stopped on their boundaries; on the CPU
    no mark is launched, so it reads nothing."""
    with tempfile.TemporaryDirectory() as tmp:
        r = harness.Run(cell=None, seed=0, seconds=0, trace=True,
                        device="cpu", t0=time.perf_counter(), tmpdir=tmp)
        subs = sublayers.Sublayers(None)
        st = trace.Stretch(r, 2, subs, "t")
        units = 0
        while not st.done:
            st.boundary()
            if not st.done:
                torch.ones(4).add_(1)
                units += 1
        assert units == 16 and st.prof is None and not subs.recording
        assert st.result() == (None, None, None)
        assert os.listdir(tmp) == []


def test_the_data_states_what_is_run(tiny):
    """Keys that describe the run are read: a traffic or a configuration
    that states what the kinds do not do is refused, not run as theirs."""
    cell = tiny("gen_256_plms50", in_flight=2)
    with pytest.raises(ValueError, match="in flight"):
        _run(cell, generate)
    cell = tiny("train_256_b4a2")
    cell.config["trainable_modules"] = ["_temp"]
    with pytest.raises(ValueError, match="trains"):
        _run(cell, finetune)
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "benchmark", "configs"))
        for c in spec["configs"]:
            cfg = json.load(open(os.path.join(ROOT, c["file"])))
            cfg["audio_sample_rate"] = 22050
            json.dump(cfg, open(os.path.join(tmp, c["file"]), "w"))
        json.dump(spec, open(os.path.join(tmp, "BENCHMARK.json"), "w"))
        with pytest.raises(ValueError, match="audio_sample_rate"):
            harness.load_cell("gen_256_plms50", tmp)


def _root_with(tmp, edit):
    """A root beside the repository's BENCHMARK.json whose configuration
    files are the repository's after `edit(cfg)`."""
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    os.makedirs(os.path.join(tmp, "benchmark", "configs"))
    for c in spec["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        edit(cfg)
        json.dump(cfg, open(os.path.join(tmp, c["file"]), "w"))
    json.dump(spec, open(os.path.join(tmp, "BENCHMARK.json"), "w"))


def test_a_configuration_without_an_audio_tower_loads():
    """The audio invariants hold only where there is an audio group: a
    model without one loads, and its kind decides what it reads."""
    def no_audio(cfg):
        for key in ("audio", *harness.FIXED):
            del cfg[key]
    with tempfile.TemporaryDirectory() as tmp:
        _root_with(tmp, no_audio)
        cell = harness.load_cell("gen_tgh_plms50", tmp)
    assert "audio" not in cell.config and cell.chips == 1
    assert cell.config["image_size"] == [128, 256]
    assert cell.traffic == harness.load_cell("gen_tgh_plms50").traffic


@pytest.mark.parametrize("key", sorted(harness.FIXED))
def test_an_audio_configuration_that_leaves_out_a_fixed_key_is_refused(
        key):
    def drop(cfg):
        del cfg[key]
    with tempfile.TemporaryDirectory() as tmp:
        _root_with(tmp, drop)
        with pytest.raises(ValueError, match=key):
            harness.load_cell("train_256_b4a2", tmp)


# ------------------------------------------------------ the processes ---

def test_nothing_forbidden_is_imported():
    """benchmark/run.py, the harness and the kinds with the port's modules
    they drive load no JAX package; the reference loads nothing of the
    port."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import importlib.util\n"
        "spec = importlib.util.spec_from_file_location('run', %r)\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import benchmark.reference.pipeline, benchmark.reference.train\n"
        "import benchmark.weights, benchmark.work\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "from benchmark import harness\n"
        "from benchmark.kinds import generate, finetune\n"
        "import asva_tpu_torch.pipelines.generate, asva_tpu_torch.runtime\n"
        "import asva_tpu_torch.training, asva_tpu_torch.parallel.mesh\n"
        "print(ref); print(harness.forbidden_modules())\n"
    ) % (ROOT, os.path.join(ROOT, "benchmark", "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    ref_modules, forbidden = out.stdout.strip().splitlines()[-2:]
    assert "asva_tpu_torch" not in eval(ref_modules)
    assert eval(forbidden) == []
    assert harness.forbidden_modules(["asva_tpu.ops", "numpy"]) == \
        ["asva_tpu"]
    assert harness.forbidden_modules(["asva_tpu_torch.ops", "jaxtyping"]) \
        == []


def test_no_card_exits_nonzero_without_a_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "gen_256_plms50",
         "--seed", str(2**31 + 1), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and "{" not in out.stdout
    assert "card" in out.stderr


def test_a_checkout_without_the_program_exits_nonzero(tmp_path):
    for rel in ("BENCHMARK.json",):
        (tmp_path / rel).write_bytes(open(os.path.join(ROOT, rel),
                                          "rb").read())
    subprocess.run(["cp", "-r", os.path.join(ROOT, "benchmark"),
                    str(tmp_path / "benchmark")], check=True)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "gen_256_plms50",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout


# --------------------------------------------------------- on a card ---

@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["gen_256_plms50", "gen_tgh_plms50",
                                      "train_256_b4a2"])
def test_the_float8_control_is_not_correct(workload):
    """The fp8 reference in the program's place, at the cell's own size,
    fails the cell's limits (benchmark/control.py)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    from benchmark import control
    readings = control.control_readings(harness.load_cell(workload),
                                        2**31 + 41, "cuda")
    limits = harness.load_cell(workload).limits
    assert any(readings[k] > lim for k, lim in limits.items()), readings


@pytest.mark.parametrize("workload", ["gen_256_plms50", "train_256_b4a2"])
def test_the_float8_control_reads_far_above_the_program(tiny, workload):
    """At the tiny size on the CPU the control runs end to end and its
    numbers lie far above those of the bfloat16 program's rehearsal."""
    from benchmark import control
    cell = tiny(workload)
    got = control.control_readings(cell, 2**31 + 51, "cpu")
    kind = generate if cell.traffic["kind"] == "generate" else finetune
    program = {k: v for k, (v, _) in _run(cell, kind, seed=2**31 + 51)
               .checks.items()}
    assert all(np.isfinite(v) for v in got.values())
    assert max(got[k] / program[k] for k in program) > 3, (got, program)


def _data_parallel_rank(rank, world, port, out, fault, trace=False):
    torch.set_num_threads(2)
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(world), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig
    from asva_tpu_torch.models.unet3d import UNet3DConfig
    from asva_tpu_torch.models.vae import VAEConfig
    from asva_tpu_torch.parallel import multihost
    if fault:
        faults.no_exchange(setattr)
    multihost.maybe_initialize_distributed("cpu")
    cell = harness.load_cell("train_256_dp4")
    cell.config.update(
        unet=_group(UNet3DConfig.tiny(audio_cross_attention_dim=32),
                    ("remat", "remat_policy")),
        vae=_group(VAEConfig.tiny()),
        audio=_group(ImageBindAudioConfig.tiny()), image_size=[16, 16])
    cell.traffic.update(batch_size=2, pool_micro_batches=8,
                        data_parallel=world, stretch_units=1)
    outcome = _run(cell, finetune, trace, rank=rank, world=world)
    if rank == 0:
        with open(out, "w") as f:
            json.dump({"correct": harness.correct(outcome.checks),
                       "checks": outcome.checks,
                       "metrics": harness.per_layer_metrics(
                           cell, outcome.record)}, f)
    import torch.distributed as dist
    dist.destroy_process_group()


@pytest.mark.parametrize("fault,trace", [(False, False), (False, True),
                                         (True, False)])
def test_data_parallel_rehearsal_and_the_exchange_left_out(tmp_path, fault,
                                                           trace):
    """Two gloo ranks of the data-parallel cell at the tiny size: correct
    as it stands, traced or not, and not correct with the gradient mean
    across ranks left out."""
    import torch.multiprocessing as mp
    out = str(tmp_path / "rank0.json")
    mp.start_processes(_data_parallel_rank,
                       args=(2, harness._free_port(), out, fault, trace),
                       nprocs=2,
                       join=True, start_method="spawn")
    got = json.load(open(out))
    assert got["correct"] is (not fault), got
    if trace:
        assert got["metrics"]["optim_ms.train"]["value"] > 0, got
