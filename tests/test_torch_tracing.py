"""The port's spans and counters (asva_tpu_torch/observability.py) on the
CPU: off means the shared no-op and no record; nesting, parents, units and
one stack per thread; the spans on torch.profiler's clock; the named tree
of a tiny pipeline request and of a tiny trainer step, with the gradient
mean's bytes; `profile_steps` writing the spans into its trace; the
training CLI's step timer.  Tiny modules, fp32, a few seconds in all."""
import json
import threading
import time
import types

import numpy as np
import torch

from asva_tpu_torch import observability as obs
from asva_tpu_torch.utils import StepTimer

F = 4          # frames of the tiny pipeline and trainer


def _children(record, parent):
    return [s[0] for s in record.spans if s[3] == parent]


def test_off_is_the_shared_no_op_and_records_nothing():
    assert obs._RECORD is None
    a, b = obs.span("a"), obs.span("b")
    assert a is b is obs._OFF
    with a as got:
        assert got is obs._OFF
    assert obs.count("c", 5) is None

    @obs.traced("f")
    def f(x):
        return x + 1
    assert f(1) == 2 and f.__name__ == "f"
    with obs.tracing() as rec:
        assert f(2) == 3
    assert [s[0] for s in rec.spans] == ["f"] and obs._RECORD is None
    assert f(3) == 4 and len(rec.spans) == 1        # off again


def test_nesting_parents_units_and_threads():
    with obs.tracing() as rec:
        with obs.tracing() as inner:          # nested: the same record
            assert inner is rec
        with obs.span("step"):
            with obs.span("a"):
                obs.count("bytes", 4)
                with obs.span("b"):
                    pass
            barrier = threading.Barrier(2, timeout=10)

            def worker():
                with obs.span("bwd"):
                    barrier.wait()
                    with obs.span("bwd.inner"):
                        obs.count("bytes", 6)
            th = threading.Thread(target=worker)
            th.start()
            with obs.span("main.side"):
                barrier.wait()
            th.join(timeout=10)
            assert not th.is_alive()
        with obs.span("step"):
            obs.count("bytes", 1)
    assert obs._RECORD is None
    names = {s[0]: (i, s) for i, s in enumerate(rec.spans)}
    step0 = names["a"][1][3]
    assert rec.spans[step0][0] == "step" and rec.spans[step0][3] == -1
    assert names["b"][1][3] == names["a"][0]
    assert names["main.side"][1][3] == step0
    # the worker's spans: their own stack, their own unit
    bwd_id, bwd = names["bwd"]
    assert bwd[3] == -1 and bwd[5] == bwd_id
    assert names["bwd.inner"][1][3] == bwd_id
    assert names["bwd.inner"][1][5] == bwd_id
    assert bwd[4] != rec.spans[step0][4]             # another thread id
    for i, s in enumerate(rec.spans):
        assert s[1] <= s[2], s
        if s[3] >= 0:
            p = rec.spans[s[3]]
            assert p[1] <= s[1] and s[2] <= p[2] and s[5] == p[5]
        if s[0] in ("a", "b", "main.side"):
            assert s[5] == step0
    assert rec.spans[-1][0] == "step" and rec.spans[-1][5] == \
        len(rec.spans) - 1
    # counters: each sample in the order counted, on the record's clock
    assert [(n, k) for n, k, _ in rec.counts] == [
        ("bytes", 4), ("bytes", 6), ("bytes", 1)]
    times = [t for _, _, t in rec.counts]
    assert times == sorted(times)
    assert names["a"][1][1] <= times[0] <= names["a"][1][2]


def test_a_span_closes_into_its_record_after_tracing_ends():
    with obs.tracing() as rec:
        s = obs.span("open")
        s.__enter__()
    s.__exit__(None, None, None)
    assert rec.spans[0][2] is not None and rec.spans[0][2] >= rec.spans[0][1]


def test_spans_lie_on_the_profilers_clock(tmp_path):
    """A span around a record_function range contains the range, both on
    the trace's clock (ts + baseTimeNanoseconds / 1e3 us), within 50 us."""
    from torch.profiler import ProfilerActivity, profile, record_function
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with obs.tracing() as rec:
        for _ in range(3):
            with obs.span("outer"):
                with record_function("probe"):
                    torch.ones(64).sum()
                    time.sleep(0.002)
    prof.stop()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    obs.add_spans_to_trace(path, rec)
    events = json.load(open(path))["traceEvents"]
    probes = sorted((e for e in events if e.get("name") == "probe"
                     and e.get("ph") == "X"), key=lambda e: e["ts"])
    spans = sorted((e for e in events if e.get("cat") == "program_span"),
                   key=lambda e: e["ts"])
    assert len(probes) == len(spans) == 3
    for p, s in zip(probes, spans):
        assert s["name"] == "outer" and s["tid"] == p["tid"]
        assert s["ts"] - 50 <= p["ts"], (s, p)
        assert p["ts"] + p["dur"] <= s["ts"] + s["dur"] + 50, (s, p)
        assert p["dur"] >= 2000 and s["dur"] < p["dur"] + 1000


def _tiny_modules(train: bool):
    from asva_tpu_torch.models.imagebind_audio import (ImageBindAudioConfig,
                                                       SegmaskAudioEncoder)
    from asva_tpu_torch.models.unet3d import AudioUNet3D, UNet3DConfig
    from asva_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    torch.manual_seed(0)
    unet = AudioUNet3D(UNet3DConfig.tiny(audio_cross_attention_dim=32,
                                         remat=train))
    vae = AutoencoderKL(VAEConfig.tiny())
    audio = SegmaskAudioEncoder(ImageBindAudioConfig.tiny(), n_segment=F)
    for m in (unet, vae, audio):
        m.train(train)
    return unet, vae, audio


def test_a_pipeline_request_gives_the_named_tree(tmp_path):
    from scipy.io import wavfile
    from PIL import Image

    from asva_tpu_torch.pipelines.animation import AnimationPipeline
    from asva_tpu_torch.pipelines.generate import generate_videos
    pipe = AnimationPipeline(*_tiny_modules(False),
                             null_text_encoding=torch.randn(1, 77, 768))
    rng = np.random.default_rng(0)
    png, wav = str(tmp_path / "a.png"), str(tmp_path / "a.wav")
    Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
        png)
    wavfile.write(wav, 16000, (rng.standard_normal(16000 * 3) * 0.1).astype(
        np.float32))
    kw = dict(image_path=png, audio_path=wav,
              category_text_encoding=np.zeros((1, 77, 768), np.float32),
              image_size=(16, 16), video_fps=6, video_num_frame=F,
              num_clips_per_video=2, audio_guidance_scale=4.0,
              num_inference_steps=2, sampler="ddim", seed=3)
    with obs.tracing() as rec:
        got = generate_videos(pipe, **kw)
    off = generate_videos(pipe, **kw)         # off: the same frames
    assert all(np.array_equal(a[0], b[0]) for a, b in zip(got, off))
    request = [i for i, s in enumerate(rec.spans) if s[0] == "gen.request"]
    assert len(request) == 1 and rec.spans[request[0]][3] == -1
    assert {s[5] for s in rec.spans} == set(request)      # one unit
    kids = _children(rec, request[0])
    assert set(kids) == {"gen.load", "pipe.encode_image", "pipe.encode_audio",
                         "pipe.denoise", "pipe.decode_latents"}, kids
    denoise = [i for i, s in enumerate(rec.spans) if s[0] == "pipe.denoise"]
    steps = _children(rec, denoise[0])
    # 2 DDIM rows: sampler, UNet, sampler each
    assert steps == ["sampler.step", "unet.call", "sampler.step"] * 2
    calls = [i for i, s in enumerate(rec.spans) if s[0] == "unet.call"]
    blocks = _children(rec, calls[0])
    levels = len(pipe.unet.down_blocks)
    assert blocks == (["unet.down.%d" % i for i in range(levels)]
                      + ["unet.mid"]
                      + ["unet.up.%d" % i for i in range(levels)])
    fused = {s[0] for s in rec.spans
             if rec.spans[s[3]][0].startswith("unet.")}
    assert {"fused.B2", "fused.B3"} <= fused
    # the denoise loop lies inside its children, back to back
    d = rec.spans[denoise[0]]
    loop = [rec.spans[i] for i, s in enumerate(rec.spans)
            if s[3] == denoise[0]]
    assert d[1] <= loop[0][1] and loop[-1][2] <= d[2]
    assert all(a[2] <= b[1] for a, b in zip(loop, loop[1:]))


def test_a_trainer_step_gives_train_optim_and_the_exchanged_bytes(
        monkeypatch):
    """On a stubbed two-rank mesh (the collective the identity): the
    step's spans and a comm.bytes sample equal to what all_reduce_mean_
    returns, 4 bytes a trainable fp32 gradient element."""
    import torch.distributed as dist

    from asva_tpu_torch.training import (AnimationTrainConfig,
                                         AnimationTrainer, TrainState,
                                         build_optimizer, trainable_mask)
    from asva_tpu_torch.training import animation_trainer as at
    from asva_tpu_torch.training.optim import apply_trainable_mask
    unet, vae, audio = _tiny_modules(True)
    apply_trainable_mask(unet, trainable_mask(unet))
    trainer = AnimationTrainer(unet=unet, vae=vae, audio_encoder=audio,
                               null_text_encoding=torch.randn(1, 77, 768),
                               config=AnimationTrainConfig())
    state = TrainState(0, unet, build_optimizer(unet, 1e-4))
    returned = []

    def recorded(tensors, mesh):
        returned.append(all_reduce_mean_(tensors, mesh))
        return returned[-1]
    all_reduce_mean_ = at.all_reduce_mean_
    monkeypatch.setattr(at, "all_reduce_mean_", recorded)
    monkeypatch.setattr(dist, "all_reduce", lambda t, *a, **k: None)
    mesh = types.SimpleNamespace(world=2)
    g = torch.Generator().manual_seed(0)
    batch = {"videos": torch.rand(1, F, 16, 16, 3, generator=g),
             "waveforms": torch.randn(1, 1, 8000, generator=g) * 0.1,
             "text_encodings": torch.randn(1, 77, 768, generator=g)}
    with obs.tracing() as rec:
        _, grads = trainer.grad_step(state, batch, torch.Generator()
                                     .manual_seed(1))
        trainer.apply_step(state, grads, mesh)
    names = [s[0] for s in rec.spans]
    top = [s[0] for s in rec.spans if s[3] == -1]
    assert top == ["train.grad_step", "train.apply_step"], top
    assert _children(rec, names.index("train.grad_step")) == [
        "train.draw", "train.encode", "train.forward", "train.backward"]
    apply = names.index("train.apply_step")
    kids = _children(rec, apply)
    assert kids[-2:] == ["optim.clip", "optim.adamw"]
    assert set(kids[:-2]) == {"comm.all_reduce"}
    # the backward's fused rules and the recomputed blocks
    backward = names.index("train.backward")
    inside = {s[0] for s in rec.spans[backward + 1:apply]}
    assert {"fused.B1", "fused.B3", "unet.down.0"} <= inside, inside
    elements = sum(p.numel() for p in state.optimizer.params)
    assert returned == [4 * elements]
    assert [(n, k) for n, k, _ in rec.counts] == [
        ("comm.bytes", 4 * elements)]
    start, end = rec.spans[apply][1:3]
    assert start <= rec.counts[0][2] <= end


def test_profile_steps_writes_the_spans_into_its_trace(tmp_path):
    with obs.profile_steps(str(tmp_path)):
        with obs.span("outer"):
            torch.ones(4).sum()
            obs.count("comm.bytes", 8)
    assert obs._RECORD is None
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    mine = [e for e in events if e.get("cat") in ("program_span",
                                                  "program_counter")]
    assert [(e["ph"], e["name"]) for e in mine] == [("X", "outer"),
                                                    ("C", "comm.bytes")]
    assert mine[1]["args"] == {"comm.bytes": 8}


def test_step_timer_counts_the_steps_of_a_tick():
    timer = StepTimer(window=5)
    timer.last -= 2.0
    timer.tick(4)                  # 4 steps in about 2 s
    assert 1.9 < timer.steps_per_sec <= 2.0
    timer.last -= 1.0
    timer.tick()                   # 5 steps in about 3 s
    assert 1.6 < timer.steps_per_sec <= 5 / 3
    timer.last -= 1.0
    timer.tick(2)                  # past 5 steps: the first tick drops out
    assert 1.4 < timer.steps_per_sec <= 1.5
    timer.last -= 1.0
    timer.tick(9)                  # the newest tick stays, however long
    assert list(timer.steps) == [9] and 8.5 < timer.steps_per_sec <= 9
