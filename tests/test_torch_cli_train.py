"""The port's training, serving and sync-eval CLIs, AVID-CMA init and the
one-process `parallel/` forms on the CPU.

Each CLI's flags and defaults equal those of the repository's scripts/
(compared by AST), plus `--device`.  `main(argv)` runs in this process at
tiny configs on clips the port's writer makes: `animation_train` (3 steps,
accumulation 2; a run resumed from checkpoint-2 equals the uninterrupted
one bit for bit, and checkpoint-3's exports load), `avsync_train` (2 steps
through the process loader, one in-train evaluation against a mean
computed by hand, the classifier export), `avsync_eval` against asva_tpu's
script on the same clips and weights (the same per-example hits), and
`animation_serve` in a thread.  The full-size VAE and audio tower are
replaced by tiny ones in the runtime's builders, as the UNet is by the
YAML."""
import ast
import dataclasses
import http.client
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import pytest
import torch

from asva_tpu_torch import runtime
from asva_tpu_torch.data import media
from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig
from asva_tpu_torch.models.vae import VAEConfig

pytestmark = pytest.mark.skipif(not media.headers_available(),
                                reason="libav development files missing")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = ("animation_demo", "animation_gen", "animation_eval", "avsync_metric",
        "animation_serve", "animation_train", "avsync_train", "avsync_eval")
UNET_YAML = """
  unet:
    down_block_types: [FFSpatioAudioTempCrossAttnDownBlock3D, FFSpatioTempResDownBlock3D]
    up_block_types: [FFSpatioTempResUpBlock3D, FFSpatioAudioTempCrossAttnUpBlock3D]
    mid_block_type: FFSpatioAudioTempCrossAttnUNetMidBlock3D
    block_out_channels: [32, 64]
    layers_per_block: 1
    norm_num_groups: 8
    attention_head_dim: 2
    audio_cross_attention_dim: 32
"""


def _write(path, n=40, fps=12.0, hw=(64, 64), seed=0):
    rng = np.random.default_rng(seed)
    frames = (rng.random((n,) + hw + (3,)) * 255).astype(np.uint8)
    t = np.arange(int(n / fps * 16000)) / 16000
    audio = (0.3 * np.sin(2 * np.pi * (300 + 40 * seed) * t)).astype(
        np.float32)[None]
    os.makedirs(os.path.dirname(path), exist_ok=True)
    media.write_video(path, frames, fps, audio, 16000)


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """8 clips of a class with its encoding, as tests/test_scripts.py makes
    them (40 frames at 12 fps, 64x64, 16 kHz audio)."""
    root = tmp_path_factory.mktemp("ds")
    names = [f"dog/v{i}.mp4" for i in range(8)]
    for i, name in enumerate(names):
        _write(str(root / name), seed=i)
    (root / "train.txt").write_text("\n".join(names))
    (root / "test.txt").write_text("\n".join(names[:3]))
    rng = np.random.default_rng(1)
    np.savez(root / "enc.npz",
             **{"a dog": rng.standard_normal((77, 768)).astype(np.float32)})
    (root / "class_mapping.json").write_text(json.dumps({"dog": "a dog"}))
    return root


@pytest.fixture
def tiny_towers(monkeypatch):
    """The runtime's VAE and audio-tower builders make tiny models."""
    for name, cfg in (("build_vae", VAEConfig.tiny()),
                      ("build_audio_encoder", ImageBindAudioConfig.tiny())):
        orig = getattr(runtime, name)
        if name == "build_vae":
            def build(config=None, *a, _orig=orig, _cfg=cfg, **kw):
                return _orig(_cfg, *a, **kw)
        else:
            def build(n_segment=12, config=None, *a, _orig=orig, _cfg=cfg,
                      **kw):
                return _orig(n_segment, _cfg, *a, **kw)
        monkeypatch.setattr(runtime, name, build)


# ----------------------------------------------------------------- flags ---

def _flags(tree):
    """{flag: (default, type, nargs, required, action)} of the
    add_argument calls in a module's AST."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords
                  if k.arg in ("default", "type", "nargs", "required",
                               "action", "choices")}
            name = node.args[0]
            out[name.value if isinstance(name, ast.Constant)
                else ast.unparse(name)] = kw
    return out


@pytest.mark.parametrize("name", CLIS)
def test_cli_flags_match_scripts(name):
    """The port's CLI has the flags and defaults of scripts/<name>.py, plus
    --device, and a main(argv=None)."""
    def parse(path):
        with open(path) as f:
            return ast.parse(f.read())
    ref = _flags(parse(os.path.join(REPO, "scripts", f"{name}.py")))
    mod = parse(os.path.join(REPO, "asva_tpu_torch", "scripts", f"{name}.py"))
    ours = _flags(mod)
    common = parse(os.path.join(REPO, "asva_tpu_torch", "scripts",
                                "common.py"))
    assert "add_device_flag" in ast.unparse(mod)
    ours.update(_flags(common))
    assert ours.pop("--device") == {"default": "'cuda'"}
    assert ours == ref
    main = next(n for n in mod.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    assert main.args.args[0].arg == "argv"
    assert all(ast.unparse(d) == "None" for d in main.args.defaults)
    assert len(main.args.defaults) == len(main.args.args)


# ------------------------------------------------------- animation_train ---

def _animation_yaml(root, out):
    """tests/test_scripts.py's animation_train config (its UNet, 3 steps of
    batch 1 with accumulation 2, checkpoints every 2 steps kept as
    milestones), with the tiny audio tower's width."""
    return f"""
exp:
  output_dir: "{out}"
  seed: 1
model:
  scheduler: {{beta_start: 0.00085, beta_end: 0.012, prediction_type: epsilon}}
  audio_encoder: {{n_segment: 4}}
{UNET_YAML}
  audio_cond_drop_prob: 0.2
train:
  batch_size: 1
  log_steps: 1
  dataset:
    data_root: "{root}"
    example_list_path: "{root}/train.txt"
    img_size: [32, 32]
    video_fps: 6
    video_num_frame: 4
    class_mapping_json: "{root}/class_mapping.json"
    class_text_encoding_mapping_pt: "{root}/enc.npz"
optim:
  learning_rate: 1e-4
  gradient_accumulation_steps: 2
  checkpointing_steps: 2
  checkpointing_milestones: 2
"""


def test_animation_train_cli_resumes_bit_for_bit(clips, tmp_path,
                                                 tiny_towers):
    """3 steps write checkpoint-2 (a milestone) and checkpoint-3 with the
    loader's cursor; a run resumed from checkpoint-2 takes step 3 with the
    same loss and parameters, bit for bit; checkpoint-3's exports load
    through load_animation_pipeline; an --fsdp that does not divide the
    processes is refused."""
    import shutil

    from asva_tpu_torch.scripts import animation_train
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    cfg = tmp_path / "a.yaml"
    cfg.write_text(_animation_yaml(clips, tmp_path / "a"))
    argv = ["--config_file", str(cfg), "--max_steps_override", "3",
            "--device", "cpu"]
    with pytest.raises(ValueError, match="fsdp=2 does not divide the 1"):
        animation_train.main(argv + ["--fsdp", "2"])
    full = animation_train.main(argv)
    mgr = CheckpointManager(str(tmp_path / "a" / "ckpts"))
    assert mgr.existing_steps() == [2, 3]
    assert len(full["losses"]) == 3 and full["resumed_from"] is None
    assert mgr.restore_extra(2)["loader"] == {"epoch": 0, "cursor": 4,
                                              "seed": 1}
    assert mgr.restore_extra(3)["loader"] == {"epoch": 0, "cursor": 6,
                                              "seed": 1}

    # the interrupted run: its checkpoint-2 only
    shutil.copytree(mgr._path(2), tmp_path / "b" / "ckpts" / "checkpoint-2")
    cfg_b = tmp_path / "b.yaml"
    cfg_b.write_text(_animation_yaml(clips, tmp_path / "b"))
    resumed = animation_train.main(["--config_file", str(cfg_b),
                                    "--max_steps_override", "3",
                                    "--device", "cpu"])
    assert resumed["resumed_from"] == 2 and resumed["state"].step == 3
    assert resumed["losses"] == full["losses"][2:]
    assert resumed["loader"] == full["loader"]
    want = full["state"].unet.state_dict()
    got = resumed["state"].unet.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    for kind in ("mu", "nu"):
        a = full["state"].optimizer.state_dict()[kind]
        b = resumed["state"].optimizer.state_dict()[kind]
        assert all(torch.equal(a[k], b[k]) for k in a)

    pipe = runtime.load_animation_pipeline(mgr.modules_dir(3), device="cpu",
                                           dtype=torch.float32)
    loaded = pipe.unet.state_dict()
    assert all(torch.equal(loaded[k], want[k].float()) for k in want)
    recorded = runtime.load_module_configs(mgr.modules_dir(3))
    assert recorded["audio_encoder"] == dict(
        dataclasses.asdict(ImageBindAudioConfig.tiny()), n_segment=4)


# ---------------------------------------------------------- avsync_train ---

def test_avsync_train_cli_and_evaluate(clips, tmp_path):
    """tests/test_scripts.py's avsync_train config: 2 steps through the
    process loader, checkpoint-2 with the loader's state and the classifier
    export, which build_avsync_classifier loads; one evaluate() whose mean
    is the batch-size-weighted mean of eval_metrics over the test batches
    (2 + 1 examples)."""
    import logging

    from asva_tpu_torch.scripts import avsync_train
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    cfg = tmp_path / "sync.yaml"
    ds = f"""
    data_root: "{clips}"
    image_size: 32
    video_fps: 6
    video_num_frames: 4
    shift_time: 0.2
    num_clips: 3"""
    cfg.write_text(f"""
exp:
  output_dir: "{tmp_path}/sync"
  seed: 1
model:
  tau: 0.1
train:
  batch_size: 1
  log_steps: 1
  dataset:
    example_list_path: "{clips}/train.txt"
    sampling_type: "random-compact"{ds}
test:
  batch_size: 2
  test_steps: 0
  dataset:
    example_list_path: "{clips}/test.txt"
    sampling_type: "uniform"{ds}
optim:
  learning_rate: 1e-4
  checkpointing_steps: 2
""")
    out = avsync_train.main(["--config_file", str(cfg),
                             "--max_steps_override", "2", "--device", "cpu"])
    state = out["state"]
    assert state.step == 2 and len(out["metrics"]) == 2
    assert all(np.isfinite(v) for m in out["metrics"] for v in m.values())
    mgr = CheckpointManager(str(tmp_path / "sync" / "ckpts"))
    assert mgr.existing_steps() == [2]
    assert mgr.restore_extra(2)["loader"] == {"epoch": 0, "cursor": 2,
                                              "seed": 1}
    clf = runtime.build_avsync_classifier(
        os.path.join(mgr.modules_dir(2), "classifier"), device="cpu")
    want = state.classifier.state_dict()
    assert all(torch.equal(v, want[k]) for k, v in clf.state_dict().items())

    trainer, loader = out["trainer"], out["test_loader"]
    mean = avsync_train.evaluate(trainer, loader, "cpu",
                                 logging.getLogger("test"), max_batches=50)
    sums, n = {}, 0
    loader.reset()
    for batch in loader:
        m = trainer.eval_metrics({"mels": avsync_train.mels_of(
            batch["waveforms"]), "videos": batch["videos"]})
        b = len(batch["videos"])
        for k, v in m.items():
            sums[k] = sums.get(k, 0.0) + float(v) * b
        n += b
    assert n == 3
    for k, v in sums.items():
        np.testing.assert_allclose(mean[k], v / n, rtol=1e-12)


# ----------------------------------------------------------- avsync_eval ---

def test_avsync_eval_cli_matches_jax(clips, tmp_path, monkeypatch, capsys):
    """The same per-example hits and A2V/V2A accuracies as asva_tpu's
    scripts/avsync_eval.py, run in this process on the same clips and on
    the same classifier (seeded in the port, saved in the reference's
    per-module layout, which both packages load)."""
    from asva_tpu.parallel import multihost as jax_multihost
    from asva_tpu_torch.scripts import avsync_eval
    from test_torch_media import jax_media
    jax_media()
    clf = runtime.build_avsync_classifier(device="cpu", seed=30,
                                          randomize_all=True)
    mods = tmp_path / "modules"
    for name in ("audio_encoder", "video_encoder", "head"):
        (mods / name).mkdir(parents=True)
        torch.save(getattr(clf, name).state_dict(),
                   mods / name / "pytorch_model.bin")
    argv = ["--data_root", str(clips), "--example_list_path",
            str(clips / "test.txt"), "--checkpoint_modules_dir", str(mods),
            "--num_clips", "7", "--shift_time", "0.2", "--tolerance", "0",
            "--image_size", "32", "--video_num_frames", "4",
            "--max_examples", "3"]
    got = avsync_eval.main(argv + ["--device", "cpu"])
    assert "over 3 examples" in capsys.readouterr().out

    records = []
    gather = jax_multihost.gather_metric_records

    def record(indices, values, value_shape=None):
        records.append((np.asarray(indices), np.asarray(values)))
        return gather(indices, values, value_shape)
    monkeypatch.setattr(jax_multihost, "gather_metric_records", record)
    spec = importlib.util.spec_from_file_location(
        "jax_avsync_eval", os.path.join(REPO, "scripts", "avsync_eval.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["avsync_eval.py"] + argv)
    script.main()
    out = capsys.readouterr().out
    indices, hits = records[0]
    np.testing.assert_array_equal(got["indices"], indices)
    np.testing.assert_array_equal(got["hits"], hits)
    assert f"A2V sync acc: {got['a2v']:.4f} over 3 examples" in out
    assert f"V2A sync acc: {got['v2a']:.4f}" in out


# ------------------------------------------------------------- AVID-CMA ---

def test_init_avsync_from_avid_cma_matches_jax(tmp_path):
    """A synthetic AVID-CMA tar ({"model": {module.audio_model.*,
    module.video_model.*}}, as tests/test_convert_real_layouts.py builds
    it, plus one key of neither tower) loaded into the same fresh
    classifier by both packages: the same tensors, the head left at its
    init, the scores within 1e-5; `modules` selects the towers."""
    import jax
    import jax.numpy as jnp
    from asva_tpu.convert import convert_state_dict
    from asva_tpu.convert.jax_to_torch import export_state_dict
    from asva_tpu.convert.torch_to_jax import avsync_key_map
    from asva_tpu.models.avsync import AVSyncClassifier as JaxClassifier
    from asva_tpu.runtime import init_avsync_from_avid_cma as jax_init

    def fresh():
        return runtime.build_avsync_classifier(device="cpu", seed=40,
                                               randomize_all=True)
    source = runtime.build_avsync_classifier(device="cpu", seed=41,
                                             randomize_all=True)
    raw = {f"module.{tag}_model.{k}": v
           for tag in ("audio", "video")
           for k, v in getattr(source, f"{tag}_encoder").state_dict().items()}
    raw["module.queue_memory"] = torch.zeros(4)
    path = tmp_path / "AVID-CMA_checkpoint.pth.tar"
    torch.save({"model": raw}, path)

    clf = fresh()
    before = {k: v.clone() for k, v in clf.state_dict().items()}
    report = runtime.init_avsync_from_avid_cma(clf, str(path))
    assert report["unused"] == ["module.queue_memory"]
    assert not report["missing"]
    assert len(report["loaded"]) == len(raw) - 1
    state = clf.state_dict()
    for k, v in state.items():
        tower, _, rest = k.partition(".")
        if tower == "head":
            assert torch.equal(v, before[k])
        else:
            src = raw[f"module.{tower.split('_')[0]}_model.{rest}"]
            assert torch.equal(v, src.to(v.dtype))

    jm = JaxClassifier()
    mel = np.random.default_rng(0).standard_normal(
        (2, 128, 204, 1)).astype(np.float32)
    video = np.random.default_rng(1).standard_normal(
        (2, 4, 32, 32, 3)).astype(np.float32)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1,) + mel.shape[1:]),
                            jnp.zeros((1,) + video.shape[1:]))
    variables, rep = convert_state_dict(
        shapes, {k: v.numpy() for k, v in before.items()}, avsync_key_map)
    assert not rep["fresh"]
    variables, _ = jax_init(dict(variables), str(path))
    exported = export_state_dict(variables, avsync_key_map)
    assert exported and all(np.array_equal(state[k].numpy(), v)
                            for k, v in exported.items())
    want = jax.jit(jm.apply)(variables, mel, video)
    with torch.no_grad():
        got = clf(torch.from_numpy(mel), torch.from_numpy(video))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(
        got.shape), rtol=1e-5, atol=1e-5)

    audio_only = fresh()
    runtime.init_avsync_from_avid_cma(audio_only, str(path),
                                      modules=("audio",))
    for k, v in audio_only.state_dict().items():
        if not k.startswith("audio_encoder."):
            assert torch.equal(v, before[k])


# ------------------------------------------------------- animation_serve ---

def _request(port, method, path, body=None, timeout=60):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request(method, path, json.dumps(body) if body else None,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def test_animation_serve_cli(tmp_path, tiny_towers, monkeypatch, capsys):
    """The server in a thread: a warmup, /healthz, one /generate with a
    save_template that writes its mp4s, two concurrent requests that get
    distinct ids (their default templates), a failed request that does not
    count, and the exit after --max_requests successful requests."""
    from PIL import Image
    from scipy.io import wavfile

    from asva_tpu_torch.scripts import animation_serve
    cfg = tmp_path / "serve.yaml"
    cfg.write_text("model:\n  audio_encoder: {n_segment: 4}\n" + UNET_YAML)
    img = str(tmp_path / "cond.png")
    Image.fromarray((np.random.default_rng(0).random((64, 64, 3)) * 255
                     ).astype(np.uint8)).save(img)
    wav = str(tmp_path / "cond.wav")
    s = np.arange(3 * 16000) / 16000
    wavfile.write(wav, 16000, (0.4 * np.sin(2 * np.pi * 440 * s)).astype(
        np.float32))
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    listening = []
    server = threading.Thread(target=animation_serve.main, args=([
        "--port", "0", "--config_file", str(cfg), "--sd_root", "",
        "--null_text_encoding_path", "", "--image_size", "32", "32",
        "--warmup", "--warmup_steps", "1", "--warmup_clips", "2",
        "--max_requests", "3", "--device", "cpu"], listening.append),
        daemon=True)
    server.start()
    text, deadline = "", time.time() + 60
    while "listening on" not in text and time.time() < deadline:
        time.sleep(0.05)
        text += capsys.readouterr().out
    assert "[serve] warmup" in text
    port = int(text.split("listening on 127.0.0.1:")[1].split()[0])
    assert port > 0 and listening[0].server_address[1] == port
    assert _request(port, "GET", "/healthz") == (
        200, {"ok": True, "requests": 0, "warm": True})

    req = {"image_path": img, "audio_path": wav, "num_clips": 1,
           "num_inference_steps": 1, "sampler": "ddim"}
    status, resp = _request(port, "POST", "/generate",
                            dict(req, image_path=str(tmp_path / "none")))
    assert status == 500 and not resp["ok"]
    status, resp = _request(port, "POST", "/generate",
                            dict(req, save_template=str(tmp_path / "srv")))
    assert status == 200 and resp["outputs"] == [
        str(tmp_path / "srv_clip-00.mp4")]
    with media.MediaReader(resp["outputs"][0]) as r:
        assert r.size == (32, 32)
    replies = []
    pair = [threading.Thread(target=lambda: replies.append(
        _request(port, "POST", "/generate", req))) for _ in range(2)]
    for t in pair:
        t.start()
    for t in pair:
        t.join(timeout=60)
    assert sorted(r[1]["outputs"][0] for r in replies) == [
        str(tmp_path / f"asva_serve_{i}_clip-00.mp4") for i in (2, 3)]
    server.join(timeout=30)
    assert not server.is_alive()


# ------------------------------------------------------- parallel (one) ---

def test_multihost_one_process_forms():
    from asva_tpu_torch.parallel import multihost
    assert multihost.maybe_initialize_distributed() is False
    batch = {"x": torch.arange(6.0).reshape(2, 3), "y": np.ones(2)}
    out = multihost.make_global_batch(batch, "cpu")
    assert torch.equal(out["x"], batch["x"]) and out["y"].dtype == \
        torch.float64
    np.testing.assert_array_equal(multihost.process_allgather([[1, 2]]),
                                  [[1, 2]])
    idx, vals = multihost.gather_metric_records(
        [3, 1, 3, 2], [[1, 0], [0, 1], [0, 0], [1, 1]], value_shape=(2,))
    np.testing.assert_array_equal(idx, [1, 2, 3])
    np.testing.assert_array_equal(vals, [[0, 1], [1, 1], [1, 0]])
    tree = {"a": 1}
    assert multihost.globalize_host_local(tree) is tree


RANK = r"""
import datetime, sys
import numpy as np
import torch, torch.distributed as dist
from asva_tpu_torch.parallel import multihost
rank, path = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", store=dist.FileStore(path, 2), rank=rank,
                        world_size=2, timeout=datetime.timedelta(seconds=60))
assert multihost.maybe_initialize_distributed("cpu") is True
assert (multihost.process_index(), multihost.process_count()) == (rank, 2)
local = multihost.make_global_batch({"x": torch.full((2,), rank)}, "cpu")
assert local["x"].tolist() == [rank, rank]
assert multihost.process_allgather(np.array([rank])).tolist() == [0, 1]
idx, vals = multihost.gather_metric_records([rank, 2], [[rank], [5 + rank]])
assert idx.tolist() == [0, 1, 2] and vals.tolist() == [[0], [1], [5]]
tree = {"a": 1}
assert multihost.globalize_host_local(tree) is tree
dist.barrier()
dist.destroy_process_group()
print("across", 2)
"""


def test_multihost_raises_across_processes(tmp_path, monkeypatch):
    """Under a 2-rank gloo group made by the caller every form works across
    processes (each rank's own batch, the gathers over both ranks, each
    index once); a launcher environment that names peers but cannot reach
    them raises instead of carrying on as one process."""
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, str(rank), str(tmp_path / "store")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and "across 2" in out, err[-2000:]

    from asva_tpu_torch.parallel import multihost
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="names peers"):
        multihost.maybe_initialize_distributed("cpu")
