"""The port's data parallelism on the CPU: `asva_tpu_torch/parallel`, the
trainers' gradient mean, BatchNorm's global statistics, primary-rank
checkpoints and metrics, and the multi-process branches of the CLIs.

Two gloo ranks join through `maybe_initialize_distributed` (torchrun's
`env://` variables on a free localhost port), each a subprocess running
this file (`python tests/test_torch_parallel.py <job> <dir>`).  Three pairs
run per module: "main" (every case but two) and "signal" side by side,
then "resume", a fresh pair that continues main's 3-step CLI run.  Each
rank writes its results to <dir>; the tests read them and hold them
against one process on the concatenated batch (the port's own, which
tests/test_torch_train.py and test_torch_sync_train.py hold against
asva_tpu) and against asva_tpu's host gathers.  Tiny configs, fp32, one
thread a process."""
import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from asva_tpu_torch import runtime
from asva_tpu_torch.data import media
from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig
from asva_tpu_torch.models.unet3d import UNet3DConfig
from asva_tpu_torch.models.vae import VAEConfig
from asva_tpu_torch.training import (AnimationTrainConfig, AnimationTrainer,
                                     SyncContrastiveTrainer, SyncTrainState,
                                     TrainState, build_optimizer,
                                     trainable_mask)
from asva_tpu_torch.training.optim import apply_trainable_mask

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 120
F = 4                                  # video length of the tiny trainer
ANIM_B, SYNC_B, SYNC_K = 4, 2, 3       # global batches of the steps
LR = 1e-3


# -------------------------------------------------- shared by both sides ---

def tiny_animation_trainer():
    """A tiny AnimationTrainer, every parameter seeded at random, AdamW over
    the trainable mask."""
    unet = runtime.build_unet(UNet3DConfig.tiny(audio_cross_attention_dim=32),
                              device="cpu", dtype=torch.float32,
                              randomize_all=True, train=True)
    apply_trainable_mask(unet, trainable_mask(unet))
    trainer = AnimationTrainer(
        unet=unet,
        vae=runtime.build_vae(VAEConfig.tiny(), "cpu", torch.float32,
                              randomize_all=True),
        audio_encoder=runtime.build_audio_encoder(
            F, ImageBindAudioConfig.tiny(), "cpu", torch.float32,
            randomize_all=True),
        null_text_encoding=torch.from_numpy(
            np.random.default_rng(5).standard_normal((1, 7, 768)).astype(
                np.float32)),
        config=AnimationTrainConfig(text_cond_drop_prob=0.3,
                                    audio_cond_drop_prob=0.4))
    return trainer, TrainState(0, unet, build_optimizer(unet, LR))


def animation_batch(micro, rows=slice(None)):
    """Micro-batch `micro` of the global batch of ANIM_B, its `rows`."""
    rng = np.random.default_rng(30 + micro)
    batch = {"videos": rng.random((ANIM_B, F, 16, 16, 3)),
             "mels": rng.standard_normal((ANIM_B, 128, 204, 1)),
             "text_encodings": rng.standard_normal((ANIM_B, 7, 768))}
    return {k: torch.from_numpy(v[rows].astype(np.float32))
            for k, v in batch.items()}


def animation_steps(accum, mesh=None, rows=slice(None)):
    """One optimizer step of `accum` micro-batches: (the last micro-batch's
    loss, the gradients the optimizer took, the trainable parameters
    after the step)."""
    trainer, state = tiny_animation_trainer()
    acc = None
    for micro in range(accum):
        loss, grads = trainer.grad_step(
            state, animation_batch(micro, rows),
            torch.Generator().manual_seed(100 + micro), mesh=mesh)
        acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
    grads = [g / accum for g in acc]
    trainer.apply_step(state, grads, mesh)
    return loss, grads, [p.detach().clone() for p in state.optimizer.params]


def sync_batch(rows=slice(None)):
    """test_torch_sync_train.py's sizes: b 2, k 3, 4 frames at 48x48, a
    32x32 mel; float64 (see `sync_step`)."""
    rng = np.random.default_rng(21)
    mels = rng.standard_normal((SYNC_B, SYNC_K, 32, 32, 1))
    videos = rng.standard_normal((SYNC_B, SYNC_K, 4, 48, 48, 3))
    return {"mels": torch.from_numpy(mels[rows]),
            "videos": torch.from_numpy(videos[rows])}


def sync_step(mesh=None, rows=slice(None)):
    """One classifier step in float64: (metrics, the gradients the
    optimizer took, the running statistics after it).  At these inputs the
    video tower's 17 BatchNorms scale an fp32 rounding difference by about
    1e5 (its fp32 gradients are 2e-2 from jax.grad's,
    test_torch_sync_train.py), so the global statistics' sums against
    F.batch_norm are compared where rounding does not reach 1e-5."""
    clf = runtime.build_avsync_classifier(device="cpu", train=True).to(
        torch.float64)
    state = SyncTrainState(0, clf, build_optimizer(clf, LR, warmup_steps=2))
    taken = []
    step = state.optimizer.step

    def record(grads):
        taken.extend(g.clone() for g in grads)
        return step(grads)
    state.optimizer.step = record
    metrics = SyncContrastiveTrainer(clf, tau=0.1).train_step(
        state, sync_batch(rows), mesh)
    stats = [b.clone() for n, b in clf.named_buffers() if "running" in n]
    return {k: float(v) for k, v in metrics.items()}, taken, stats


def rel_l2(got, want):
    got = torch.cat([g.reshape(-1).double() for g in got])
    want = torch.cat([w.reshape(-1).double() for w in want])
    return float((got - want).norm() / want.norm())


def _tensors(path):
    with np.load(path) as z:
        return [torch.from_numpy(z[f"a{i}"]) for i in range(len(z.files))]


def _save(path, tensors):
    np.savez(path, **{f"a{i}": t.detach().numpy()
                      for i, t in enumerate(tensors)})


# ------------------------------------------------------------ rank jobs ---

def case_gathers(mesh, out):
    from asva_tpu_torch.parallel import multihost
    r = mesh.rank
    x = np.array([[r, r + 10], [r + 20, r + 30]], dtype=np.int64)
    recs = {0: ([5, 1, 3], [[1, 0], [0, 1], [1, 1]]),
            1: ([3, 7], [[0, 0], [1, 0]])}[r]
    idx, vals = multihost.gather_metric_records(*recs)
    empty = ([4, 2], [[1, 1], [0, 1]]) if r == 0 else ([], [])
    e_idx, e_vals = multihost.gather_metric_records(*empty, value_shape=(2,))
    return dict(
        tiled=multihost.process_allgather(x).tolist(),
        stacked=multihost.process_allgather(x, tiled=False).tolist(),
        flags=multihost.process_allgather(np.array([r == 1])).tolist(),
        records=[idx.tolist(), vals.tolist()],
        empty_rank=[e_idx.tolist(), e_vals.tolist()])


def case_trainer(mesh, out):
    from asva_tpu_torch.parallel.reduce import all_reduce_mean_
    rows = slice(mesh.rank * ANIM_B // 2, (mesh.rank + 1) * ANIM_B // 2)
    res = {}
    for accum in (1, 2):
        loss, grads, params = animation_steps(accum, mesh, rows)
        loss = loss.clone()
        all_reduce_mean_([loss], mesh)
        res[accum] = float(loss)
        _save(os.path.join(out, f"grads{accum}.{mesh.rank}.npz"), grads)
        _save(os.path.join(out, f"params{accum}.{mesh.rank}.npz"), params)
    return res


def case_classifier(mesh, out):
    metrics, grads, stats = sync_step(mesh, slice(mesh.rank, mesh.rank + 1))
    _save(os.path.join(out, f"sync_grads.{mesh.rank}.npz"), grads)
    _save(os.path.join(out, f"sync_stats.{mesh.rank}.npz"), stats)
    return metrics


def case_checkpoint(mesh, out):
    """Saves at steps 1-3 (checkpoint every step, milestones every 2):
    which files each rank wrote, which directories it removed, and the step
    each rank restored while rank 1 sees another latest step."""
    import shutil

    from asva_tpu_torch.training import checkpoint
    written, removed = [], []
    write, rmtree = checkpoint._write_atomic, shutil.rmtree

    def record_write(path, fn):
        written.append(os.path.relpath(path, out))
        write(path, fn)

    def record_rmtree(path, **kw):
        removed.append(os.path.relpath(path, out))
        rmtree(path, **kw)
    checkpoint._write_atomic = record_write
    checkpoint.shutil.rmtree = record_rmtree
    try:
        mgr = checkpoint.CheckpointManager(os.path.join(out, "ckpts"), 1, 2)
        for step in (1, 2, 3):
            mgr.save(step, {"step": step, "w": torch.full((3,), step)},
                     modules={"m": {"w": torch.ones(2)}},
                     extra={"loader": {"cursor": step}})
        steps = mgr.existing_steps()
        if mesh.rank == 1:          # a rank that would pick another step
            mgr.latest_step = lambda: 2
        step, state = mgr.restore_latest()
    finally:
        checkpoint._write_atomic = write
        checkpoint.shutil.rmtree = rmtree
    return dict(written=written, removed=removed, steps=steps, restored=step,
                w=state["w"].tolist())


def case_logger(mesh, out):
    from asva_tpu_torch.observability import MetricsLogger
    from asva_tpu_torch.parallel import multihost
    logger = MetricsLogger(os.path.join(out, "metrics.jsonl"))
    logger.log(1, loss=torch.tensor(0.5))
    opened = logger._f is not None
    logger.close()
    multihost.barrier()
    return dict(opened=opened)


def case_eval(mesh, out):
    from asva_tpu_torch.scripts import avsync_eval
    with open(os.path.join(out, "spec.json")) as f:
        res = avsync_eval.main(json.load(f)["eval_argv"])
    return dict(indices=res["indices"].tolist(), hits=res["hits"].tolist(),
                a2v=res["a2v"], v2a=res["v2a"])


def _tiny_towers():
    """The runtime's VAE and audio-tower builders make tiny models (as
    tests/test_torch_cli_train.py's fixture)."""
    vae, audio = runtime.build_vae, runtime.build_audio_encoder
    runtime.build_vae = lambda config=None, *a, **kw: vae(
        VAEConfig.tiny(), *a, **kw)
    runtime.build_audio_encoder = lambda n_segment=12, config=None, *a, \
        **kw: audio(n_segment, ImageBindAudioConfig.tiny(), *a, **kw)


def _train_cli(mesh, out, name, max_steps):
    from asva_tpu_torch.parallel import multihost
    from asva_tpu_torch.scripts import animation_train
    with open(os.path.join(out, "spec.json")) as f:
        cfg = json.load(f)[name]
    res = animation_train.main(["--config_file", cfg, "--max_steps_override",
                                str(max_steps), "--device", "cpu"])
    params = torch.cat([p.detach().reshape(-1) for p in
                        res["state"].optimizer.params]).numpy()
    same = multihost.process_allgather(params, tiled=False)
    return dict(losses=res["losses"], step=res["state"].step,
                resumed_from=res["resumed_from"], loader=res["loader"],
                replicas_equal=bool((same[0] == same[1]).all()))


def case_cli(mesh, out):
    _tiny_towers()
    return dict(full=_train_cli(mesh, out, "full", 6),
                part=_train_cli(mesh, out, "part", 3))


def case_resume(mesh, out):
    _tiny_towers()
    return _train_cli(mesh, out, "part", 6)


def case_signal(mesh, out):
    """Rank 1 sends itself SIGTERM during its second optimizer step."""
    _tiny_towers()
    apply = AnimationTrainer.apply_step

    def apply_step(self, state, grads, mesh=None):
        apply(self, state, grads, mesh)
        if mesh.rank == 1 and state.step == 2:
            os.kill(os.getpid(), signal.SIGTERM)
    AnimationTrainer.apply_step = apply_step
    return _train_cli(mesh, out, "signal", 6)


JOBS = {"main": (case_gathers, case_trainer, case_classifier,
                 case_checkpoint, case_logger, case_eval, case_cli),
        "resume": (case_resume,), "signal": (case_signal,)}


def rank_main(job, out):
    import torch.distributed as dist

    from asva_tpu_torch.parallel import make_mesh, multihost
    joined = multihost.maybe_initialize_distributed("cpu")
    mesh = make_mesh("cpu")
    res = dict(joined=joined, rank=mesh.rank, world=mesh.world,
               device=mesh.device, backend=mesh.backend)
    for case in JOBS[job]:
        res[case.__name__] = case(mesh, out)
    with open(os.path.join(out, f"{job}.{mesh.rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


# ----------------------------------------------------------- the pairs ---

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(job, out):
    env = dict(os.environ, PYTHONPATH=REPO, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(_free_port()), WORLD_SIZE="2",
               LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = []
    for rank in range(2):
        env.update(RANK=str(rank), LOCAL_RANK=str(rank))
        with open(os.path.join(out, f"{job}.{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), job, str(out)],
                env=dict(env), stdout=log, stderr=subprocess.STDOUT))
    return procs, time.monotonic()


def _wait(job, out, started):
    """Both ranks' results; a rank that fails or outlives TIMEOUT_S
    kills its pair and fails the job with the end of its output."""
    procs, t0 = started
    for rank, p in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, TIMEOUT_S - (time.monotonic() - t0)))
            failed = p.returncode != 0 and f"exit {p.returncode}"
        except subprocess.TimeoutExpired:
            failed = f"did not end in {TIMEOUT_S} s"
        if failed:
            for q in procs:
                q.kill()
                q.wait()
            with open(os.path.join(out, f"{job}.{rank}.log")) as f:
                tail = f.read()[-3000:]
            pytest.fail(f"{job}: rank {rank} {failed}:\n{tail}")
    results = []
    for rank in range(2):
        with open(os.path.join(out, f"{job}.{rank}.json")) as f:
            results.append(json.load(f))
    return results


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


def _animation_yaml(root, out, checkpointing_steps):
    """tests/test_torch_cli_train.py's config: batch 1 a rank with
    accumulation 2, a log record every step."""
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
  checkpointing_steps: {checkpointing_steps}
  checkpointing_milestones: 3
"""


def _write_clips(root):
    """8 clips of one class with its text encoding (40 frames at 12 fps,
    64x64, 16 kHz audio), as tests/test_torch_cli_train.py makes them."""
    names = [f"dog/v{i}.mp4" for i in range(8)]
    for i, name in enumerate(names):
        rng = np.random.default_rng(i)
        frames = (rng.random((40, 64, 64, 3)) * 255).astype(np.uint8)
        t = np.arange(int(40 / 12.0 * 16000)) / 16000
        audio = (0.3 * np.sin(2 * np.pi * (300 + 40 * i) * t)).astype(
            np.float32)[None]
        os.makedirs(os.path.dirname(os.path.join(root, name)), exist_ok=True)
        media.write_video(os.path.join(root, name), frames, 12.0, audio,
                          16000)
    with open(os.path.join(root, "train.txt"), "w") as f:
        f.write("\n".join(names))
    with open(os.path.join(root, "test.txt"), "w") as f:
        f.write("\n".join(names[:5]))
    rng = np.random.default_rng(1)
    np.savez(os.path.join(root, "enc.npz"),
             **{"a dog": rng.standard_normal((77, 768)).astype(np.float32)})
    with open(os.path.join(root, "class_mapping.json"), "w") as f:
        json.dump({"dog": "a dog"}, f)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{job: [rank 0's results, rank 1's]} and the job directory."""
    if not media.headers_available():
        pytest.skip("libav development files missing")
    out = tmp_path_factory.mktemp("ranks")
    clips = out / "clips"
    _write_clips(str(clips))
    mods = out / "modules"
    clf = runtime.build_avsync_classifier(device="cpu", seed=30,
                                          randomize_all=True)
    for name in ("audio_encoder", "video_encoder", "head"):
        (mods / name).mkdir(parents=True)
        torch.save(getattr(clf, name).state_dict(),
                   mods / name / "pytorch_model.bin")
    spec = {"eval_argv": [
        "--data_root", str(clips), "--example_list_path",
        str(clips / "test.txt"), "--checkpoint_modules_dir", str(mods),
        "--num_clips", "7", "--shift_time", "0.2", "--tolerance", "0",
        "--image_size", "32", "--video_num_frames", "4", "--device", "cpu"]}
    for name, every in (("full", 999), ("part", 999), ("signal", 999)):
        path = out / f"{name}.yaml"
        path.write_text(_animation_yaml(clips, out / name, every))
        spec[name] = str(path)
    (out / "spec.json").write_text(json.dumps(spec))
    main, sig = _start("main", out), _start("signal", out)
    jobs = {"main": _wait("main", out, main)}
    resume = _start("resume", out)
    jobs["signal"] = _wait("signal", out, sig)
    jobs["resume"] = _wait("resume", out, resume)
    return jobs, out, spec


# ---------------------------------------------------------------- tests ---

def test_maybe_initialize_distributed_forms(ranks, monkeypatch):
    """Without WORLD_SIZE (or with 1) nothing starts; with peers each rank
    joins a gloo group on the CPU, and a failed init raises instead of
    carrying on as one process; the backend and card follow the rule."""
    from asva_tpu_torch.parallel import make_mesh, multihost
    jobs, _, _ = ranks
    for rank, res in enumerate(jobs["main"]):
        assert res["joined"] and res["rank"] == rank and res["world"] == 2
        assert res["backend"] == "gloo" and res["device"] == "cpu"
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.maybe_initialize_distributed("cpu") is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.maybe_initialize_distributed("cpu") is False
    assert make_mesh("cpu").world == 1
    with pytest.raises(ValueError, match="fsdp=2 does not divide the 1"):
        make_mesh("cpu", fsdp=2)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    with pytest.raises(RuntimeError, match="WORLD_SIZE=2 names peers"):
        multihost.maybe_initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "1")
    for cards, want in ((1, ("gloo", "cuda:0")), (2, ("nccl", "cuda:1"))):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        assert multihost.local_layout("cuda") == want
    assert multihost.local_layout("cpu") == ("gloo", "cpu")


def test_process_allgather_tiled_and_stacked(ranks):
    jobs, _, _ = ranks
    x = [np.array([[r, r + 10], [r + 20, r + 30]]) for r in (0, 1)]
    for res in jobs["main"]:
        g = res["case_gathers"]
        np.testing.assert_array_equal(g["tiled"], np.concatenate(x))
        np.testing.assert_array_equal(g["stacked"], np.stack(x))
        assert g["flags"] == [False, True]


def test_gather_metric_records_matches_asva_tpu(ranks):
    """Ragged counts, an index on both ranks (the first rank's record
    wins), and an empty rank with `value_shape`: equal to asva_tpu's
    gather on the concatenated records in one process."""
    from asva_tpu.parallel import multihost as jax_multihost
    jobs, _, _ = ranks
    want = jax_multihost.gather_metric_records(
        [5, 1, 3, 3, 7], [[1, 0], [0, 1], [1, 1], [0, 0], [1, 0]])
    want_empty = jax_multihost.gather_metric_records(
        [4, 2], [[1, 1], [0, 1]], value_shape=(2,))
    for res in jobs["main"]:
        g = res["case_gathers"]
        for got, ref in ((g["records"], want), (g["empty_rank"], want_empty)):
            np.testing.assert_array_equal(got[0], ref[0])
            np.testing.assert_array_equal(got[1], ref[1])
    assert want[1][list(want[0]).index(3)].tolist() == [1, 1]


@pytest.mark.parametrize("accum", [1, 2])
def test_animation_step_equals_one_process(ranks, accum):
    """Two ranks of two rows each (their rows of one global draw, their
    gradients' mean) take the step of one process on the four rows: loss
    within 1e-6, gradients within 1e-5 relative L2; both replicas end
    bit-equal."""
    jobs, out, _ = ranks
    loss, grads, params = animation_steps(accum)
    for res in jobs["main"]:
        assert abs(res["case_trainer"][str(accum)] - float(loss)) <= 1e-6
    got = [_tensors(out / f"grads{accum}.{r}.npz") for r in (0, 1)]
    assert rel_l2(got[0], grads) <= 1e-5
    assert all(torch.equal(a, b) for a, b in zip(*got))
    replicas = [_tensors(out / f"params{accum}.{r}.npz") for r in (0, 1)]
    assert all(torch.equal(a, b) for a, b in zip(*replicas))
    assert rel_l2(replicas[0], params) <= 1e-5


def test_classifier_step_equals_one_process(ranks):
    """The classifier's training step on one item a rank: BatchNorm by the
    global batch's statistics, so the running statistics, the gradients
    and the metrics equal one process on both items within 1e-5 (float64,
    see `sync_step`); both replicas' statistics are bit-equal."""
    jobs, out, _ = ranks
    metrics, grads, stats = sync_step()
    for r, res in enumerate(jobs["main"]):
        for k, v in res["case_classifier"].items():
            assert abs(v - metrics[k]) <= 1e-5 * max(1.0, abs(metrics[k])), k
        assert rel_l2(_tensors(out / f"sync_grads.{r}.npz"), grads) <= 1e-5
        got = _tensors(out / f"sync_stats.{r}.npz")
        assert rel_l2(got, stats) <= 1e-5
    same = [_tensors(out / f"sync_stats.{r}.npz") for r in (0, 1)]
    assert all(torch.equal(a, b) for a, b in zip(*same))


def test_checkpoints_written_by_the_primary(ranks):
    """Rank 0 alone writes every file and applies retention (checkpoint-1
    removed, the milestone 2 kept); both ranks return after its writes
    and restore the step rank 0 finds."""
    jobs, out, _ = ranks
    zero, one = (res["case_checkpoint"] for res in jobs["main"])
    names = ("extra.json", "modules/m.pt", "state.pt")
    assert sorted(zero["written"]) == sorted(
        f"ckpts/checkpoint-{s}/{n}" for s in (1, 2, 3) for n in names)
    assert zero["removed"] == ["ckpts/checkpoint-1"]
    assert one["written"] == [] and one["removed"] == []
    assert zero["steps"] == one["steps"] == [2, 3]
    assert zero["restored"] == one["restored"] == 3
    assert zero["w"] == one["w"] == [3, 3, 3]
    left = [n for _, _, files in os.walk(out / "ckpts") for n in files
            if n.endswith(".tmp")]
    assert left == []


def test_metrics_logger_writes_on_rank_zero(ranks):
    jobs, out, _ = ranks
    assert [r["case_logger"]["opened"] for r in jobs["main"]] == [True, False]
    lines = (out / "metrics.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["loss"] == 0.5


def test_avsync_eval_two_ranks_equal_one_process(ranks, capsys):
    """Each rank scores its shard of the 5 examples; the merged records
    equal one process's, on both ranks."""
    from asva_tpu_torch.scripts import avsync_eval
    jobs, _, spec = ranks
    one = avsync_eval.main(spec["eval_argv"])
    assert "over 5 examples" in capsys.readouterr().out
    for res in jobs["main"]:
        got = res["case_eval"]
        assert got["indices"] == one["indices"].tolist() == [0, 1, 2, 3, 4]
        assert got["hits"] == one["hits"].tolist()
        assert (got["a2v"], got["v2a"]) == (one["a2v"], one["v2a"])


def test_animation_train_cli_resumes_across_ranks(ranks):
    """asva_tpu's tests/test_multihost_train_resume.py:220 on the port: two
    ranks train 6 steps; two train 3, and a fresh pair resumes them to 6.
    The per-step losses (the ranks' mean) are identical, every rank's
    loader cursor counts its own batches, and the replicas are
    bit-equal."""
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    jobs, out, _ = ranks
    for r in (0, 1):
        full = jobs["main"][r]["case_cli"]["full"]
        part = jobs["main"][r]["case_cli"]["part"]
        resumed = jobs["resume"][r]["case_resume"]
        assert len(full["losses"]) == 6 and full["resumed_from"] is None
        assert part["losses"] == full["losses"][:3]
        assert resumed["resumed_from"] == 3 and resumed["step"] == 6
        assert resumed["losses"] == full["losses"][3:]
        # 4 clips a rank, batch 1, 2 micro-batches a step: 12 batches
        assert resumed["loader"] == full["loader"] == {
            "epoch": 2, "cursor": 4, "seed": 1}
        assert part["loader"] == {"epoch": 1, "cursor": 2, "seed": 1}
        assert all(res["replicas_equal"] for res in (full, part, resumed))
    assert jobs["main"][0]["case_cli"] == jobs["main"][1]["case_cli"]
    mgr = CheckpointManager(str(out / "part" / "ckpts"))
    assert mgr.existing_steps() == [3, 6]
    assert mgr.restore_extra(3)["loader"] == {"epoch": 1, "cursor": 2,
                                              "seed": 1}
    lines = (out / "full" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(line)["step"] for line in lines] == [1, 2, 3, 4, 5, 6]


def test_signal_on_one_rank_stops_both(ranks):
    """SIGTERM on rank 1 during step 2: both ranks stop after step 2 and
    one checkpoint, checkpoint-2, is written."""
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    jobs, out, _ = ranks
    for res in jobs["signal"]:
        got = res["case_signal"]
        assert got["step"] == 2 and len(got["losses"]) == 2
        assert got["replicas_equal"]
    assert CheckpointManager(str(out / "signal" / "ckpts")
                             ).existing_steps() == [2]


if __name__ == "__main__":
    rank_main(sys.argv[1], sys.argv[2])
