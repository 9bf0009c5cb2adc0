"""The judge's trainer in the port (`training/sync_trainer.py`) against
asva_tpu's `SyncContrastiveTrainer` on the CPU in fp32, and the small host
modules that the train CLIs will need: config, resample, the clip-time
samplers, utils and observability.

The classifier has no tiny config: it runs at full width on the smallest
inputs that keep its BatchNorms conditioned (b 2, k 3, 4 frames at 48x48, a
32x32 mel: 24 elements a channel at the last stage).  The
same numpy draws feed both packages; weights, BatchNorm statistics and the
optax Adam state are carried across by `export_state_dict` through
`avsync_key_map`."""
import dataclasses
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asva_tpu import config as jconfig
from asva_tpu import observability as jobs
from asva_tpu import utils as jutils
from asva_tpu.convert.jax_to_torch import export_state_dict
from asva_tpu.convert.torch_to_jax import avsync_key_map
from asva_tpu.data import multipair as jmultipair
from asva_tpu.models.avsync import classifier as jc
from asva_tpu.ops import resample as jresample
from asva_tpu.training import optim as joptim
from asva_tpu.training.sync_trainer import (
    SyncContrastiveTrainer as JTrainer, SyncTrainState as JState)
from asva_tpu_torch import config as tconfig
from asva_tpu_torch import observability as tobs
from asva_tpu_torch import utils as tutils
from asva_tpu_torch.convert import load_exported, load_exported_sync_state
from asva_tpu_torch.data import multipair as tmultipair
from asva_tpu_torch.models.avsync import classifier as tc
from asva_tpu_torch.ops import resample as tresample
from asva_tpu_torch.runtime import build_avsync_classifier
from asva_tpu_torch.training import (SyncContrastiveTrainer, SyncTrainState,
                                     build_optimizer)

from test_torch_ops import close, randomize, t

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, K = 2, 3
MELS = (B, K, 32, 32, 1)
VIDEOS = (B, K, 4, 48, 48, 3)
OPT = dict(max_grad_norm=1.0, weight_decay=1e-2, warmup_steps=2)
LR = 1e-3


def _export(tree):
    return export_state_dict(tree, avsync_key_map)


class Pair:
    """One set of classifier variables in both packages, one batch."""

    def __init__(self):
        rng = np.random.default_rng(21)
        self.jm = jc.AVSyncClassifier()
        v = jax.jit(lambda: self.jm.init(
            jax.random.PRNGKey(0), jnp.zeros(MELS[1:]),
            jnp.zeros(VIDEOS[1:])))()
        v = randomize(v, rng)
        stats = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.abs(a) + 0.5
            if getattr(path[-1], "key", "") == "var" else a, v["batch_stats"])
        self.variables = {"params": v["params"], "batch_stats": stats}
        self.mels = rng.standard_normal(MELS).astype(np.float32)
        self.videos = rng.standard_normal(VIDEOS).astype(np.float32)
        self.jtrainer = JTrainer(self.jm, tau=0.1)
        self.tx = joptim.build_optimizer(LR, **OPT)
        self.jstep = self.jtrainer.make_train_step(self.tx, donate=False)

    def jbatch(self, perm=None):
        perm = slice(None) if perm is None else perm
        return {"mels": jnp.asarray(self.mels[perm]),
                "videos": jnp.asarray(self.videos[perm])}

    def tbatch(self, perm=None):
        perm = slice(None) if perm is None else perm
        return {"mels": t(self.mels[perm]), "videos": t(self.videos[perm])}

    def jstate(self):
        p = self.variables["params"]
        return JState(jnp.zeros((), jnp.int32), p,
                      self.variables["batch_stats"], self.tx.init(p))

    def torch_state(self):
        clf = build_avsync_classifier(device="cpu", train=True)
        load_exported(clf, _export(self.variables))
        return (SyncContrastiveTrainer(clf, tau=0.1),
                SyncTrainState(0, clf, build_optimizer(clf, LR, **OPT)))


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _grad_close(name, got, want, floor):
    """A gradient (or Adam moment) against asva_tpu's.  Audio tower and
    head: every entry within 2e-4 of the largest.  Video tower: relative L2
    error of the tensor <= 6e-2.  Its backward runs through 17 BatchNorms
    that normalise by the statistics of 24 to 3456 elements, and fp32
    rounding inside them is amplified: measured against the port in fp64,
    the port's fp32 gradients are off by up to 1.5e-2 relative L2 per
    tensor and asva_tpu's by up to 2.1e-2, while a 1e-7 perturbation of the
    fp64 inputs moves them by 4e-6 to 3e-3 (the seeds' weights decide)."""
    if name.startswith("video_encoder"):
        assert np.linalg.norm(got - want) <= 6e-2 * max(
            floor, np.linalg.norm(want)), name
    else:
        assert np.abs(got - want).max() <= 2e-4 * max(
            floor, np.abs(want).max()), name


def _assert_params_match(clf, want, lr):
    """Parameters after Adam steps: every entry within 3 lr (Adam normalises
    the gradient: an entry whose gradient sits at the fp32 noise floor moves
    by up to a few lr in a direction that differs between the packages;
    seen: 2 lr on single entries), and 5e-6 on average over all entries."""
    total, count = 0.0, 0
    for name, p in clf.named_parameters():
        d = np.abs(p.detach().numpy() - want[name])
        assert d.max() <= 3 * lr, name
        total, count = total + d.sum(), count + d.size
    assert total / count <= 5e-6


def _assert_state_matches(clf, jparams, jstats, atol):
    want = _export({"params": jparams, "batch_stats": jstats})
    got = clf.state_dict()
    assert set(want) == {k for k in got if not k.endswith("tracked")}
    for key, value in want.items():
        np.testing.assert_allclose(got[key].numpy(), value, atol=atol,
                                   rtol=atol, err_msg=key)


def test_classifier_training_mode_matches_flax(pair):
    """encode(train=True) with mutable batch_stats: the audio embedding and
    every updated running mean and variance, 1e-5 (the variance update is
    flax's biased one; torch's own is n / (n - 1) larger).  The video
    embedding 3e-4: its 17 BatchNorms normalise by the statistics of few
    elements, which amplifies fp32 noise (the port in fp32 against itself in
    fp64: 4e-5; asva_tpu in fp32 against that: 9e-5)."""
    mels = pair.mels.reshape((B * K,) + MELS[2:])
    videos = pair.videos.reshape((B * K,) + VIDEOS[2:])
    (a, v), new = jax.jit(lambda var, m, x: pair.jm.apply(
        var, m, x, train=True, method=pair.jm.encode,
        mutable=["batch_stats"]))(pair.variables, mels, videos)
    _, state = pair.torch_state()
    clf = state.classifier
    assert clf.training and all(p.requires_grad and p.dtype == torch.float32
                                for p in clf.parameters())
    ta, tv = clf.encode(t(mels), t(videos))
    close(ta, a, 1e-5)
    close(tv, v, 3e-4)
    _assert_state_matches(clf, pair.variables["params"], new["batch_stats"],
                          1e-5)
    moved = clf.state_dict()["audio_encoder.conv1.1.running_var"].numpy()
    before = _export(pair.variables)["audio_encoder.conv1.1.running_var"]
    assert np.abs(moved - before).max() > 1e-3
    # torch's own BatchNorm stores the unbiased variance: visibly different
    ref = torch.nn.BatchNorm2d(3).train()
    own = tc.BatchNorm2d(3).train()
    x = torch.randn(2, 3, 2, 2, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(own(x), ref(x))
    n = x.numel() // 3
    torch.testing.assert_close((own.running_var - 0.9) * n / (n - 1),
                               ref.running_var - 0.9)
    torch.testing.assert_close(own.running_mean, ref.running_mean)


def test_loss_and_gradients_match_jax(pair):
    """loss_fn: the loss and the two cross-entropies 5e-5 relative (the
    logits are head scores over tau = 0.1, ten times the embeddings' fp32
    noise, see the test above), and every parameter's gradient against
    jax.grad as `_grad_close` states.  Accuracies only when the top two
    logits of every row
    differ by more than 1e-4 (argmax ties)."""
    def jloss(params):
        return pair.jtrainer.loss_fn(params, pair.variables["batch_stats"],
                                     pair.jbatch())
    (want, (jmetrics, _)), jgrads = jax.jit(jax.value_and_grad(
        jloss, has_aux=True))(pair.variables["params"])
    trainer, state = pair.torch_state()
    loss, metrics = trainer.loss_fn(pair.tbatch())
    np.testing.assert_allclose(loss.item(), float(want), rtol=5e-5)
    for key in ("av_loss", "va_loss"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]),
                                   rtol=5e-5)
    av, va, labels = trainer._pair_logits(pair.tbatch())
    assert labels.tolist() == list(range(K)) * B
    top2 = torch.cat([av, va]).topk(2, dim=-1).values
    if (top2[:, 0] - top2[:, 1]).min().item() > 1e-4:
        for key in ("av_acc", "va_acc"):
            assert metrics[key].item() == pytest.approx(float(jmetrics[key]))
    names = state.optimizer.names
    grads = torch.autograd.grad(loss, state.optimizer.params)
    want_grads = _export({"params": jgrads})
    assert set(names) == set(want_grads)
    for name, g in zip(names, grads):
        w = want_grads[name]
        # floor 1e-2: the last bias's true gradient is 0 (softmax rows sum
        # to one), its computed one fp32 noise of 1e-6
        _grad_close(name, g.numpy(), w, 1e-2)


def test_two_train_steps_match_jax(pair):
    """Two train steps (AdamW lr 1e-3 after a 2-step warm-up, wd 1e-2, clip
    1.0, every parameter trained; the first step's lr is 0, the second's
    5e-4): metrics 5e-5 relative, parameters as `_assert_params_match`
    states, running statistics 1e-5, Adam moments at the gradients'
    tolerances (`_grad_close`), and the step counts."""
    jstate = pair.jstate()
    trainer, state = pair.torch_state()
    before = {k: v.detach().clone() for k, v in
              state.classifier.named_parameters()}
    for _ in range(2):
        jstate, jmetrics = pair.jstep(jstate, pair.jbatch())
        metrics = trainer.train_step(state, pair.tbatch())
        for key in ("av_loss", "va_loss"):
            np.testing.assert_allclose(metrics[key].item(),
                                       float(jmetrics[key]), rtol=5e-5)
    assert state.step == 2 == int(jstate.step)
    assert state.optimizer.count == 2
    want = _export({"params": jstate.params,
                    "batch_stats": jstate.batch_stats})
    got = state.classifier.state_dict()
    _assert_params_match(state.classifier, want, 5e-4)
    assert all(not torch.equal(p, before[name])
               for name, p in state.classifier.named_parameters())
    for key, value in want.items():
        if "running_" in key:
            np.testing.assert_allclose(got[key].numpy(), value, atol=1e-5,
                                       rtol=1e-5, err_msg=key)
    adam = jstate.opt_state[1][0]
    opt = state.optimizer.state_dict()
    for kind, tree in (("mu", adam.mu), ("nu", adam.nu)):
        for name, w in _export({"params": tree}).items():
            g = opt[kind][name].numpy()
            _grad_close(name, g, w, 1e-4 if kind == "mu" else 1e-8)


def test_carried_training_state_takes_the_same_step(pair):
    """asva_tpu takes one step; its whole state (parameters, running
    statistics, Adam moments, counts) is carried into the port; both take a
    second step (lr 5e-4) and agree as in the test above."""
    jstate, _ = pair.jstep(pair.jstate(), pair.jbatch())
    trainer, state = pair.torch_state()
    adam = jstate.opt_state[1][0]
    load_exported_sync_state(
        state, _export({"params": jstate.params,
                        "batch_stats": jstate.batch_stats}),
        _export({"params": adam.mu}), _export({"params": adam.nu}),
        int(adam.count), int(jstate.step))
    assert state.step == 1 and state.optimizer.count == 1
    jstate, jmetrics = pair.jstep(jstate, pair.jbatch())
    metrics = trainer.train_step(state, pair.tbatch())
    np.testing.assert_allclose(metrics["av_loss"].item(),
                               float(jmetrics["av_loss"]), rtol=5e-5)
    want = _export({"params": jstate.params,
                    "batch_stats": jstate.batch_stats})
    _assert_params_match(state.classifier, want, 5e-4)
    for key, value in state.classifier.state_dict().items():
        if "running_" in key:
            np.testing.assert_allclose(value.numpy(), want[key], atol=1e-5,
                                       rtol=1e-5, err_msg=key)


def test_eval_metrics_match_and_ignore_batch_order(pair):
    """eval_metrics: running-average BatchNorm, equal in both packages
    (1e-5), no change to the state, the classifier's mode restored, and the
    same numbers when the batch's items are permuted."""
    jmetrics = pair.jtrainer.make_eval_metrics()(
        pair.variables["params"], pair.variables["batch_stats"],
        pair.jbatch())
    trainer, state = pair.torch_state()
    snapshot = {k: v.clone() for k, v in state.classifier.state_dict().items()}
    metrics = trainer.eval_metrics(pair.tbatch())
    for key in ("av_loss", "va_loss"):
        np.testing.assert_allclose(metrics[key].item(), float(jmetrics[key]),
                                   rtol=1e-5)
    assert state.classifier.training
    for key, value in state.classifier.state_dict().items():
        assert torch.equal(value, snapshot[key]), key
    permuted = trainer.eval_metrics(pair.tbatch(np.array([1, 0])))
    for key in metrics:
        np.testing.assert_allclose(permuted[key].item(), metrics[key].item(),
                                   rtol=1e-6)
    # eval_scores: the classifier's eval-mode forward
    mels = pair.mels.reshape((B * K,) + MELS[2:])
    videos = pair.videos.reshape((B * K,) + VIDEOS[2:])
    want = pair.jtrainer.make_eval_scores()(
        pair.variables["params"], pair.variables["batch_stats"], mels, videos)
    close(trainer.eval_scores(t(mels), t(videos)), want, 2e-5)


def test_sync_state_checkpoint_round_trip(pair, tmp_path):
    """Parameters, BatchNorm buffers, Adam moments and both counters come
    back bit for bit through the CheckpointManager."""
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    trainer, state = pair.torch_state()
    trainer.train_step(state, pair.tbatch())
    saved = state.state_dict()
    want = {k: v.clone() for k, v in saved["classifier"].items()}
    mu = {k: v.clone() for k, v in saved["optimizer"]["mu"].items()}
    assert CheckpointManager(str(tmp_path), 1).save(state.step, saved)
    _, fresh = pair.torch_state()
    step, restored = CheckpointManager(str(tmp_path)).restore_latest("cpu")
    fresh.load_state_dict(restored)
    assert step == 1 == fresh.step and fresh.optimizer.count == 1
    for key, value in fresh.classifier.state_dict().items():
        assert torch.equal(value, want[key]), key
    for key, value in fresh.optimizer.state_dict()["mu"].items():
        assert torch.equal(value, mu[key]), key


# ------------------------------------------------------ host-side modules

YAMLS = ["configs/audio-cond_animation/avsync15_audio-cond_cfg.yaml",
         "configs/audio-cond_animation/landscapes_audio-cond_cfg.yaml",
         "configs/audio-cond_animation/thegreatesthits_audio-cond_cfg.yaml",
         "configs/avsync/vggss_sync_contrast.yaml"]


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_configs_load_to_equal_fields(path):
    """Every field of the job config, nested configs included (the UNet and
    schedule dataclasses are each package's own), equal in both packages."""
    name = "SyncJobConfig" if "avsync/" in path else "AnimationJobConfig"
    want = getattr(jconfig, name).from_yaml(os.path.join(ROOT, path))
    got = getattr(tconfig, name).from_yaml(os.path.join(ROOT, path))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__module__ == "asva_tpu_torch.config"


def test_config_take_warns_and_coerces():
    with pytest.warns(UserWarning, match="unknown key 'lr'"):
        cfg = tconfig._take({"learning_rate": "2e-4", "lr": 1},
                            tconfig.OptimConfig)
    assert cfg.learning_rate == 2e-4


@pytest.mark.parametrize("orig,new", [(44100, 16000), (48000, 16000),
                                      (16000, 16000)])
def test_resample_matches(rng, orig, new):
    """Polyphase resampling of (2, T) noise, 1e-6."""
    x = rng.standard_normal((2, 4410)).astype(np.float32)
    want = jresample.resample(x, orig, new)
    got = tresample.resample(t(x), orig, new)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    close(got, want, 1e-6)
    close(tresample.resample(x[0], orig, new), want[0], 1e-6)


@pytest.mark.parametrize("name,needs_rng,args", [
    ("uniform_sample", False, (0.5, 9.0, 21)),
    ("random_compact_sample", True, (0.0, 10.0, 21, 0.2)),
    ("center_compact_sample", False, (1.0, 9.0, 21, 0.2)),
    ("random_sample", True, (0.0, 10.0, 21, 0.2)),
])
def test_clip_time_samplers_match(name, needs_rng, args):
    for seed in (0, 1):
        extra = lambda: ((np.random.default_rng(seed),)   # noqa: E731
                         if needs_rng else ())
        want = getattr(jmultipair, name)(*extra(), *args)
        got = getattr(tmultipair, name)(*extra(), *args)
        np.testing.assert_array_equal(got, want)
    assert tmultipair.CLIP_SAMPLE_RATE == jmultipair.CLIP_SAMPLE_RATE


PACKAGES = [pytest.param((jobs, jutils), id="jax"),
            pytest.param((tobs, tutils), id="torch")]


@pytest.mark.parametrize("mods", PACKAGES)
def test_metrics_logger_jsonl(tmp_path, mods):
    path = str(tmp_path / "sub" / "m.jsonl")
    m = mods[0].MetricsLogger(path)
    m.log(1, loss=torch.tensor(0.5) if mods[0] is tobs else 0.5, acc=0.9)
    m.log(2, loss=0.25)
    m.close()
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["step"] == 1 and lines[0]["loss"] == 0.5
    assert lines[1]["step"] == 2 and "time" in lines[1]


@pytest.mark.parametrize("mods", PACKAGES)
def test_graceful_shutdown_flag(mods):
    g = mods[0].GracefulShutdown()
    assert not g.requested and not g.poll()
    os.kill(os.getpid(), signal.SIGTERM)
    assert g.requested and g.poll() and g.requested_global()
    g.restore()


@pytest.mark.parametrize("mods", PACKAGES)
def test_average_meter_and_step_timer(mods):
    m = mods[1].AverageMeter(window=2)
    for v in (1.0, 2.0, 3.0):
        m.update(v)
    assert m.avg == 2.5  # only the last two
    m2 = mods[1].AverageMeter()
    m2.update(1.0, n=3)
    m2.update(5.0, n=1)
    assert m2.avg == 2.0
    timer = mods[1].StepTimer(window=3)
    assert timer.steps_per_sec == 0.0
    assert timer.tick() >= 0.0 and timer.steps_per_sec > 0.0


def test_model_size_cast_floating_and_logging(tmp_path):
    clf = tc.SyncHead()
    n = sum(p.numel() for p in clf.parameters())
    assert tutils.get_model_size(clf, "K") == pytest.approx(n / 1e3)
    tree = {"a": torch.zeros(1000, 1000), "b": [torch.zeros(24)]}
    assert abs(tutils.get_model_size(tree, "M") - 1.000024) < 1e-6
    state = {"w": torch.ones(2), "n": torch.ones(2, dtype=torch.long),
             "nested": {"v": torch.ones(1, dtype=torch.float64)}, "s": 3}
    cast = tutils.cast_floating(state, torch.bfloat16)
    assert cast["w"].dtype == cast["nested"]["v"].dtype == torch.bfloat16
    assert cast["n"].dtype == torch.long and cast["s"] == 3
    log = tutils.setup_logging(str(tmp_path / "a" / "train.log"), "t_port")
    tutils.setup_logging(str(tmp_path / "a" / "train.log"), "t_port")
    assert len(log.handlers) == 2
    log.info("hello")
    assert "hello" in open(tmp_path / "a" / "train.log").read()


def test_profile_steps_writes_a_trace(tmp_path):
    with tobs.profile_steps(None):
        pass
    with tobs.profile_steps(str(tmp_path / "prof")):
        torch.ones(4).sum()
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
