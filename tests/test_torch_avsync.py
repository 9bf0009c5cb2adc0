"""Parity of the port's AVSync classifier against asva_tpu on the CPU, fp32,
with the weights (params and BatchNorm running statistics) carried across by
`export_state_dict` on the whole variables dict and a strict load.  The
nets are full width (they have no tiny config) at the smallest inputs their
strides allow; one jitted JAX init per module fixture."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asva_tpu.convert.jax_to_torch import export_state_dict
from asva_tpu.convert.torch_to_jax import avsync_key_map
from asva_tpu.models.avsync import classifier as jc
from asva_tpu_torch.convert import load_exported
from asva_tpu_torch.models.avsync import classifier as tc
from asva_tpu_torch.runtime import build_avsync_classifier

from test_torch_ops import close, port, randomize, t

torch.set_num_threads(1)

MEL = (2, 128, 204, 1)
VIDEO = (2, 4, 32, 32, 3)


def _positive_stats(variables, rng):
    """Randomised variables whose running variances stay positive."""
    out = randomize(variables, rng)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.abs(a) + 0.5
        if getattr(path[-1], "key", "") == "var" else a, out["batch_stats"])
    return {"params": out["params"], "batch_stats": stats}


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(11)
    jm = jc.AVSyncClassifier()
    variables = jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros(MEL), jnp.zeros(VIDEO)))()
    variables = _positive_stats(variables, rng)
    return jm, variables, port(tc.AVSyncClassifier(), variables,
                               avsync_key_map)


def test_audio_conv_net(pair, rng):
    """mel -> 512-d embedding through 9 conv+BN layers, 2e-4 (fp32 convs in
    two libraries; values O(1))."""
    jm, v, tm = pair
    mel = rng.standard_normal(MEL).astype(np.float32)
    want = jm.apply(v, mel, method=lambda m, x: m.audio_encoder(x))
    with torch.no_grad():
        got = tm.audio_encoder(t(mel))
    assert got.shape == (2, 512)
    close(got, want, 2e-4)


def test_video_r2plus1d_net(pair, rng):
    """video -> 512-d embedding: the stride-(1,2,2) stem, the -inf padded
    max pool, the stride-2 stages with their 1x1x1 residual convs; 2e-4."""
    jm, v, tm = pair
    video = rng.standard_normal(VIDEO).astype(np.float32)
    want = jm.apply(v, video, method=lambda m, x: m.video_encoder(x))
    with torch.no_grad():
        got = tm.video_encoder(t(video))
    assert got.shape == (2, 512)
    close(got, want, 2e-4)


def test_classifier_score_encode_and_pairs(pair, rng):
    """The scalar sync score, and encode + score_pairs on swapped pairs;
    2e-4."""
    jm, v, tm = pair
    mel = rng.standard_normal(MEL).astype(np.float32)
    video = rng.standard_normal(VIDEO).astype(np.float32)
    with torch.no_grad():
        got = tm(t(mel), t(video))
        a, vid = tm.encode(t(mel), t(video))
        swapped = tm.score_pairs(a.flip(0), vid)
    assert got.shape == (2,)
    close(got, jm.apply(v, mel, video), 2e-4)
    ja, jv = jm.apply(v, mel, video, method=jm.encode)
    close(swapped, jm.apply(v, ja[::-1], jv, method=jm.score_pairs), 2e-4)


def test_sync_head(rng):
    """concat -> 512 -> 256 -> 1, 1e-5."""
    a = rng.standard_normal((3, 512)).astype(np.float32)
    v = rng.standard_normal((3, 512)).astype(np.float32)
    jm = jc.SyncHead()
    p = randomize(jm.init(jax.random.PRNGKey(0), a, v), rng)
    tm = port(tc.SyncHead(), p, avsync_key_map)
    with torch.no_grad():
        close(tm(t(a), t(v)), jm.apply(p, a, v), 1e-5)


def test_export_carries_running_statistics_and_stays_strict(pair):
    """Both flax collections arrive: the running statistics are JAX's, not
    torch's defaults; `num_batches_tracked` (no JAX source) is the only key
    the load fills in itself, and a missing real key still raises."""
    _, v, tm = pair
    state = export_state_dict(v, avsync_key_map)
    assert not any(k.endswith("num_batches_tracked") for k in state)
    sd = tm.state_dict()
    assert set(sd) - set(state) == {k for k in sd
                                    if k.endswith("num_batches_tracked")}
    np.testing.assert_array_equal(
        sd["video_encoder.conv1.1.running_var"].numpy(),
        state["video_encoder.conv1.1.running_var"])
    state.pop("audio_encoder.block2.bn1.running_mean")
    with pytest.raises(RuntimeError, match="Missing key"):
        load_exported(tc.AVSyncClassifier(), state)


def test_build_avsync_classifier_and_weight_directories(tmp_path, pair, rng):
    """build_avsync_classifier: the random init is finite and in eval
    mode; the reference's per-module directories load strictly, and a
    missing module keeps its init."""
    _, _, tm = pair
    model = build_avsync_classifier(device="cpu", seed=1)
    assert not model.training
    assert all(not p.requires_grad for p in model.parameters())
    mel = t(rng.standard_normal(MEL).astype(np.float32))
    video = t(rng.standard_normal(VIDEO).astype(np.float32))
    assert torch.isfinite(model(mel, video)).all()
    for mod in ("audio_encoder", "head"):
        (tmp_path / mod).mkdir()
        torch.save(getattr(tm, mod).state_dict(),
                   tmp_path / mod / "pytorch_model.bin")
    loaded = build_avsync_classifier(str(tmp_path), device="cpu", seed=1)
    with torch.no_grad():
        close(loaded.audio_encoder(mel), tm.audio_encoder(mel).numpy(), 0)
        close(loaded.video_encoder(video), model.video_encoder(video).numpy(),
              0)


def test_build_avsync_classifier_finds_the_ports_exports(tmp_path, pair,
                                                          rng):
    """A directory of the port's per-module exports, `<dir>/<module>.pt`, and
    a CheckpointManager step, `<dir>/modules/<module>.pt`: every module
    loads the values asva_tpu's variables hold (the `pair` export), so the
    classifier computes what the ported one computes, bit for bit."""
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    _, _, tm = pair
    mods = ("audio_encoder", "video_encoder", "head")
    flat = tmp_path / "flat"
    flat.mkdir()
    for mod in mods:
        torch.save(getattr(tm, mod).state_dict(), str(flat / f"{mod}.pt"))
    mgr = CheckpointManager(str(tmp_path / "run"), checkpointing_steps=1)
    mgr.save(3, {"step": 3},
             modules={m: getattr(tm, m).state_dict() for m in mods})
    mel = t(rng.standard_normal(MEL).astype(np.float32))
    video = t(rng.standard_normal(VIDEO).astype(np.float32))
    with torch.no_grad():
        want = tm(mel, video)
        for root in (str(flat), os.path.dirname(mgr.modules_dir(3))):
            loaded = build_avsync_classifier(root, device="cpu", seed=2)
            assert torch.equal(loaded(mel, video), want)


@pytest.mark.slow
def test_full_size_inputs(pair, rng):
    """The eval protocol's input: 12 frames at 224^2 and a 128 x 204 mel;
    2e-4."""
    jm, v, tm = pair
    mel = rng.standard_normal((1, 128, 204, 1)).astype(np.float32)
    video = rng.standard_normal((1, 12, 224, 224, 3)).astype(np.float32)
    with torch.no_grad():
        got = tm(t(mel), t(video))
    close(got, jm.apply(v, mel, video), 2e-4)
