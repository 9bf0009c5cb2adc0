"""Parity of the port's metric networks (Inception-I3D, InceptionV3-FID)
against asva_tpu on the CPU, fp32, weights and BatchNorm running statistics
carried across with a strict load.  Full-width nets at the smallest inputs
their strides allow; one jitted JAX init per module fixture and jitted JAX
forwards (one compile instead of an eager compile per op).  The published
input sizes are marked slow."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asva_tpu.convert.torch_to_jax import i3d_key_map, inception_v3_key_map
from asva_tpu.models.evalnets import i3d as ji
from asva_tpu.models.evalnets import inception_v3 as jv
from asva_tpu_torch.models.evalnets import i3d as ti
from asva_tpu_torch.models.evalnets import inception_v3 as tv
from asva_tpu_torch.runtime import build_i3d_classifier

from test_torch_avsync import _positive_stats
from test_torch_ops import close, port, t

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def i3d_pair():
    rng = np.random.default_rng(21)
    jm = ji.InceptionI3D()
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 9, 33, 33, 3))))()
    v = _positive_stats(v, rng)
    return jm, v, port(ti.InceptionI3D(), v, i3d_key_map)


@pytest.mark.parametrize("shape", [(2, 9, 33, 33, 3)])
def test_i3d_features(i3d_pair, rng, shape):
    """400-d logits through 57 conv layers; odd extents exercise the
    asymmetric TF-same padding at stride 2 and the -inf padded pools.
    Relative to max|logits| 2e-4 (deep fp32 net, two conv libraries)."""
    jm, v, tm = i3d_pair
    x = (rng.random(shape) * 2 - 1).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        got = tm(t(x))
    assert got.shape == (shape[0], 400)
    assert np.abs(got.numpy() - want).max() <= 2e-4 * np.abs(want).max()


def test_i3d_sliding_temporal_head(i3d_pair, rng):
    """24 frames reach the head with t' = 3: the (2, 7, 7) average window
    slides, which a global mean would not reproduce; 2e-4 relative."""
    jm, v, tm = i3d_pair
    x = (rng.random((1, 24, 32, 32, 3)) * 2 - 1).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()


@pytest.mark.parametrize("kernel,strides,shape", [
    ((7, 7, 7), (2, 2, 2), (9, 33, 32)), ((3, 3, 3), (1, 1, 1), (4, 5, 6)),
    ((1, 3, 3), (1, 2, 2), (5, 16, 17)), ((2, 2, 2), (2, 2, 2), (3, 4, 5))])
def test_same_pad_and_max_pool(rng, kernel, strides, shape):
    """TF-same padding amounts equal JAX's, and the padded max pool equals
    flax's on signed inputs (so the padding value is -inf, not 0)."""
    want = ji._same_pad(kernel, strides, shape)
    got = ti._same_pad(kernel, strides, shape)
    assert [tuple(got[i:i + 2]) for i in (4, 2, 0)] == [tuple(p) for p in want]
    x = rng.standard_normal((1,) + shape + (3,)).astype(np.float32) - 2.0
    jy = ji._same_max_pool(jnp.asarray(x), kernel, strides)
    ty = ti._same_max_pool(t(x).permute(0, 4, 1, 2, 3), kernel, strides)
    close(ty.permute(0, 2, 3, 4, 1), jy, 0)


def test_i3d_bn_eps_is_used(i3d_pair, rng):
    _, v, _ = i3d_pair
    jm = ji.InceptionI3D(bn_eps=1e-3)
    tm = port(ti.InceptionI3D(bn_eps=1e-3), v, i3d_key_map)
    x = (rng.random((1, 9, 32, 32, 3)) * 2 - 1).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert tm.Mixed_3b.b0.bn.eps == 1e-3
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()


def test_build_i3d_classifier_loads_state(tmp_path, i3d_pair, rng):
    """A raw state dict in the blob's naming (batch3d, b1.0 ...) loads
    strictly; with another class count the 400-way head is dropped and the
    fresh one kept."""
    _, _, tm = i3d_pair
    renamed = {}
    for k, val in tm.state_dict().items():
        for new, old in (("batch3d", "bn"), ("b1.0", "b1a"), ("b1.1", "b1b"),
                         ("b2.0", "b2a"), ("b2.1", "b2b"), ("b3.1", "b3b")):
            k = k.replace(f".{old}.", f".{new}.")
        renamed[k] = val
    path = str(tmp_path / "i3d_pretrained_400.pt")
    torch.save(renamed, path)
    model, missing = build_i3d_classifier(weights_path=path, device="cpu")
    assert missing == [] and not model.training
    x = t((rng.random((1, 9, 32, 32, 3)) * 2 - 1).astype(np.float32))
    with torch.no_grad():
        close(model(x), tm(x).numpy(), 0)
    model, missing = build_i3d_classifier(15, path, device="cpu")
    assert sorted(missing) == ["logits.conv3d.bias", "logits.conv3d.weight"]
    with torch.no_grad():
        assert model(x).shape == (1, 15)


@pytest.fixture(scope="module")
def fid_pair():
    rng = np.random.default_rng(22)
    jm = jv.InceptionV3FID()
    v = jax.jit(lambda: jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 75, 75, 3))))()
    v = _positive_stats(v, rng)
    return jm, v, port(tv.InceptionV3FID(), v, inception_v3_key_map)


@pytest.mark.parametrize("shape", [(2, 83, 75, 3)])
def test_inception_v3_fid_features(fid_pair, rng, shape):
    """2048-d pool3 features through 94 conv layers, BN eps 1e-3, the
    count_include_pad=False average pools and the max-pool InceptionE;
    2e-4 relative to max|features|."""
    jm, v, tm = fid_pair
    x = (rng.random(shape) * 2 - 1).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        got = tm(t(x))
    assert got.shape == (shape[0], 2048)
    assert np.abs(got.numpy() - want).max() <= 2e-4 * np.abs(want).max()


def test_avg_pool_nocount(rng):
    """Edge windows divide by the count of real elements, 1e-6."""
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    got = tv._avg_pool_nocount(t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    close(got, jv._avg_pool_nocount(jnp.asarray(x)), 1e-6)


@pytest.mark.slow
def test_full_size_inputs(i3d_pair, fid_pair, rng):
    """The published input sizes: 12 x 224^2 video, 229^2 image."""
    jm, v, tm = i3d_pair
    x = (rng.random((1, 12, 224, 224, 3)) * 2 - 1).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
    jm, v, tm = fid_pair
    x = (rng.random((1, 229, 229, 3)) * 2 - 1).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(v, x))
    with torch.no_grad():
        got = tm(t(x)).numpy()
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()
