"""Parity of the port's evaluation side against asva_tpu on the CPU: the
resize matrices and frame transforms, the sync / align metric reducers, the
Frechet distance, and the EvalModels bundle."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asva_tpu.data import transforms as jtr
from asva_tpu.eval import frechet as jf
from asva_tpu.eval import metrics as jm
from asva_tpu.ops import resize as jr
from asva_tpu_torch.data import transforms as ttr
from asva_tpu_torch.eval import frechet as tf
from asva_tpu_torch.eval import metrics as tm
from asva_tpu_torch.eval.harness import EvalModels, build_eval_models
from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig
from asva_tpu_torch.models.imagebind_extra import (ImageBindTextConfig,
                                                   ImageBindVisionConfig)
from asva_tpu_torch.ops import resize as tr

from test_torch_ops import close, t

torch.set_num_threads(1)


# --------------------------------------------------------------- resize ---

@pytest.mark.parametrize("kind,antialias", [("bilinear", True),
                                            ("bicubic", True),
                                            ("bicubic", False),
                                            ("bilinear", False)])
@pytest.mark.parametrize("sizes", [(270, 224), (31, 224), (64, 64), (7, 3)])
def test_resize_matrix(kind, antialias, sizes):
    """The port's own copy builds the JAX package's matrices, bit for bit."""
    np.testing.assert_array_equal(
        tr.resize_matrix(*sizes, kind, antialias),
        jr.resize_matrix(*sizes, kind, antialias))


@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
def test_resize_image(rng, kind):
    """Tensor in, tensor out, against the JAX contraction, 1e-5; numpy in,
    numpy out, equal to the JAX package's host path."""
    x = rng.random((2, 3, 40, 52, 3)).astype(np.float32)
    want = jr.resize_image(jnp.asarray(x), 24, 30, kind)
    got = tr.resize_image(t(x), 24, 30, kind)
    assert got.shape == (2, 3, 24, 30, 3) and got.dtype == torch.float32
    close(got, want, 1e-5)
    host = tr.resize_image(x, 24, 30, kind)
    assert isinstance(host, np.ndarray)
    np.testing.assert_allclose(host, jr.resize_image(x, 24, 30, kind),
                               atol=1e-6)
    assert tr.resize_image(t(x), 40, 52, kind) .equal(t(x))


@pytest.mark.parametrize("kind", ["bilinear", "bicubic"])
def test_resize_matches_torch_interpolate(rng, kind):
    """The matrices reproduce torch's own antialiased interpolate, which is
    what the reference's preprocessing calls, border rows included; 2e-6."""
    x = rng.random((1, 64, 50, 3)).astype(np.float32)
    ours = tr.resize_image(t(x), 24, 21, kind)
    lib = torch.nn.functional.interpolate(
        t(x).permute(0, 3, 1, 2), (24, 21), mode=kind,
        antialias=True).permute(0, 2, 3, 1)
    close(ours, lib.numpy(), 2e-6)


@pytest.mark.parametrize("shape,size,flip,normalize", [
    ((2, 3, 40, 60, 3), 32, False, True), ((3, 50, 36, 3), (24, 32), True,
                                           False)])
def test_sd_video_transform(rng, shape, size, flip, normalize):
    """Center trim to aspect, bilinear antialias resize, flip, [-1, 1];
    1e-5."""
    x = rng.random(shape).astype(np.float32)
    want = jtr.sd_video_transform(jnp.asarray(x), size, flip, normalize)
    got = ttr.sd_video_transform(t(x), size, flip, normalize)
    close(got, want, 1e-5)
    np.testing.assert_allclose(
        ttr.sd_video_transform(x, size, flip, normalize),
        jtr.sd_video_transform(x, size, flip, normalize), atol=1e-6)


@pytest.mark.parametrize("name,out", [("clip_frame_transform", 224),
                                      ("fid_frame_transform", 229),
                                      ("fvd_frame_transform", 224)])
def test_frame_transforms(rng, name, out):
    """Bicubic antialias to 224 / 229 with the CLIP or [-1, 1] scaling;
    2e-5 (CLIP divides by std ~0.27)."""
    x = rng.random((2, 48, 64, 3)).astype(np.float32)
    got = getattr(ttr, name)(t(x))
    assert got.shape == (2, out, out, 3)
    close(got, getattr(jtr, name)(jnp.asarray(x)), 2e-5)


# -------------------------------------------------------------- metrics ---

def test_relsync_and_alignsync_formulas(rng):
    ref, gen = rng.standard_normal(6) * 5, rng.standard_normal(6) * 5
    np.testing.assert_array_equal(tm.relsync_from_scores(t(ref), gen),
                                  jm.relsync_from_scores(ref, gen))
    gt, sims = rng.standard_normal((6, 1)), rng.standard_normal((6, 11))
    rel = rng.random(6)
    got = tm.alignsync_from_sims(t(gt), t(sims), rel)
    np.testing.assert_array_equal(got, jm.alignsync_from_sims(gt, sims, rel))
    assert got.dtype == np.float32 and ((got >= 0) & (got <= 1)).all()


def _score_fns():
    """Deterministic stand-ins for the nets, one pair per framework."""
    def score(mels, vids, xp):
        return xp.tanh(mels.mean((1, 2, 3)) * 3) + vids.mean((1, 2, 3, 4))

    def ia(frames, mels, xp):
        return xp.tanh(frames.mean((1, 2, 3)) + mels.mean((1, 2, 3)))
    return ((lambda m, v: score(jnp.asarray(m), jnp.asarray(v), jnp)),
            (lambda m, v: score(m, v, torch)),
            (lambda f, m: ia(jnp.asarray(f), jnp.asarray(m), jnp)),
            (lambda f, m: ia(f, m, torch)))


def test_compute_sync_metrics(rng):
    """compute_avsync_scores / compute_relsync (both reference kinds) /
    compute_alignsync on tensors against the JAX package on arrays, with the
    CLIP preprocessing inside; 1e-5."""
    jscore, tscore, jia, tia = _score_fns()
    mels = rng.standard_normal((2, 128, 204, 1)).astype(np.float32)
    ref_mels = rng.standard_normal((2, 128, 204, 1)).astype(np.float32)
    vids = rng.random((2, 4, 32, 32, 3)).astype(np.float32)
    ref_vids = rng.random((2, 4, 32, 32, 3)).astype(np.float32)
    close(tm.compute_avsync_scores(tscore, t(mels), t(vids)),
          jm.compute_avsync_scores(jscore, mels, vids), 1e-5)
    close(tm.compute_relsync(tscore, t(mels), t(vids), ref_videos=t(ref_vids)),
          jm.compute_relsync(jscore, mels, vids, ref_videos=ref_vids), 1e-5)
    close(tm.compute_relsync(tscore, t(mels), t(vids), ref_mels=t(ref_mels)),
          jm.compute_relsync(jscore, mels, vids, ref_mels=ref_mels), 1e-5)
    got = tm.compute_alignsync(tscore, tia, t(mels), t(vids), t(ref_vids))
    assert got.shape == (2,) and ((got >= 0) & (got <= 1)).all()
    close(got, jm.compute_alignsync(jscore, jia, mels, vids, ref_vids), 1e-5)
    with pytest.raises(ValueError, match="exactly one"):
        tm.compute_relsync(tscore, t(mels), t(vids))


@pytest.mark.parametrize("n1,n2,d", [(40, 50, 8), (5, 6, 16)])
def test_frechet_distance(rng, n1, n2, d):
    """Well conditioned, and rank deficient (fewer samples than dimensions:
    the singular product the metric sees on small sets); 1e-9 relative."""
    a = rng.standard_normal((n1, d)) * 2 + 1
    b = rng.standard_normal((n2, d)) + rng.standard_normal(d)
    want = jf.frechet_distance(a, b)
    np.testing.assert_allclose(tf.frechet_distance(t(a), t(b)), want,
                               rtol=1e-9)
    assert abs(tf.frechet_distance(a, a)) <= 1e-6 * (1 + abs(want))


# -------------------------------------------------------------- harness ---

@pytest.fixture(scope="module")
def eval_models():
    return build_eval_models(
        "cpu", torch.float32, seed=0, randomize_all=True,
        vision_config=ImageBindVisionConfig.tiny(image_size=224),
        text_config=ImageBindTextConfig.tiny(context_length=77),
        audio_config=ImageBindAudioConfig.tiny())


def test_build_eval_models_bundle(eval_models, rng):
    """The five callables take arrays or tensors and return finite float32
    tensors of the stated shapes; every net is listed as random."""
    m = eval_models
    assert isinstance(m, EvalModels)
    assert m.random_nets == ["fid_inception_v3", "fvd_i3d",
                             "avsync_classifier", "imagebind_vision",
                             "imagebind_audio", "imagebind_text"]
    assert m.provenance == {"I3D_BN_EPS": 1e-5}
    frames = rng.standard_normal((2, 224, 224, 3)).astype(np.float32)
    mels = rng.standard_normal((2, 128, 204, 1)).astype(np.float32)
    ids = np.zeros((2, 77), np.int64)
    ids[:, 0], ids[:, 5] = 62, 63
    outs = dict(
        fid=m.fid_features(rng.random((2, 75, 75, 3)).astype(np.float32)),
        fvd=m.fvd_features(t(rng.random((1, 9, 32, 32, 3)).astype(np.float32))),
        sync=m.avsync_score(mels, rng.random((2, 4, 32, 32, 3)).astype(
            np.float32)),
        ia=m.ia_sim(frames, mels), it=m.it_sim(t(frames), ids))
    shapes = dict(fid=(2, 2048), fvd=(1, 400), sync=(2,), ia=(2,), it=(2,))
    for name, out in outs.items():
        assert tuple(out.shape) == shapes[name], name
        assert out.dtype == torch.float32 and torch.isfinite(out).all(), name
        assert not out.requires_grad
    assert (outs["ia"].abs() <= 1 + 1e-5).all()      # unit embeddings
    assert (outs["it"].abs() <= 1 + 1e-5).all()


def test_eval_models_are_seeded(eval_models, rng):
    again = build_eval_models(
        "cpu", torch.float32, seed=0, randomize_all=True,
        vision_config=ImageBindVisionConfig.tiny(image_size=224),
        text_config=ImageBindTextConfig.tiny(context_length=77),
        audio_config=ImageBindAudioConfig.tiny())
    x = rng.random((1, 75, 75, 3)).astype(np.float32)
    assert torch.equal(again.fid_features(x), eval_models.fid_features(x))


def test_judge_end_to_end_on_bundle(eval_models, rng):
    """Frames -> transforms -> bundle -> reducers, the chain the chip run
    drives at full size: finite FID / FVD, RelSync and AlignSync in
    [0, 1]."""
    m = eval_models
    gen = t(rng.random((3, 4, 40, 40, 3)).astype(np.float32))
    ref = t(rng.random((3, 4, 40, 40, 3)).astype(np.float32))
    mels = t(rng.standard_normal((3, 128, 204, 1)).astype(np.float32))

    def fid(v):
        small = ttr.resize_image(v.flatten(0, 1), 75, 75, "bicubic") * 2 - 1
        return m.fid_features(small)[:, :32]
    assert np.isfinite(tf.frechet_distance(fid(ref), fid(gen)))
    rel = tm.compute_relsync(m.avsync_score, mels, gen, ref_videos=ref)
    align = tm.compute_alignsync(m.avsync_score, m.ia_sim, mels, gen, ref)
    for x in (rel, align):
        assert x.shape == (3,) and ((x >= 0) & (x <= 1)).all()
