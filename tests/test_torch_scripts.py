"""The file-walking eval harness and the four CLIs of the port on the CPU.

`evaluate_generation_results` over a directory of tiny clips, with shared
weights (ImageBind towers at tiny sizes, the same stub feature nets in both
packages), against asva_tpu's: the same keys, values within
test_torch_eval.py's 1e-5 (FID / FVD, Frechet distances of features that
differ in the last fp32 bits, within 1e-4 relative).  Then each CLI's
`main` with `--device cpu` on tiny configs: the files, stdout lines and
JSON keys of the JAX scripts (tests/test_scripts.py runs those)."""
import json
import os

import numpy as np
import pytest
import torch

from asva_tpu_torch.data import media

pytestmark = pytest.mark.skipif(not media.headers_available(),
                                reason="libav development files missing")
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NULL_TEXT = os.path.join(REPO, "tests", "fixtures",
                         "null_text_encoding_fixture.npy")
VOCAB = 600


def _write(path, n, hw=(32, 32), fps=12.0, seed=0):
    rng = np.random.default_rng(seed)
    frames = (rng.random((n,) + hw + (3,)) * 255).astype(np.uint8)
    t = np.arange(int(n / fps * 16000)) / 16000
    audio = np.stack([0.3 * np.sin(2 * np.pi * (200 + 50 * seed) * t),
                      0.2 * np.sin(2 * np.pi * 90 * t)]).astype(np.float32)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    media.write_video(path, frames, fps, audio, 16000)


@pytest.fixture(scope="module")
def eval_tree(tmp_path_factory):
    """A ground-truth video (3 s) and its three generated 4-frame clips,
    named as generate_videos names them."""
    root = tmp_path_factory.mktemp("tree")
    names = ["dog/x.mp4"]
    for i, name in enumerate(names):
        _write(str(root / "gt" / name), 36, seed=i)
        for k in range(3):
            stem = name.replace(".mp4", "")
            _write(str(root / "gen" / f"{stem}_clip-{k:02d}.mp4"), 8,
                   seed=10 + 3 * i + k)
    return str(root / "gt"), str(root / "gen"), names


def _stub_nets(xp):
    """Feature and score stand-ins, one formula for both packages."""
    def fid(x):          # (n, 229, 229, 3) -> (n, 3)
        return xp.stack([x.mean((1, 2, 3)), x.std((1, 2, 3)),
                         x[:, :100].mean((1, 2, 3))], -1)

    def fvd(v):          # (b, f, 224, 224, 3) -> (b, 2)
        return xp.stack([v.mean((1, 2, 3, 4)), v[:, 1:].std((1, 2, 3, 4))],
                        -1)

    def score(mels, vids):
        return mels.mean((1, 2, 3)) * 3 + vids.mean((1, 2, 3, 4))
    return fid, fvd, score


def _ids(cat):
    rng = np.random.default_rng(len(cat))
    ids = np.zeros(77, np.int64)
    ids[:5] = rng.integers(1, VOCAB - 1, 5)
    ids[5] = VOCAB - 1                    # end of text: the largest id
    return ids


@pytest.fixture(scope="module")
def towers():
    """Tiny ImageBind towers, seeded in the port and carried into JAX."""
    import jax
    from asva_tpu.convert import convert_state_dict
    from asva_tpu.convert.torch_to_jax import (imagebind_audio_key_map,
                                               imagebind_text_key_map,
                                               imagebind_vision_key_map)
    from asva_tpu.models import imagebind_audio as ja
    from asva_tpu.models import imagebind_extra as je
    from asva_tpu_torch import runtime
    from asva_tpu_torch.models import imagebind_audio as ta
    from asva_tpu_torch.models import imagebind_extra as te
    cfgs = dict(vision=dict(embed_dim=32, out_embed_dim=16, num_blocks=1,
                            num_heads=2, image_size=224, patch_size=14),
                audio=dict(embed_dim=32, out_embed_dim=16, num_blocks=1,
                           num_heads=2),
                text=dict(vocab_size=VOCAB, embed_dim=32, out_embed_dim=16,
                          num_blocks=1, num_heads=2, context_length=77))
    specs = dict(
        vision=(te.ImageBindVisionEncoder, te.ImageBindVisionConfig,
                je.ImageBindVisionEncoder, je.ImageBindVisionConfig,
                imagebind_vision_key_map, np.zeros((1, 224, 224, 3),
                                                   np.float32)),
        audio=(ta.ImageBindAudioEncoder, ta.ImageBindAudioConfig,
               ja.ImageBindAudioEncoder, ja.ImageBindAudioConfig,
               imagebind_audio_key_map, np.zeros((1, 128, 204, 1),
                                                 np.float32)),
        text=(te.ImageBindTextEncoder, te.ImageBindTextConfig,
              je.ImageBindTextEncoder, je.ImageBindTextConfig,
              imagebind_text_key_map, np.zeros((1, 77), np.int32)))
    out = {}
    for i, (name, (tcls, tcfg, jcls, jcfg, key_map, x)) in enumerate(
            specs.items()):
        tm = runtime._build(lambda: tcls(tcfg(**cfgs[name])), "cpu",
                            torch.float32, 20 + i, True)
        jm = jcls(jcfg(**cfgs[name]))
        shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
        state = {k: v.numpy() for k, v in tm.state_dict().items()}
        params, report = convert_state_dict(shapes, state, key_map)
        assert not report["fresh"]
        out[name] = (tm, jm, params)
    return out


def test_harness_matches_jax(eval_tree, towers, tmp_path):
    import jax
    import jax.numpy as jnp
    from asva_tpu.eval import harness as jh
    from asva_tpu_torch.eval import harness as th
    from test_torch_media import jax_media
    jax_media()
    gt_root, gen_root, names = eval_tree
    (tv, jv, pv), (ta_, ja_, pa), (tt, jt, pt) = (
        towers["vision"], towers["audio"], towers["text"])

    @jax.jit   # one compile per shape instead of one per eager op
    def jia(frames, mels):
        v = jv.apply(pv, frames)
        a, _ = ja_.apply(pa, mels, normalize=True)
        return jnp.sum(v * a / 20.0, axis=-1)

    @jax.jit
    def jit_sim(frames, ids):
        return jnp.sum(jv.apply(pv, frames)
                       * jt.apply(pt, ids.astype(jnp.int32)), axis=-1)

    jfid, jfvd, jscore = _stub_nets(jnp)
    jmodels = jh.EvalModels(
        fid_features=lambda x: jfid(jnp.asarray(x)),
        fvd_features=lambda v: jfvd(jnp.asarray(v)),
        avsync_score=lambda m, v: jscore(jnp.asarray(m), jnp.asarray(v)),
        ia_sim=jia, it_sim=jit_sim, random_nets=["stub"],
        provenance={"I3D_BN_EPS": 1e-3})
    tmodels = th.eval_models_from_nets("cpu", vision=tv, audio=ta_, text=tt)
    tfid, tfvd, tscore = _stub_nets(torch)
    tmodels.fid_features, tmodels.fvd_features = tfid, tfvd
    tmodels.avsync_score = tscore
    tmodels.random_nets, tmodels.provenance = ["stub"], {"I3D_BN_EPS": 1e-3}

    kw = dict(image_size=32, video_fps=6, video_num_frame=4,
              record_instance_metrics=True)
    want = jh.evaluate_generation_results(
        jmodels, gt_root, names, ["dog"], 3, gen_root,
        str(tmp_path / "jax.json"), text_ids_for_category=_ids, **kw)
    got = th.evaluate_generation_results(
        tmodels, gt_root, names, ["dog"], 3, gen_root,
        str(tmp_path / "port.json"),
        text_ids_for_category=lambda c: torch.from_numpy(_ids(c)),
        device="cpu", **kw)
    with open(tmp_path / "port.json") as f:
        assert json.load(f) == got
    assert list(got) == list(want)
    assert len(got["instance_metrics"]) == 3
    for key, value in want.items():
        if key == "instance_metrics":
            assert list(got[key]) == list(value)
            for clip, rec in value.items():
                assert list(got[key][clip]) == list(rec)
                np.testing.assert_allclose(
                    [got[key][clip][m] for m in rec], list(rec.values()),
                    rtol=1e-5, atol=1e-5)
        elif key in ("FID", "FVD"):
            np.testing.assert_allclose(got[key], value, rtol=1e-4)
        elif isinstance(value, float):
            np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-5)
        else:
            assert got[key] == value, key


def test_generated_clip_paths(tmp_path):
    """Exact names only, sorted by the clip index (`dog_1` never picks up
    `dog_10`'s clips), as asva_tpu's."""
    from asva_tpu.eval.harness import generated_clip_paths as jpaths
    from asva_tpu_torch.eval.harness import generated_clip_paths
    for stem in ("dog_1", "dog_10"):
        for k in (1, 0):
            (tmp_path / f"{stem}_clip-{k:02d}.mp4").write_bytes(b"x")
    (tmp_path / "dog_1_clip-extra.mp4").write_bytes(b"x")
    for stem in ("dog_1", "dog_10", "sub/none"):
        assert generated_clip_paths(str(tmp_path), stem) == jpaths(
            str(tmp_path), stem)
    assert [k for k, _ in generated_clip_paths(str(tmp_path), "dog_1")] == \
        [0, 1]


# ------------------------------------------------------------------ CLIs ---

@pytest.fixture(scope="module")
def experiment(tmp_path_factory):
    """exp/ckpts/checkpoint-40/modules with a tiny UNet and audio tower
    (CheckpointManager exports and their modules_config.json), and a
    dataset tree with one test video, a class mapping and its encodings."""
    import dataclasses
    from asva_tpu_torch import runtime
    from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig
    from asva_tpu_torch.models.unet3d import UNet3DConfig
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    root = tmp_path_factory.mktemp("exp")
    ucfg = UNet3DConfig.tiny(audio_cross_attention_dim=32)
    acfg = ImageBindAudioConfig.tiny()
    unet = runtime.build_unet(ucfg, "cpu", torch.float32, randomize_all=True)
    audio = runtime.build_audio_encoder(4, acfg, "cpu", torch.float32,
                                        randomize_all=True)
    ckpt = CheckpointManager(
        str(root / "exp" / "ckpts"), checkpointing_steps=40,
        module_configs={"unet": dataclasses.asdict(ucfg),
                        "audio_encoder": dataclasses.asdict(acfg)})
    ckpt.save(40, {"step": 40}, force=True,
              modules={"unet": unet.state_dict(),
                       "audio_encoder": audio.state_dict()})
    ds = root / "datasets" / "AVSync15"
    _write(str(ds / "videos" / "dog" / "v0.mp4"), 30, hw=(48, 48))
    (ds / "test.txt").write_text("dog/v0.mp4\n")
    (ds / "class_mapping.json").write_text(json.dumps({"dog": "a dog"}))
    rng = np.random.default_rng(4)
    torch.save({"a dog": torch.from_numpy(
        rng.standard_normal((77, 768)).astype(np.float32))},
        ds / "class_clip_text_encodings_stable-diffusion-v1-5.pt")
    return str(root)


def test_animation_demo_cli(experiment, tmp_path, capsys):
    from PIL import Image
    from scipy.io import wavfile
    from asva_tpu_torch.scripts import animation_demo
    rng = np.random.default_rng(0)
    img = str(tmp_path / "cond.png")
    Image.fromarray((rng.random((48, 48, 3)) * 255).astype(np.uint8)).save(
        img)
    wav = str(tmp_path / "cond.wav")
    s = np.arange(3 * 16000) / 16000
    wavfile.write(wav, 16000, (0.4 * np.sin(2 * np.pi * 440 * s)).astype(
        np.float32))
    animation_demo.main([
        "--image_path", img, "--audio_path", wav,
        "--checkpoint_modules_dir", os.path.join(
            experiment, "exp", "ckpts", "checkpoint-40", "modules"),
        "--sd_root", "", "--null_text_encoding_path", NULL_TEXT,
        "--image_size", "32", "32", "--video_num_frame", "4",
        "--num_clips", "2", "--num_inference_steps", "2",
        "--sampler", "ddim", "--save_template", str(tmp_path / "demo"),
        "--device", "cpu"])
    assert "wrote 2 clips" in capsys.readouterr().out
    for k in range(2):
        with media.MediaReader(str(tmp_path / f"demo_clip-{k:02d}.mp4")) as r:
            assert r.size == (32, 32) and r.audio_sample_rate == 16000


class Pool(torch.nn.Module):
    """A stand-in for the FID net: (n, 229, 229, 3) -> (n, 4)."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Linear(3, 4)

    def forward(self, x):
        return self.proj(x.mean((1, 2)))


class TinyI3D(torch.nn.Module):
    """A stand-in for the FVD net, (b, f, 224, 224, 3) -> (b, 3), with one
    BatchNorm whose eps a TorchScript blob carries."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.conv3d = torch.nn.Conv3d(3, 3, 1)
        self.bn = torch.nn.BatchNorm3d(3, eps=eps)

    def forward(self, v):
        return self.bn(self.conv3d(v.permute(0, 4, 1, 2, 3))).mean((2, 3, 4))


def _gen_args(experiment):
    return ["--exp_root", os.path.join(experiment, "exp"),
            "--checkpoint", "40", "--dataset", "AVSync15",
            "--dataset_root", os.path.join(experiment, "datasets"),
            "--image_size", "32", "32", "--video_num_frame", "4",
            "--num_clips_per_video", "2", "--device", "cpu"]


def test_animation_gen_and_eval_cli(experiment, tmp_path, monkeypatch,
                                    capsys):
    """animation_gen writes the reference's evaluations/checkpoint-N/
    AG-.._TG-../seed-N/videos layout; animation_eval scores it: the metric
    JSON next to videos/, ImageBind from a raw imagebind_huge.pth, the FVD
    net from a TorchScript blob whose BatchNorm eps is read out of it, the
    nets without weights labelled random."""
    from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig
    from asva_tpu_torch.models.imagebind_extra import (
        ImageBindTextConfig, ImageBindTextEncoder, ImageBindVisionConfig,
        ImageBindVisionEncoder)
    from asva_tpu_torch.models.imagebind_audio import ImageBindAudioEncoder
    from asva_tpu_torch.scripts import animation_eval, animation_gen
    animation_gen.main(_gen_args(experiment) + [
        "--num_inference_steps", "2", "--sampler", "ddim"])
    assert "generated dog/v0.mp4" in capsys.readouterr().out
    run = os.path.join(experiment, "exp", "evaluations", "checkpoint-40",
                       "AG-4.0_TG-1.0", "seed-0")
    assert sorted(os.listdir(os.path.join(run, "videos", "dog"))) == [
        "v0_clip-00.mp4", "v0_clip-01.mp4"]

    vcfg = dict(embed_dim=32, out_embed_dim=16, num_blocks=1, num_heads=2,
                image_size=224, patch_size=14)
    acfg = dict(embed_dim=32, out_embed_dim=16, num_blocks=1, num_heads=2)
    tcfg = dict(vocab_size=VOCAB, embed_dim=32, out_embed_dim=16,
                num_blocks=1, num_heads=2, context_length=77)
    monkeypatch.setitem(animation_eval.NETS, "fid_inception_v3",
                        (Pool, 10, 1.0))
    monkeypatch.setitem(animation_eval.NETS, "fvd_i3d", (TinyI3D, 11, 1.0))
    monkeypatch.setitem(animation_eval.NETS, "imagebind_vision", (
        lambda: ImageBindVisionEncoder(ImageBindVisionConfig(**vcfg)), 13,
        1.0))
    monkeypatch.setitem(animation_eval.NETS, "imagebind_audio", (
        lambda: ImageBindAudioEncoder(ImageBindAudioConfig(**acfg)), 14,
        1.0))
    monkeypatch.setitem(animation_eval.NETS, "imagebind_text", (
        lambda: ImageBindTextEncoder(ImageBindTextConfig(**tcfg)), 15, 1.0))

    pre = tmp_path / "pretrained"
    (pre / ".checkpoints").mkdir(parents=True)
    huge = {}
    for factory, _, _ in (animation_eval.NETS[n] for n in (
            "imagebind_vision", "imagebind_audio", "imagebind_text")):
        for k, v in factory().state_dict().items():
            for part, prefix in (("preprocessors", "preprocessor."),
                                 ("trunks", "trunk."), ("heads", "head.")):
                if k.startswith(prefix):   # the audio export -> raw names
                    k = f"modality_{part}.audio." + k[len(prefix):]
            huge[k] = v
    torch.save(huge, pre / ".checkpoints" / "imagebind_huge.pth")
    torch.jit.script(TinyI3D(1e-3)).save(str(pre / "i3d_torchscript.pt"))
    tok = pre / "stable-diffusion-v1-5" / "tokenizer"
    tok.mkdir(parents=True)
    from asva_tpu_torch.models.clip_bpe import _bytes_to_unicode
    vocab = list(_bytes_to_unicode().values())
    vocab += [v + "</w>" for v in vocab] + ["<|startoftext|>",
                                            "<|endoftext|>"]
    (tok / "vocab.json").write_text(json.dumps(
        {t: i for i, t in enumerate(vocab)}))
    (tok / "merges.txt").write_text("#version: 0.2\n")
    assert len(vocab) <= VOCAB

    argv = _gen_args(experiment) + [
        "--pretrained_root", str(pre), "--avsync_checkpoint",
        str(tmp_path / "none"), "--eval_fid", "--eval_fvd", "--eval_clipsim",
        "--eval_relsync", "--eval_alignsync", "--record_instance_metrics"]
    with pytest.raises(SystemExit, match="fid_inception_v3"):
        animation_eval.main(argv)          # no FID weights: refused
    result = animation_eval.main(argv + ["--allow_random_eval_nets"])
    with open(os.path.join(run, "result.json")) as f:
        assert json.load(f) == result
    assert list(result) == [
        "groundtruth_video_root", "generated_video_root",
        "num_clips_per_video", "RANDOM_WEIGHT_NETS", "MEL_PROVENANCE",
        "I3D_BN_EPS", "I3D_BN_EPS_SOURCE", "FID", "FVD", "IA_mean",
        "IA_std", "IT_mean", "IT_std", "RelSync_mean", "RelSync_std",
        "AlignSync_mean", "AlignSync_std", "instance_metrics"]
    assert result["RANDOM_WEIGHT_NETS"] == ["fid_inception_v3",
                                            "avsync_classifier"]
    assert result["I3D_BN_EPS"] == 1e-3
    assert result["I3D_BN_EPS_SOURCE"] == "auto-detected from blob"
    assert list(result["instance_metrics"]) == ["v0_clip-00.mp4",
                                                "v0_clip-01.mp4"]
    assert all(np.isfinite(v) for v in result.values()
               if isinstance(v, float))
    assert os.path.isfile(pre / "i3d_state.pt.eps.json")


def test_avsync_metric_cli(tmp_path, capsys):
    from asva_tpu_torch.scripts import avsync_metric
    v0, v1 = str(tmp_path / "v0.mp4"), str(tmp_path / "v1.mp4")
    _write(v0, 30, hw=(48, 48), seed=1)
    _write(v1, 30, hw=(48, 48), seed=2)
    score = avsync_metric.main(["--video_path", v0, "--video_num_frame",
                                "4", "--device", "cpu"])
    assert "avsync_score:" in capsys.readouterr().out
    assert np.isfinite(score)
    rel = avsync_metric.main(["--video_path", v0, "--ref_video_path", v1,
                              "--video_num_frame", "4", "--metric",
                              "relsync", "--device", "cpu"])
    assert "relsync:" in capsys.readouterr().out
    assert 0.0 <= rel <= 1.0
