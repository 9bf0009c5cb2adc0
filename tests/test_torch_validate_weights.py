"""The port's real-weights path on the CPU at tiny sizes: the weights gate
(asva_tpu_torch/tools/validate_weights.py) over a tree that
asva_tpu_torch/tools/fabricate.py writes in the published formats, the
fabricated files' key sets against asva_tpu's published key spaces, the
inverse key spaces of convert.py, the pipeline loaded from the tree by both
packages, the gate's mutations (each fails its own check, as its loader
raises), the null-text mint against tools/make_null_text_encoding.py and the
per-dataset recipes against scripts/animation_test_*.sh."""
import functools
import importlib.util
import json
import os
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asva_tpu import runtime as jrt
from asva_tpu.convert.jax_to_torch import export_state_dict
from asva_tpu.convert.torch_to_jax import (avsync_key_map, clip_text_key_map,
                                           i3d_key_map,
                                           imagebind_audio_key_map,
                                           imagebind_text_key_map,
                                           imagebind_vision_key_map,
                                           inception_v3_key_map,
                                           unet_key_map, vae_key_map)
from asva_tpu.models import avsync as javs
from asva_tpu.models import clip_bpe as jb
from asva_tpu.models import clip_text as jclip
from asva_tpu.models import evalnets as jev
from asva_tpu.models import imagebind_audio as ja
from asva_tpu.models import imagebind_extra as je
from asva_tpu.models.unet3d import AudioUNet3D as JU, UNet3DConfig as JC
from asva_tpu.models.vae import AutoencoderKL as JV, VAEConfig as JVC
from asva_tpu_torch import convert, runtime
from asva_tpu_torch.models import clip_text as tclip
from asva_tpu_torch.models.evalnets import InceptionI3D, InceptionV3FID
from asva_tpu_torch.models.imagebind_audio import (ImageBindAudioConfig,
                                                   SegmaskAudioEncoder)
from asva_tpu_torch.models.imagebind_extra import (ImageBindTextConfig,
                                                   ImageBindTextEncoder,
                                                   ImageBindVisionConfig,
                                                   ImageBindVisionEncoder)
from asva_tpu_torch.models.vae import VAEConfig as TVC
from asva_tpu_torch.scripts import animation_eval, animation_gen
from asva_tpu_torch.scripts import animation_test
from asva_tpu_torch.tools import fabricate as fab
from asva_tpu_torch.tools import make_null_text_encoding as ttool
from asva_tpu_torch.tools import validate_weights as vw

from test_torch_ops import close, t
from test_torch_text import MERGES

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LABELS = ["sd15_vae", "sd15_unet_graft", "sd15_text_encoder", "avsyncd_unet",
          "avsyncd_audio_encoder", "imagebind_huge_audio",
          "imagebind_huge_vision", "imagebind_huge_text", "fid_inception_v3",
          "fvd_i3d", "avsync_classifier", "avid_cma_init",
          "null_text_encoding"]
F = 4   # the tiny tree's n_segment (frames)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("artifacts"))
    return fab.fabricate(root, full=False, seed=0, device="cpu")


def _gate(tree):
    """(exit code, results) of the gate over the tiny tree."""
    args = vw.parser().parse_args([
        "--root", tree["root"], "--device", "cpu",
        "--checkpoint_modules_dir", tree["checkpoint_modules_dir"],
        "--avsync_modules_dir", tree["avsync_modules_dir"],
        "--avid_cma_path", tree["avid_cma_path"]])
    results = vw.Gate(args, full=False).run_all()
    return vw.summary(results), results


def test_fabricate_dry_run_passes_every_check(capsys):
    """`--fabricate --device cpu`: 13 checks, all PASS, exit 0, the I3D
    blob's eps read as 1e-3, the temporary tree removed."""
    code, results = vw.run(["--fabricate", "--device", "cpu"])
    assert code == 0
    assert [r["label"] for r in results] == LABELS
    assert all(r["status"] == vw.PASS for r in results), results
    i3d = results[LABELS.index("fvd_i3d")]
    assert i3d["bn_eps"] == pytest.approx(1e-3)
    out = capsys.readouterr().out
    assert "13 checks: 13 pass, 0 fail, 0 not staged" in out
    root = out.split("validating artifacts under ")[1].split(" on ")[0]
    assert not os.path.exists(root)


# ---------------------------------------------- asva_tpu's key spaces ---

def _zeros(module, *args):
    """A flax variables tree of `module`'s shapes (no init compiled)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)


def _flax_paths(module, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return [tuple(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]


def _prefer_huge(km):
    """The raw imagebind_huge.pth candidate of a key map (asva_tpu's
    fabrication, tools/validate_weights.py:317-324)."""
    def f(segs):
        keys = km(segs)
        if isinstance(keys, list):
            return [k for k in keys if k.startswith("modality_")] or keys
        return keys
    return f


@functools.lru_cache(maxsize=None)
def _unet_vars():
    c = JC.tiny(audio_cross_attention_dim=32)
    return _zeros(JU(c), jnp.zeros((1, F, 8, 8, 4)),
                  jnp.zeros((1,), jnp.int32), jnp.zeros((1, 77, 768)),
                  jnp.zeros((1, 229, 32)), jnp.ones((1, F, 229), bool))


def _huge_space():
    audio = export_state_dict(
        _zeros(ja.SegmaskAudioEncoder(ja.ImageBindAudioConfig.tiny(),
                                      n_segment=F),
               jnp.zeros((1, 128, 204, 1)))["params"],
        _prefer_huge(imagebind_audio_key_map))
    space = {k for k in audio if not k.startswith("final_layer_norm")}
    vc, tc = je.ImageBindVisionConfig.tiny(), je.ImageBindTextConfig.tiny()
    space |= set(export_state_dict(_zeros(
        je.ImageBindVisionEncoder(vc),
        jnp.zeros((1, vc.image_size, vc.image_size, 3)))["params"],
        _prefer_huge(imagebind_vision_key_map)))
    space |= set(export_state_dict(_zeros(
        je.ImageBindTextEncoder(tc),
        jnp.zeros((1, tc.context_length), jnp.int32))["params"],
        _prefer_huge(imagebind_text_key_map)))
    return space


@functools.lru_cache(maxsize=None)
def _classifier_space():
    v = _zeros(javs.AVSyncClassifier(), jnp.zeros((1, 128, 204, 1)),
               jnp.zeros((1, 12, 224, 224, 3)))
    return set(export_state_dict(v, avsync_key_map))


def _space(name):
    """asva_tpu's published key space of the artifact `name`."""
    if name in ("sd15_unet", "avsyncd_unet"):
        keys = set(export_state_dict(_unet_vars()["params"], unet_key_map))
        if name == "sd15_unet":   # asva_tpu's 2D rule (validate_weights:342)
            keys = {k for k in keys if "temp" not in k and "audio" not in k}
        return keys
    if name == "sd15_vae":
        key = jax.random.PRNGKey(0)
        return set(export_state_dict(_zeros(
            JV(JVC.tiny()), jnp.zeros((1, 32, 32, 3)), key)["params"],
            vae_key_map))
    if name == "sd15_text_encoder":
        c = jclip.CLIPTextConfig.tiny(vocab_size=1024, max_positions=77)
        return set(export_state_dict(_zeros(
            jclip.CLIPTextModel(c), jnp.zeros((1, 77), jnp.int32))["params"],
            clip_text_key_map))
    if name == "avsyncd_audio_encoder":
        return set(export_state_dict(_zeros(
            ja.SegmaskAudioEncoder(ja.ImageBindAudioConfig.tiny(),
                                   n_segment=F),
            jnp.zeros((1, 128, 204, 1)))["params"], imagebind_audio_key_map))
    if name == "imagebind_huge":
        return _huge_space()
    if name == "fid_inception_v3":   # the map's keys, and the classifier
        return {inception_v3_key_map(p) for p in _flax_paths(
            jev.InceptionV3FID(), jnp.zeros((1, 75, 75, 3)))} | {
                "fc.weight", "fc.bias"}
    if name == "fvd_i3d":            # pytorch-i3d's names: first candidate
        return {i3d_key_map(p)[0] for p in _flax_paths(
            jev.InceptionI3D(), jnp.zeros((1, 8, 32, 32, 3)))}
    if name == "avsync_classifier":
        return _classifier_space()
    assert name == "avid_cma"
    return {f"module.{k[:5]}_model.{k[len('audio_encoder.'):]}"
            for k in _classifier_space() if not k.startswith("head.")}


def _file_keys(tree, name):
    root = tree["root"]
    if name == "fvd_i3d":
        state, _ = convert.extract_state_and_eps(
            os.path.join(root, fab.PATHS[name]))
        return set(state)
    if name == "avsync_classifier":
        return {f"{m}.{k}" for m in ("audio_encoder", "video_encoder", "head")
                for k in runtime.load_torch_state(os.path.join(
                    tree["avsync_modules_dir"], m, "pytorch_model.bin"))}
    if name == "avid_cma":
        return set(torch.load(tree["avid_cma_path"],
                              weights_only=True)["model"])
    return set(torch.load(os.path.join(root, fab.PATHS[name]),
                          weights_only=True))


# keys of the published torch files that asva_tpu's trees have no leaf for:
# BatchNorm's step counters, CLIP's position index
NO_LEAF = ("num_batches_tracked", "position_ids")


@pytest.mark.parametrize("name", [
    "sd15_unet", "avsyncd_unet", "sd15_vae", "sd15_text_encoder",
    "avsyncd_audio_encoder", "imagebind_huge", "fid_inception_v3",
    "fvd_i3d", "avsync_classifier", "avid_cma"])
def test_fabricated_keys_are_the_published_key_space(tree, name):
    """Each file's keys are asva_tpu's export of the same module
    (`export_state_dict` with the key maps of convert/torch_to_jax.py, or
    the maps' candidates for InceptionV3 and I3D), plus only the buffers
    that asva_tpu's trees have no leaf for."""
    keys = _file_keys(tree, name)
    extra = {k for k in keys if k.endswith(NO_LEAF)}
    assert keys - extra == _space(name)
    if name == "sd15_text_encoder":
        assert extra == {"text_model.embeddings.position_ids"}
    elif name in ("sd15_unet", "avsyncd_unet", "sd15_vae",
                  "avsyncd_audio_encoder", "imagebind_huge"):
        assert not extra


def test_two_dimensional_unet_is_the_file_minus_trainable_keys(tree):
    """The 2D file holds every key of the 3D file outside
    TRAINABLE_SEGMENTS, the same tensors."""
    root = tree["root"]
    full = torch.load(os.path.join(root, fab.PATHS["avsyncd_unet"]),
                      weights_only=True)
    flat = torch.load(os.path.join(root, fab.PATHS["sd15_unet"]),
                      weights_only=True)
    assert set(full) - set(flat) == convert.graft_keys(full)
    assert all(torch.equal(flat[k], full[k]) for k in flat)


# ----------------------------------------------------- inverse spaces ---

def _meta_state(factory):
    with torch.device("meta"):
        return factory().state_dict()


SPACE_MODULES = {
    "clip_text": lambda: tclip.CLIPTextModel(tclip.CLIPTextConfig.tiny()),
    "imagebind_audio": lambda: SegmaskAudioEncoder(
        ImageBindAudioConfig.tiny(), F),
    "imagebind_vision": lambda: ImageBindVisionEncoder(
        ImageBindVisionConfig.tiny()),
    "imagebind_text": lambda: ImageBindTextEncoder(
        ImageBindTextConfig.tiny()),
    "inception_v3": InceptionV3FID, "i3d": InceptionI3D}


@pytest.mark.parametrize("space", sorted(convert.SOURCE_SPACES))
def test_from_port_keys_inverts_to_port_keys(space):
    """to_port_keys(from_port_keys(s)) == s for the port's module of every
    space, each value the same tensor; the audio tower's published names
    are the raw file's `modality_*.audio.` ones."""
    state = _meta_state(SPACE_MODULES[space])
    out = convert.from_port_keys(state, space)
    back, _ = convert.to_port_keys(out, space)
    assert list(back) == list(state)
    assert all(back[k] is state[k] for k in state)
    if space == "imagebind_audio":
        assert {k.split(".")[0] for k in out} == {
            "modality_preprocessors", "modality_trunks", "modality_heads",
            "final_layer_norm"}


# ------------------------------------------- the pipeline from files ---

def test_pipeline_from_tree_matches_jax_package(tree, rng, monkeypatch):
    """asva_tpu's load_animation_pipeline and the port's, both from the
    fabricated tree (trained checkpoint, VAE, null text), give the same
    clip with JAX's noise draws: latents within 1e-4, frames within one
    uint8 level (fp32).  Two things are monkeypatched in asva_tpu: the
    tiny VAE (its loader builds the published one), and an init of zeros
    from `jax.eval_shape` in place of its compiled init (some 30 s here):
    the files hold every leaf, so no init value survives the load, and
    one that did would show as a difference from the port."""
    monkeypatch.setattr(jrt, "VAEConfig", JVC.tiny)
    monkeypatch.setattr(jrt, "_init_params", lambda model, *a, seed=0: _zeros(
        model, *a))
    sd = os.path.join(tree["root"], fab.SD)
    null = os.path.join(tree["root"], fab.PATHS["null_text_encoding"])
    mods = tree["checkpoint_modules_dir"]
    jpipe = jrt.load_animation_pipeline(mods, sd, null, n_segment=F,
                                        dtype=jnp.float32, param_dtype=None)
    tpipe = runtime.load_animation_pipeline(
        mods, sd, null, n_segment=F, device="cpu", dtype=torch.float32,
        vae_config=TVC.tiny())
    images = rng.random((1, 16, 16, 3)).astype(np.float32)
    mels = rng.standard_normal((1, 128, 204, 1)).astype(np.float32)
    text = rng.standard_normal((1, 77, 768)).astype(np.float32)
    kw = dict(video_length=F, num_inference_steps=3, sampler="ddim",
              text_guidance_scale=1.0, audio_guidance_scale=4.0)
    key = jax.random.PRNGKey(7)
    rng_vae, rng_noise = jax.random.split(key)
    mean, _ = jax.eval_shape(lambda: jpipe.vae.apply(
        jpipe.vae_params, jnp.asarray(images * 2 - 1),
        method=jpipe.vae.encode))
    draws = dict(vae_noise=t(jax.random.normal(rng_vae, mean.shape)),
                 latent_noise=t(jax.random.normal(
                     rng_noise, (1, F - 1) + mean.shape[1:])))
    args = tuple(jnp.asarray(a) for a in (images, mels, text))
    for decode in (False, True):
        want = np.asarray(jpipe(*args, rng=key, decode=decode, **kw))
        with torch.no_grad():
            got = tpipe(*map(t, (images, mels, text)), decode=decode,
                        **draws, **kw).numpy()
        assert got.shape == want.shape
        if decode:
            frames = [np.round(np.clip(v, 0, 1) * 255) for v in (got, want)]
            assert np.abs(frames[0] - frames[1]).max() <= 1
        else:
            close(got, want, 1e-4)


# --------------------------------------------------------- mutations ---

def _rewrite(path, edit):
    state = torch.load(path, weights_only=True)
    edit(state)
    torch.save(state, path)


def _mutate_vae(root):
    path = os.path.join(root, fab.PATHS["sd15_vae"])
    _rewrite(path, lambda s: s.pop(sorted(s)[0]))
    return lambda: runtime.build_vae(TVC.tiny(), device="cpu",
                                     weights_dir=os.path.dirname(path))


def _mutate_text(root):
    path = os.path.join(root, fab.PATHS["sd15_text_encoder"])
    _rewrite(path, lambda s: s.update(
        {"text_model.extra.weight": torch.zeros(3)}))
    return lambda: runtime.build_text_encoder(
        fab.configs(False)["text_encoder"], device="cpu",
        weights_dir=os.path.dirname(path))


def _mutate_audio(root):
    path = os.path.join(root, fab.PATHS["avsyncd_audio_encoder"])
    key = "trunk.blocks.0.mlp.fc1.weight"
    _rewrite(path, lambda s: s.update({key: s[key][:, :-1]}))
    return lambda: runtime.build_audio_encoder(
        F, ImageBindAudioConfig.tiny(), device="cpu",
        weights_dir=os.path.dirname(path))


def _mutate_unet(root):
    path = os.path.join(root, fab.PATHS["sd15_unet"])
    full = torch.load(os.path.join(root, fab.PATHS["avsyncd_unet"]),
                      weights_only=True)
    key = sorted(k for k in full if "conv_temp" in k)[0]
    _rewrite(path, lambda s: s.update({key: full[key]}))
    return lambda: runtime.build_unet(fab.configs(False)["unet"],
                                      device="cpu",
                                      weights_dir=os.path.dirname(path))


MUTATIONS = {"sd15_vae": (_mutate_vae, "sd15_vae", "missing"),
             "sd15_text_encoder": (_mutate_text, "sd15_text_encoder",
                                   "unexpected"),
             "avsyncd_audio_encoder": (_mutate_audio, "avsyncd_audio_encoder",
                                       "shapes"),
             "sd15_unet_graft": (_mutate_unet, "sd15_unet", "missing")}


@pytest.mark.parametrize("label", sorted(MUTATIONS))
def test_mutation_fails_only_its_own_check(tree, label):
    """A key dropped from the VAE, an extra key in the text encoder, a
    wrong shape in the audio tower, one `_temp` key in the 2D UNet: the
    gate fails that check alone and exits 1, and the loader that the check
    stands for refuses the same file."""
    mutate, artifact, why = MUTATIONS[label]
    path = os.path.join(tree["root"], fab.PATHS[artifact])
    with open(path, "rb") as f:
        original = f.read()
    try:
        load = mutate(tree["root"])
        code, results = _gate(tree)
        with pytest.raises((KeyError, RuntimeError)):
            load()
    finally:
        with open(path, "wb") as f:
            f.write(original)
    assert code == 1
    failed = [r for r in results if r["status"] == vw.FAIL]
    assert [r["label"] for r in failed] == [label]
    assert why in failed[0]["detail"]
    assert all(r["status"] == vw.PASS for r in results if r["label"] != label)


def test_missing_file_is_not_staged(tree):
    """An artifact that is not there is NOT-STAGED, with exit 0."""
    path = os.path.join(tree["root"], fab.PATHS["fid_inception_v3"])
    os.rename(path, path + ".away")
    try:
        code, results = _gate(tree)
    finally:
        os.rename(path + ".away", path)
    assert code == 0
    status = {r["label"]: r["status"] for r in results}
    assert status.pop("fid_inception_v3") == vw.MISS
    assert set(status.values()) == {vw.PASS}


# ---------------------------------------------------- null text mint ---

def test_null_text_mint_matches_jax_tool(tree, tmp_path, monkeypatch):
    """The port's tool against tools/make_null_text_encoding.py's main, run
    in-process on the tree's tiny text encoder with a synthetic BPE
    vocabulary, the default CLIP config monkeypatched to the tree's tiny
    one in both packages; asva_tpu's tool builds its encoder in bfloat16
    (build_text_encoder's default dtype), so it runs in float32 here to
    compare the function rather than the rounding."""
    spec = importlib.util.spec_from_file_location(
        "jax_null_text_tool",
        os.path.join(REPO, "tools", "make_null_text_encoding.py"))
    jtool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtool)
    sd = tmp_path / "sd"
    tok = sd / "tokenizer"
    tok.mkdir(parents=True)
    os.symlink(os.path.join(tree["root"], fab.SD, "text_encoder"),
               sd / "text_encoder")
    vocab = list(jb._bytes_to_unicode().values())
    vocab += [v + "</w>" for v in vocab]
    vocab += ["".join(m) for m in MERGES]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    (tok / "vocab.json").write_text(
        json.dumps({w: i for i, w in enumerate(vocab)}))
    (tok / "merges.txt").write_text(
        "#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES))
    jcfg = jclip.CLIPTextConfig.tiny(vocab_size=1024, max_positions=77)
    tcfg = fab.configs(False)["text_encoder"]
    monkeypatch.setattr(jrt, "CLIPTextConfig", lambda: jcfg)
    monkeypatch.setattr(jrt, "build_text_encoder", functools.partial(
        jrt.build_text_encoder, jnp.float32))
    monkeypatch.setattr(tclip, "CLIPTextConfig", lambda: tcfg)
    monkeypatch.setattr("sys.argv", ["make_null_text_encoding.py",
                                     "--sd_root", str(sd), "--out",
                                     str(tmp_path / "jax.npy")])
    jtool.main()
    got = ttool.main(["--sd_root", str(sd), "--out",
                      str(tmp_path / "port.pt"), "--device", "cpu"])
    want = np.load(tmp_path / "jax.npy")
    assert got.shape == want.shape == (1, 77, 32)
    close(got, want, 1e-5)
    assert torch.equal(torch.load(tmp_path / "port.pt", weights_only=True),
                       torch.from_numpy(got))


# ------------------------------------------------------------ recipes ---

def _sh_argvs(dataset_file, exp_root, ckpt, ag):
    """The argv of each `python scripts/animation_{gen,eval}.py` call of a
    shell recipe, its variables substituted."""
    with open(os.path.join(REPO, "scripts", dataset_file)) as f:
        lines = f.read().splitlines()
    calls, i = [], 0
    while i < len(lines):
        line = lines[i].strip()
        if line.startswith("python scripts/animation_"):
            cmd = line
            while cmd.endswith("\\"):
                i += 1
                cmd = cmd[:-1] + " " + lines[i].strip()
            calls.append(shlex.split(cmd))
        i += 1
    subs = {"$EXP_ROOT": exp_root, "$CKPT": ckpt, "$AG": ag}
    return [(c[1], [subs.get(a, a) for a in c[2:]]) for c in calls]


@pytest.mark.parametrize("dataset,sh", [
    ("AVSync15", "animation_test_avsync15.sh"),
    ("Landscapes", "animation_test_landscapes.sh"),
    ("TheGreatestHits", "animation_test_thegreatesthits.sh")])
def test_recipes_match_shell_scripts(monkeypatch, dataset, sh):
    """For every audio guidance of the default sweep, animation_test calls
    gen then eval with exactly the flags of the dataset's shell recipe."""
    calls = []
    monkeypatch.setattr(animation_gen, "main",
                        lambda argv: calls.append(
                            ("scripts/animation_gen.py", argv)))
    monkeypatch.setattr(animation_eval, "main",
                        lambda argv: calls.append(
                            ("scripts/animation_eval.py", argv)))
    animation_test.main(["--dataset", dataset, "exps/run", "37000"])
    want = [c for ag in ("1.0", "4.0", "8.0")
            for c in _sh_argvs(sh, "exps/run", "37000", ag)]
    assert len(want) == 6
    assert calls == want
