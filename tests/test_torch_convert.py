"""The second source key spaces and the TorchScript helpers of
asva_tpu_torch/convert.py against asva_tpu's converter on the CPU.

The synthetic state dicts of tests/test_convert_real_layouts.py (the raw
imagebind_huge.pth names and layouts) go through asva_tpu's
`convert_state_dict` with its key maps and through the port's
`load_source_state`; the two towers then agree in fp32 within 1e-5.  The
variants the key maps accept as later candidates are covered too: the audio
stem as `audio_stem`, the vision stem conv at `proj.0`, the text tower's
final LayerNorm after the trunk, other modalities in the file, and the
shape adaptations of `_adapt` (a Linear stored as a 1x1 conv, an (n,)
vector stored as (1, n)).  For I3D and InceptionV3, whose full-size JAX
forward is too slow here, every flax leaf's key-map candidates are checked
to hold the file key that the port loads into the same parameter."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asva_tpu.convert import convert_state_dict
from asva_tpu.convert.torch_to_jax import (i3d_key_map,
                                           imagebind_audio_key_map,
                                           imagebind_text_key_map,
                                           imagebind_vision_key_map,
                                           inception_v3_key_map)
from asva_tpu.convert.torchscript import extract_state_and_eps as jextract
from asva_tpu.models import evalnets as jev
from asva_tpu.models import imagebind_audio as ja
from asva_tpu.models import imagebind_extra as je
from asva_tpu_torch import convert, runtime
from asva_tpu_torch.models import evalnets as tev
from asva_tpu_torch.models import imagebind_audio as ta
from asva_tpu_torch.models import imagebind_extra as te
from test_convert_real_layouts import (make_imagebind_audio_state,
                                       make_imagebind_text_state,
                                       make_imagebind_vision_state)
from test_torch_ops import close

torch.set_num_threads(1)
TOL = 1e-5
AUDIO = dict(embed_dim=64, out_embed_dim=32, num_blocks=2, num_heads=4)


def _torch(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


_FRESH = {}


def _jax_params(module, sd, key_map, *init_args):
    """asva_tpu's converter on `sd`, into a tree of the module's shapes
    (made once per configuration)."""
    key = repr(module)
    if key not in _FRESH:    # shapes only: every leaf is converted
        _FRESH[key] = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                                     *init_args)
    return convert_state_dict(_FRESH[key], sd, key_map)


@pytest.fixture(scope="module")
def audio_state():
    return make_imagebind_audio_state(ja.ImageBindAudioConfig(**AUDIO),
                                      np.random.default_rng(5))


def _other_modalities(sd, rng):
    """The file holds every modality: a vision and a thermal key, which the
    audio tower must drop."""
    sd = dict(sd)
    sd["modality_trunks.vision.blocks.0.norm_1.weight"] = np.ones(8,
                                                                  np.float32)
    sd["modality_preprocessors.thermal.cls_token"] = rng.standard_normal(
        (1, 1, 8)).astype(np.float32)
    return sd


@pytest.mark.parametrize("variant", ["rgbt_stem", "audio_stem", "adapt"])
def test_imagebind_audio_raw_huge(audio_state, rng, variant):
    """The eval audio tower from the raw file: cls embeddings and tokens."""
    sd = _other_modalities(audio_state, rng)
    if variant == "audio_stem":
        sd = {k.replace(".rgbt_stem.", ".audio_stem."): v
              for k, v in sd.items()}
    if variant == "adapt":   # head Linear as a 1x1 conv, a LN scale (1, n)
        key = "modality_heads.audio.2.weight"
        sd[key] = sd[key][:, :, None, None]
        key = "modality_preprocessors.audio.rgbt_stem.norm_layer.weight"
        sd[key] = sd[key][None]
    mel = rng.standard_normal((2, 128, 204, 1)).astype(np.float32)
    jm = ja.ImageBindAudioEncoder(ja.ImageBindAudioConfig(**AUDIO))
    params, report = _jax_params(jm, sd, imagebind_audio_key_map, mel)
    assert not report["fresh"]
    jcls, jtok = jm.apply(params, mel)
    tm = ta.ImageBindAudioEncoder(ta.ImageBindAudioConfig(**AUDIO))
    convert.load_source_state(tm, _torch(sd), "imagebind_audio")
    with torch.no_grad():
        tcls, ttok = tm.eval().encode(torch.from_numpy(mel))
    close(tcls, jcls, TOL)
    close(ttok, jtok, TOL)


def test_segment_audio_tower_from_raw_huge(audio_state, rng, tmp_path):
    """build_audio_encoder(weights_dir=<imagebind_huge.pth>): every tensor
    of the file's audio modality lands where the alias table puts it (the
    tower above holds those names against asva_tpu), and the final
    LayerNorm, absent from the file, keeps its init as in asva_tpu (the
    reference initialises it fresh)."""
    path = str(tmp_path / "imagebind_huge.pth")
    torch.save(_torch(_other_modalities(audio_state, rng)), path)
    tm = runtime.build_audio_encoder(4, ta.ImageBindAudioConfig(**AUDIO),
                                     device="cpu", dtype=torch.float32,
                                     weights_dir=path)
    own = tm.state_dict()
    renamed, may_miss = convert.to_port_keys(_torch(audio_state),
                                             "imagebind_audio")
    assert may_miss == ("final_layer_norm.",)
    assert set(own) - set(renamed) == {"final_layer_norm.weight",
                                       "final_layer_norm.bias"}
    for k, v in renamed.items():
        assert torch.equal(own[k], v), k
    assert torch.equal(own["final_layer_norm.weight"], torch.ones(64))
    assert not own["final_layer_norm.bias"].any()


@pytest.mark.parametrize("stem", ["proj.1", "proj.0"])
def test_imagebind_vision_raw_huge(rng, stem):
    cfg = dict(embed_dim=64, out_embed_dim=32, num_blocks=2, num_heads=4,
               image_size=28, patch_size=14)
    sd = make_imagebind_vision_state(je.ImageBindVisionConfig(**cfg), rng)
    if stem == "proj.0":
        sd = {k.replace("rgbt_stem.proj.1.", "rgbt_stem.proj.0."): v
              for k, v in sd.items()}
    sd["modality_postprocessors.vision.1.log_logit_scale"] = np.float32(1)
    imgs = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    jm = je.ImageBindVisionEncoder(je.ImageBindVisionConfig(**cfg))
    params, report = _jax_params(jm, sd, imagebind_vision_key_map, imgs)
    assert not report["fresh"]
    tm = te.ImageBindVisionEncoder(te.ImageBindVisionConfig(**cfg))
    convert.load_source_state(tm, _torch(sd), "imagebind_vision")
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(imgs))
    close(got, jm.apply(params, imgs), TOL)


@pytest.mark.parametrize("final_ln", ["head", "trunk"])
def test_imagebind_text_raw_huge(rng, final_ln):
    cfg = dict(vocab_size=64, embed_dim=32, out_embed_dim=16, num_blocks=2,
               num_heads=2, context_length=12)
    sd = make_imagebind_text_state(je.ImageBindTextConfig(**cfg), rng)
    if final_ln == "trunk":
        sd = {k.replace("modality_heads.text.proj.0.",
                        "modality_trunks.text.post_transformer_layer.0."): v
              for k, v in sd.items()}
    ids = np.zeros((2, 12), np.int32)
    ids[0, :5] = [1, 9, 17, 3, 63]
    ids[1, :3] = [1, 20, 63]
    jm = je.ImageBindTextEncoder(je.ImageBindTextConfig(**cfg))
    params, report = _jax_params(jm, sd, imagebind_text_key_map,
                                 jnp.asarray(ids))
    assert not report["fresh"]
    tm = te.ImageBindTextEncoder(te.ImageBindTextConfig(**cfg))
    convert.load_source_state(tm, _torch(sd), "imagebind_text")
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(ids).long())
    close(got, jm.apply(params, jnp.asarray(ids)), TOL)


def test_load_source_state_is_strict(audio_state):
    """A missing trunk tensor or a stray key raises; the eval tower (no
    final LayerNorm to keep fresh) loads the raw file whole."""
    tm = ta.ImageBindAudioEncoder(ta.ImageBindAudioConfig(**AUDIO))
    sd = _torch(audio_state)
    del sd["modality_trunks.audio.blocks.1.mlp.fc1.bias"]
    with pytest.raises(KeyError, match="fc1.bias"):
        convert.load_source_state(tm, sd, "imagebind_audio")
    sd = _torch(audio_state)
    sd["modality_heads.audio.3.weight"] = torch.zeros(3)
    with pytest.raises(KeyError, match="head.3.weight"):
        convert.load_source_state(tm, sd, "imagebind_audio")


@functools.lru_cache(maxsize=None)
def _flax_paths(module, *init_args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *init_args)
    return [tuple(str(getattr(k, "key", k)) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(shapes)[0]]


# the two alternative namings asva_tpu's i3d_key_map lists after
# pytorch-i3d's (torch_to_jax.py:299): the BatchNorm as `batch3d`, or the
# branches as `b1.0`, `b1.1`, `b2.0`, `b2.1`, `b3.1`
I3D_SCHEMES = {"batch3d": convert._I3D_ALIASES[:1],
               "branches": convert._I3D_ALIASES[1:]}


def _rename(key, scheme):
    for new, old in I3D_SCHEMES[scheme]:   # the port's names -> the file's
        key = key.replace(old, new)
    return key


I3D_INPUT = jax.ShapeDtypeStruct((1, 8, 32, 32, 3), jnp.float32)


def _filled(module):
    """`module` with every tensor drawn from a seed (no init pass)."""
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for v in module.state_dict().values():
            if v.is_floating_point():
                v.copy_(torch.randn(v.shape, generator=gen))
            else:
                v.zero_()
    return module


@pytest.fixture(scope="module")
def i3d_net():
    with torch.device("meta"):
        net = tev.InceptionI3D()
    return _filled(net.to_empty(device="cpu"))


@pytest.mark.parametrize("scheme", sorted(I3D_SCHEMES))
def test_i3d_second_key_space(i3d_net, scheme):
    """A file in either alternative naming loads into the parameters that
    carry pytorch-i3d's names, bit for bit, and asva_tpu's key map lists
    that file key for the same leaf."""
    src = i3d_net
    file_state = {_rename(k, scheme): v.clone()
                  for k, v in src.state_dict().items()
                  if not k.endswith("num_batches_tracked")}
    assert all(any(new in k for k in file_state)
               for new, _ in I3D_SCHEMES[scheme])
    dst = tev.InceptionI3D()
    convert.load_source_state(dst, file_state, "i3d")
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    own = set(src.state_dict())
    for path in _flax_paths(jev.InceptionI3D(), I3D_INPUT):
        cands = i3d_key_map(path)
        assert cands[0] in own, cands[0]
        assert _rename(cands[0], scheme) in cands, cands


def test_inception_v3_second_key_space(rng):
    """pytorch-fid's file carries the 1008-way classifier (and torchvision's
    the auxiliary head): the port drops them, as asva_tpu's converter leaves
    them unused, and loads the rest strictly."""
    with torch.device("meta"):
        src = tev.InceptionV3FID()
    src = _filled(src.to_empty(device="cpu"))
    file_state = {k: v.clone() for k, v in src.state_dict().items()
                  if not k.endswith("num_batches_tracked")}
    file_state["fc.weight"] = torch.zeros(1008, 2048)
    file_state["fc.bias"] = torch.zeros(1008)
    file_state["AuxLogits.fc.weight"] = torch.zeros(1000, 768)
    dst = tev.InceptionV3FID()
    convert.load_source_state(dst, file_state, "inception_v3")
    for k, v in src.state_dict().items():
        assert torch.equal(dst.state_dict()[k], v), k
    mapped = {inception_v3_key_map(p) for p in _flax_paths(
        jev.InceptionV3FID(),
        jax.ShapeDtypeStruct((1, 75, 75, 3), jnp.float32))}
    own = {k for k in src.state_dict()
           if not k.endswith("num_batches_tracked")}
    assert mapped == own


def test_adapt_shapes_and_square_linear(rng):
    """load_exported: a Linear weight stored as a 1x1 conv and an (n,)
    vector stored as (1, n) are squeezed; a square Linear is taken as it
    is (torch layout on both sides), never transposed."""
    m = torch.nn.Sequential(torch.nn.Linear(6, 6), torch.nn.LayerNorm(6),
                            torch.nn.Linear(6, 4))
    w0 = torch.from_numpy(rng.standard_normal((6, 6)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((4, 6)).astype(np.float32))
    convert.load_exported(m, {"0.weight": w0, "0.bias": torch.zeros(1, 6),
                              "1.weight": torch.ones(1, 6),
                              "1.bias": torch.zeros(6),
                              "2.weight": w2[:, :, None, None],
                              "2.bias": torch.zeros(4)})
    assert torch.equal(m[0].weight, w0) and torch.equal(m[2].weight, w2)
    assert m[0].bias.shape == (6,) and m[1].weight.shape == (6,)


class _Tiny(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = torch.nn.Conv3d(3, 4, 1)
        self.bn = torch.nn.BatchNorm3d(4, eps=1e-3)

    def forward(self, x):
        return self.bn(self.conv(x))


@pytest.mark.parametrize("how", ["script", "trace"])
def test_extract_state_and_eps(tmp_path, how):
    """A scripted module (eps on the BatchNorm) and a traced one (eps a
    graph constant): the same state dict and eps as asva_tpu's helper."""
    m = _Tiny().eval()
    blob = (torch.jit.script(m) if how == "script"
            else torch.jit.trace(m, torch.zeros(1, 3, 2, 4, 4)))
    path = str(tmp_path / "i3d_torchscript.pt")
    blob.save(path)
    state, eps = convert.extract_state_and_eps(path)
    jstate, jeps = jextract(path)
    assert eps == jeps == 1e-3
    assert sorted(state) == sorted(jstate)
    for k in state:
        assert state[k].dtype == torch.float32
        assert torch.equal(state[k], jstate[k])
