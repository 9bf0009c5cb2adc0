"""Parity of the port's text side against asva_tpu on the CPU, fp32: the
CLIP text encoder, the BPE tokenizer, and the ImageBind vision and text
towers (tiny configs), weights carried across with a strict load."""
import gzip
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asva_tpu.convert.torch_to_jax import (clip_text_key_map,
                                           imagebind_text_key_map,
                                           imagebind_vision_key_map)
from asva_tpu.models import clip_bpe as jb
from asva_tpu.models import clip_text as jt
from asva_tpu.models import imagebind_extra as je
from asva_tpu_torch.models import clip_bpe as tb
from asva_tpu_torch.models import clip_text as tt
from asva_tpu_torch.models import imagebind_extra as te
from asva_tpu_torch.runtime import build_text_encoder

from test_torch_ops import close, port, randomize, t

torch.set_num_threads(1)


# ------------------------------------------------------------ CLIP text ---

@pytest.fixture(scope="module")
def clip_pair():
    rng = np.random.default_rng(31)
    jm = jt.CLIPTextModel(jt.CLIPTextConfig.tiny())
    p = randomize(jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 16), jnp.int32)))(), rng)
    return jm, p, port(tt.CLIPTextModel(tt.CLIPTextConfig.tiny()), p,
                       clip_text_key_map)


@pytest.mark.parametrize("n", [16, 9])
def test_clip_text_model(clip_pair, rng, n):
    """last_hidden_state with the causal mask and quick-gelu, also for fewer
    tokens than positions; 2e-5."""
    jm, p, tm = clip_pair
    ids = rng.integers(0, 100, (3, n)).astype(np.int32)
    with torch.no_grad():
        got = tm(t(ids))
    assert got.shape == (3, n, 32)
    close(got, jm.apply(p, jnp.asarray(ids)), 2e-5)


def test_clip_text_is_causal(clip_pair, rng):
    """Position i does not see tokens after i."""
    _, _, tm = clip_pair
    ids = rng.integers(0, 100, (1, 16))
    other = ids.copy()
    other[:, 10:] = rng.integers(0, 100, (1, 6))
    with torch.no_grad():
        a, b = tm(t(ids)), tm(t(other))
    assert torch.equal(a[:, :10], b[:, :10]) and not torch.equal(a, b)


def test_quick_gelu(rng):
    x = rng.standard_normal((5, 7)).astype(np.float32) * 3
    close(tt.quick_gelu(t(x)), jt.quick_gelu(jnp.asarray(x)), 1e-6)


def test_build_text_encoder_and_weights_dir(tmp_path, clip_pair, rng):
    """Random init in eval mode, frozen, in the asked dtype; an HF-layout
    directory (with its position_ids buffer) loads strictly."""
    _, _, tm = clip_pair
    cfg = tt.CLIPTextConfig.tiny()
    model = build_text_encoder(cfg, device="cpu", dtype=torch.float32)
    assert not model.training
    assert all(not p.requires_grad for p in model.parameters())
    ids = t(rng.integers(0, 100, (2, 16)))
    assert torch.isfinite(model(ids)).all()
    state = dict(tm.state_dict())
    state["text_model.embeddings.position_ids"] = torch.arange(16)[None]
    torch.save(state, tmp_path / "pytorch_model.bin")
    loaded = build_text_encoder(cfg, device="cpu", dtype=torch.float32,
                                weights_dir=str(tmp_path))
    with torch.no_grad():
        close(loaded(ids), tm(ids).numpy(), 0)
    state.pop("text_model.final_layer_norm.bias")
    torch.save(state, tmp_path / "pytorch_model.bin")
    with pytest.raises(RuntimeError, match="Missing key"):
        build_text_encoder(cfg, device="cpu", weights_dir=str(tmp_path))


@pytest.mark.slow
def test_full_size_clip_text_model(rng):
    """The SD1.5 width and depth (12 layers, 768 wide, 77 positions) with
    end-of-text padded ids; 1e-4 on O(1) outputs after the final
    LayerNorm."""
    jm = jt.CLIPTextModel()
    ids = np.full((2, 77), 49407, np.int32)
    ids[:, 0] = 49406
    ids[:, 1:9] = rng.integers(256, 49000, (2, 8))
    p = randomize(jax.jit(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 77), jnp.int32)))(), rng)
    tm = port(tt.CLIPTextModel(), p, clip_text_key_map)
    with torch.no_grad():
        got = tm(t(ids))
    assert got.shape == (2, 77, 768)
    close(got, jm.apply(p, jnp.asarray(ids)), 1e-4)


# ------------------------------------------------------------ tokenizer ---

MERGES = [("h", "e"), ("l", "l"), ("he", "ll"), ("hell", "o</w>"),
          ("w", "o"), ("r", "l"), ("wo", "rl"), ("worl", "d</w>"),
          ("d", "o"), ("do", "g</w>"), ("1", "2")]
TEXTS = ["hello world", "Dog Barking", "hello, world!!",
         "a   dog  barking 123", "unmergedxyz", "it's a dog's world"]


@pytest.fixture(scope="module")
def tok_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("tok")
    vocab = list(jb._bytes_to_unicode().values())
    vocab += [v + "</w>" for v in vocab]
    vocab += ["".join(m) for m in MERGES]
    vocab += ["<|startoftext|>", "<|endoftext|>"]
    with open(d / "vocab.json", "w") as f:
        json.dump({tok: i for i, tok in enumerate(vocab)}, f)
    with open(d / "merges.txt", "w") as f:
        f.write("#version: 0.2\n" + "\n".join(" ".join(m) for m in MERGES))
    return d


@pytest.mark.parametrize("pad", ["zero", "eot"])
def test_bpe_tokenizer_matches_jax_package(tok_dir, pad):
    """The port's own copy of the tokenizer gives the JAX package's ids."""
    ours = tb.ClipBPETokenizer.from_pretrained(str(tok_dir))
    theirs = jb.ClipBPETokenizer.from_pretrained(str(tok_dir))
    np.testing.assert_array_equal(ours(TEXTS, 20, pad), theirs(TEXTS, 20, pad))
    assert tb._bytes_to_unicode() == jb._bytes_to_unicode()


def test_tokenize_pads_with_end_of_text(tok_dir):
    ids = tt.tokenize(TEXTS, 12, str(tok_dir))
    want = np.asarray(jt.tokenize(TEXTS, 12, str(tok_dir)))
    assert ids.dtype == torch.int64 and ids.shape == (len(TEXTS), 12)
    np.testing.assert_array_equal(ids.numpy(), want)
    eot = int(ids.max())
    assert (ids[0, 3:] == eot).all()


def test_bpe_gz_constructor(tmp_path):
    """The ImageBind .txt.gz constructor keeps its 48894-merge window."""
    with gzip.open(tmp_path / "bpe_simple_vocab_16e6.txt.gz", "wt") as f:
        f.write("header\n" + "\n".join(" ".join(m) for m in MERGES))
    a = tb.ClipBPETokenizer.from_pretrained(str(tmp_path))
    b = jb.ClipBPETokenizer.from_pretrained(str(tmp_path))
    np.testing.assert_array_equal(a(TEXTS[:3], 16), b(TEXTS[:3], 16))


# ------------------------------------------------------ ImageBind towers ---

@pytest.mark.parametrize("normalize", [True, False])
def test_imagebind_vision_encoder(rng, normalize):
    """Tiny ViT: the (2, 14, 14) stem on the duplicated frame, CLS, the
    pre-trunk LayerNorm, unit-norm head; 2e-5."""
    jm = je.ImageBindVisionEncoder(je.ImageBindVisionConfig.tiny())
    img = rng.standard_normal((2, 28, 28, 3)).astype(np.float32)
    p = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), img), rng)
    tm = port(te.ImageBindVisionEncoder(te.ImageBindVisionConfig.tiny()), p,
              imagebind_vision_key_map)
    with torch.no_grad():
        got = tm(t(img), normalize)
    assert got.shape == (2, 16)
    close(got, jax.jit(jm.apply, static_argnums=2)(p, img, normalize), 2e-5)
    if normalize:
        close(got.norm(dim=-1), np.ones(2), 1e-5)


@pytest.mark.parametrize("normalize", [True, False])
def test_imagebind_text_encoder(rng, normalize):
    """Tiny text tower: the masked trunk (causal) and the pooling at the
    end-of-text token, the argmax of the ids, at a different position per
    row; 2e-5."""
    jm = je.ImageBindTextEncoder(je.ImageBindTextConfig.tiny())
    ids = rng.integers(1, 60, (3, 12)).astype(np.int32)
    for row, eos in enumerate((4, 11, 7)):
        ids[row, eos] = 63
        ids[row, eos + 1:] = 0
    p = randomize(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(ids)),
                  rng)
    tm = port(te.ImageBindTextEncoder(te.ImageBindTextConfig.tiny()), p,
              imagebind_text_key_map)
    with torch.no_grad():
        got = tm(t(ids), normalize)
        padded = ids.copy()
        padded[0, 5:] = 9          # after end-of-text: invisible
        again = tm(t(padded), normalize)
    assert got.shape == (3, 16)
    close(got, jax.jit(jm.apply, static_argnums=2)(p, jnp.asarray(ids),
                                                   normalize), 2e-5)
    close(again[0], got[0].numpy(), 1e-6)
