"""The sampler loop's CUDA-graph segments (asva_tpu_torch/models/unet3d/
graphs.py) and what makes the UNet call capturable.

On the CPU: the sinusoidal embedding and the audio token gather are bit-equal
to their host-copy forms now that their constants live on the device; the
fused wrappers' `out=`; each condition that keeps a loop eager; the
boundaries a capture records (entry, order, argument shapes) against the
fused calls of an eager forward.  On a card (marked `cuda`, skipped here): a
graphed PLMS-5 request's frames `torch.equal` to the eager request's, a test
double over `fused.fused_ln_attn3` sees every block's call on every replayed
call, and the memory allocated after a request returns to its value before.

Imports no JAX: on the card `python -m pytest --noconftest -q
tests/test_torch_graphs.py`."""
import types

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from asva_tpu_torch import observability as obs
from asva_tpu_torch.models import embeddings
from asva_tpu_torch.models.unet3d import AudioUNet3D, UNet3DConfig, graphs
from asva_tpu_torch.models.unet3d.primitives import (CrossAttention,
                                                     token_indices_on)
from asva_tpu_torch.models.unet3d.transformer import (
    SpatioAudioTempTransformerBlock)
from asva_tpu_torch.ops import fused
from asva_tpu_torch.ops.norms import LayerNormParams

FRAMES = 4


def _host_fold_embedding(timesteps, dim, flip_sin_to_cos=True,
                         downscale_freq_shift=0.0, max_period=10000.0):
    """The embedding as it was: its frequencies copied from the host on
    every call."""
    half_dim = dim // 2
    freqs = np.exp(-np.log(max_period) * np.arange(half_dim, dtype=np.float64)
                   / (half_dim - downscale_freq_shift)).astype(np.float32)
    emb = (torch.from_numpy(freqs).to(timesteps.device)[None, :]
           * timesteps.float()[:, None])
    sin, cos = torch.sin(emb), torch.cos(emb)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


@pytest.mark.parametrize("dim,flip,shift", [(320, True, 0.0), (64, False, 1.0),
                                            (33, True, 0.0)])
def test_sinusoidal_embedding_bit_equal_to_the_host_copy(dim, flip, shift):
    t = torch.tensor([0.0, 1.0, 7.0, 981.0, 999.0])
    got = embeddings.sinusoidal_timestep_embedding(t, dim, flip, shift)
    assert torch.equal(got, _host_fold_embedding(t, dim, flip, shift))
    first = embeddings._frequencies(dim // 2, shift, 10000.0, t.device)
    assert embeddings._frequencies(dim // 2, shift, 10000.0,
                                   t.device) is first    # made once


def test_audio_gather_bit_equal_with_device_indices():
    torch.manual_seed(0)
    attn = CrossAttention(32, 2, 16, 24)
    ln = LayerNormParams(32)
    context = torch.randn(2, 30, 24)
    idx = np.stack([np.arange(f * 5, f * 5 + 7) for f in range(FRAMES)])
    # the gather as it was: the indices copied to the device on every call
    k, v = attn.to_k(context), attn.to_v(context)
    host = torch.as_tensor(idx, dtype=torch.long)
    want = (k[:, host], v[:, host])
    on_device = token_indices_on(idx.astype(np.int32), context.device)
    assert on_device.dtype == torch.long and torch.equal(on_device, host)
    assert token_indices_on(idx, context.device) is on_device   # cached
    assert token_indices_on(on_device, context.device) is on_device
    for given in (idx, idx.tolist(), on_device):
        got = attn.prepare(context, ln, given)[-2:]
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    x = torch.randn(2, FRAMES, 6, 32)
    plain = attn(x, context, context_indices=idx)
    assert torch.equal(attn(x, context, context_indices=on_device), plain)


@pytest.mark.parametrize("entry", ["fused_ln_attn", "fused_ln_attn3",
                                   "fused_ln_geglu"])
def test_fused_wrappers_write_out(entry):
    torch.manual_seed(1)
    c, heads = 16, 2
    x = torch.randn(2, FRAMES, 3, c)

    def sub():
        return [torch.rand(c) + 0.5, torch.randn(c) * 0.1,
                torch.randn(c, c) * 0.2, torch.randn(c, c) * 0.2,
                torch.randn(c) * 0.1]
    if entry == "fused_ln_geglu":
        x = x.reshape(-1, c)
        args = (x, torch.rand(c) + 0.5, torch.randn(c) * 0.1,
                torch.randn(8 * c, c) * 0.2, torch.randn(8 * c) * 0.1,
                torch.randn(c, 4 * c) * 0.2, torch.randn(c) * 0.1, 1e-5)
    elif entry == "fused_ln_attn":
        x = x.reshape(2, -1, c)
        args = (x, *sub(), torch.randn(2, 5, c), torch.randn(2, 5, c), 1e-5,
                heads)
    else:
        args = (x, *sub(), torch.randn(2, 5, c), torch.randn(2, 5, c),
                *sub(), torch.randn(2, FRAMES, 3, c),
                torch.randn(2, FRAMES, 3, c), *sub(), torch.randn(2, 7, c),
                torch.randn(2, 7, c), (1e-5,) * 3, heads)
    fn = getattr(fused, entry)
    with torch.no_grad():
        want = fn(*args)
        out = torch.empty_like(x)
        assert fn(*args, out=out) is out and torch.equal(out, want)
    with pytest.raises(ValueError, match="out= takes no input"):
        fn(x.clone().requires_grad_(), *args[1:], out=torch.empty_like(x))
    with pytest.raises(ValueError, match="out: shape"):
        with torch.no_grad():
            fn(*args, out=torch.empty(x.shape[:-1] + (c + 1,)))


@pytest.mark.parametrize("case", ["cpu", "grad", "frames", "one_call"])
def test_fallback_conditions_run_eagerly(case):
    """Each condition alone keeps the call eager and counts it; where all
    hold (a card's tensor, stood in for here) the loop is graphed."""
    cuda_like = types.SimpleNamespace(device=torch.device("cuda"))
    with torch.no_grad():
        assert graphs.graphable(2, cuda_like)
    calls, frames = 5, None
    sample = cuda_like
    if case == "cpu":
        sample = torch.zeros(1)
    elif case == "frames":
        frames = object()
    elif case == "one_call":
        calls = 1
    seen = []

    def forward(*args):
        seen.append(args)
        return len(seen)
    loop = graphs.LoopGraphs(calls)
    with obs.tracing() as rec, torch.set_grad_enabled(case == "grad"):
        assert not graphs.graphable(calls, sample, frames)
        got = [loop(forward, sample, 0, None, None, None, None, True, frames)
               for _ in range(3)]
    assert got == [1, 2, 3] and all(a[0] is sample for a in seen)
    assert loop.graphs is None and loop.made == 0
    assert [c[:2] for c in rec.counts] == [("unet.graph.eager_calls", 1)] * 3


def _tiny_unet():
    torch.manual_seed(0)
    return AudioUNet3D(UNet3DConfig.tiny(audio_cross_attention_dim=32)).eval()


def _inputs(rows=1):
    gen = torch.Generator().manual_seed(3)
    return (torch.randn(rows, FRAMES, 4, 4, 4, generator=gen),
            torch.full((rows,), 500, dtype=torch.long),
            torch.randn(rows, 77, 768, generator=gen),
            torch.randn(rows, 20, 32, generator=gen))


def test_capture_boundaries_match_the_eager_fused_calls():
    """`graphs.boundaries` records what a capture would cut at: the fused
    calls of an eager forward, in order, with the same arguments' shapes
    and outputs shaped like them; one boundary a fused call, two a
    transformer block (B2, B3).  The eager forward is a CPU call inside
    `segmented`, which runs it as it is and counts it."""
    unet = _tiny_unet()
    sample, t, text, audio = _inputs()
    idx = np.stack([np.arange(f * 5, f * 5 + 5) for f in range(FRAMES)])
    with torch.no_grad():
        want = unet._forward(sample, t, text, audio, None,
                             token_indices_on(idx, "cpu"), True, None)

    def shapes(args):
        return [tuple(a.shape) if torch.is_tensor(a) else a for a in args]
    eager = []
    saved = {n: getattr(fused, n) for n in graphs.ENTRIES}

    def spy(name):
        def call(*args, **kw):
            out = saved[name](*args, **kw)
            eager.append((name, shapes(args), sorted(kw), tuple(out.shape)))
            return out
        return call
    with torch.no_grad():
        for n in graphs.ENTRIES:
            setattr(fused, n, spy(n))
        try:
            with obs.tracing() as rec, graphs.segmented(unet, 3):
                assert unet._graphs is not None
                got = unet(sample, t, text, audio, audio_token_indices=idx,
                           fuse_blocks=True)
        finally:
            for n, fn in saved.items():
                setattr(fused, n, fn)
        assert unet._graphs is None and torch.equal(got, want)
        assert [c[:2] for c in rec.counts] == [("unet.graph.eager_calls", 1)]
        ticks = []
        with graphs.boundaries(lambda: ticks.append(len(ticks))) as got:
            out = unet(sample, t, text, audio, audio_token_indices=idx,
                       fuse_blocks=True)
    assert all(getattr(fused, n) is fn for n, fn in saved.items())
    assert out.shape == sample.shape
    blocks = [m for m in unet.modules()
              if isinstance(m, SpatioAudioTempTransformerBlock)]
    assert len(got) == len(eager) == len(ticks) == 2 * len(blocks) > 0
    assert [e[0] for e in eager] == ["fused_ln_attn3", "fused_ln_geglu"] * \
        len(blocks)
    for (name, args, kw, o), want in zip(got, eager):
        assert (name, shapes(args), sorted(kw), tuple(o.shape)) == want


def test_call_into_passes_out_or_copies(monkeypatch):
    x = torch.arange(6.0).reshape(2, 3)
    out = torch.empty_like(x)
    monkeypatch.setattr(fused, "fused_ln_geglu", lambda a: a * 2)   # no out=
    graphs._call_into("fused_ln_geglu", (x,), {}, out)
    assert torch.equal(out, x * 2)
    seen = []

    def takes_out(a, out=None):
        seen.append(out)
        return out.copy_(a + 1)
    monkeypatch.setattr(fused, "fused_ln_geglu", takes_out)
    graphs._call_into("fused_ln_geglu", (x,), {}, out)
    assert seen == [out] and torch.equal(out, x + 1)


# ------------------------------------------------------------ on a card ---

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the H100)")
    return torch.device("cuda")


def _card_pipeline(device):
    """The tiny UNet at widths 64 / 128 (K-gemm's smallest in bf16), the
    tiny VAE and audio tower, seeded on the CPU, in bf16 on the card."""
    from asva_tpu_torch import runtime
    from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig
    from asva_tpu_torch.models.vae import VAEConfig
    from asva_tpu_torch.pipelines.animation import AnimationPipeline
    dtype = torch.bfloat16
    ucfg = UNet3DConfig.tiny(block_out_channels=(64, 128),
                             audio_cross_attention_dim=32)
    null = torch.randn((1, 77, 768), generator=torch.Generator().manual_seed(
        9))
    return AnimationPipeline(
        runtime.build_unet(ucfg, "cpu", dtype, 0,
                           randomize_all=True).to(device),
        runtime.build_vae(VAEConfig.tiny(), "cpu", dtype, 1,
                          randomize_all=True).to(device),
        runtime.build_audio_encoder(FRAMES, ImageBindAudioConfig.tiny(),
                                    "cpu", dtype, 2,
                                    randomize_all=True).to(device),
        null_text_encoding=null.to(device))


def _request(pipe, device, steps=5, **kw):
    gen = torch.Generator().manual_seed(5)
    cfg = pipe.audio_encoder.config
    images = torch.rand((2, 16, 16, 3), generator=gen)
    mels = torch.randn((2, cfg.mel_bins, cfg.mel_frames, 1), generator=gen)
    text = torch.randn((2, 77, 768), generator=gen)
    hh = 16 // pipe.vae.downscale
    noise = (torch.randn((1, hh, hh, 4), generator=gen),
             torch.randn((1, FRAMES - 1, hh, hh, 4), generator=gen))
    return pipe(images.to(device), mels.to(device), text.to(device),
                video_length=FRAMES, num_inference_steps=steps,
                sampler="plms", audio_guidance_scale=4.0,
                vae_noise=noise[0].to(device),
                latent_noise=noise[1].to(device), **kw)


def _calls(unet):
    n = [0]
    unet.register_forward_pre_hook(lambda *_: n.__setitem__(0, n[0] + 1))
    return n


@pytest.mark.cuda
def test_graphed_request_equals_the_eager_one(dev, monkeypatch):
    pipe = _card_pipeline(dev)
    calls = _calls(pipe.unet)
    with obs.tracing() as rec:
        graphed = _request(pipe, dev)
    n = calls[0]
    counts = {}
    for name, k, _ in rec.counts:
        counts[name] = counts.get(name, 0) + k
    blocks = sum(isinstance(m, SpatioAudioTempTransformerBlock)
                 for m in pipe.unet.modules())
    assert n >= 6 and counts["unet.graph.captures"] == 1
    assert counts["unet.graph.eager_calls"] == 1
    assert counts["unet.graph.replays"] == (2 * blocks + 1) * (n - 1)
    assert counts["unet.graph.held_bytes"] > 0
    monkeypatch.setattr(graphs, "graphable", lambda *a, **k: False)
    eager = _request(pipe, dev)
    assert torch.equal(graphed, eager)


@pytest.mark.cuda
def test_a_double_over_the_fused_entry_sees_every_replayed_call(
        dev, monkeypatch):
    pipe = _card_pipeline(dev)
    real = fused.fused_ln_attn3
    seen = []

    def double(*args, **kw):
        seen.append((tuple(args[0].shape), "out" in kw))
        return real(*args, **kw)
    monkeypatch.setattr(fused, "fused_ln_attn3", double)
    calls = _calls(pipe.unet)
    _request(pipe, dev, decode=False)
    blocks = sum(isinstance(m, SpatioAudioTempTransformerBlock)
                 and m.use_audio for m in pipe.unet.modules())
    assert len(seen) == blocks * calls[0]
    # the first call eager, every later one replayed with out=
    assert [o for _, o in seen] == [False] * blocks + [True] * (
        blocks * (calls[0] - 1))
    assert seen[:blocks] * calls[0] == [(s, False) for s, _ in seen]


@pytest.mark.cuda
def test_memory_after_a_request_returns_to_before(dev):
    pipe = _card_pipeline(dev)
    _request(pipe, dev, decode=False)               # caches, workspaces
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(dev)
    out = _request(pipe, dev, decode=False)
    del out
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == before
