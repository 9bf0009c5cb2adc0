"""Weight loading of the port's runtime against asva_tpu's, on the CPU at
tiny configs: checkpoints the port saves load back into a pipeline, weights
paths (missing, a file, orbax), the 2D SD1.5 graft, the null text encoding
and the shutdown agreement across ranks.  The reference-layout directories
of the UNet, VAE and audio tower are held against asva_tpu's loader in
test_torch_unet.py and test_torch_vae_audio.py, beside their JAX
fixtures."""
import dataclasses
import os
import signal
import threading
import time
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.distributed as dist

from asva_tpu import runtime as jrt
from asva_tpu_torch import runtime
from asva_tpu_torch.diffusion.schedules import DiffusionSchedule
from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig as TAC
from asva_tpu_torch.models.unet3d import UNet3DConfig as TC
from asva_tpu_torch.models.vae import VAEConfig as TVC
from asva_tpu_torch.observability import GracefulShutdown
from asva_tpu_torch.pipelines.animation import AnimationPipeline
from asva_tpu_torch.training import optim
from asva_tpu_torch.training.animation_trainer import (AnimationTrainConfig,
                                                       AnimationTrainer,
                                                       TrainState)
from asva_tpu_torch.training.checkpoint import CheckpointManager

torch.set_num_threads(1)
F = 4                       # video length
UNET = TC.tiny(audio_cross_attention_dim=32)
CPU32 = dict(device="cpu", dtype=torch.float32)


def _save(state, path):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save(state, path)


def _equal_state(module, state):
    own = module.state_dict()
    assert set(own) == set(state)
    for k, v in state.items():
        assert torch.equal(own[k], v.reshape(own[k].shape).to(own[k].dtype)), k


# ------------------------------------------- C-6.1: the port's checkpoints ---

def test_pipeline_loads_a_trained_checkpoint_bit_for_bit(tmp_path):
    """Two steps of the tiny trainer, a CheckpointManager save of its
    modules, then load_animation_pipeline(mgr.modules_dir(step)): the UNet
    and the audio tower hold the trained values bit for bit and the
    pipeline's video equals the trained modules' video bit for bit."""
    acfg = TAC.tiny()
    unet = runtime.build_unet(UNET, **CPU32, seed=5, randomize_all=True,
                              train=True)
    optim.apply_trainable_mask(unet, optim.trainable_mask(unet))
    vae = runtime.build_vae(TVC.tiny(), **CPU32, seed=1)
    audio = runtime.build_audio_encoder(F, acfg, **CPU32, seed=7,
                                        randomize_all=True)
    null_text = torch.randn(1, 7, 768,
                            generator=torch.Generator().manual_seed(3))
    trainer = AnimationTrainer(unet=unet, vae=vae, audio_encoder=audio,
                               null_text_encoding=null_text,
                               config=AnimationTrainConfig())
    state = TrainState(0, unet, optim.build_optimizer(unet, 1e-3))
    gen = torch.Generator().manual_seed(0)
    batch = {"videos": torch.rand(2, F, 16, 16, 3, generator=gen),
             "mels": torch.randn(2, 128, 204, 1, generator=gen),
             "text_encodings": torch.randn(2, 7, 768, generator=gen)}
    before = [p.clone() for p in state.optimizer.params]
    for _ in range(2):
        trainer.train_step(state, batch, generator=gen)
    assert all(not torch.equal(a, b)
               for a, b in zip(before, state.optimizer.params))

    mgr = CheckpointManager(str(tmp_path), checkpointing_steps=1,
                            module_configs={
                                "unet": dataclasses.asdict(UNET),
                                "audio_encoder": dataclasses.asdict(acfg)})
    assert mgr.save(state.step, state.state_dict(),
                    modules={"unet": unet.state_dict(),
                             "audio_encoder": audio.state_dict()})
    pipe = runtime.load_animation_pipeline(
        mgr.modules_dir(2), n_segment=F, vae_config=TVC.tiny(),
        null_text_encoding=null_text, **CPU32)
    _equal_state(pipe.unet, unet.state_dict())
    _equal_state(pipe.audio_encoder, audio.state_dict())

    # inference mode, as the loader builds it: on the CPU a convolution
    # whose weight requires grad rounds differently (1e-7)
    trained = AnimationPipeline(unet=unet.eval().requires_grad_(False),
                                vae=vae,
                                audio_encoder=audio,
                                schedule=DiffusionSchedule(),
                                null_text_encoding=null_text)
    kw = dict(video_length=F, num_inference_steps=2, sampler="ddim")
    image, mel = torch.rand(1, 16, 16, 3), torch.randn(1, 128, 204, 1)
    with torch.no_grad():
        got = pipe(image, mel, batch["text_encodings"][:1],
                   generator=torch.Generator().manual_seed(9), **kw)
        want = trained(image, mel, batch["text_encodings"][:1],
                       generator=torch.Generator().manual_seed(9), **kw)
    assert torch.equal(got, want)


# ----------------------------------------- C-6.1: paths and the graft ---

def test_weights_paths_missing_file_and_orbax(tmp_path, caplog):
    """A path without weights keeps the seeded init with a warning; a file
    path loads as it is; an orbax directory raises with the way out."""
    seeded = runtime.build_audio_encoder(F, TAC.tiny(), **CPU32, seed=3)
    missing = runtime.build_audio_encoder(F, TAC.tiny(), **CPU32, seed=3,
                                          weights_dir=str(tmp_path / "none"))
    _equal_state(missing, seeded.state_dict())
    assert "no weights under" in caplog.text
    other = runtime.build_audio_encoder(F, TAC.tiny(), **CPU32, seed=4,
                                        randomize_all=True)
    path = str(tmp_path / "audio.bin")
    torch.save(other.state_dict(), path)
    _equal_state(runtime.build_audio_encoder(F, TAC.tiny(), **CPU32,
                                             weights_dir=path),
                 other.state_dict())
    orbax = tmp_path / "orbax_unet"
    orbax.mkdir()
    (orbax / "_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="export_state_dict"):
        runtime.build_unet(UNET, **CPU32, weights_dir=str(orbax))


def test_unet_graft_of_2d_weights(tmp_path):
    """A file without the _temp/_audio keys (2D SD1.5 weights): those keep
    the seeded init (zero where the reference zero-inits), the rest holds
    the file; another missing key or an unexpected one raises."""
    source = runtime.build_unet(UNET, **CPU32, seed=8, randomize_all=True)
    graft = runtime._graft_keys(source)
    assert graft and all("_temp" in k or "_audio" in k for k in graft)
    state2d = {k: v for k, v in source.state_dict().items() if k not in graft}
    path = str(tmp_path / "unet2d" / "diffusion_pytorch_model.bin")
    _save(state2d, path)
    seeded = runtime.build_unet(UNET, **CPU32, seed=0)
    got = runtime.build_unet(UNET, **CPU32, seed=0,
                             weights_dir=os.path.dirname(path))
    own = got.state_dict()
    for k, v in seeded.state_dict().items():
        assert torch.equal(own[k], state2d[k] if k in state2d else v), k
    assert not own["conv_in.conv_temp.weight"].any()
    bad = dict(state2d, extra_key=torch.zeros(1))
    _save(bad, path)
    with pytest.raises(RuntimeError, match="unexpected"):
        runtime.build_unet(UNET, **CPU32, weights_dir=os.path.dirname(path))
    bad = dict(state2d)
    bad.pop("conv_in.weight")
    _save(bad, path)
    with pytest.raises(RuntimeError, match="conv_in.weight"):
        runtime.build_unet(UNET, **CPU32, weights_dir=os.path.dirname(path))


# ------------------------------------------ C-6.2: null text encoding ---

def test_null_text_encoding_like_asva_tpu(tmp_path):
    """.pt and .npy, and each asked for under the other spelling: the
    port's (1, 77, 768) fp32 tensor equals asva_tpu's array; no file: None
    for both; the pipeline loader takes the path."""
    enc = np.random.default_rng(33).standard_normal((77, 768)).astype(
        np.float32)
    torch.save(torch.from_numpy(enc).to(torch.bfloat16),
               str(tmp_path / "null.pt"))
    np.save(str(tmp_path / "null2.npy"), enc)
    for name in ("null.pt", "null.npy", "null2.npy", "null2.pt"):
        path = str(tmp_path / name)
        got = runtime.load_null_text_encoding(path, device="cpu")
        want = np.asarray(jrt.load_null_text_encoding(path))
        assert got.dtype == torch.float32 and got.shape == (1, 77, 768)
        np.testing.assert_array_equal(got.numpy(), want)
    assert runtime.load_null_text_encoding(str(tmp_path / "x.pt")) is None
    assert jrt.load_null_text_encoding(str(tmp_path / "x.pt")) is None
    pipe = runtime.load_animation_pipeline(
        None, None, str(tmp_path / "null.npy"), n_segment=F,
        unet_config=UNET, vae_config=TVC.tiny(), **CPU32)
    np.testing.assert_array_equal(
        pipe.null_text_encoding.numpy(),
        np.asarray(jrt.load_null_text_encoding(str(tmp_path / "null.pt"))))


def test_pipeline_takes_the_unet_from_sd_root(tmp_path):
    """No checkpoint: the UNet comes from <sd_root>/unet (grafted) and the
    VAE from <sd_root>/vae."""
    src = runtime.build_unet(UNET, **CPU32, seed=9, randomize_all=True)
    state2d = {k: v for k, v in src.state_dict().items()
               if k not in runtime._graft_keys(src)}
    _save(state2d, str(tmp_path / "unet" / "diffusion_pytorch_model.bin"))
    vae = runtime.build_vae(TVC.tiny(), **CPU32, seed=10, randomize_all=True)
    _save(vae.state_dict(), str(tmp_path / "vae" / "pytorch_model.bin"))
    pipe = runtime.load_animation_pipeline(
        sd_root=str(tmp_path), n_segment=F, unet_config=UNET,
        vae_config=TVC.tiny(), **CPU32)
    own = pipe.unet.state_dict()
    assert all(torch.equal(own[k], v) for k, v in state2d.items())
    _equal_state(pipe.vae, vae.state_dict())


# ------------------------------------------- C-6.4: shutdown agreement ---

def _ranks(store, world, flags, rounds=3):
    """Run requested_global on `world` ranks (threads) for `rounds` rounds;
    rank r raises its flag before round flags[r] (None: never)."""
    out = [[None] * rounds for _ in range(world)]

    def rank(r):
        g = GracefulShutdown(store, r, world)
        for n in range(rounds):
            if flags[r] == n:
                g.requested = True
            out[r][n] = g.requested_global()

    threads = [threading.Thread(target=rank, args=(r,)) for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    return out


def test_shutdown_agreement_across_ranks():
    """One rank's signal makes every rank's requested_global() true in the
    same round; keys from two rounds back are deleted; a peer that never
    publishes raises TimeoutError; one process keeps the local flag."""
    store = dist.HashStore()
    store.set_timeout(timedelta(seconds=30))
    out = _ranks(store, 2, [None, 1], rounds=4)
    assert out == [[False, True, True, True]] * 2
    assert not store.check(["asva/graceful_shutdown/1/0/0"])
    assert store.check(["asva/graceful_shutdown/1/3/1"])
    lonely = GracefulShutdown(dist.HashStore(), 0, 2)
    lonely.agreement_timeout_s = 0.2
    with pytest.raises(TimeoutError, match="rank 1"):
        lonely.requested_global()
    solo = GracefulShutdown()
    assert not solo.poll() and not solo.requested_global()
    os.kill(os.getpid(), signal.SIGTERM)
    assert solo.requested and solo.poll() and solo.requested_global()
    solo.restore()
    for g in (lonely,):
        g.restore()


def test_second_shutdown_loop_ignores_the_first_loops_keys():
    """Two loops one after the other in one group: in the first, rank 1's
    SIGTERM flag stops both at round 2.  In the second, rank 1 runs each
    round late, so rank 0 reaches every round first: a key left by the
    first loop's rounds must not answer for rank 1 (the parent commit's
    shared round names made rank 0 read rank 1's old flag in round 2 and
    stop alone).  restore() leaves only each rank's last key."""
    store = dist.HashStore()
    store.set_timeout(timedelta(seconds=30))
    world, rounds = 2, 4

    def loop(r, flag_at, delay, out):
        g = GracefulShutdown(store, r, world)
        g.agreement_timeout_s = 10.0   # a peer that stopped alone
        for n in range(rounds):
            time.sleep(delay)
            if n == flag_at:
                g.requested = True
            out[r].append(g.requested_global())
            if out[r][-1]:
                break
        g.restore()

    first = [[], []]
    threads = [threading.Thread(target=loop, daemon=True,
                                args=(r, (None, 2)[r], 0.0, first))
               for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert first == [[False, False, True]] * 2
    for r in range(world):
        assert [store.check([f"asva/graceful_shutdown/1/{n}/{r}"])
                for n in range(3)] == [False, False, True]
    second = [[], []]
    threads = [threading.Thread(target=loop, daemon=True,
                                args=(r, None, 0.1 * r, second))
               for r in range(world)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
    assert not any(th.is_alive() for th in threads)
    assert second == [[False] * rounds] * 2
