"""The port's training path (asva_tpu_torch/training, remat, the training
build) against asva_tpu on the CPU at tiny size, fp32.

The same numpy-seeded inputs and asva_tpu's own random draws go through
both packages: the trainable mask, the optimizer against optax, the loss,
its gradients, train steps, gradient accumulation, remat, and the
checkpoint manager's retention and resume."""
import functools
import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from asva_tpu.convert.jax_to_torch import export_state_dict
from asva_tpu.convert.torch_to_jax import (imagebind_audio_key_map,
                                           unet_key_map, vae_key_map)
from asva_tpu.models.imagebind_audio import (ImageBindAudioConfig as JAC,
                                             SegmaskAudioEncoder as JAE)
from asva_tpu.models.unet3d import AudioUNet3D as JU, UNet3DConfig as JC
from asva_tpu.models.vae import AutoencoderKL as JV, VAEConfig as JVC
from asva_tpu.training import (AnimationTrainConfig as JTC,
                               AnimationTrainer as JTrainer,
                               TrainState as JTrainState)
from asva_tpu.training import optim as joptim
from asva_tpu_torch import runtime
from asva_tpu_torch.convert import load_exported_adam_state
from asva_tpu_torch.diffusion.schedules import DiffusionSchedule as TS
from asva_tpu_torch.models.imagebind_audio import (ImageBindAudioConfig as TAC,
                                                   SegmaskAudioEncoder as TAE)
from asva_tpu_torch.models.unet3d import AudioUNet3D as TU, UNet3DConfig as TC
from asva_tpu_torch.models.vae import AutoencoderKL as TV, VAEConfig as TVC
from asva_tpu_torch.training import (AnimationTrainConfig, AnimationTrainer,
                                     TrainState, build_optimizer,
                                     trainable_mask)
from asva_tpu_torch.training import optim as toptim
from asva_tpu_torch.training.checkpoint import CheckpointManager

from test_torch_ops import close, port, randomize, t

torch.set_num_threads(1)
F = 4       # video length
LR = 1e-3


# ------------------------------------------------------------- fixtures ---

class Pair:
    """A tiny JAX trainer with randomised parameters and a way to build the
    ported torch trainer from any JAX parameter tree.  The jitted JAX steps
    are compiled once and shared by the tests."""

    def __init__(self):
        rng = np.random.default_rng(21)
        k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
        self.junet = JU(JC.tiny())
        jvae, jaud = JV(JVC.tiny()), JAE(JAC.tiny(), n_segment=F)
        # jit: one compiled init instead of thousands of eager init ops
        self.params = randomize(jax.jit(self.junet.init)(
            k1, jnp.zeros((1, F, 8, 8, 4)), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 7, 768)), jnp.zeros((1, 229, 32)),
            jnp.ones((1, F, 229), bool)), rng)
        self.vae_params = randomize(
            jax.jit(jvae.init)(k2, jnp.zeros((1, 16, 16, 3)), k2), rng)
        self.aud_params = randomize(
            jax.jit(jaud.init)(k3, jnp.zeros((1, 128, 204, 1))), rng)
        self.null_text = rng.standard_normal((1, 7, 768)).astype(np.float32)
        self.jvae, self.jaud = jvae, jaud
        self.config = dict(text_cond_drop_prob=0.3, audio_cond_drop_prob=0.4,
                           prediction_type="epsilon")
        self.jtrainer = self.jax_trainer("epsilon")
        self.mask = joptim.trainable_mask(self.params)
        self.tx = joptim.build_optimizer(LR)
        self.batch = {
            "videos": rng.random((2, F, 16, 16, 3)).astype(np.float32),
            "mels": rng.standard_normal((2, 128, 204, 1)).astype(np.float32),
            "text_encodings": rng.standard_normal((2, 7, 768)).astype(
                np.float32)}

    def jax_trainer(self, prediction_type):
        return JTrainer(
            unet=self.junet, vae=self.jvae, audio_encoder=self.jaud,
            vae_params=self.vae_params, audio_encoder_params=self.aud_params,
            null_text_encoding=jnp.asarray(self.null_text),
            config=JTC(**dict(self.config, prediction_type=prediction_type)))

    @functools.cached_property
    def jgrad_step(self):
        return self.jtrainer.make_grad_step(mask=self.mask)

    @functools.cached_property
    def jtrain_step(self):
        return self.jtrainer.make_train_step(self.tx, donate=False,
                                             mask=self.mask)

    def torch_trainer(self, params=None, prediction_type="epsilon",
                      **unet_kw):
        """(trainer, state) with the UNet ported from `params`, the mask
        applied and AdamW(LR) over the trainable parameters."""
        unet = port(TU(TC.tiny(audio_cross_attention_dim=32, **unet_kw)),
                    self.params if params is None else params).train()
        toptim.apply_trainable_mask(unet, trainable_mask(unet))
        trainer = AnimationTrainer(
            unet=unet, vae=port(TV(TVC.tiny()), self.vae_params, vae_key_map),
            audio_encoder=port(TAE(TAC.tiny(), n_segment=F), self.aud_params,
                               imagebind_audio_key_map),
            null_text_encoding=t(self.null_text),
            config=AnimationTrainConfig(**dict(
                self.config, prediction_type=prediction_type)))
        return trainer, TrainState(0, unet, build_optimizer(unet, LR))

    def jbatch(self):
        return {k: jnp.asarray(v) for k, v in self.batch.items()}

    def tbatch(self):
        return {k: t(v) for k, v in self.batch.items()}

    def draws(self, key):
        """The five draws asva_tpu's `_loss` makes from `key`."""
        r_vae, r_t, r_noise, r_tdrop, r_adrop = jax.random.split(key, 5)
        videos = self.batch["videos"]
        b = videos.shape[0]
        frames = jnp.asarray(videos.reshape((b * F,) + videos.shape[2:]))
        mean, _ = self.jtrainer.vae.apply(self.vae_params, frames,
                                          method=self.jtrainer.vae.encode)
        return {
            "vae_noise": t(jax.random.normal(r_vae, mean.shape)),
            "t": t(jax.random.randint(r_t, (b,), 0, 1000)).long(),
            "noise": t(jax.random.normal(r_noise, (b, F) + mean.shape[1:])),
            "text_keep": t(jax.random.uniform(r_tdrop, (b, 1, 1))),
            "audio_keep": t(jax.random.uniform(r_adrop, (b, 1, 1)))}


@pytest.fixture(scope="module")
def pair():
    return Pair()


def _exported(tree):
    return export_state_dict(tree, unet_key_map)


def _grad_close(got, want, rel):
    """max |got - want| <= rel * max(1e-3, max|want|) per tensor."""
    want = np.asarray(want)
    scale = max(1e-3, float(np.abs(want).max()))
    assert float(np.abs(got.detach().numpy() - want).max()) <= rel * scale


# ----------------------------------------------------------------- mask ---

def test_trainable_mask_equals_jax_mask_through_key_map(pair):
    """The port's trainable names are the image of asva_tpu's mask under
    export_state_dict; both train the _temp/_audio families only."""
    unet = TU(TC.tiny(audio_cross_attention_dim=32))
    mask = trainable_mask(unet)
    jmask = _exported(jax.tree.map(lambda m: np.float32(m), pair.mask))
    assert set(mask) == set(jmask)
    assert {k for k, v in mask.items() if v} == \
        {k for k, v in jmask.items() if v}
    on = [k for k, v in mask.items() if v]
    assert on and not all(mask.values())
    assert all("_temp" in k or "_audio" in k for k in on)
    assert any("conv_temp" in k for k in on)
    assert not mask["conv_in.weight"]
    assert not any(v for k, v in mask.items() if ".attn1." in k)


def test_trainable_mask_segments_and_errors(caplog):
    unet = TU(TC.tiny(audio_cross_attention_dim=32))
    for tokens in (("temp", "audio"), ("_temp", "_audio")):
        segs = toptim.segments_for_trainable_modules(tokens)
        assert segs == toptim.TRAINABLE_SEGMENTS
        assert trainable_mask(unet, segs) == trainable_mask(unet)
    assert all(trainable_mask(unet, ()).values())
    only_audio = trainable_mask(unet, ("attn_audio",))
    assert any(only_audio.values())
    assert not any(v for k, v in only_audio.items() if "attn_audio" not in k)
    # exact segments: a substring of a segment matches nothing
    with pytest.raises(ValueError, match="no parameter path matches"):
        trainable_mask(unet, ("temp",))
    with caplog.at_level(logging.WARNING, logger="asva_tpu_torch"):
        segs = toptim.segments_for_trainable_modules(("audio", "attn1"))
    assert "attn1" in segs and "not a known module family" in caplog.text


def test_apply_trainable_mask_and_training_build():
    """build_unet(train=True): fp32 parameters, all requiring grad, train
    mode, bf16 compute; the mask then freezes and (optionally) rounds the
    frozen ones.  The inference build is unchanged: bf16, frozen, eval."""
    cfg = TC.tiny(audio_cross_attention_dim=32)
    unet = runtime.build_unet(cfg, device="cpu", dtype=torch.bfloat16,
                              seed=3, train=True)
    assert unet.training and unet.compute_dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 and p.requires_grad
               for p in unet.parameters())
    infer = runtime.build_unet(cfg, device="cpu", dtype=torch.bfloat16,
                               seed=3)
    assert not infer.training
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in infer.parameters())
    mask = trainable_mask(unet)
    toptim.apply_trainable_mask(unet, mask, frozen_dtype=torch.bfloat16)
    for (name, p), q in zip(unet.named_parameters(), infer.parameters()):
        assert p.requires_grad == mask[name]
        assert p.dtype == (torch.float32 if mask[name] else torch.bfloat16)
        # one rounding: the stored frozen value is the inference build's
        assert torch.equal(p.detach().bfloat16(), q)
    # fp32 trainable + bf16 frozen parameters run under bf16 activations
    x = torch.randn(1, F, 8, 8, 4)
    out = unet(x, torch.tensor([5]), torch.randn(1, 7, 768),
               torch.randn(1, 229, 32),
               audio_token_indices=np.zeros((F, 3), np.int64))
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None


# ------------------------------------------------------------ optimizer ---

class _Toy(nn.Module):
    def __init__(self, values):
        super().__init__()
        self.p = nn.ParameterDict({k: nn.Parameter(t(v))
                                   for k, v in values.items()})


@pytest.mark.parametrize("warmup", [0, 3])
@pytest.mark.parametrize("mu_dtype", [None, "bfloat16"])
def test_optimizer_steps_match_optax(rng, warmup, mu_dtype):
    """Three AdamW steps on the same gradients against asva_tpu's optax
    chain: the clip is active on the first step (norm 7) and not on the
    others, with and without linear warmup (lr 0 on the first step), with
    an fp32 and a bf16 first moment.  fp32, 1e-6 (bf16 moment: 1e-5 on
    parameters, its own rounding on mu)."""
    values = {"a": rng.standard_normal((4, 3)).astype(np.float32),
              "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = []
    for norm in (7.0, 0.3, 0.5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in values.items()}
        total = np.sqrt(sum(float((x ** 2).sum()) for x in g.values()))
        grads.append({k: x * np.float32(norm / total) for k, x in g.items()})
    tx = joptim.build_optimizer(
        1e-2, warmup_steps=warmup,
        mu_dtype=None if mu_dtype is None else jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in values.items()}
    jstate = tx.init(jp)
    toy = _Toy(values)
    opt = build_optimizer(toy, 1e-2, warmup_steps=warmup,
                          mu_dtype=None if mu_dtype is None
                          else torch.bfloat16)
    tol = 1e-6 if mu_dtype is None else 1e-5
    for i, g in enumerate(grads):
        updates, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    jstate, jp)
        jp = optax.apply_updates(jp, updates)
        norm = opt.step([t(g[n.split(".")[-1]]) for n in opt.names])
        close(norm, [7.0, 0.3, 0.5][i], 1e-5)
        for name, p in toy.named_parameters():
            close(p, jp[name.split(".")[-1]], tol)
    assert opt.count == 3
    adam = jstate[1][0]
    for name, mu, nu in zip(opt.names, opt.mu, opt.nu):
        key = name.split(".")[-1]
        assert mu.dtype == (torch.float32 if mu_dtype is None
                            else torch.bfloat16)
        close(mu.float(), np.asarray(adam.mu[key].astype(jnp.float32)),
              1e-6 if mu_dtype is None else 2.0 ** -8)
        close(nu, adam.nu[key], 1e-6)
    if warmup:   # lr 0 on the first step: it moved nothing
        assert opt.lr(0) == 0.0 and opt.lr(3) == opt.lr(10) == 1e-2


def test_optimizer_covers_trainable_parameters_only(pair):
    _, state = pair.torch_trainer()
    mask = trainable_mask(state.unet)
    assert state.optimizer.names == [k for k, v in mask.items() if v]
    with pytest.raises(ValueError, match="no gradient"):
        state.optimizer.step([None] * len(state.optimizer.names))
    frozen = nn.Linear(2, 2).requires_grad_(False)
    with pytest.raises(ValueError, match="no trainable parameter"):
        build_optimizer(frozen)


# ----------------------------------------------------- loss and its grads ---

@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_loss_and_gradients_match_jax(pair, prediction_type):
    """Tiny config, asva_tpu's draws injected: the loss to 1e-5 relative and
    every trainable gradient to 2e-4 of its largest entry (fp32; the two
    packages sum in different orders through ~40 layers); frozen parameters
    receive no gradient."""
    key = jax.random.PRNGKey(7)
    jgrad_step = (pair.jgrad_step if prediction_type == "epsilon" else
                  pair.jax_trainer(prediction_type).make_grad_step(
                      mask=pair.mask))
    jloss, jgrads = jgrad_step(pair.params, pair.jbatch(), key)
    trainer, state = pair.torch_trainer(prediction_type=prediction_type)
    loss, grads = trainer.grad_step(state, pair.tbatch(),
                                    draws=pair.draws(key))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    want = _exported(jgrads)
    assert set(want) == set(state.optimizer.names)
    for name, g in zip(state.optimizer.names, grads):
        assert float(g.abs().max()) > 0, name
        _grad_close(g, want[name], 2e-4)
    trainer.loss_fn(pair.tbatch(), draws=pair.draws(key)).backward()
    mask = trainable_mask(state.unet)
    for name, p in state.unet.named_parameters():
        assert (p.grad is not None) == mask[name], name
    for m in (trainer.vae, trainer.audio_encoder):
        assert all(p.grad is None for p in m.parameters())


def test_loss_draws_come_from_the_generator(pair):
    """With a generator the draws are reproducible, t lies in [0, 1000) and
    the keep masks use >=; without a generator or draws loss_fn raises."""
    trainer, _ = pair.torch_trainer()
    batch = pair.tbatch()
    d1 = trainer.draw(batch, torch.Generator().manual_seed(4))
    d2 = trainer.draw(batch, torch.Generator().manual_seed(4))
    assert all(torch.equal(d1[k], d2[k]) for k in d1)
    assert d1["vae_noise"].shape == (2 * F, 8, 8, 4)
    assert d1["noise"].shape == (2, F, 8, 8, 4)
    assert d1["t"].dtype == torch.int64
    assert 0 <= int(d1["t"].min()) and int(d1["t"].max()) < 1000
    with torch.no_grad():
        a = trainer.loss_fn(batch, torch.Generator().manual_seed(4))
        b = trainer.loss_fn(batch, draws=d1)
    assert torch.equal(a, b) and torch.isfinite(a)
    with pytest.raises(ValueError, match="generator"):
        trainer.loss_fn(batch)
    # a draw equal to the probability keeps the condition (>=)
    keep_all = dict(d1, text_keep=torch.full((2, 1, 1), 0.3),
                    audio_keep=torch.full((2, 1, 1), 0.4))
    drop_all = dict(d1, text_keep=torch.full((2, 1, 1), 0.29),
                    audio_keep=torch.full((2, 1, 1), 0.39))
    no_drop = dict(d1, text_keep=torch.ones(2, 1, 1),
                   audio_keep=torch.ones(2, 1, 1))
    with torch.no_grad():
        kept, dropped, full = (trainer.loss_fn(batch, draws=d)
                               for d in (keep_all, drop_all, no_drop))
    assert torch.equal(kept, full) and not torch.equal(dropped, full)


def test_schedule_add_noise_and_velocity_match_jax(rng):
    from asva_tpu.diffusion.schedules import DiffusionSchedule as JS
    x0 = rng.standard_normal((3, 2, 4, 4, 4)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    ts = np.array([0, 500, 999])
    for fn in ("add_noise", "velocity"):
        want = getattr(JS(), fn)(jnp.asarray(x0), jnp.asarray(noise),
                                 jnp.asarray(ts))
        close(getattr(TS(), fn)(t(x0), t(noise), t(ts)), want, 1e-6)


# ---------------------------------------------------------- train steps ---

def _jax_state(pair):
    sub = joptim.partition_params(pair.params, pair.mask)[0]
    return JTrainState(jnp.zeros((), jnp.int32), pair.params,
                       pair.tx.init(sub))


def _assert_params_match(unet, jparams, before):
    """Every trainable parameter against the exported JAX tree: 1e-4
    absolute at worst, a tenth of one step's lr (Adam normalises the
    gradient, so an entry near the fp32 noise floor moves by a visibly
    different fraction of lr in the two packages; seen: 4e-5 on one entry
    of 12288), and 1e-6 on average.  Frozen parameters are bit-identical to
    `before`."""
    want = _exported(jparams)
    mask = trainable_mask(unet)
    moved = 0
    for name, p in unet.named_parameters():
        got = p.detach().numpy()
        if mask[name]:
            np.testing.assert_allclose(got, want[name], atol=1e-4, rtol=0)
            assert float(np.abs(got - want[name]).mean()) <= 1e-6, name
            moved += int(not np.array_equal(got, before[name]))
        else:
            np.testing.assert_array_equal(got, before[name])
    assert moved > 0


def test_two_train_steps_match_jax(pair):
    """Two train steps (asva_tpu's draws, AdamW lr 1e-3, clip 1.0): the
    losses to 1e-5 relative; parameters as `_assert_params_match` states;
    frozen parameters are bit-identical to the start."""
    jstate = _jax_state(pair)
    trainer, state = pair.torch_trainer()
    before = {k: v.detach().numpy().copy()
              for k, v in state.unet.named_parameters()}
    key = jax.random.PRNGKey(3)
    for i in range(2):
        k = jax.random.fold_in(key, i)
        jstate, jloss = pair.jtrain_step(jstate, pair.jbatch(), k)
        loss = trainer.train_step(state, pair.tbatch(), draws=pair.draws(k))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    assert state.step == 2 == int(jstate.step)
    _assert_params_match(state.unet, jstate.params, before)


def test_accumulation_and_carried_adam_state_match_jax(pair):
    """asva_tpu takes one step; its parameters and its optax state (mu, nu,
    count through export_state_dict) are carried into the port; both then
    take a second, accumulated step (two grad_steps averaged, one
    apply_step).  Parameters as `_assert_params_match` states; the carried count makes the
    bias correction that of step 2."""
    jstate = _jax_state(pair)
    key = jax.random.PRNGKey(9)
    jstate, _ = pair.jtrain_step(jstate, pair.jbatch(), key)
    trainer, state = pair.torch_trainer(jstate.params)
    adam = jstate.opt_state[1][0]
    load_exported_adam_state(state.optimizer, _exported(adam.mu),
                             _exported(adam.nu), int(adam.count))
    assert state.optimizer.count == 1
    before = {k: v.detach().numpy().copy()
              for k, v in state.unet.named_parameters()}

    gstep = pair.jgrad_step
    astep = pair.jtrainer.make_apply_step(pair.tx, mask=pair.mask)
    keys = [jax.random.fold_in(key, i) for i in (1, 2)]
    jgrads = [gstep(jstate.params, pair.jbatch(), k)[1] for k in keys]
    jstate = astep(jstate, jax.tree.map(lambda a, b: (a + b) / 2, *jgrads))

    grads = [trainer.grad_step(state, pair.tbatch(), draws=pair.draws(k))[1]
             for k in keys]
    trainer.apply_step(state, [(a + b) / 2 for a, b in zip(*grads)])
    assert state.step == 1 and state.optimizer.count == 2
    _assert_params_match(state.unet, jstate.params, before)
    with pytest.raises(KeyError, match="no mu"):
        load_exported_adam_state(state.optimizer, {}, {}, 0)


# ---------------------------------------------------------------- remat ---

@pytest.mark.parametrize("policy", ["full", "highres", "saveconv", "dots"])
def test_remat_changes_no_output_and_no_gradient(pair, policy):
    """Loss and every gradient with remat on are bit-identical to remat off,
    and the rematerialised blocks really run twice."""
    key = jax.random.PRNGKey(5)
    base_trainer, base_state = pair.torch_trainer()
    want_loss, want = base_trainer.grad_step(base_state, pair.tbatch(),
                                             draws=pair.draws(key))
    trainer, state = pair.torch_trainer(remat=True, remat_policy=policy)
    calls = []
    state.unet.down_blocks[0].register_forward_pre_hook(
        lambda *a: calls.append(1))
    loss, grads = trainer.grad_step(state, pair.tbatch(),
                                    draws=pair.draws(key))
    assert len(calls) == 2          # forward + recompute in the backward
    assert torch.equal(loss, want_loss)
    for a, b in zip(grads, want):
        assert torch.equal(a, b)
    with torch.no_grad():           # no graph, no checkpoint
        calls.clear()
        trainer.loss_fn(pair.tbatch(), draws=pair.draws(key))
    assert len(calls) == 1


def test_remat_levels_and_unknown_policy(monkeypatch):
    """"highres" rematerialises only the two highest-resolution levels, with
    the non-reentrant checkpoint; an unknown policy name raises."""
    import asva_tpu_torch.models.unet3d.model as model
    unet = TU(TC.tiny(remat=True, remat_policy="highres"))
    seen = []
    monkeypatch.setattr(model, "checkpoint",
                        lambda fn, *a, **kw: seen.append(kw) or fn(*a))
    for level in range(4):
        assert unet._run_block(lambda x: x + 1, level, 1) == 2
    assert seen == [{"use_reentrant": False}] * 2
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TU(TC.tiny(remat_policy="everything"))


# ----------------------------------------------------------- checkpoint ---

def _ckpt_state(step):
    return {"step": step, "unet": {"w": torch.full((4, 4), float(step))},
            "optimizer": {"count": step,
                          "mu": {"w": torch.full((4, 4), 0.1 * step)}}}


def test_checkpoint_retention_keeps_milestones(tmp_path):
    mgr = CheckpointManager(str(tmp_path), checkpointing_steps=10,
                            milestone_steps=30)
    for step in range(1, 61):
        assert mgr.save(step, _ckpt_state(step)) == (step % 10 == 0)
    # milestones 30 and 60 survive; 60 is also the latest
    assert mgr.existing_steps() == [30, 60]
    assert mgr.is_milestone(30) and not mgr.is_milestone(40)
    assert not mgr.should_save(0) and mgr.should_save(20)


def test_checkpoint_retention_is_lazy_and_crash_safe(tmp_path, monkeypatch):
    """The previous checkpoint goes only once the newer one is complete: a
    save that dies before state.pt is renamed leaves the old one in place
    and is itself not listed."""
    mgr = CheckpointManager(str(tmp_path), checkpointing_steps=10,
                            milestone_steps=100)
    mgr.save(10, _ckpt_state(10))

    def failing(obj, path):
        raise OSError("disk full")
    monkeypatch.setattr(torch, "save", failing)
    with pytest.raises(OSError):
        mgr.save(20, _ckpt_state(20))
    monkeypatch.undo()
    assert mgr.existing_steps() == [10]
    mgr.save(20, _ckpt_state(20))
    mgr.save(30, _ckpt_state(30))
    assert mgr.existing_steps() == [30]
    assert not mgr.save(30, _ckpt_state(30), force=True)   # idempotent
    assert mgr.save(31, _ckpt_state(31), force=True)       # off-schedule
    assert mgr.existing_steps() == [31]


def test_checkpoint_extra_sidecar_and_resume(tmp_path):
    mgr = CheckpointManager(str(tmp_path), checkpointing_steps=1)
    mgr.save(1, _ckpt_state(1), extra={"loader": {"epoch": 0, "cursor": 3}})
    mgr.save(2, _ckpt_state(2), extra={"loader": {"epoch": 1, "cursor": 0}})
    mgr2 = CheckpointManager(str(tmp_path), checkpointing_steps=1)
    assert mgr2.latest_step() == 2
    step, restored = mgr2.restore_latest()
    assert step == 2 and restored["step"] == 2
    assert torch.equal(restored["unet"]["w"], torch.full((4, 4), 2.0))
    assert mgr2.restore_extra(2) == {"loader": {"epoch": 1, "cursor": 0}}
    assert mgr2.restore_extra(1) is None    # retention removed checkpoint-1
    assert mgr2.restore_extra(99) is None
    assert CheckpointManager(str(tmp_path / "empty")).restore_latest() is None
    # a new manager continues the retention from what is on disk
    mgr2.save(3, _ckpt_state(3))
    assert mgr2.existing_steps() == [3]


def test_train_state_roundtrip_and_module_export(pair, tmp_path):
    """Exact resume of the trainer state (step, parameters, Adam moments and
    count) through save / restore_latest, and a module export whose
    modules_config.json sidecar the runtime reads back."""
    trainer, state = pair.torch_trainer()
    key = jax.random.PRNGKey(1)
    trainer.train_step(state, pair.tbatch(), draws=pair.draws(key))
    cfg = {"unet": {"block_out_channels": [32, 64], "layers_per_block": 1}}
    mgr = CheckpointManager(str(tmp_path), checkpointing_steps=1,
                            module_configs=cfg)
    assert mgr.save(state.step, state.state_dict(),
                    modules={"unet": state.unet.state_dict()},
                    extra={"seed": 1})
    want = trainer.train_step(state, pair.tbatch(),
                              draws=pair.draws(jax.random.fold_in(key, 1)))

    trainer2, state2 = pair.torch_trainer()
    step, restored = CheckpointManager(str(tmp_path)).restore_latest()
    state2.load_state_dict(restored)
    assert step == 1 and state2.step == 1 and state2.optimizer.count == 1
    got = trainer2.train_step(state2, pair.tbatch(),
                              draws=pair.draws(jax.random.fold_in(key, 1)))
    assert torch.equal(got, want)
    for a, b in zip(state.unet.parameters(), state2.unet.parameters()):
        assert torch.equal(a, b)
    exported = mgr.restore_module(1, "unet")
    assert set(exported) == set(state.unet.state_dict())
    assert runtime.load_module_configs(mgr.modules_dir(1)) == cfg
    assert json.load(open(tmp_path / "checkpoint-1" / "extra.json")) == \
        {"seed": 1}
