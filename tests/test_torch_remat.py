"""The UNet's remat policies (asva_tpu_torch/ops/remat.py and the levels of
models/unet3d/model.py) on the CPU at tiny size, fp32.

For each of asva_tpu's six policies, a tiny AudioUNet3D's loss and every
parameter gradient equal those with remat off bit for bit, and asva_tpu's
jax.grad of the same loss on the same (converted) weights within
test_torch_train.py's tolerance.  asva_tpu's gradient is compiled once, under
"saveconv": a jitted JAX gradient of this UNet takes about 30 s to compile
on a CPU, and its policies change no gradient (asva_tpu's own
tests/test_remat_policy.py).  Counters on the tagged code then show what
each policy's recompute runs again, level by level, against asva_tpu's
choices (asva_tpu/models/unet3d/model.py:125-149)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import checkpoint

from asva_tpu.convert.jax_to_torch import export_state_dict
from asva_tpu.convert.torch_to_jax import convert_state_dict, unet_key_map
from asva_tpu.models.unet3d import AudioUNet3D as JU, UNet3DConfig as JC
from asva_tpu_torch import runtime
from asva_tpu_torch.models.unet3d import AudioUNet3D as TU, UNet3DConfig as TC
from asva_tpu_torch.models.unet3d import model as tmodel
from asva_tpu_torch.ops import fused, remat
from asva_tpu_torch.parallel import sharding

torch.set_num_threads(1)
F = 4
POLICIES = ("full", "highres", "l0", "saveconv", "saveconv0", "dots")
SAVECONV = {"conv_out", "sublayer_x", "attn_res", "block_out"}
# asva_tpu's maybe_remat, levels 0-3 (0 the highest resolution): None no
# remat, "full" a remat that keeps nothing, else the names kept
LEVELS = {
    "full": ("full", "full", "full", "full"),
    "highres": ("full", "full", None, None),
    "l0": ("full", None, None, None),
    "saveconv": (SAVECONV, SAVECONV, None, None),
    "saveconv0": (SAVECONV, "full", None, None),
    "dots": ({"dot"}, {"dot"}, {"dot"}, {"dot"})}


class Setup:
    """Seeded tiny weights and inputs, the loss and gradients with remat
    off, and asva_tpu's (one jitted JAX gradient)."""

    def __init__(self):
        cfg = TC.tiny(audio_cross_attention_dim=32)
        unet = runtime.build_unet(cfg, device="cpu", dtype=torch.float32,
                                  seed=3, randomize_all=True)
        self.state = {k: v.clone() for k, v in unet.state_dict().items()}
        rng = np.random.default_rng(31)
        mask = np.zeros((2, F, 229), bool)
        mask[:, :, 0] = True
        for i in range(F):
            mask[:, i, 1 + 10 * i:12 + 10 * i] = True
        self.inputs = (
            rng.standard_normal((2, F, 8, 8, 4)).astype(np.float32),
            np.array([17, 630], np.int32),
            rng.standard_normal((2, 7, 768)).astype(np.float32),
            rng.standard_normal((2, 229, 32)).astype(np.float32), mask)
        self.target = rng.standard_normal((2, F, 8, 8, 4)).astype(np.float32)
        self.base_loss, self.base_grads = self.step(self.unet())

        jnet = JU(JC.tiny(remat=True, remat_policy="saveconv"))
        shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                                *map(jnp.asarray, self.inputs))
        params, report = convert_state_dict(
            shapes, {k: v.numpy() for k, v in self.state.items()},
            unet_key_map, strict=True)
        assert not report["unused"], report["unused"][:5]
        jargs = tuple(map(jnp.asarray, self.inputs))
        target = jnp.asarray(self.target)

        def loss(p):
            return jnp.mean((jnet.apply(p, *jargs) - target) ** 2)
        jloss, jgrads = jax.jit(jax.value_and_grad(loss))(params)
        self.jax_loss = float(jloss)
        self.jax_grads = export_state_dict(jgrads, unet_key_map)

    def unet(self, **kw):
        unet = TU(TC.tiny(audio_cross_attention_dim=32, **kw))
        unet.load_state_dict(self.state)
        return unet.train()

    def step(self, unet):
        """(loss, {name: gradient}) of one forward and backward."""
        sample, t, text, audio, mask = (torch.from_numpy(a)
                                        for a in self.inputs)
        unet.zero_grad(set_to_none=True)
        out = unet(sample, t.long(), text, audio, audio_mask=mask)
        loss = ((out - torch.from_numpy(self.target)) ** 2).mean()
        loss.backward()
        return loss.detach(), {n: p.grad for n, p in unet.named_parameters()}


@pytest.fixture(scope="module")
def setup():
    return Setup()


def _grad_close(got, want, rel):
    """max |got - want| <= rel * max(1e-3, max|want|) (test_torch_train)."""
    want = np.asarray(want)
    scale = max(1e-3, float(np.abs(want).max()))
    assert float(np.abs(got.detach().numpy() - want).max()) <= rel * scale


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_keeps_gradients_and_matches_jax(setup, policy):
    """Loss and every gradient bit-equal to remat off, and within 1e-5
    (loss) and 2e-4 of the largest entry (gradients) of asva_tpu's."""
    loss, grads = setup.step(setup.unet(remat=True, remat_policy=policy))
    assert torch.equal(loss, setup.base_loss)
    assert set(grads) == set(setup.base_grads) == set(setup.jax_grads)
    for name, g in grads.items():
        assert torch.equal(g, setup.base_grads[name]), name
        _grad_close(g, setup.jax_grads[name], 2e-4)
    np.testing.assert_allclose(float(loss), setup.jax_loss, rtol=1e-5)


class _Convs(TorchDispatchMode):
    """Counts the convolutions that really run (a replayed one does not
    reach this mode)."""

    def __init__(self, counts):
        super().__init__()
        self.counts = counts

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.convolution.default:
            self.counts["conv"] += 1
        return func(*args, **(kwargs or {}))


class _Counters:
    """Counts what really runs in a step: convolutions (by dispatch) and
    the tagged fused code (B1's q and output projection, B4, B3), and each
    block's runs; in a block's first run, what it ran, by level."""
    KINDS = ("conv", "q", "b4", "b1", "b3")

    def __init__(self, monkeypatch):
        self.counts = dict.fromkeys(self.KINDS, 0)
        for kind, fn in (("q", "_ln_q_proj"), ("b4", "mha_fwd"),
                         ("b1", "_attn_out"), ("b3", "_ln_geglu_fwd")):
            def counted(*a, _fn=getattr(fused, fn), _kind=kind):
                self.counts[_kind] += 1
                return _fn(*a)
            monkeypatch.setattr(fused, fn, counted)

    def step(self, setup, unet):
        """-> (counts, runs of each block, the blocks' levels, {level:
        counts of its blocks' first runs}, loss)."""
        counts = self.counts
        for k in counts:
            counts[k] = 0
        top = len(unet.config.block_out_channels) - 1
        blocks = ([(b, i) for i, b in enumerate(unet.down_blocks)]
                  + [(unet.mid_block, top)]
                  + [(b, top - i) for i, b in enumerate(unet.up_blocks)])
        runs, before, by_level = [0] * len(blocks), {}, {}
        for j, (block, level) in enumerate(blocks):
            def pre(*_, _j=j):
                runs[_j] += 1
                before[_j] = dict(counts)

            def post(*_, _j=j, _level=level):
                if runs[_j] == 1:
                    acc = by_level.setdefault(_level,
                                              dict.fromkeys(counts, 0))
                    for k in counts:
                        acc[k] += counts[k] - before[_j][k]
            block.register_forward_pre_hook(pre)
            block.register_forward_hook(post)
        with _Convs(counts):
            loss, _ = setup.step(unet)
        return (dict(counts), runs, [lv for _, lv in blocks], by_level,
                loss)


# what the recompute of a rematerialised level runs again, unless the level
# keeps one of these names (B1's q sits inside the attn_res value)
_RERUN_UNLESS = {"conv": {"conv_out"}, "b4": {"attn_res"},
                 "b1": {"sublayer_x", "dot"}, "b3": {"block_out", "dot"},
                 "q": {"dot", "attn_res"}}


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_recompute_counts(setup, policy, monkeypatch):
    """Each level of the tiny UNet (0 and 1) runs its blocks twice where
    asva_tpu rematerialises it and once elsewhere, and its recompute runs a
    tagged convolution, B1 sub-layer, B4 or B3 again only where the level
    keeps none of its names: under saveconv nothing tagged runs again, under
    l0 level 1 is not rematerialised, under full everything is."""
    counters = _Counters(monkeypatch)
    if not hasattr(setup, "base_counts"):          # remat off, once
        setup.base_counts = counters.step(setup, setup.unet())
    base, _, _, levels, _ = setup.base_counts
    counts, runs, block_levels, _, loss = counters.step(
        setup, setup.unet(remat=True, remat_policy=policy))
    assert torch.equal(loss, setup.base_loss)
    assert all(base[k] > 0 for k in base)
    plan = LEVELS[policy]
    assert runs == [1 if plan[lv] is None else 2 for lv in block_levels]
    want = dict(base)
    for level, ran in levels.items():
        keep = plan[level]
        for kind, names in _RERUN_UNLESS.items():
            if keep == "full" or (keep is not None and not keep & names):
                want[kind] += ran[kind]
    assert counts == want
    if policy == "saveconv":
        assert counts == base
    if policy == "full":
        assert counts == {k: base[k] + sum(ran[k] for ran in levels.values())
                          for k in base}


def test_remat_levels_match_asva_tpu():
    """remat_saves_at gives asva_tpu's level choices for every policy at
    levels 0-3; unknown policies and names raise ValueError."""
    for policy, plan in LEVELS.items():
        for level, want in enumerate(plan):
            got = tmodel.remat_saves_at(policy, level)
            if want is None or want == "full":
                assert got == (None if want is None else ()), (policy, level)
            else:
                assert set(got) == want, (policy, level)
    assert set(tmodel.REMAT_POLICIES) == set(LEVELS)
    with pytest.raises(ValueError, match="unknown remat_policy"):
        TU(TC.tiny(remat=True, remat_policy="everything"))
    with pytest.raises(ValueError, match="unknown saved names"):
        remat.policy(["conv_out", "activations"])


def _squared(x):
    return remat.checkpoint_name("dot", torch.square, x) + 1


def test_remat_refuses_what_it_cannot_replay():
    """Outside a policy a tag changes nothing.  A recompute that runs other
    operations than a stored value's, reaches a tag that stored nothing, or
    tagged code with an in-place operation raises instead of recomputing
    quietly."""
    x = torch.randn(5, requires_grad=True)
    assert torch.equal(_squared(x), x * x + 1)
    calls = []

    def other_ops(v):
        calls.append(1)
        if len(calls) == 1:
            return _squared(v).sum()
        return (remat.checkpoint_name("dot", torch.exp, v) + 1).sum()
    y = checkpoint(other_ops, x, use_reentrant=False,
                   context_fn=remat.policy(["dot"]))
    with pytest.raises(RuntimeError, match="remat: the recompute of dot"):
        y.backward()

    def nothing_stored(v):
        calls.append(1)
        if len(calls) == 4:                   # the recompute only
            with torch.no_grad():
                remat.checkpoint_name("attn_res", torch.exp, v)
        return (v * v).sum()
    y = checkpoint(nothing_stored, x, use_reentrant=False,
                   context_fn=remat.policy(["attn_res"]))
    with pytest.raises(RuntimeError, match="no stored value for attn_res"):
        y.backward()

    def inplace(v):
        return remat.checkpoint_name("dot", lambda t: (t * 2).add_(1), v)
    with pytest.raises(RuntimeError, match="mutates"):
        checkpoint(inplace, x, use_reentrant=False,
                   context_fn=remat.policy(["dot"]))


def test_fsdp_gathers_unchanged_by_the_saves(setup, monkeypatch):
    """Under FSDP every unit is rematerialised; a policy's saves apply
    there and the units' parameter gathers (one a unit's forward, one its
    recompute) are as many as under a full remat."""
    gathered = []

    def call_gathered(module, *args):
        gathered.append(type(module).__name__)
        return module(*args)
    monkeypatch.setattr(sharding, "sharded", lambda module: True)
    monkeypatch.setattr(sharding, "call_gathered", call_gathered)
    unet = setup.unet()
    with torch.no_grad():                   # one gather a unit's module
        setup_inputs = [torch.from_numpy(a) for a in setup.inputs]
        unet(*setup_inputs[:2], setup_inputs[2], setup_inputs[3],
             audio_mask=setup_inputs[4])
    once = sorted(gathered)
    counts = {}
    for policy in ("full", "saveconv"):
        gathered.clear()
        loss, grads = setup.step(setup.unet(remat=True, remat_policy=policy))
        assert torch.equal(loss, setup.base_loss)
        assert all(torch.equal(g, setup.base_grads[n])
                   for n, g in grads.items())
        counts[policy] = sorted(gathered)
    assert counts["saveconv"] == counts["full"] == sorted(once * 2)


class _Built(Exception):
    pass


def test_config_policy_reaches_the_unet(tmp_path, monkeypatch):
    """The YAML's gradient_checkpoint_policy becomes UNet3DConfig's
    remat_policy as in asva_tpu/config.py:127-130 (default highres, remat
    from enable_gradient_checkpoint), and animation_train builds the UNet
    from that config unchanged."""
    import dataclasses
    import yaml
    from asva_tpu.config import AnimationJobConfig as JJob
    from asva_tpu_torch.config import AnimationJobConfig as TJob
    from asva_tpu_torch.scripts import animation_train
    with open(os.path.join(os.path.dirname(__file__), "..", "configs",
                           "audio-cond_animation",
                           "avsync15_audio-cond_cfg.yaml")) as f:
        raw = yaml.safe_load(f)
    for policy in POLICIES + (None,):
        optim = {k: v for k, v in raw["optim"].items()
                 if k != "gradient_checkpoint_policy"}
        if policy is not None:
            optim["gradient_checkpoint_policy"] = policy
        path = tmp_path / f"{policy}.yaml"
        path.write_text(yaml.safe_dump(dict(raw, optim=optim)))
        got, want = TJob.from_yaml(str(path)), JJob.from_yaml(str(path))
        assert (got.unet.remat, got.unet.remat_policy) == (
            want.unet.remat, want.unet.remat_policy) == (
            True, policy or "highres")
    cfg = dataclasses.replace(got, output_dir=str(tmp_path / "run"))

    def build_unet(config, *a, **kw):
        raise _Built(config)
    monkeypatch.setattr(runtime, "build_unet", build_unet)
    with pytest.raises(_Built) as built:
        animation_train.train(cfg, None, "cpu", 1)
    assert built.value.args[0] is cfg.unet

