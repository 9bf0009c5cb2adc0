"""Parity of the PyTorch port's ops against asva_tpu on the CPU: norms,
attention, embeddings, mel, samplers; plus the port's import rule.

Shared helpers for the test_torch_* files live here.  Inputs come from
numpy seeds; weights go JAX -> `export_state_dict` -> `load_exported`.
Tolerances are fp32 ones (stated per test)."""
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asva_tpu.convert.jax_to_torch import export_state_dict
from asva_tpu.convert.torch_to_jax import unet_key_map
from asva_tpu_torch.convert import load_exported

torch.set_num_threads(1)

PKG = os.path.join(os.path.dirname(__file__), "..", "asva_tpu_torch")


def randomize(params, rng, scale=0.2):
    """Every leaf redrawn around its init: kernels get fan-in normal noise,
    vectors 0.1-scale noise, so zero-init leaves contribute too."""
    def draw(a):
        a = np.asarray(a)
        if a.ndim >= 2:
            std = scale / np.sqrt(np.prod(a.shape[:-1]))
        else:
            std = 0.1
        return jnp.asarray(a + std * rng.standard_normal(a.shape), a.dtype)
    return jax.tree.map(draw, params)


def port(module, params, key_map=unet_key_map):
    """Load JAX params into the torch module (strict) and return it."""
    load_exported(module, export_state_dict(params, key_map))
    return module.eval()


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, want, tol):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), atol=tol, rtol=tol)


# ---------------------------------------------------------------- rules ---

def test_port_imports_no_jax():
    """asva_tpu_torch — every sub-package, training/, eval/ and data/
    included — never imports jax, flax, optax, orbax or asva_tpu."""
    pat = re.compile(
        r"^\s*(import|from)\s+(jax|flax|optax|orbax|asva_tpu)(\.|\s|$)", re.M)
    offenders, seen = [], set()
    for root, _, files in os.walk(PKG):
        for name in files:
            if name.endswith(".py"):
                path = os.path.join(root, name)
                seen.add(os.path.relpath(path, PKG))
                with open(path) as f:
                    if pat.search(f.read()):
                        offenders.append(path)
    assert offenders == []
    assert {os.path.join("training", n) for n in
            ("__init__.py", "optim.py", "animation_trainer.py",
             "checkpoint.py")} <= seen
    assert {os.path.join(*n.split("/")) for n in
            ("ops/flat_attention.py", "ops/resize.py", "data/transforms.py",
             "models/avsync/classifier.py", "models/evalnets/i3d.py",
             "models/evalnets/inception_v3.py", "models/clip_text.py",
             "models/clip_bpe.py", "models/imagebind_extra.py",
             "eval/metrics.py", "eval/frechet.py", "eval/harness.py",
             "tools/attn_experiments.py", "tools/mha_phase_bench.py",
             "training/sync_trainer.py", "config.py", "observability.py",
             "utils.py", "ops/resample.py", "ops/variants.py",
             "data/multipair.py", "data/media.py", "data/datasets.py",
             "pipelines/generate.py", "convert.py", "scripts/__init__.py",
             "scripts/common.py", "scripts/animation_demo.py",
             "scripts/animation_gen.py", "scripts/animation_eval.py",
             "scripts/avsync_metric.py", "data/loader.py",
             "parallel/__init__.py", "parallel/multihost.py",
             "parallel/mesh.py", "parallel/reduce.py",
             "parallel/sharding.py",
             "scripts/animation_serve.py", "scripts/animation_train.py",
             "scripts/avsync_train.py", "scripts/avsync_eval.py")} <= seen
    # the media layer builds the port's own copy of its C++ source
    from asva_tpu_torch.data import media
    assert os.path.samefile(os.path.dirname(media.SOURCE),
                            os.path.join(PKG, "csrc"))
    # chip_smoke.py and the port also stay clear of the repo's tools/ (they
    # import JAX at their top)
    tools = re.compile(r"^\s*(import|from)\s+tools(\.|\s|$)", re.M)
    root = os.path.dirname(PKG)
    paths = [os.path.join(PKG, rel) for rel in seen]
    paths.append(os.path.join(root, "chip_smoke.py"))
    for path in paths:
        with open(path) as f:
            text = f.read()
        assert not tools.search(text), path
        if path.endswith("chip_smoke.py"):
            assert not pat.search(text), path


def test_kernel_table_names_every_source_once():
    """cuda_build keeps one table: every source of csrc/ is a row, every
    row's headers exist, every entry point is declared extern "C" in its
    source with as many parameters as the table has argtypes."""
    from asva_tpu_torch.ops import cuda_build
    csrc = cuda_build.CSRC
    on_disk = {n[:-3] for n in os.listdir(csrc) if n.endswith(".cu")}
    assert set(cuda_build.SOURCES) == on_disk == set(cuda_build.KERNEL_TABLE)
    for name, (headers, entries) in cuda_build.KERNEL_TABLE.items():
        with open(os.path.join(csrc, f"{name}.cu")) as f:
            text = f.read()
        for header in headers:
            assert os.path.isfile(os.path.join(csrc, header))
            assert f'#include "{header}"' in text
        for entry, (argtypes, _) in entries.items():
            m = re.search(r'extern "C" [\w\s\*]+?\b%s\(([^)]*)\)' % entry,
                          text)
            assert m, (name, entry)
            assert len(m.group(1).split(",")) == len(argtypes), entry
    assert os.path.basename(cuda_build._lib_path("gemm")).startswith("libgemm_")


# ---------------------------------------------------------------- norms ---

@pytest.mark.parametrize("kind,shape", [
    ("video", (2, 3, 4, 4, 16)),
    ("spatial", (2, 3, 4, 4, 16)),
    ("spatial", (3, 4, 4, 16)),
])
def test_group_norms(rng, kind, shape):
    """fp32 E[x^2]-E[x]^2 group stats, 2e-5: only summation order differs."""
    from asva_tpu.ops import norms as jn
    from asva_tpu_torch.ops import norms as tn
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    jcls, tcls = ((jn.VideoGroupNorm, tn.VideoGroupNorm) if kind == "video"
                  else (jn.SpatialGroupNorm, tn.SpatialGroupNorm))
    jm = jcls(4, 1e-6)
    p = randomize(jm.init(jax.random.PRNGKey(0), x), rng)
    tm = port(tcls(4, shape[-1], 1e-6), p)
    close(tm(t(x)), jm.apply(p, x), 2e-5)


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_layer_norms(rng, eps):
    """LayerNormParams / AdaptiveOrLayerNorm, fp32 stats, 2e-5."""
    from asva_tpu.ops import norms as jn
    from asva_tpu_torch.ops import norms as tn
    x = rng.standard_normal((5, 7, 24)).astype(np.float32) * 2
    for jm, tm in ((jn.LayerNormParams(24, eps), tn.LayerNormParams(24, eps)),
                   (jn.AdaptiveOrLayerNorm(eps),
                    tn.AdaptiveOrLayerNorm(24, eps))):
        p = randomize(jm.init(jax.random.PRNGKey(0), x), rng)
        close(port(tm, p)(t(x)), jm.apply(p, x), 2e-5)


# ------------------------------------------------------------ attention ---

@pytest.mark.parametrize("masked", [False, True])
def test_dot_product_attention(rng, masked):
    """Broadcast K/V over a leading axis and an optional mask; 2e-5."""
    from asva_tpu.ops.attention import dot_product_attention as jattn
    from asva_tpu_torch.ops.attention import dot_product_attention as tattn
    q = rng.standard_normal((2, 3, 5, 4, 8)).astype(np.float32)
    k = rng.standard_normal((2, 1, 7, 4, 8)).astype(np.float32)
    v = rng.standard_normal((2, 1, 7, 4, 8)).astype(np.float32)
    mask = (rng.random((2, 3, 1, 1, 7)) > 0.4) if masked else None
    if masked:
        mask[..., 0] = True
    want = jattn(q, k, v, None if mask is None else jnp.asarray(mask))
    got = tattn(t(q), t(k), t(v), None if mask is None else t(mask))
    close(got, want, 2e-5)


# ----------------------------------------------------------- embeddings ---

@pytest.mark.parametrize("dim,flip,shift", [(32, True, 0.0), (33, False, 1.0)])
def test_sinusoidal_embedding(dim, flip, shift):
    """Same fp64-folded frequencies; sin/cos of fp32, 1e-5 at |t| <= 999."""
    from asva_tpu.models.embeddings import sinusoidal_timestep_embedding as je
    from asva_tpu_torch.models.embeddings import \
        sinusoidal_timestep_embedding as te
    ts = np.array([0, 1, 17, 500, 999], np.int32)
    close(te(t(ts), dim, flip, shift), je(jnp.asarray(ts), dim, flip, shift),
          1e-5)


def test_timestep_embedding(rng):
    """2-layer SiLU MLP, 2e-5."""
    from asva_tpu.models.embeddings import TimestepEmbedding as J
    from asva_tpu_torch.models.embeddings import TimestepEmbedding as T
    x = rng.standard_normal((3, 16)).astype(np.float32)
    jm = J(24)
    p = randomize(jm.init(jax.random.PRNGKey(0), x), rng)
    close(port(T(16, 24), p)(t(x)), jm.apply(p, x), 2e-5)


# ------------------------------------------------------------------ mel ---

@pytest.mark.parametrize("length", [32000, 40000, 20000])
def test_waveform_to_mel(rng, length):
    """Kaldi fbank + crop/pad + normalisation.  1e-3 absolute on a log-mel
    normalised by 9.138: the two FFTs (pocketfft vs XLA) differ in the last
    fp32 bits of power spectra spanning ~1e-7..1e3."""
    from asva_tpu.ops.mel import waveform_to_mel as jmel
    from asva_tpu_torch.ops.mel import waveform_to_mel as tmel
    wave = (rng.standard_normal((2, length)) * 0.1).astype(np.float32)
    got = tmel(t(wave))
    assert got.shape == (128, 204, 1)
    close(got, jmel(jnp.asarray(wave)), 1e-3)


# ------------------------------------------------------------- samplers ---

@pytest.mark.parametrize("kind,steps", [("ddim", 5), ("ddim", 25),
                                        ("ddim", 50), ("plms", 5),
                                        ("plms", 25), ("plms", 50)])
def test_samplers_replay_goldens(kind, steps):
    """Replay tests/fixtures/scheduler_goldens.npz through the port's plans
    and steps: timesteps exact, latents 1e-5 (fp32 state)."""
    from asva_tpu_torch.diffusion.samplers import (ddim_plan, init_state,
                                                   plan_row_arrays, plms_plan,
                                                   sampler_step)
    from asva_tpu_torch.diffusion.schedules import DiffusionSchedule
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
    from make_scheduler_goldens import fake_eps, initial_latents
    goldens = np.load(os.path.join(os.path.dirname(__file__), "fixtures",
                                   "scheduler_goldens.npz"))
    plan = (ddim_plan if kind == "ddim" else plms_plan)(DiffusionSchedule(),
                                                        steps)
    np.testing.assert_array_equal(
        plan.t_model, goldens[f"{kind}_{steps}_timesteps"].astype(np.int32))
    traj = goldens[f"{kind}_{steps}_latents"]
    state = init_state(plan, t(initial_latents()))
    for i, row in enumerate(plan_row_arrays(plan)):
        eps = fake_eps(state.latents.numpy(), int(row["t_model"]))
        state = sampler_step(plan.kind, row, state, t(eps))
        close(state.latents, traj[i + 1], 1e-5)


@pytest.mark.parametrize("kind,pred", [("ddim", "epsilon"),
                                       ("ddim", "v_prediction"),
                                       ("plms", "epsilon")])
def test_sampler_plans_and_steps_match_jax(rng, kind, pred):
    """Plans equal the JAX plans; steps with frame 0 pinned match, 1e-5."""
    from asva_tpu.diffusion import samplers as js
    from asva_tpu.diffusion.schedules import DiffusionSchedule as JS
    from asva_tpu_torch.diffusion import samplers as ts
    from asva_tpu_torch.diffusion.schedules import DiffusionSchedule as TS
    jplan = getattr(js, f"{kind}_plan")(JS(prediction_type=pred), 7)
    tplan = getattr(ts, f"{kind}_plan")(TS(prediction_type=pred), 7)
    for name in ("t_model", "sqrt_ac_t", "sqrt_ac_prev", "ac_t", "ac_prev",
                 "ets_weights", "append_flag", "use_cur_sample",
                 "store_cur_sample"):
        np.testing.assert_array_equal(getattr(tplan, name),
                                      getattr(jplan, name))
    lat = rng.standard_normal((1, 4, 2, 2, 3)).astype(np.float32)
    sl = slice(1, None)
    jstate = js.init_state(jplan, jnp.asarray(lat), sl)
    tstate = ts.init_state(tplan, t(lat), sl)
    jrows = js.plan_row_arrays(jplan)
    for i, trow in enumerate(ts.plan_row_arrays(tplan)):
        eps = rng.standard_normal((1, 3, 2, 2, 3)).astype(np.float32)
        jrow = jax.tree.map(lambda a: a[i], jrows)
        jstate = js.sampler_step(kind, jrow, jstate, jnp.asarray(eps), sl,
                                 pred)
        tstate = ts.sampler_step(kind, trow, tstate, t(eps), sl, pred)
        close(tstate.latents, jstate.latents, 1e-5)
        assert np.array_equal(tstate.latents[:, 0].numpy(), lat[:, 0])
