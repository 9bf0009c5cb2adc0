"""Generation across processes and FSDP training on the CPU: the
pipeline's (data, seq) mesh, `parallel/sharding.py`, the FSDP step, its
optimizer state and its checkpoints.

One pair of gloo ranks runs every two-rank job, as
tests/test_torch_parallel.py starts its pairs (this file run as a script,
`python tests/test_torch_parallel_gen.py <dir>`, torchrun's variables on a
free localhost port): generation at data 2 and at seq 2 (8 frames, 4 a
rank), two FSDP steps at fsdp 2 beside two data-parallel steps, an fsdp-2
checkpoint and its restore at fsdp 2, and the train CLI at --fsdp 2 beside
data parallelism.  The tests hold the ranks' results against one process
of the port, against asva_tpu's unsharded pipeline with JAX's noise draws,
and against each other.  Tiny configs, fp32, one thread a process."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_torch_parallel as tp
from asva_tpu_torch.parallel import sharding
from asva_tpu_torch.parallel.mesh import FrameShard, Mesh

torch.set_num_threads(1)

F_GEN, B_GEN, STEPS = 8, 2, 2          # frames, clips, DDIM steps
GEN_KW = dict(video_length=F_GEN, num_inference_steps=STEPS, sampler="ddim",
              audio_guidance_scale=4.0)
MIN_SIZE = 2 ** 10                     # tests/test_training.py:70


# ---------------------------------------------------- shared by both sides ---

def port_pipeline(weights, mesh=None):
    """The tiny port pipeline of `weights` (the three modules' state dicts
    and the null text encoding)."""
    from asva_tpu_torch.models.imagebind_audio import (
        ImageBindAudioConfig, SegmaskAudioEncoder)
    from asva_tpu_torch.models.unet3d import AudioUNet3D, UNet3DConfig
    from asva_tpu_torch.models.vae import AutoencoderKL, VAEConfig
    from asva_tpu_torch.pipelines.animation import AnimationPipeline
    modules = (AudioUNet3D(UNet3DConfig.tiny(audio_cross_attention_dim=32)),
               AutoencoderKL(VAEConfig.tiny()),
               SegmaskAudioEncoder(ImageBindAudioConfig.tiny(),
                                   n_segment=F_GEN))
    for m, name in zip(modules, ("unet", "vae", "audio")):
        m.load_state_dict(weights[name])
        m.eval()
    return AnimationPipeline(*modules, null_text_encoding=weights["null"],
                             mesh=mesh)


def clip(w, i):
    """`w` with the inputs and noise of clip i alone."""
    return dict(w, **{k: w[k][i:i + 1] for k in (
        "images", "mels", "text", "vae_noise", "latent_noise")})


def generate(pipe, w, decode):
    return pipe(w["images"], w["mels"], w["text"], vae_noise=w["vae_noise"],
                latent_noise=w["latent_noise"], decode=decode, **GEN_KW)


def fsdp_state(mesh):
    """test_torch_parallel's tiny trainer with its UNet split over the fsdp
    axis of `mesh` (MIN_SIZE) and the optimizer built on the shards."""
    from asva_tpu_torch.training import TrainState, build_optimizer
    trainer, state = tp.tiny_animation_trainer()
    sharding.shard_module(state.unet, sharding.fsdp_shardings(
        state.unet, mesh, MIN_SIZE), mesh)
    return trainer, TrainState(0, state.unet, build_optimizer(state.unet,
                                                              tp.LR))


def two_steps(trainer, state, mesh=None, rows=slice(None)):
    """Steps 1-2 on micro-batches 0-1 (accumulation 1): the ranks' mean
    losses."""
    from asva_tpu_torch.parallel.reduce import all_reduce_mean_
    losses = []
    for micro in range(2):
        loss = trainer.train_step(
            state, tp.animation_batch(micro, rows),
            torch.Generator().manual_seed(100 + micro), mesh=mesh)
        loss = loss.reshape(1).clone()
        all_reduce_mean_([loss], mesh)
        losses.append(float(loss))
    return losses


@torch.no_grad()
def next_loss(trainer, mesh=None, rows=slice(None)):
    """The loss of micro-batch 2 (the step after a checkpoint-2), the
    ranks' mean."""
    from asva_tpu_torch.parallel.reduce import all_reduce_mean_
    loss = trainer.loss_fn(tp.animation_batch(2, rows),
                           torch.Generator().manual_seed(102),
                           mesh=mesh).reshape(1).clone()
    all_reduce_mean_([loss], mesh)
    return float(loss)


# ------------------------------------------------------------ rank jobs ---

def case_generation(out, rank):
    from asva_tpu_torch.parallel import make_gen_mesh
    w = torch.load(os.path.join(out, "gen.pt"), weights_only=True)
    res = {}
    for seq in (1, 2):
        mesh = make_gen_mesh("cpu", seq=seq)
        pipe = port_pipeline(w, mesh)
        got = {"latents": generate(pipe, w, False),
               "videos": generate(pipe, w, True)}
        torch.save(got, os.path.join(out, f"gen_seq{seq}.{rank}.pt"))
        res[seq] = dict(data=mesh.size("data"), seq=mesh.size("seq"),
                        coords=list(mesh.coords))
    return res


def case_fsdp(out, rank):
    """Two data-parallel steps and two FSDP steps (fsdp 2) from the same
    init; each state in full (rank 0 writes it: the fsdp-2 checkpoint);
    the next loss at fsdp 2, live and after a restore at fsdp 2."""
    from asva_tpu_torch.parallel import make_mesh
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    rows = slice(rank * tp.ANIM_B // 2, (rank + 1) * tp.ANIM_B // 2)
    dp = make_mesh("cpu")
    trainer, state = tp.tiny_animation_trainer()
    dp_losses = two_steps(trainer, state, dp, rows)
    dp_full = state.state_dict()
    mesh = make_mesh("cpu", fsdp=2)
    trainer, state = fsdp_state(mesh)
    split = {n: getattr(p, sharding.SPEC).dim
             for n, p in state.unet.named_parameters()
             if sharding.is_sharded(p)}
    fsdp_losses = two_steps(trainer, state, mesh, rows)
    full = state.state_dict()
    ckpt = CheckpointManager(os.path.join(out, "ckpts"))
    ckpt.save(2, full, force=True)
    if rank == 0:
        torch.save(dp_full, os.path.join(out, "dp_state.pt"))
    live = next_loss(trainer, mesh, rows)
    trainer2, state2 = fsdp_state(mesh)
    state2.load_state_dict(ckpt.restore(2))
    return dict(dp_losses=dp_losses, fsdp_losses=fsdp_losses,
                next_loss=live, restored_next_loss=next_loss(trainer2, mesh,
                                                             rows),
                split_dims=split, fsdp=mesh.size("fsdp"),
                data=mesh.size("data"))


def case_cli(out, rank):
    """animation_train at --fsdp 2 and at --fsdp 1, 2 steps each."""
    from asva_tpu_torch.scripts import animation_train
    tp._tiny_towers()
    with open(os.path.join(out, "spec.json")) as f:
        spec = json.load(f)
    res = {}
    for fsdp in (2, 1):
        run = animation_train.main(["--config_file", spec[f"fsdp{fsdp}"],
                                    "--max_steps_override", "2",
                                    "--device", "cpu", "--fsdp", str(fsdp)])
        res[fsdp] = dict(losses=run["losses"], step=run["state"].step)
    return res


JOBS = (case_generation, case_fsdp, case_cli)


def rank_main(out):
    import torch.distributed as dist

    from asva_tpu_torch.parallel import multihost
    multihost.maybe_initialize_distributed("cpu")
    rank = dist.get_rank()
    with open(os.path.join(out, "spec.json")) as f:
        jobs = json.load(f)["jobs"]
    res = {case.__name__: case(out, rank) for case in JOBS
           if case.__name__ in jobs}
    with open(os.path.join(out, f"ranks.{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


# ----------------------------------------------------------- the pair ---

@pytest.fixture(scope="module")
def gen_weights():
    """The port's tiny modules on seeded random weights, the same weights
    as asva_tpu trees (asva_tpu's converter into trees shaped by
    jax.eval_shape: no JAX init is compiled), asva_tpu's pipeline, the
    inputs and JAX's two noise draws."""
    import jax
    import jax.numpy as jnp
    from asva_tpu.convert.torch_to_jax import (convert_state_dict,
                                               imagebind_audio_key_map,
                                               unet_key_map, vae_key_map)
    from asva_tpu.models.imagebind_audio import (ImageBindAudioConfig as JAC,
                                                 SegmaskAudioEncoder as JAE)
    from asva_tpu.models.unet3d import AudioUNet3D as JU, UNet3DConfig as JC
    from asva_tpu.models.vae import AutoencoderKL as JV, VAEConfig as JVC
    from asva_tpu.pipelines.animation import AnimationPipeline as JP
    from asva_tpu_torch import runtime
    from asva_tpu_torch.models.imagebind_audio import (
        ImageBindAudioConfig as TAC)
    from asva_tpu_torch.models.unet3d import UNet3DConfig as TC
    from asva_tpu_torch.models.vae import VAEConfig as TVC
    cpu = dict(device="cpu", dtype=torch.float32, randomize_all=True)
    torch_modules = {
        "unet": runtime.build_unet(TC.tiny(audio_cross_attention_dim=32),
                                   seed=1, **cpu),
        "vae": runtime.build_vae(TVC.tiny(), seed=2, **cpu),
        "audio": runtime.build_audio_encoder(F_GEN, TAC.tiny(), seed=3,
                                             **cpu)}
    unet, vae = JU(JC.tiny()), JV(JVC.tiny())
    aud = JAE(JAC.tiny(), n_segment=F_GEN)
    key = jax.random.PRNGKey(0)
    shapes = {
        "unet": jax.eval_shape(
            unet.init, key, jnp.zeros((1, F_GEN, 8, 8, 4)),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1, 7, 768)),
            jnp.zeros((1, 229, 32)), jnp.ones((1, F_GEN, 229), bool)),
        "vae": jax.eval_shape(vae.init, key, jnp.zeros((1, 16, 16, 3)), key),
        "audio": jax.eval_shape(aud.init, key, jnp.zeros((1, 128, 204, 1)))}
    maps = {"unet": unet_key_map, "vae": vae_key_map,
            "audio": imagebind_audio_key_map}
    params = {}
    for name, module in torch_modules.items():
        state = {k: v.numpy() for k, v in module.state_dict().items()}
        params[name], report = convert_state_dict(shapes[name], state,
                                                  maps[name], strict=True)
        assert not report["unused"], report["unused"][:5]
    rng = np.random.default_rng(12)
    null = rng.standard_normal((1, 7, 768)).astype(np.float32)
    jpipe = JP(unet=unet, vae=vae, audio_encoder=aud,
               unet_params=params["unet"], vae_params=params["vae"],
               audio_encoder_params=params["audio"],
               null_text_encoding=jnp.asarray(null))
    images = rng.random((B_GEN, 16, 16, 3)).astype(np.float32)
    mels = rng.standard_normal((B_GEN, 128, 204, 1)).astype(np.float32)
    text = rng.standard_normal((B_GEN, 7, 768)).astype(np.float32)
    # the two draws of JAX's __call__ under PRNGKey(5), at the latents'
    # shape (b, 8, 8, 4)
    rng_vae, rng_noise = jax.random.split(jax.random.PRNGKey(5))
    vae_noise = jax.random.normal(rng_vae, (B_GEN, 8, 8, 4))
    latent_noise = jax.random.normal(rng_noise, (B_GEN, F_GEN - 1, 8, 8, 4))
    w = {name: m.state_dict() for name, m in torch_modules.items()}
    w.update(null=torch.from_numpy(null), images=torch.from_numpy(images),
             mels=torch.from_numpy(mels), text=torch.from_numpy(text),
             vae_noise=torch.from_numpy(np.array(vae_noise)),
             latent_noise=torch.from_numpy(np.array(latent_noise)))
    jargs = (jnp.asarray(images), jnp.asarray(mels), jnp.asarray(text))
    return w, jpipe, jargs, params["unet"]


@pytest.fixture(scope="module")
def ranks(gen_weights, tmp_path_factory):
    """Both ranks' results, the job directory and one process's
    generation (latents, videos), computed while the ranks run."""
    out = tmp_path_factory.mktemp("gen_ranks")
    w = gen_weights[0]
    torch.save(w, out / "gen.pt")
    jobs = ["case_generation", "case_fsdp"]
    spec = {"jobs": jobs}
    if tp.media.headers_available():
        jobs.append("case_cli")
        tp._write_clips(str(out / "clips"))
        for fsdp in (2, 1):
            path = out / f"fsdp{fsdp}.yaml"
            path.write_text(tp._animation_yaml(out / "clips",
                                               out / f"cli{fsdp}", 999))
            spec[f"fsdp{fsdp}"] = str(path)
    (out / "spec.json").write_text(json.dumps(spec))
    started = _start(out)
    one = port_pipeline(w)
    solo = {"latents": generate(one, w, False),
            "videos": generate(one, w, True)}
    # one clip a call: what each rank of the data-2 mesh computes
    solo["latents_per_clip"] = torch.cat([
        generate(one, clip(w, i), False) for i in range(B_GEN)])
    _, jpipe, jargs, _ = gen_weights
    import jax
    solo["jax_videos"] = np.asarray(jpipe(*jargs, rng=jax.random.PRNGKey(5),
                                          **GEN_KW))
    results = _wait(out, started)
    return results, out, solo


def _start(out, script=__file__):
    """The pair of ranks, each `script` run with `out` (this file's
    rank_main by default)."""
    env = dict(os.environ, PYTHONPATH=tp.REPO, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(tp._free_port()), WORLD_SIZE="2",
               LOCAL_WORLD_SIZE="2", OMP_NUM_THREADS="1")
    procs = []
    for rank in range(2):
        env.update(RANK=str(rank), LOCAL_RANK=str(rank))
        with open(os.path.join(out, f"ranks.{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(script), str(out)],
                env=dict(env), stdout=log, stderr=subprocess.STDOUT))
    return procs, time.monotonic()


def _wait(out, started):
    """tests/test_torch_parallel.py's wait: a rank that fails or outlives
    its TIMEOUT_S kills the pair and fails with its output's end."""
    procs, t0 = started
    for rank, p in enumerate(procs):
        try:
            p.wait(timeout=max(1.0, tp.TIMEOUT_S - (time.monotonic() - t0)))
            failed = p.returncode != 0 and f"exit {p.returncode}"
        except subprocess.TimeoutExpired:
            failed = f"did not end in {tp.TIMEOUT_S} s"
        if failed:
            for q in procs:
                q.kill()
                q.wait()
            with open(os.path.join(out, f"ranks.{rank}.log")) as f:
                tail = f.read()[-3000:]
            pytest.fail(f"rank {rank} {failed}:\n{tail}")
    results = []
    for rank in range(2):
        with open(os.path.join(out, f"ranks.{rank}.json")) as f:
            results.append(json.load(f))
    return results


def _gen(out, seq, rank):
    return torch.load(out / f"gen_seq{seq}.{rank}.pt", weights_only=True)


# ---------------------------------------------------------------- tests ---

@pytest.mark.parametrize("seq", [1, 2])
def test_sharded_generation_equals_one_process(ranks, seq):
    """data 2 (a clip a rank) and seq 2 (4 frames a rank): every rank
    returns the global latents and videos, both ranks the same.  At data 2
    the latents are those of one process called clip by clip, bit for bit;
    against one process's batch-2 call they are within 1e-5 *
    max(1, max|latents|), the distance of those two one-process calls
    from each other (the CPU's products round by batch size)."""
    results, out, solo = ranks
    data = 2 // seq
    for rank in range(2):
        got = results[rank]["case_generation"][str(seq)]
        assert (got["data"], got["seq"]) == (data, seq)
        assert got["coords"] == [rank // seq, rank % seq]
    zero, one = _gen(out, seq, 0), _gen(out, seq, 1)
    for key in ("latents", "videos"):
        assert zero[key].shape == solo[key].shape
        assert torch.equal(zero[key], one[key])
    ref = solo["latents"]
    assert ref.shape == (B_GEN, F_GEN, 8, 8, 4)
    if seq == 1:
        assert torch.equal(zero["latents"], solo["latents_per_clip"])
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((zero["latents"] - ref).abs().max()) <= tol
    assert float((zero["videos"] - solo["videos"]).abs().max()) <= 1e-5


@pytest.mark.parametrize("seq", [1, 2])
def test_sharded_generation_equals_asva_tpu(ranks, seq):
    """The gathered videos against asva_tpu's unsharded AnimationPipeline
    on the same weights, inputs and JAX's noise, within
    test_torch_pipeline.py's tolerance (1e-4)."""
    from test_torch_ops import close
    _, out, solo = ranks
    close(_gen(out, seq, 0)["videos"], solo["jax_videos"], 1e-4)


def test_fsdp_steps_bit_equal_to_data_parallel(ranks):
    """Two steps at fsdp 2 (the tiny UNet's parameters of at least 2**10
    elements split, frozen ones too) end with the parameters, both moments
    and the count of two-rank data parallelism, bit for bit, and the same
    losses; within test_torch_parallel.py's tolerances of one process on
    the concatenated batch."""
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    results, out, _ = ranks
    zero, one = (r["case_fsdp"] for r in results)
    assert zero["fsdp"] == 2 and zero["data"] == 1
    assert zero["split_dims"] and zero["split_dims"] == one["split_dims"]
    assert zero["fsdp_losses"] == zero["dp_losses"] == one["fsdp_losses"]
    fsdp = CheckpointManager(str(out / "ckpts")).restore(2)
    dp = torch.load(out / "dp_state.pt", weights_only=True)
    assert fsdp["step"] == dp["step"] == 2
    assert set(fsdp["unet"]) == set(dp["unet"])
    assert all(torch.equal(fsdp["unet"][k], v) for k, v in dp["unet"].items())
    opt, want = fsdp["optimizer"], dp["optimizer"]
    assert opt["count"] == want["count"] == 2
    for m in ("mu", "nu"):
        assert all(torch.equal(opt[m][k], v) for k, v in want[m].items())
    trainer, state = tp.tiny_animation_trainer()
    losses = two_steps(trainer, state)
    for got, ref in zip(zero["fsdp_losses"], losses):
        assert abs(got - ref) <= 1e-6
    params = [fsdp["unet"][n] for n in state.optimizer.names]
    assert tp.rel_l2(params, state.optimizer.params) <= 1e-5


def test_fsdp_checkpoint_restores_at_fsdp_1_and_2(ranks):
    """The fsdp-2 checkpoint-2 holds the full state; restored at fsdp 1 in
    one process it gives the next loss of the fsdp-2 run (within 1e-6),
    and restored at fsdp 2 the same loss bit for bit."""
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    results, out, _ = ranks
    trainer, state = tp.tiny_animation_trainer()
    state.load_state_dict(CheckpointManager(str(out / "ckpts")).restore(2))
    assert state.step == 2 and state.optimizer.count == 2
    loss = next_loss(trainer)
    for res in results:
        got = res["case_fsdp"]
        assert got["restored_next_loss"] == got["next_loss"]
        assert abs(got["next_loss"] - loss) <= 1e-6


def test_animation_train_cli_fsdp_2(ranks):
    """torchrun's two ranks run animation_train --fsdp 2: two steps whose
    losses are within 1e-6 relative of the same run at --fsdp 1, and a
    checkpoint that holds the full UNet."""
    from asva_tpu_torch.training.checkpoint import CheckpointManager
    results, out, _ = ranks
    if "case_cli" not in results[0]:
        pytest.skip("libav development files missing")
    for res in results:
        got = res["case_cli"]
        assert got["2"]["step"] == got["1"]["step"] == 2
        for a, b in zip(got["2"]["losses"], got["1"]["losses"]):
            assert abs(a - b) <= 1e-6 * abs(b)
    split = CheckpointManager(str(out / "cli2" / "ckpts")).restore(2)
    whole = CheckpointManager(str(out / "cli1" / "ckpts")).restore(2)
    assert {k: v.shape for k, v in split["unet"].items()} == {
        k: v.shape for k, v in whole["unet"].items()}


# ------------------------------------------------------ one process ---

@pytest.mark.parametrize("fsdp", [2, 4])
def test_fsdp_shardings_match_asva_tpu(gen_weights, fsdp):
    """At min_size 2**10 the port splits the tiny UNet's parameters that
    asva_tpu's fsdp_shardings splits (torch names by the key map), every
    rank's block has 1/fsdp of the elements, and the blocks in order make
    the parameter."""
    import jax
    from asva_tpu.convert.torch_to_jax import unet_key_map
    from asva_tpu.parallel import make_mesh as jax_mesh
    from asva_tpu.parallel.sharding import fsdp_shardings as jax_shardings
    from asva_tpu_torch.models.unet3d import AudioUNet3D, UNet3DConfig
    params = gen_weights[3]
    specs = jax_shardings(params, jax_mesh(8, fsdp=fsdp), min_size=MIN_SIZE)
    want = set()
    for path, s in jax.tree_util.tree_flatten_with_path(specs)[0]:
        if any(a is not None for a in s.spec):
            key = unet_key_map(tuple(str(getattr(k, "key", k))
                                     for k in path))
            want.add(key[0] if isinstance(key, list) else key)
    unet = AudioUNet3D(UNet3DConfig.tiny(audio_cross_attention_dim=32))
    mesh = Mesh(axes=("data", "fsdp"), sizes=(1, fsdp))
    split = {n: d for n, d in sharding.fsdp_shardings(
        unet, mesh, MIN_SIZE).items() if d is not None}
    assert set(split) == want and want
    full = dict(unet.named_parameters())
    for name, dim in split.items():
        blocks = []
        for i in range(fsdp):
            spec = sharding.ShardSpec(dim, tuple(full[name].shape), fsdp, i,
                                      None, 1, None)
            blocks.append(spec.block(full[name].detach()))
        assert {b.numel() for b in blocks} == {full[name].numel() // fsdp}
        assert torch.equal(torch.cat(blocks, dim), full[name].detach())


def test_meshes_refuse_sizes_that_do_not_divide():
    from asva_tpu_torch.parallel import make_gen_mesh, make_mesh
    for make, n in ((make_mesh, 2), (make_gen_mesh, 3), (make_gen_mesh, 0)):
        with pytest.raises(ValueError, match="does not divide the 1"):
            make("cpu", n)
    one = make_gen_mesh("cpu")
    assert (one.size("data"), one.size("seq"), one.size("fsdp")) == (1, 1, 1)
    assert one.frame_shard(12) is None and make_mesh("cpu").world == 1


def test_pipeline_refuses_batch_or_frames_that_do_not_divide(gen_weights):
    """A mesh of data 2 refuses an odd batch, one of seq 2 an odd frame
    count, before any collective; an fsdp mesh is refused."""
    w = gen_weights[0]
    rows = {k: w[k][:1].expand((3,) + w[k].shape[1:])
            for k in ("images", "mels", "text")}
    data2 = port_pipeline(w, Mesh(axes=("data", "seq"), sizes=(2, 1)))
    with pytest.raises(ValueError, match="batch 3 must divide by the "
                                         "mesh's data size 2"):
        data2(rows["images"], rows["mels"], rows["text"], **GEN_KW)
    seq2 = port_pipeline(w, Mesh(axes=("data", "seq"), sizes=(1, 2)))
    with pytest.raises(ValueError, match="video_length 7 .* seq size 2"):
        seq2(w["images"], w["mels"], w["text"],
             **dict(GEN_KW, video_length=7))
    with pytest.raises(ValueError, match="make_gen_mesh"):
        port_pipeline(w, Mesh(axes=("data", "fsdp"), sizes=(1, 2)))


def test_unet_frame_context_of_one_rank_is_the_plain_forward(
        gen_weights, monkeypatch):
    """The frame-sharded UNet on one seq rank (its exchanges replaced by
    what they give a group of one) computes the forward without a context
    bit for bit, and the context refuses a forward that builds a graph."""
    from asva_tpu_torch.parallel import reduce
    w = gen_weights[0]
    unet = port_pipeline(w).unet
    monkeypatch.setattr(reduce, "broadcast_frame0",
                        lambda x, g: x[:, :1].clone())
    monkeypatch.setattr(reduce, "prev_frame_halo",
                        lambda x, g: x[:, -1:].clone())
    monkeypatch.setattr(reduce, "all_gather_frames", lambda x, g: x)
    import asva_tpu_torch.ops.norms as norms
    monkeypatch.setattr(norms, "all_reduce_sum", lambda x, g: x.clone())
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, F_GEN, 4, 4, 4)).astype(
        np.float32))
    text = w["text"]
    audio = torch.from_numpy(rng.standard_normal((2, 229, 32)).astype(
        np.float32))
    from asva_tpu_torch.models.imagebind_audio import segment_token_indices
    from asva_tpu_torch.models.imagebind_audio import ImageBindAudioConfig
    idx = segment_token_indices(F_GEN, ImageBindAudioConfig.tiny().patch_grid)
    t = torch.tensor([10, 500])
    frames = FrameShard(None, 1, 0, 0)
    with torch.no_grad():
        for fuse in (False, True):
            plain = unet(x, t, text, audio, audio_token_indices=idx,
                         fuse_blocks=fuse)
            ctx = unet(x, t, text, audio, audio_token_indices=idx,
                       fuse_blocks=fuse, frames=frames)
            assert torch.equal(plain, ctx)
    with pytest.raises(RuntimeError, match="without gradients"):
        unet(x, t, text, audio, audio_token_indices=idx, frames=frames)


if __name__ == "__main__":
    rank_main(sys.argv[1])
