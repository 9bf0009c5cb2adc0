"""The port's meshes at four ranks on the CPU: generation at seq 4 (the
interior seq ranks 1 and 2 take a halo and hand one on) and at data 2 x
seq 2, FSDP steps at fsdp 4 and at data 2 x fsdp 2 (both mesh axes above
1), beside data parallelism at data 4.

One job of four gloo ranks runs per module (this file run as a script,
`python tests/test_torch_parallel4.py <dir>`, torchrun's variables on a
free localhost port, one thread a process), as
tests/test_torch_parallel_gen.py starts its pair, with the same tiny
pipeline, inputs and JAX noise draws (its `gen_weights`).  The tests hold
the ranks' results against one process of the port, against asva_tpu's
unsharded pipeline and against the data-4 steps.  The one-process cases
check the rule that picks NCCL with a card a rank (torch.cuda.device_count
monkeypatched) and the subgroup blocks of the 2-D meshes against
asva_tpu's device grids."""
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import test_torch_parallel as tp
import test_torch_parallel_gen as tg
from test_torch_parallel_gen import gen_weights  # noqa: F401 (fixture)

torch.set_num_threads(1)

RANKS = 4
# generation meshes: name -> seq size (data = RANKS // seq); the training
# meshes: name -> fsdp size, beside data 4 (fsdp 1)
GEN_MESHES = {"seq4": 4, "data2_seq2": 2}
FSDP_MESHES = {"fsdp4": 4, "data2_fsdp2": 2}


# ------------------------------------------------------------ rank jobs ---

def case_generation(out, rank):
    """Each generation mesh's latents and videos (the global ones, on
    every rank) and this rank's place on it."""
    from asva_tpu_torch.parallel import make_gen_mesh
    w = torch.load(os.path.join(out, "gen.pt"), weights_only=True)
    res = {}
    for name, seq in GEN_MESHES.items():
        mesh = make_gen_mesh("cpu", seq=seq)
        pipe = tg.port_pipeline(w, mesh)
        torch.save({"latents": tg.generate(pipe, w, False),
                    "videos": tg.generate(pipe, w, True)},
                   os.path.join(out, f"gen_{name}.{rank}.pt"))
        shard = mesh.frame_shard(tg.F_GEN)
        res[name] = dict(sizes=list(mesh.sizes), coords=list(mesh.coords),
                         offset=shard.offset)
    return res


def _shard_digest(state):
    """A hash of this rank's trainable tensors (FSDP: its blocks)."""
    import hashlib
    h = hashlib.sha256()
    for p in state.optimizer.params:
        h.update(p.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


def case_fsdp(out, rank):
    """Two steps at data 4, then from the same init two at each FSDP mesh;
    each state in full (rank 0 writes it), this rank's tensors' hash, the
    losses and the split."""
    from asva_tpu_torch.parallel import make_mesh, sharding
    rows = slice(rank * tp.ANIM_B // RANKS, (rank + 1) * tp.ANIM_B // RANKS)
    trainer, state = tp.tiny_animation_trainer()
    res = {"data4": dict(losses=tg.two_steps(trainer, state,
                                             make_mesh("cpu"), rows),
                         digest=_shard_digest(state))}
    states = {"data4": state.state_dict()}
    for name, fsdp in FSDP_MESHES.items():
        mesh = make_mesh("cpu", fsdp=fsdp)
        trainer, state = tg.fsdp_state(mesh)
        split = {n: getattr(p, sharding.SPEC).dim
                 for n, p in state.unet.named_parameters()
                 if sharding.is_sharded(p)}
        res[name] = dict(losses=tg.two_steps(trainer, state, mesh, rows),
                         digest=_shard_digest(state), split_dims=split,
                         sizes=list(mesh.sizes), coords=list(mesh.coords))
        states[name] = state.state_dict()
    if rank == 0:
        torch.save(states, os.path.join(out, "states.pt"))
    return res


def rank_main(out):
    import torch.distributed as dist

    from asva_tpu_torch.parallel import multihost
    multihost.maybe_initialize_distributed("cpu")
    rank = dist.get_rank()
    res = {case.__name__: case(out, rank)
           for case in (case_generation, case_fsdp)}
    with open(os.path.join(out, f"ranks.{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


# -------------------------------------------------------- the four ranks ---

def _start(out):
    env = dict(os.environ, PYTHONPATH=tp.REPO, MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(tp._free_port()), WORLD_SIZE=str(RANKS),
               LOCAL_WORLD_SIZE=str(RANKS), OMP_NUM_THREADS="1")
    procs = []
    for rank in range(RANKS):
        env.update(RANK=str(rank), LOCAL_RANK=str(rank))
        with open(os.path.join(out, f"ranks.{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), str(out)],
                env=dict(env), stdout=log, stderr=subprocess.STDOUT))
    return procs, time.monotonic()


def _wait(out, started):
    """A rank that fails or outlives tp.TIMEOUT_S kills the job and fails
    with its output's end."""
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
    for rank in range(RANKS):
        with open(os.path.join(out, f"ranks.{rank}.json")) as f:
            results.append(json.load(f))
    return results


@pytest.fixture(scope="module")
def ranks(gen_weights, tmp_path_factory):  # noqa: F811
    """The four ranks' results, the job directory and one process's
    generation and asva_tpu's videos, computed while the ranks run."""
    out = tmp_path_factory.mktemp("ranks4")
    w, jpipe, jargs, _ = gen_weights
    torch.save(w, out / "gen.pt")
    started = _start(out)
    one = tg.port_pipeline(w)
    solo = {"latents": tg.generate(one, w, False),
            "videos": tg.generate(one, w, True)}
    import jax
    solo["jax_videos"] = np.asarray(jpipe(*jargs, rng=jax.random.PRNGKey(5),
                                          **tg.GEN_KW))
    trainer, state = tp.tiny_animation_trainer()
    solo["losses"] = tg.two_steps(trainer, state)
    solo["params"] = {n: p.detach() for n, p in zip(state.optimizer.names,
                                                    state.optimizer.params)}
    return _wait(out, started), out, solo


def _gen(out, name, rank):
    return torch.load(out / f"gen_{name}.{rank}.pt", weights_only=True)


# ---------------------------------------------------------------- tests ---

@pytest.mark.parametrize("name", sorted(GEN_MESHES))
def test_generation_at_four_ranks_equals_one_process(ranks, name):
    """seq 4 (2 of 8 frames a rank) and data 2 x seq 2 (a clip a data
    rank, 4 frames a seq rank): every rank returns the global latents and
    videos, all four the same, within 1e-5 * max(1, max|latents|) of one
    process's batch-2 call; each rank's place and first frame are
    global."""
    results, out, solo = ranks
    seq = GEN_MESHES[name]
    for rank in range(RANKS):
        got = results[rank]["case_generation"][name]
        assert got["sizes"] == [RANKS // seq, seq]
        assert got["coords"] == [rank // seq, rank % seq]
        assert got["offset"] == (rank % seq) * (tg.F_GEN // seq)
    zero = _gen(out, name, 0)
    for rank in range(1, RANKS):
        other = _gen(out, name, rank)
        for key in ("latents", "videos"):
            assert torch.equal(zero[key], other[key])
    ref = solo["latents"]
    assert zero["latents"].shape == ref.shape == (tg.B_GEN, tg.F_GEN, 8, 8, 4)
    assert zero["videos"].shape == solo["videos"].shape
    tol = 1e-5 * max(1.0, float(ref.abs().max()))
    assert float((zero["latents"] - ref).abs().max()) <= tol
    assert float((zero["videos"] - solo["videos"]).abs().max()) <= 1e-5


@pytest.mark.parametrize("name", sorted(GEN_MESHES))
def test_generation_at_four_ranks_equals_asva_tpu(ranks, name):
    """The gathered videos against asva_tpu's unsharded AnimationPipeline
    on the same weights, inputs and JAX's noise (1e-4)."""
    from test_torch_ops import close
    _, out, solo = ranks
    close(_gen(out, name, 0)["videos"], solo["jax_videos"], 1e-4)


def _rel_l2(got: dict, want: dict) -> float:
    return tp.rel_l2([got[k] for k in want], list(want.values()))


@pytest.mark.parametrize("name", sorted(FSDP_MESHES))
def test_fsdp_steps_at_four_ranks_against_data4(ranks, name):
    """Two steps at fsdp 4 and at data 2 x fsdp 2 (a split parameter's
    gradient reduce-scattered over fsdp, then averaged over data) against
    two at data 4 from the same init: the ranks along data hold the same
    blocks bit for bit and the fsdp ranks different ones; data 4's losses
    within 1e-6 relative, its trainable parameters within 1e-6 and its
    moments within 1e-5 relative L2, its frozen parameters and count
    exactly; and one process on the whole batch within
    tests/test_torch_parallel_gen.py's tolerances.  Not bit for bit: gloo
    sums each element of a 4-rank all_reduce in an order set by its place
    in the buffer, and the data-4 gradients are reduced in one bucket, a
    split parameter's alone (at 2 ranks a + b = b + a, and fsdp 2 is
    bit-equal to data 2); the distance is about 2e-8 for the parameters
    and 5e-7 for the moments."""
    results, out, solo = ranks
    fsdp = FSDP_MESHES[name]
    zero = results[0]["case_fsdp"]
    for rank, res in enumerate(results):
        got = res["case_fsdp"]
        assert got[name]["sizes"] == [RANKS // fsdp, fsdp]
        assert got[name]["coords"] == [rank // fsdp, rank % fsdp]
        assert got[name]["split_dims"] == zero[name]["split_dims"]
        assert got[name]["split_dims"]
        assert got[name]["losses"] == zero[name]["losses"]
        assert got["data4"]["digest"] == zero["data4"]["digest"]
        same = [r["case_fsdp"][name]["digest"] for r in results
                if r["case_fsdp"][name]["coords"][1] == rank % fsdp]
        assert len(same) == RANKS // fsdp and set(same) == {
            got[name]["digest"]}
    assert len({r["case_fsdp"][name]["digest"] for r in results}) == fsdp
    for a, b in zip(zero[name]["losses"], zero["data4"]["losses"]):
        assert abs(a - b) <= 1e-6 * abs(b)
    states = torch.load(out / "states.pt", weights_only=True)
    got, want = states[name], states["data4"]
    assert got["step"] == want["step"] == 2
    assert got["optimizer"]["count"] == want["optimizer"]["count"] == 2
    trainable = set(want["optimizer"]["mu"])
    assert set(got["unet"]) == set(want["unet"]) and trainable
    assert all(torch.equal(got["unet"][k], v)
               for k, v in want["unet"].items() if k not in trainable)
    assert _rel_l2(got["unet"], {k: want["unet"][k] for k in trainable}
                   ) <= 1e-6
    for m in ("mu", "nu"):
        assert _rel_l2(got["optimizer"][m], want["optimizer"][m]) <= 1e-5
    for a, b in zip(zero[name]["losses"], solo["losses"]):
        assert abs(a - b) <= 1e-6
    assert _rel_l2(got["unet"], solo["params"]) <= 1e-5


# ------------------------------------------------------ one process ---

@pytest.mark.parametrize("local_rank", range(RANKS))
def test_local_layout_picks_nccl_with_a_card_a_rank(monkeypatch, local_rank):
    """Four local ranks on four cards: NCCL, card LOCAL_RANK; on fewer
    cards they share them over gloo."""
    from asva_tpu_torch.parallel import multihost
    monkeypatch.setenv("LOCAL_RANK", str(local_rank))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(RANKS))
    for cards, backend in ((4, "nccl"), (8, "nccl"), (2, "gloo"),
                           (1, "gloo")):
        monkeypatch.setattr(torch.cuda, "device_count", lambda c=cards: c)
        assert multihost.local_layout("cuda") == (
            backend, f"cuda:{local_rank % cards}")


def test_nccl_init_binds_the_rank_card_and_a_gloo_host_group(monkeypatch):
    """maybe_initialize_distributed at rank 2 of four local ranks with four
    cards: the card becomes current, init_process_group takes NCCL with
    device_id cuda:2, a gloo host group is made; a failed init raises."""
    import torch.distributed as dist

    from asva_tpu_torch.parallel import multihost
    calls = {}
    monkeypatch.setenv("WORLD_SIZE", str(RANKS))
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(RANKS))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: RANKS)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.setdefault("current", d))
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.update(backend=backend,
                                                           **kw))

    def new_group(**kw):
        calls["host"] = kw
        return "host"
    monkeypatch.setattr(dist, "new_group", new_group)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: RANKS)
    monkeypatch.setattr(dist, "get_rank", lambda *a: 2)
    monkeypatch.setattr(multihost, "_HOST_GROUP", {})
    assert multihost.maybe_initialize_distributed("cuda")
    assert calls["current"] == "cuda:2" and calls["backend"] == "nccl"
    assert calls["device_id"] == torch.device("cuda:2")
    assert calls["init_method"] == "env://"
    assert calls["host"]["backend"] == "gloo"
    assert multihost._HOST_GROUP["group"] == "host"

    def refuse(backend, **kw):
        raise ValueError("no peer answered")
    monkeypatch.setattr(dist, "init_process_group", refuse)
    with pytest.raises(RuntimeError, match=r"init_process_group\('nccl'\) "
                                           "failed although WORLD_SIZE=4"):
        multihost.maybe_initialize_distributed("cuda")


@pytest.mark.parametrize("axis", ["fsdp", "seq"])
def test_mesh_blocks_at_data2_match_asva_tpu(monkeypatch, axis):
    """At four ranks and size 2 along `axis`, every rank makes the same
    subgroup blocks in the same order: the data axis's groups are the
    columns of asva_tpu's (data, axis) device grid (`make_mesh(4, fsdp=2)`
    / `make_gen_mesh(4, seq=2)`), the axis's groups its rows; each rank's
    coords are its place in that grid, and under seq its first frame is
    global."""
    import torch.distributed as dist

    from asva_tpu.parallel import make_gen_mesh as jax_gen_mesh
    from asva_tpu.parallel import make_mesh as jax_mesh
    from asva_tpu_torch.parallel import make_gen_mesh, make_mesh, mesh
    grid = (jax_mesh(4, fsdp=2) if axis == "fsdp"
            else jax_gen_mesh(4, seq=2)).devices
    ids = np.vectorize(lambda d: d.id)(grid)
    assert ids.shape == (2, 2)
    monkeypatch.setattr(mesh.multihost, "process_count", lambda: RANKS)
    monkeypatch.setattr(dist, "get_backend", lambda *a: "gloo")
    for rank in range(RANKS):
        made = []

        def subgroups(blocks, rank=rank):
            made.append(blocks)
            return next(b for b in blocks if rank in b)
        monkeypatch.setattr(mesh, "_subgroups", subgroups)
        monkeypatch.setattr(dist, "get_rank", lambda r=rank: r)
        m = (make_mesh("cpu", fsdp=2) if axis == "fsdp"
             else make_gen_mesh("cpu", seq=2))
        assert made == [ids.T.tolist(), ids.tolist()]
        assert m.axes == ("data", axis) and m.sizes == (2, 2)
        assert tuple(np.argwhere(ids == rank)[0]) == m.coords
        assert m.group("data") == ids[:, m.coords[1]].tolist()
        assert m.group(axis) == ids[m.coords[0]].tolist()
        if axis == "seq":
            assert m.frame_shard(12).offset == 6 * m.coords[1]


if __name__ == "__main__":
    rank_main(sys.argv[1])
