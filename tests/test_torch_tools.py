"""The kernel tools of the port: T1 `ln_attn_variant`, T2f `mha_fwd_grouped`,
T2b `mha_bwd_ordered` and the two tool scripts.

On the CPU the wrappers compute their plain versions, which are held here
against the JAX tools' own Pallas kernels (`run_variant`, `fwd_flat`,
`bwd_flat`) in TPU interpret mode; the JAX tools are loaded by path,
unchanged.  The CUDA kernels run only on a card: tests/test_torch_cuda.py
and chip_smoke.py."""
import importlib.util
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from asva_tpu_torch.ops import fused, variants
from asva_tpu_torch.tools import attn_experiments, mha_phase_bench

from test_torch_ops import close, t

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = list(variants.VARIANTS)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_attn():
    return _load_tool("attn_experiments")


@pytest.fixture(scope="module")
def jax_mha():
    return _load_tool("mha_phase_bench")


G, M, SK, C, H, BM = 1, 64, 32, 64, 2, 32


def _t1_inputs(seed=0):
    """x, ls, lb, wq (in, out), wo (in, out), bo, k, v as numpy fp32, in the
    JAX tool's layout and scale."""
    rng = np.random.default_rng(seed)
    r = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)  # noqa
    return [r(G, M, C) * 4, r(1, C) + 1.0, r(1, C), r(C, C) * 0.5,
            r(C, C) * 0.5, r(1, C), r(G, SK, C) * 3, r(G, SK, C)]


def _torch_args(args, dtype):
    x, ls, lb, wq, wo, bo, k, v = args
    return [t(a).to(dtype) for a in (x, ls, lb, wq.T, wo.T, bo, k, v)]


def test_variant_table_matches_the_jax_tool(jax_attn):
    assert NAMES == list(jax_attn.KERNELS)
    assert set(fused.LAUNCHES) >= {"T1", "T2F", "T2B"}


@pytest.mark.parametrize("name", NAMES)
def test_t1_plain_matches_pallas_interpret_fp32(jax_attn, name):
    """fp32, 3e-5: the plain version transcribes the Pallas body.
    v5_bf16exp rounds s - max and its exp to bf16 in both: 2e-2 (one
    bf16 step of an exponent near the cast flips an ulp of p)."""
    args = _t1_inputs()
    with pltpu.force_tpu_interpret_mode():
        want = jax_attn.run_variant(name, *[jnp.asarray(a) for a in args],
                                    1e-5, H, BM)
    got = variants.ln_attn_variant(name, *_torch_args(args, torch.float32),
                                   1e-5, H, BM)
    close(got, want, 2e-2 if name == "v5_bf16exp" else 3e-5)


@pytest.mark.parametrize("name", NAMES)
def test_t1_plain_matches_pallas_interpret_bf16(jax_attn, name):
    """bf16, within one bf16 ulp of max|out| (2**-7 relative): both round
    xn, q, P, each head's output and the result at the same places; the
    fp32 sums between them differ in order."""
    args = _t1_inputs(1)
    with pltpu.force_tpu_interpret_mode():
        want = jax_attn.run_variant(
            name, *[jnp.asarray(a, jnp.bfloat16) for a in args], 1e-5, H, BM)
    want = np.asarray(want.astype(jnp.float32))
    got = variants.ln_attn_variant(name, *_torch_args(args, torch.bfloat16),
                                   1e-5, H, BM).float().numpy()
    assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


def test_t1_classes_differ_where_they_should():
    """One class cannot stand in for all: in bf16 v4 (no softmax) is far from
    v0; v2 (round, then divide) differs from v0 (divide, then round) in some
    entry but by at most one ulp of max|out|; v9's rounded row sum differs
    from v2's; names of one class agree bit for bit."""
    args = _torch_args(_t1_inputs(2), torch.bfloat16)
    out = {n: variants.ln_attn_variant_plain(n, *args, 1e-5, H).float()
           for n in NAMES}
    ulp = 2.0 ** -7 * out["v0"].abs().max().item()
    assert (out["v4_mmfloor"] - out["v0"]).abs().max().item() > 20 * ulp
    d = (out["v2_postnorm"] - out["v0"]).abs().max().item()
    assert 0 < d <= ulp
    assert not torch.equal(out["v9_mxusum"], out["v2_postnorm"])
    assert not torch.equal(out["v5_bf16exp"], out["v2_postnorm"])
    for a, b in (("v0", "v1_phased"), ("v0", "v6_stacksm"), ("v0", "v8_pipe"),
                 ("v2_postnorm", "v3_both")):
        assert torch.equal(out[a], out[b])
    # v0's class is B1's plain version
    x, ls, lb, wq, wo, bo, k, v = args
    want = fused.ln_attn_plain(x, ls.reshape(-1), lb.reshape(-1), wq, wo,
                               bo.reshape(-1), k, v, 1e-5, H)
    assert torch.equal(out["v0"], want.float())


def test_t1_rejects_unknown_name_and_non_cpu_tensor():
    args = _torch_args(_t1_inputs(), torch.float32)
    with pytest.raises(KeyError):
        variants.ln_attn_variant("v10", *args, 1e-5, H, BM)
    with pytest.raises((ValueError, NotImplementedError, RuntimeError)):
        variants.ln_attn_variant("v0", args[0].to("meta"), *args[1:], 1e-5,
                                 H, BM)


def test_support_rules():
    """The stated instantiation rules: groups 1 and 2 and variants b0, b1,
    b2 at every head dim of the tools' shapes; the register rule excludes
    the rest."""
    for d in (40, 80, 160):
        assert variants.t2f_supported(d, 1) is None
        assert variants.t2f_supported(d, 2) is None
        for var in ("b0", "b1", "b2"):
            assert variants.t2b_supported(d, 8, var) is None
        assert variants.t2f_supported(d, 8) is not None
        assert variants.t2b_supported(d, 8, "b3") is not None
    assert variants.t2f_supported(40, 4) is None
    assert variants.t2f_supported(80, 4) is not None
    assert variants.t2b_supported(40, 8, "b4") is None
    assert variants.t2b_supported(80, 8, "b4") is not None
    assert variants.t2f_supported(36, 1) is not None
    assert variants.t1_supported(320, 8, 256) is None
    assert variants.t1_supported(640, 8, 256) is not None
    assert variants.t1_supported(320, 8, 96) is not None


@pytest.mark.parametrize("kernel,d,arg,supported", [
    ("t2f", 64, 4, True),      # group 4 up to head tile 64
    ("t2f", 48, 4, True),
    ("t2f", 160, 2, True),     # one warpgroup a block, two ring stages
    ("t2f", 160, 4, False),
    ("t2f", 96, 1, False),     # head tile 96 has no instantiation
    ("t2f", 40, 3, False),     # groups are 1, 2 or 4
    ("t2b", 64, (8, "b4"), True),
    ("t2b", 160, (8, "b2"), True),   # one stage, no ring
    ("t2b", 40, (6, "b4"), True),    # 4 heads a block, 6 heads: uneven
    ("t2b", 40, (4, "b3"), True),    # all 4 heads in one block
    ("t2b", 40, (2, "b3"), True),
    ("t2b", 40, (3, "b3"), False),   # 3 heads a block: no instantiation
    ("t2b", 80, (2, "b3"), True),
    ("t2b", 160, (4, "b3"), False),
])
def test_support_rule_edges(kernel, d, arg, supported):
    """Edges of the stated rules (groups / heads per block in {1, 2, 4},
    T2f group * (32 + tile / 2) <= 256, T2b heads * (64 + tile) <= 512): no
    case that the rules admitted before the kernels moved to wgmma is
    refused now."""
    if kernel == "t2f":
        why = variants.t2f_supported(d, arg)
    else:
        why = variants.t2b_supported(d, *arg)
    assert (why is None) == supported, why


def _t2_inputs(g, m, sk, hd, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((g, m, hd), (g, sk, hd), (g, sk, hd), (g, m, hd))]


@pytest.mark.parametrize("kv_len", [None, 20])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_t2f_plain_matches_fwd_flat_interpret(jax_mha, group, kv_len):
    """fp32, 3e-5 (B4's tolerance in test_torch_fused.py): o and lse for the
    group sizes 1, 2, H."""
    g, m, sk, hd, heads = 2, 64, 32, 64, 4
    q, k, v, _ = _t2_inputs(g, m, sk, hd)
    scale = 1.0 / (hd // heads) ** 0.5
    with pltpu.force_tpu_interpret_mode():
        want_o, want_lse = jax_mha.fwd_flat(jnp.asarray(q), jnp.asarray(k),
                                            jnp.asarray(v), heads, kv_len,
                                            scale, 32, group)
    o, lse = variants.mha_fwd_grouped(t(q), t(k), t(v), heads, kv_len, scale,
                                      32, group)
    close(o, want_o, 3e-5)
    close(lse, want_lse, 3e-5)


@pytest.mark.parametrize("kv_len", [None, 20])
@pytest.mark.parametrize("variant", ["b0", "b1", "b2", "b4", "b3"])
def test_t2b_plain_matches_bwd_flat_interpret(jax_mha, variant, kv_len):
    """fp32, 1e-4 of each gradient's largest entry (B5's tolerance in
    test_torch_fused.py), for the five schedules."""
    g, m, sk, hd, heads = 2, 64, 32, 64, 4
    q, k, v, do = _t2_inputs(g, m, sk, hd, 4)
    scale = 1.0 / (hd // heads) ** 0.5
    o, lse = fused.mha_fwd_plain(t(q), t(k), t(v), heads, kv_len, scale)
    dd = fused._head_rowsum(t(do), o, heads)
    with pltpu.force_tpu_interpret_mode():
        want = jax_mha.bwd_flat(*(jnp.asarray(a) for a in (q, k, v, do)),
                                jnp.asarray(lse.numpy()),
                                jnp.asarray(dd.numpy()), heads, kv_len, scale,
                                32, variant)
    got = variants.mha_bwd_ordered(t(q), t(k), t(v), t(do), lse, dd, heads,
                                   kv_len, scale, 32, variant)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * max(1.0, np.abs(b).max())


def test_attn_experiments_main_on_cpu(capsys):
    """The tool end to end at a tiny shape: a parity row for every name, none
    failed, a timing row per name and block_m, B1's row first."""
    rows = attn_experiments.main(
        ["--n", "1", "--bm", "64"], device="cpu",
        shape=dict(g=1, m=64, sk=32, c=64, heads=2))
    parity = [r for r in rows if r["kind"] == "parity"]
    times = [r for r in rows if r["kind"] == "time"]
    assert [r["name"] for r in parity] == NAMES
    assert all(r["ok"] and r["equal_in_class"] for r in parity)
    assert "err_b1" not in parity[NAMES.index("v4_mmfloor")]
    assert times[0]["name"].startswith("B1")
    assert [r["name"] for r in times[1:]] == NAMES
    assert all(r["ms"] > 0 and r["block_m"] == 64 for r in times[1:])
    out = capsys.readouterr().out
    assert "device: cpu" in out and "v9_mxusum" in out


def test_mha_phase_bench_main_on_cpu(capsys):
    rows = mha_phase_bench.main(
        ["--n", "1"], device="cpu",
        shapes=(("tiny", 1, 64, 32, 64, 2, None),
                ("tiny.kv", 2, 32, 32, 64, 2, 20)))
    assert all(r.get("ok", True) for r in rows)
    for tag in ("tiny", "tiny.kv"):
        mine = [r for r in rows if r["tag"] == tag]
        assert [r["variant"] for r in mine if r["kind"] == "parity_bwd"] == \
            list(mha_phase_bench.BWD_NAMES)
        assert all(r["equal_to_b4"] for r in mine
                   if r["kind"] == "parity_fwd")
        assert all(r["dkdv_equal_to_b5"] and "b5_unsplit" in r
                   for r in mine if r["kind"] == "parity_bwd")
        assert [r["group"] for r in mine if r["kind"] == "time_fwd"][0] is None
        assert [r["variant"] for r in mine
                if r["kind"] == "time_bwd"][0] is None
    assert "=== tiny.kv" in capsys.readouterr().out


@pytest.mark.parametrize("shape,unsplit", [
    (("wide", 66, 128, 8, 64, 2, None), True),   # 132 dK/dV blocks
    (("few", 1, 256, 8, 64, 2, None), False),    # 2 blocks: B5 splits M
])
def test_mha_phase_bench_unsplit_gate_on_cpu(shape, unsplit):
    """Where B5's dK/dV grid fills the card (`fused.dkv_split` 1) the rows
    gate dk/dv equality to B5; where B5 splits the query range they report
    it without gating."""
    rows = mha_phase_bench.main(["--n", "1"], device="cpu", shapes=(shape,))
    bwd = [r for r in rows if r["kind"] == "parity_bwd"]
    assert len(bwd) == len(mha_phase_bench.BWD_NAMES)
    assert all(r["b5_unsplit"] == unsplit and r["dkdv_equal_to_b5"]
               and r["ok"] for r in bwd)


def test_tools_import_no_jax():
    """Both tools run as modules without jax in the process."""
    code = ("import sys\n"
            "from asva_tpu_torch.tools import attn_experiments as a, "
            "mha_phase_bench as m\n"
            "assert a.main(['--n', '1', '--bm', '64'], 'cpu', "
            "dict(g=1, m=64, sk=32, c=64, heads=2))\n"
            "assert m.main(['--n', '1'], 'cpu', (('t', 1, 64, 32, 64, 2, "
            "None),))\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'flax', 'optax', 'orbax', 'asva_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
