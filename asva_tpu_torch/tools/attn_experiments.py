"""attn1 kernel experiments on the card: ten orders of the fused attention
sub-layer against B1, the production kernel.

Counterpart of tools/attn_experiments.py.  The candidates are the ten names
of `ops.variants.VARIANTS`, each run by T1 `ln_attn_variant`, the
single-launch sub-layer (`csrc/attn_variants.cu`):

  v0  divide, round, then P V, heads in sequence (the Pallas B1's order)
  v1  PHASED: two heads' logits started before either softmax
  v2  POST-NORM: round exp(s - m), P V, divide by l at the end (the order
      of this package's B1, `fused.fused_ln_attn`)
  v3  v1 + v2
  v4  matmul floor: softmax replaced by a cast (NOT numerically valid;
      isolates the tensor-core share)
  v5  v3 + bf16 exp (accuracy probe only)
  v6  v1 with one stacked softmax (the same instantiation as v1 here)
  v7  v1 with log2(e) folded into the scale and exp2
  v8  one head, the next K tile's logits started before this tile's softmax
  v9  v3 with the row sum taken by the tensor cores through a block of ones

First the correctness table: every name against its own plain version (the
hard check: bf16 within 2**-6 of max|plain|, v5_bf16exp within 0.05), and
beside it the largest difference from B1 with the JAX tool's tolerance for
that name.  B1 here divides after P V, so v2/v3 are its arithmetic and the
v0 class differs from it at bf16 rounding: that difference is printed, not
failed.  On the card two gates hold the tool to comparing orders only: v2
and v3 (the POST class) must be B1's bits (`equal_to_b1`), and every order
of a class the bits of the class's first name (`equal_in_class`: v0 =
v1_phased = v6_stacksm = v8_pipe, v2 = v3).  Then one timing row per
variant and rows-per-block (`--bm`), with B1's own time as the first row.
Times are medians of `--n` launches between CUDA events, after warm-up.

Run on the card: python3 -m asva_tpu_torch.tools.attn_experiments [--n 50]
[--bm 256]
"""
from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import fused, variants
from .common import describe, emit, flag, max_abs_diff, seeded, time_ms

DT = torch.bfloat16
SHAPE = dict(g=2, m=12288, sk=1024, c=320, heads=8)
# the JAX tool's tolerances against the production kernel
B1_TOL = {"v5_bf16exp": 0.05, "v2_postnorm": 5e-3, "v3_both": 5e-3,
          "v7_exp2": 5e-3, "v9_mxusum": 5e-3}
PLAIN_TOL = 2.0 ** -6


def main(argv: Optional[Sequence[str]] = None, device="cuda",
         shape: Optional[dict] = None) -> List[dict]:
    """Print the correctness table and the timing rows; return them as a
    list of dicts (kind "parity" or "time").  `shape` overrides SHAPE (the
    tests pass a tiny one with device="cpu")."""
    argv = list(sys.argv[1:] if argv is None else argv)
    n = flag(argv, "--n", 50)
    bm = flag(argv, "--bm", None)
    # 64 is the block's own tile; 256 and 512 are the JAX tool's defaults
    bms = [64, 256, 512] if bm is None else [bm]
    device = torch.device(device)
    s = dict(SHAPE, **(shape or {}))
    g, m, sk, c, heads = s["g"], s["m"], s["sk"], s["c"], s["heads"]
    rng = np.random.default_rng(0)

    def r(*dims):
        return seeded(rng, dims, DT, device)

    print(f"device: {describe(device)}  (N={n})", flush=True)
    x = r(g, m, c)
    ls, lb = (r(1, c).float() + 1.0).to(DT), r(1, c)
    # the JAX tool holds wq / wo as (in, out); Linear layout is (out, in)
    wq, wo, bo = r(c, c).t().contiguous(), r(c, c).t().contiguous(), r(1, c)
    k, v = r(g, sk, c), r(g, sk, c)
    args = (x, ls, lb, wq, wo, bo, k, v)
    rows: List[dict] = []

    def b1():
        return fused.fused_ln_attn(x, ls.reshape(-1), lb.reshape(-1), wq, wo,
                                   bo.reshape(-1), k, v, 1e-5, heads)

    with torch.no_grad():
        # correctness before timing
        ref = b1()
        first = {}                      # class -> its first name's output
        for name in variants.VARIANTS:
            cls = variants.VARIANTS[name][0]
            got = variants.ln_attn_variant(name, *args, 1e-5, heads, bms[0])
            plain = variants.ln_attn_variant_plain(name, *args, 1e-5, heads)
            err = max_abs_diff(got, plain)
            tol = (0.05 if name == "v5_bf16exp"
                   else PLAIN_TOL * plain.float().abs().max().item())
            first.setdefault(cls, got)
            row = dict(kind="parity", name=name, err_plain=err,
                       tol_plain=tol,
                       equal_in_class=bool(torch.equal(got, first[cls])))
            row["ok"] = err <= tol and row["equal_in_class"]
            if device.type == "cuda" and cls == variants.POST:
                row["equal_to_b1"] = bool(torch.equal(got, ref))
                row["ok"] = row["ok"] and row["equal_to_b1"]
            gates = "".join(f" {k} {row[k]}" for k in
                            ("equal_in_class", "equal_to_b1") if k in row)
            text = (f"  {name}: vs plain max|d|={err:.2e} (tol {tol:.2e})"
                    f"{gates} {'OK' if row['ok'] else 'FAIL'}")
            if name != "v4_mmfloor":     # no softmax: never held against B1
                d = max_abs_diff(got, ref)
                b1_tol = B1_TOL.get(name, 1e-6)
                row.update(err_b1=d, tol_b1=b1_tol, within_b1_tol=d <= b1_tol)
                text += (f"; vs B1 max|d|={d:.2e} (JAX tool's tol "
                         f"{b1_tol:.0e}) "
                         f"{'within' if d <= b1_tol else 'DIFFERS'}")
            emit(rows, row, text)

        ms = time_ms(b1, device, n)
        emit(rows, dict(kind="time", name="B1 fused_ln_attn", block_m=None,
                        ms=ms, supported=True),
             f"{'B1 fused_ln_attn (production)':40s} {ms:7.3f} ms/iter")
        for block_m in bms:
            print(f"--- block_m={block_m} ---", flush=True)
            for name in variants.VARIANTS:
                label = f"attn1 {name} bm{block_m}"
                why = (variants.t1_supported(c, heads, block_m)
                       if device.type == "cuda" else None)
                if why:
                    emit(rows, dict(kind="time", name=name, block_m=block_m,
                                    ms=None, supported=False, why=why),
                         f"{label}: UNSUPPORTED ({why})")
                    continue
                ms = time_ms(lambda: variants.ln_attn_variant(
                    name, *args, 1e-5, heads, block_m), device, n)
                emit(rows, dict(kind="time", name=name, block_m=block_m,
                                ms=ms, supported=True),
                     f"{label:40s} {ms:7.3f} ms/iter")
    return rows


if __name__ == "__main__":
    sys.exit(0 if all(r.get("ok", True) for r in main()) else 1)
