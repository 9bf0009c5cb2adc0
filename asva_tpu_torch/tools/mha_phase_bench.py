"""Schedule probe for the TRAINING flash attention kernels on the card.

Counterpart of tools/mha_phase_bench.py.  Training's attention runs through
B4 `fused.mha_fwd` and B5 `fused.mha_bwd`.  This tool measures, at the real
training shapes (batch 4, 12 frames):

  fwd  T2f `mha_fwd_grouped`: `group` heads per block, all their logits
       started before any softmax; group 1 is B4's own schedule; 1, 2, 4, H
  bwd  T2b `mha_bwd_ordered`: one kernel of five products (B5 is two
       kernels and seven), in the orders
       b0 one head, the exp between its two logit products
       b1 one head, s and dO V^T started back to back before the exp
       b2 / b4 / b3  two / four / all heads' logit products first

Both are built on B4's and B5's wgmma tile code (`csrc/hopper.cuh`,
`csrc/wgmma.cuh`), with B4's and B5's statements per head, so the tool
compares schedules and nothing else.  lse and dd come from the production
forward.  Parity first, the JAX tool's gates: every forward group must
equal B4 bit for bit (o and lse; tools/mha_phase_bench.py:247 demands
err == 0.0); every backward order must be within 2**-6 of max|B5| of B5's
dq, dk, dv, its dk/dv equal bit for bit across the orders and, where B5
runs its dK/dV kernel unsplit (`fused.dkv_split` 1: the same sums in the
same order), equal to B5's bit for bit.  dq is summed over the K/V blocks
by atomics in no fixed order, so it has only the tolerance.  A (group,
head dim) or (variant, head dim) without an instantiation is listed as
UNSUPPORTED with the rule that excludes it.  Then the timing matrix, B4's
and B5's own times first: medians of `--n` launches between CUDA events,
after warm-up.  The exit code is 0 only if every parity row holds.

Run on the card: python3 -m asva_tpu_torch.tools.mha_phase_bench [--n 30]
"""
from __future__ import annotations

import sys
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..ops import fused, variants
from .common import describe, emit, flag, max_abs_diff, seeded, time_ms

DT = torch.bfloat16
BWD_TOL = 2.0 ** -6
SMS = 132               # an H100's SMs: B5's split rule in a dry run
# training shapes at batch 4, 12 frames: attn1 flattens to (b, f*n, c),
# audio cross-attention to (b*f, n, c): (tag, G, M, Sk, HD, H, kv_len)
SHAPES = (("L0.attn1", 4, 12288, 1024, 320, 8, None),
          ("L0.audio", 48, 1024, 128, 320, 8, 25),
          ("L0.text", 4, 12288, 128, 320, 8, 77),
          ("L1.attn1", 4, 3072, 256, 640, 8, None),
          ("L2.attn1", 4, 768, 128, 1280, 8, 64))
BWD_NAMES = ("b0", "b1", "b2", "b4", "b3")


def bench_shape(tag, g, m, sk, hdp, heads, kv_len, n, device,
                rows: List[dict]) -> None:
    rng = np.random.default_rng(0)
    q, k, v, do = (seeded(rng, s, DT, device) for s in
                   ((g, m, hdp), (g, sk, hdp), (g, sk, hdp), (g, m, hdp)))
    d = hdp // heads
    scale = 1.0 / (d ** 0.5)
    on_card = device.type == "cuda"
    # real lse/dd from the production forward so exp(s - lse) stays bounded
    o, lse = fused.mha_fwd(q, k, v, heads, kv_len, scale)
    dd = fused._head_rowsum(do, o, heads)
    print(f"=== {tag}: G={g} M={m} Sk={sk} HD={hdp} H={heads} "
          f"kv_len={kv_len} ===", flush=True)

    ok_fwd, ok_bwd = [], []
    for grp in dict.fromkeys((1, 2, 4, heads)):
        why = variants.t2f_supported(d, min(grp, heads)) if on_card else None
        if why:
            emit(rows, dict(kind="parity_fwd", tag=tag, group=grp,
                            supported=False, why=why),
                 f"  fwd g{grp}: UNSUPPORTED ({why})")
            continue
        of, lf = variants.mha_fwd_grouped(q, k, v, heads, kv_len, scale,
                                          None, grp)
        same = bool(torch.equal(of, o) and torch.equal(lf, lse))
        err_o, err_lse = max_abs_diff(of, o), max_abs_diff(lf, lse)
        emit(rows, dict(kind="parity_fwd", tag=tag, group=grp, supported=True,
                        equal_to_b4=same, err_o=err_o, err_lse=err_lse,
                        ok=same),
             f"  fwd g{grp}: {'equal to' if same else 'DIFFERS from'} B4 "
             f"(max|d| o={err_o:.2e} lse={err_lse:.2e}) "
             f"{'OK' if same else 'FAIL'}")
        ok_fwd.append(grp)
    ref = fused.mha_bwd(q, k, v, do, lse, dd, heads, kv_len, scale)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if on_card else SMS)
    unsplit = fused.dkv_split(g, m, sk, heads, d, sms) == 1
    first = None
    for var in BWD_NAMES:
        why = variants.t2b_supported(d, heads, var) if on_card else None
        if why:
            emit(rows, dict(kind="parity_bwd", tag=tag, variant=var,
                            supported=False, why=why),
                 f"  bwd {var}: UNSUPPORTED ({why})")
            continue
        got = variants.mha_bwd_ordered(q, k, v, do, lse, dd, heads, kv_len,
                                       scale, None, var)
        errs = [max_abs_diff(a, b) for a, b in zip(got, ref)]
        tols = [BWD_TOL * b.float().abs().max().item() for b in ref]
        first = first or got
        same = bool(torch.equal(got[1], first[1])
                    and torch.equal(got[2], first[2]))
        eq_b5 = bool(torch.equal(got[1], ref[1])
                     and torch.equal(got[2], ref[2]))
        ok = (all(e <= t for e, t in zip(errs, tols)) and same
              and (eq_b5 or not unsplit))
        emit(rows, dict(kind="parity_bwd", tag=tag, variant=var,
                        supported=True, errs=errs, tols=tols,
                        dkdv_equal_across_variants=same, b5_unsplit=unsplit,
                        dkdv_equal_to_b5=eq_b5, ok=ok),
             f"  bwd {var}: vs B5 max|d| dq/dk/dv="
             f"{'/'.join(f'{e:.2e}' for e in errs)} (tol "
             f"{'/'.join(f'{t:.2e}' for t in tols)}), dk/dv "
             f"{'equal' if same else 'NOT equal'} across variants, "
             f"{'equal' if eq_b5 else 'not equal'} to B5"
             f"{' (unsplit: gated)' if unsplit else ''} "
             f"{'OK' if ok else 'FAIL'}")
        ok_bwd.append(var)

    def timed(kind, label, fn, **extra):
        ms = time_ms(fn, device, n)
        emit(rows, dict(kind=kind, tag=tag, ms=ms, **extra),
             f"{tag + ' ' + label:44s} {ms:7.3f} ms/iter")

    timed("time_fwd", "fwd B4 (production)",
          lambda: fused.mha_fwd(q, k, v, heads, kv_len, scale), group=None)
    for grp in ok_fwd:
        timed("time_fwd", f"fwd grouped g{grp}",
              lambda: variants.mha_fwd_grouped(q, k, v, heads, kv_len, scale,
                                               None, grp), group=grp)
    timed("time_bwd", "bwd B5 (production)",
          lambda: fused.mha_bwd(q, k, v, do, lse, dd, heads, kv_len, scale),
          variant=None)
    for var in ok_bwd:
        timed("time_bwd", f"bwd {var}",
              lambda: variants.mha_bwd_ordered(q, k, v, do, lse, dd, heads,
                                               kv_len, scale, None, var),
              variant=var)


def main(argv: Optional[Sequence[str]] = None, device="cuda",
         shapes=SHAPES) -> List[dict]:
    """Print parity and timing for every shape; return the rows as a list
    of dicts.  `shapes` overrides SHAPES (the tests pass tiny ones with
    device="cpu")."""
    argv = list(sys.argv[1:] if argv is None else argv)
    n = flag(argv, "--n", 30)
    device = torch.device(device)
    print(f"device: {describe(device)}  (N={n})", flush=True)
    rows: List[dict] = []
    with torch.no_grad():
        for shape in shapes:
            bench_shape(*shape, n, device, rows)
    return rows


if __name__ == "__main__":
    sys.exit(0 if all(r.get("ok", True) for r in main()) else 1)
