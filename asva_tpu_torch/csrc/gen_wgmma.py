"""Write `wgmma.cuh`: the warpgroup MMA wrappers that the attention kernels
and K-gemm use.  Inline PTX has to name every accumulator register, so each width N is
spelled out once here instead of by hand.  Run after changing the widths:

    python3 asva_tpu_torch/csrc/gen_wgmma.py
"""
import os

# widths of the A-from-registers form: every head tile 16..160 and the dK/dV
# head slices of the tiles wider than 96 (56, 64, 72, 80); T2f (attn_grouped.cu)
# and T2b (attn_bwd_fused.cu) use the widths 32-80 and 160 of B4 and B5
RS_WIDTHS = (16, 32, 48, 56, 64, 72, 80, 96, 112, 128, 144, 160)
# widths of the both-from-shared-memory form: the 64-key S tiles of the
# attention kernels, and K-gemm's N tiles (160 for every SD1.5 width, 80 for
# its GEGLU panels, 64 for the other multiples of 64)
SS_WIDTHS = (64, 80, 160)
# widths of the both-from-shared-memory form with both operands MN-major: the
# dQ product of T2b (attn_bwd_fused.cu), dS staged as [key][query] and K read
# as [key][column], over the dK/dV head slices 32, 48, 64 and 80
SS_MN_WIDTHS = (32, 48, 64, 80)

HEAD = """\
// Generated by gen_wgmma.py: warpgroup matrix products for sm_90a.
//
// Wgmma<N>::ss: d (64 x N, fp32) (+)= A (64 x 16) B (N x 16)^T, A and B
//   bf16 in shared memory, both K-major, given by matrix descriptors.
// Wgmma<N>::rs: d (64 x N) (+)= A (64 x 16) B (16 x N), A bf16 in registers
//   (the m16n8k16 A fragment of each warp's 16 rows), B in shared memory
//   MN-major (imm-trans-b = 1).
// Wgmma<N>::ss_mn: d (64 x N) (+)= A (64 x 16) B (16 x N), A and B bf16 in
//   shared memory, both MN-major (imm-trans-a = imm-trans-b = 1): A stored
//   with its 64 rows contiguous, B with its N columns contiguous.
// scale_d = 0 overwrites d, 1 accumulates.  The accumulator layout is that
// of mma.sync m16n8 repeated over N / 8 column tiles: d[4j + e] holds row
// 16 warp + lane / 4 + 8 (e / 2), column 8 j + 2 (lane % 4) + e % 2.
#pragma once
#include <stdint.h>

template <int N> struct Wgmma;
"""


def regs(n, first):
    return ", ".join(f"%{first + i}" for i in range(n))


def spec(n):
    acc = n // 2
    outs = ", ".join(f'"+f"(d[{i}])' for i in range(acc))
    lines = [f"template <> struct Wgmma<{n}> {{"]
    if n in SS_WIDTHS:
        lines += [
            f"  static __device__ __forceinline__ void ss(float (&d)[{acc}], "
            "uint64_t da, uint64_t db, int scale_d) {",
            "    asm volatile(",
            '        "{\\n.reg .pred p;\\n"',
            f'        "setp.ne.b32 p, %{acc + 2}, 0;\\n"',
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "',
            f'        "{{{regs(acc, 0)}}}, "',
            f'        "%{acc}, %{acc + 1}, p, 1, 1, 0, 0;\\n}}\\n"',
            f"        : {outs}",
            '        : "l"(da), "l"(db), "r"(scale_d));',
            "  }"]
    if n in SS_MN_WIDTHS:
        lines += [
            f"  static __device__ __forceinline__ void ss_mn(float (&d)[{acc}], "
            "uint64_t da, uint64_t db, int scale_d) {",
            "    asm volatile(",
            '        "{\\n.reg .pred p;\\n"',
            f'        "setp.ne.b32 p, %{acc + 2}, 0;\\n"',
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "',
            f'        "{{{regs(acc, 0)}}}, "',
            f'        "%{acc}, %{acc + 1}, p, 1, 1, 1, 1;\\n}}\\n"',
            f"        : {outs}",
            '        : "l"(da), "l"(db), "r"(scale_d));',
            "  }"]
    if n in RS_WIDTHS:
        lines += [
            f"  static __device__ __forceinline__ void rs(float (&d)[{acc}], "
            "const uint32_t (&a)[4], uint64_t db, int scale_d) {",
            "    asm volatile(",
            '        "{\\n.reg .pred p;\\n"',
            f'        "setp.ne.b32 p, %{acc + 5}, 0;\\n"',
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "',
            f'        "{{{regs(acc, 0)}}}, "',
            f'        "{{{regs(4, acc)}}}, %{acc + 4}, p, 1, 1, 1;\\n}}\\n"',
            f"        : {outs}",
            '        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),',
            '          "r"(scale_d));',
            "  }"]
    lines.append("};")
    return "\n".join(lines) + "\n"


def render() -> str:
    """The text of wgmma.cuh."""
    widths = sorted(set(RS_WIDTHS) | set(SS_WIDTHS) | set(SS_MN_WIDTHS))
    return HEAD + "\n" + "\n".join(spec(n) for n in widths)


def main():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "wgmma.cuh")
    with open(path, "w") as f:
        f.write(render())


if __name__ == "__main__":
    main()
