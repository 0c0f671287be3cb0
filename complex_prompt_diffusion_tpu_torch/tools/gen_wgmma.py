"""Write ``csrc/wgmma.cuh``: the Hopper ``wgmma.mma_async`` wrappers the sm90
kernels call, one per output width N.

PTX names every accumulator register of a ``wgmma`` in the instruction
(N / 2 of them a thread for an m64nNk16 f32 product), and an inline-asm
string is a literal, so each width needs its own text. This script writes
it; run it from the repository root after changing the widths below::

    python -m complex_prompt_diffusion_tpu_torch.tools.gen_wgmma

``Wgmma<N>::ss`` multiplies two shared-memory operands, both K-major (the
conv's pixels x weights, attention's Q K^T); ``Wgmma<N>::ss_bmn`` the same
with B MN-major (the GEGLU FF's weights ``[C, 2 H4]`` and ``[H4, C]`` read
as they lie); ``Wgmma<N>::rs`` takes A from registers and B from shared
memory MN-major (attention's P V, V read as it lies). K5's d-major
operands add three: ``Wgmma<N>::ss_amn`` (A MN-major, B K-major: a d-major
Q tile against a canonical K tile), ``Wgmma<N>::ss_mn`` (both MN-major: a
d-major Q against a d-major K) and ``Wgmma<N>::rs_bk`` (A from registers,
B K-major: P against a d-major V tile). bf16 inputs, f32 accumulators.
``WgmmaTf32<N>::ss`` multiplies two shared-memory f32 operands on the TF32
tensor cores, both K-major (TF32 has no MN-major form): the three products
of K1's f32 body and of K5's f32 scores; ``WgmmaTf32<N>::rs`` takes A from
registers (K5's f32 P V).

The transpose immediates: ``ss`` forms end in ``imm-trans-a, imm-trans-b``
(0 = K-major, 1 = MN-major), the bf16 ``rs`` forms in ``imm-trans-b``; TF32
forms carry none.
"""

from __future__ import annotations

from pathlib import Path

# SS: attention's score tile (64 or 128 keys) and the conv's 128-channel tile
SS_WIDTHS = (64, 128)
# SS with B MN-major: K2's tiles (value and gate tiles of 64 or 128 columns,
# the second GEMM's 64 .. 256)
SS_BMN_WIDTHS = (64, 128, 192, 256)
# TF32 SS: K1's f32 body, 128-wide tiles; K5's f32 score tiles (64 or 32 keys)
TF32_WIDTHS = (32, 64, 128)
# RS: attention's PV width, the head dim rounded up to 8, for every head dim
# K1's bf16 body takes up to 256 (ops/attention.py: _ATTN_BF16_DP), and the
# probe K7's ones column at d = 160 (d + 8; at 40 and 80 the list has it)
RS_WIDTHS = (8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 120, 128, 152, 160, 168, 248, 256)
# K5's bf16 body (ops/attention.py: _K5_BF16_DV): score tiles of 128 or 64
# keys (SS with A MN-major, B K-major or MN-major), PV widths (RS, B K-major)
K5_SS_WIDTHS = (64, 128)
K5_RS_WIDTHS = (16, 32, 40, 48, 64, 80, 96, 128, 160, 256)
# K5's f32 body (ops/attention.py: _K5_F32_DV): TF32 RS, the PV widths
TF32_RS_WIDTHS = (16, 32, 40, 48, 64, 80, 96, 128, 160)

OUT = Path(__file__).resolve().parents[1] / "csrc" / "wgmma.cuh"


def _wrap(items, per_line, indent):
    lines = [", ".join(items[i:i + per_line]) for i in range(0, len(items), per_line)]
    return (",\n" + indent).join(lines)


# each generated function: name -> (A from registers, imm-trans-a, imm-trans-b);
# None where the form has no such immediate (TF32; A in registers)
FORMS = {
    "ss": (False, 0, 0),
    "ss_bmn": (False, 0, 1),
    "ss_amn": (False, 1, 0),
    "ss_mn": (False, 1, 1),
    "rs": (True, None, 1),
    "rs_bk": (True, None, 0),
}


def _fn(n: int, name: str, tf32: bool = False) -> str:
    rs, ta, tb = FORMS[name]
    r = n // 2
    regs = "{" + ", ".join(f"%{i}" for i in range(r)) + "}"
    # TF32 takes no transpose immediates: both operands K-major
    trans = "" if tf32 else "".join(f", {t}" for t in (ta, tb) if t is not None)
    if rs:
        a = "{" + ", ".join(f"%{r + i}" for i in range(4)) + "}"
        ins = f"{regs}, {a}, %{r + 4}, p, 1, 1{trans};"
        scale = r + 5
        sig = f"float (&d)[{r}], const uint32_t (&a)[4], uint64_t db, int scale_d"
        ins_ops = '"r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d)'
    else:
        ins = f"{regs}, %{r}, %{r + 1}, p, 1, 1{trans};"
        scale = r + 2
        sig = f"float (&d)[{r}], uint64_t da, uint64_t db, int scale_d"
        ins_ops = '"l"(da), "l"(db), "r"(scale_d)'
    outs = _wrap([f'"+f"(d[{i}])' for i in range(r)], 8, "      ")
    kind = "k8.f32.tf32.tf32" if tf32 else "k16.f32.bf16.bf16"
    text = (f"wgmma.mma_async.sync.aligned.m64n{n}{kind} {ins}")
    # split the long instruction string into literal pieces
    pieces = [text[i:i + 88] for i in range(0, len(text), 88)]
    body = "\n".join(f'      "{p}"' for p in pieces)
    return (f"  __device__ static __forceinline__ void {name}({sig}) {{\n"
            f"    asm volatile(\n"
            f'      "{{\\n.reg .pred p;\\nsetp.ne.b32 p, %{scale}, 0;\\n"\n'
            f"{body}\n"
            f'      "\\n}}\\n"\n'
            f"      : {outs}\n"
            f"      : {ins_ops});\n"
            f"  }}\n")


def render() -> str:
    widths = sorted(set(SS_WIDTHS) | set(RS_WIDTHS) | set(SS_BMN_WIDTHS) | set(K5_SS_WIDTHS)
                    | set(K5_RS_WIDTHS))
    out = [
        "// Generated by complex_prompt_diffusion_tpu_torch/tools/gen_wgmma.py; do not edit.",
        "//",
        "// Wgmma<N>::ss(d, da, db, scale_d): d += A B with A (64 x 16) and B (16 x N) in",
        "// shared memory, both K-major, through wgmma descriptors da and db.",
        "// Wgmma<N>::ss_bmn(d, da, db, scale_d): the same with B MN-major.",
        "// Wgmma<N>::ss_amn(d, da, db, scale_d): A MN-major, B K-major.",
        "// Wgmma<N>::ss_mn(d, da, db, scale_d): both MN-major.",
        "// Wgmma<N>::rs(d, a, db, scale_d): the same with A in registers (the m64k16",
        "// fragment of mma.sync's A layout, a warp holding 16 rows) and B MN-major.",
        "// Wgmma<N>::rs_bk(d, a, db, scale_d): A in registers, B K-major.",
        "// scale_d == 0 overwrites d instead of adding to it. bf16 in, f32 out; d holds",
        "// a thread's N / 2 accumulators in wgmma's m64nN layout.",
        "// WgmmaTf32<N>::ss(d, da, db, scale_d): d += A B, A (64 x 8) and B (8 x N) f32",
        "// in shared memory, both K-major, on the TF32 tensor cores (the low 13",
        "// mantissa bits of each operand are ignored).",
        "// WgmmaTf32<N>::rs(d, a, db, scale_d): the same with A in registers (the",
        "// m64k8 fragment: a thread holds rows g and g + 8, columns t and t + 4 of",
        "// its warp's 16 rows, g = lane / 4, t = lane % 4) and B K-major.",
        "#pragma once",
        "",
        "#include <stdint.h>",
        "",
        "namespace cpd {",
        "",
        "template <int N>",
        "struct Wgmma;",
        "",
    ]
    for n in widths:
        out.append(f"template <>\nstruct Wgmma<{n}> {{")
        for name, have in (("ss", SS_WIDTHS), ("ss_bmn", SS_BMN_WIDTHS), ("ss_amn", K5_SS_WIDTHS),
                           ("ss_mn", K5_SS_WIDTHS), ("rs", RS_WIDTHS), ("rs_bk", K5_RS_WIDTHS)):
            if n in have:
                out.append(_fn(n, name).rstrip("\n"))
        out.append("};\n")
    out.append("template <int N>\nstruct WgmmaTf32;\n")
    for n in sorted(set(TF32_WIDTHS) | set(TF32_RS_WIDTHS)):
        out.append(f"template <>\nstruct WgmmaTf32<{n}> {{")
        if n in TF32_WIDTHS:
            out.append(_fn(n, "ss", tf32=True).rstrip("\n"))
        if n in TF32_RS_WIDTHS:
            out.append(_fn(n, "rs_bk", tf32=True).rstrip("\n").replace(" rs_bk(", " rs("))
        out.append("};\n")
    out.append("}  // namespace cpd\n")
    return "\n".join(out)


def main() -> int:
    OUT.write_text(render())
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
