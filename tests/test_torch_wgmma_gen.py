"""The generated wgmma wrappers (``csrc/wgmma.cuh``) against their generator
(``tools/gen_wgmma.py``), on the CPU.

The header is written by the generator and committed; the kernels include
it. These tests hold the committed file to ``render()`` byte for byte, and
each generated function to the operand majors its name promises (the
transpose immediates at the end of its ``wgmma`` instruction).
"""

import re

import pytest

from complex_prompt_diffusion_tpu_torch.tools import gen_wgmma as G

# one function: its struct, width, name, and the instruction's text
_FN_RE = re.compile(r"struct (Wgmma|WgmmaTf32)<(\d+)> \{(.*?)\n\};", re.S)
_BODY_RE = re.compile(r"void (\w+)\((.*?)\) \{\n    asm volatile\(\n(.*?)\n      :", re.S)


def _functions(text):
    """[(struct, N, name, signature, instruction text)] of a rendered header."""
    out = []
    for struct, n, body in _FN_RE.findall(text):
        for name, sig, asm in _BODY_RE.findall(body):
            lit = "".join(re.findall(r'"(.*?)"\n', asm + "\n"))
            ins = re.search(r"wgmma\.mma_async[^;]*;", lit).group(0)
            out.append((struct, int(n), name, sig, ins))
    return out


def test_committed_header_is_the_generators_output():
    assert G.OUT.read_text() == G.render()


def test_every_width_of_every_list_is_generated():
    want = {("Wgmma", n, name) for name, widths in (
        ("ss", G.SS_WIDTHS), ("ss_bmn", G.SS_BMN_WIDTHS), ("ss_amn", G.K5_SS_WIDTHS),
        ("ss_mn", G.K5_SS_WIDTHS), ("rs", G.RS_WIDTHS), ("rs_bk", G.K5_RS_WIDTHS))
        for n in widths}
    want |= {("WgmmaTf32", n, "ss") for n in G.TF32_WIDTHS}
    want |= {("WgmmaTf32", n, "rs") for n in G.TF32_RS_WIDTHS}
    got = {(s, n, name) for s, n, name, _, _ in _functions(G.render())}
    assert got == want


@pytest.mark.parametrize("name", sorted(G.FORMS))
def test_bf16_forms_carry_the_transpose_immediates_their_names_say(name):
    rs, ta, tb = G.FORMS[name]
    fns = [f for f in _functions(G.render()) if f[0] == "Wgmma" and f[2] == name]
    assert fns
    for _, n, _, sig, ins in fns:
        assert f"m64n{n}k16.f32.bf16.bf16" in ins
        # scale-d, imm-scale-a, imm-scale-b, then the transposes
        tail = ins.split("p, ", 1)[1].rstrip(";")
        imms = [int(x) for x in tail.split(", ")]
        assert imms[:2] == [1, 1]
        assert imms[2:] == ([tb] if rs else [ta, tb])
        assert ("const uint32_t (&a)[4]" in sig) == rs
        assert len(re.findall(r"%\d+", ins.split("}", 1)[0])) == n // 2  # accumulators


def test_tf32_forms_take_no_transpose_immediates():
    fns = [f for f in _functions(G.render()) if f[0] == "WgmmaTf32"]
    assert {f[2] for f in fns} == {"ss", "rs"}
    for _, n, name, sig, ins in fns:
        assert f"m64n{n}k8.f32.tf32.tf32" in ins
        assert ins.rstrip(";").endswith("p, 1, 1")
        assert ("const uint32_t (&a)[4]" in sig) == (name == "rs")


def test_the_k5_widths_cover_the_k5_bodies():
    import importlib

    A = importlib.import_module("complex_prompt_diffusion_tpu_torch.ops.attention")
    assert set(A._K5_BF16_DV) <= set(G.K5_RS_WIDTHS)
    assert set(A._K5_F32_DV) <= set(G.TF32_RS_WIDTHS)
    assert {c for dv in A._K5_BF16_DV for c in (128 if dv <= 128 else 64,)} <= set(
        G.K5_SS_WIDTHS)
    assert {64, 32} <= set(G.TF32_WIDTHS)  # the f32 body's score tiles
