"""The attention probes on the card: the counterparts of the TPU scripts
``scripts/perf_attn8.py`` .. ``perf_attn12.py``, through K7
(``csrc/probe_attention.cu``), K1 and K5.

Run from the repository root on a machine with the GPU and nvcc::

    python -m complex_prompt_diffusion_tpu_torch.tools.probe_attention
    python -m complex_prompt_diffusion_tpu_torch.tools.probe_attention --sass

It checks every mode and flag against its plain twin at a small shape,
then prints one row per script variant at the scripts' shapes (B8 H8 = the
scripts' BH64, at the UNet levels S4096 d40, S1024 d80, S256 d160; B2 for
``perf_attn12``'s batch-1 row): the kernel's time with the L2 hot and cold
(``tools/hotcold.py``), the bound (the least time an H100 could take for
the row's work: flops over 989 TFLOP/s bf16 / 67 f32, or bytes over 3.35
TB/s), the bound's share of the cold time, and SDPA's time on the same
inputs where the row computes the attention. ``--sass`` counts the HMMA
instructions of every K7 instantiation in the built library's SASS
(``cuobjdump``) and holds each ablated mode to the MMAs of the steps it
keeps.
"""

from __future__ import annotations

import argparse
import math
import re
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch import _build
from complex_prompt_diffusion_tpu_torch.ops.attention import (
    attention_dmajor,
    attention_kcanon,
    flash_attention,
)
from complex_prompt_diffusion_tpu_torch.ops.probes import attention as PA
from complex_prompt_diffusion_tpu_torch.tools.hotcold import hot_cold_ms
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import HBM_BYTES_PER_S, PEAK_FLOPS

__all__ = ["ProbeRow", "SASS_OPS", "check_small", "run", "sass_counts", "check_sass"]

LEVELS = ((4096, 40), (1024, 80), (256, 160))  # the UNet's self-attention levels at 512^2
BATCH = 8  # the scripts' BH64 = B8 x H8
B1_ROW = (2, 4096, 40)  # perf_attn12's batch-1 row: UNet batch 2, level 0
TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}  # max |kernel - plain| / max |plain|


class ProbeRow(NamedTuple):
    script: str
    variant: str
    shape: str
    hot_ms: float
    cold_ms: float
    bound_ms: float
    bound_by: str
    yardstick: Optional[str]
    yard_cold_ms: Optional[float]

    def line(self, card: str) -> str:
        yard = ("" if self.yardstick is None else
                f" | {self.yardstick} cold {self.yard_cold_ms:.4f} ms")
        return (f"  {self.script:14s} {self.variant:34s} {self.shape:18s} hot "
                f"{self.hot_ms:.4f} ms cold {self.cold_ms:.4f} ms | bound {self.bound_ms:.4f} ms "
                f"({self.bound_by}) = {self.bound_ms / self.cold_ms:.3f} of cold{yard} ({card})")


def _bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS["float32" if dtype == torch.float32 else "bfloat16"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _randn(gen, shape, dev, dtype):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _split(t, heads):
    b, s, inner = t.shape
    return t.view(b, s, heads, inner // heads).transpose(1, 2)


def _sdpa(heads):
    return lambda q, k, v: F.scaled_dot_product_attention(_split(q, heads), _split(k, heads),
                                                          _split(v, heads))


def check_small(dev) -> list:
    """Every mode and flag of K7 against its plain twin at small ragged
    shapes; returns [(label, relative error, tolerance)]."""
    gen = torch.Generator(device=dev).manual_seed(21)
    out = []

    def rel(got, want):
        got, want = got.float(), want.float()
        if not bool(torch.isfinite(got).all()):
            return math.inf
        return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))

    b, h, sq, skv = 2, 2, 136, 200  # ragged: neither a multiple of 64
    for d in (40, 80, 160):
        q = _randn(gen, (b, sq, h * d), dev, torch.bfloat16)
        k, v = (_randn(gen, (b, skv, h * d), dev, torch.bfloat16) for _ in range(2))
        scale = d ** -0.5
        combos = [("full", "sum", "exp2", False, 64), ("full", "sum", "exp", False, 64),
                  ("full", "ones", "exp2", False, 64), ("full", "ones", "exp", False, 64),
                  ("full", "ones", "exp2", True, 64), ("full", "sum", "exp2", False, 128)]
        combos += [(m, "sum", "exp2", False, 64)
                   for m in ("scores", "max", "exp", "pv", "rowsum", "loads")]
        for mode, denom, ex, unnorm, tile in combos:
            args = (q, k, v, h, scale, mode, denom, ex, unnorm, tile)
            got = PA.attention_probe(*args)
            out.append((f"K7 bf16 d{d} {mode} denom={denom} {ex} unnormalized={unnorm} "
                        f"kv_tile={tile}", rel(got, PA.attention_probe_plain(*args)),
                        TOL[torch.bfloat16]))
        qd, kd, vd = (PA.to_dmajor(t, h) for t in (q, k, v))
        kc = k.view(b, skv, h, d).permute(0, 2, 1, 3)
        for kk, canon in ((kd, False), (kc, True)):
            got = PA.attention_dmajor_scores(qd, kk, vd, scale, canon)
            want = PA.attention_dmajor_scores_plain(qd, kk, vd, scale, canon)
            out.append((f"K7 (K5's loop) bf16 d{d} scores k_canonical={canon}", rel(got, want),
                        TOL[torch.bfloat16]))
    q, k, v = (_randn(gen, (b, s_, h * 40), dev, torch.float32) for s_ in (sq, skv, skv))
    got = PA.attention_probe(q, k, v, h, 40 ** -0.5, "scores")
    out.append(("K7 (K1's f32 loop) d40 scores",
                rel(got, PA.attention_probe_plain(q, k, v, h, 40 ** -0.5, "scores")),
                TOL[torch.float32]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def run(dev, card: str) -> list:
    """Every script variant at the scripts' shapes; returns the ProbeRows."""
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def timed(script, variant, shape, make, sets, fn, flops, nbytes, dtype, yard=None):
        hc = hot_cold_ms(make, fn, nbytes, sets)
        bound_ms, by = _bound(flops, nbytes, dtype)
        row = ProbeRow(script, variant, shape, hc.hot_ms, hc.cold_ms, bound_ms, by,
                       None if yard is None else "SDPA", None if yard is None else yard)
        rows.append(row)
        print(row.line(card), flush=True)
        torch.cuda.empty_cache()
        return row

    def bsc_maker(b, s, c, dtype):
        def make(i):
            g = torch.Generator(device=dev).manual_seed(1000 + i)
            return tuple(_randn(g, (b, s, c), dev, dtype) for _ in range(3))
        return make

    def derived(make, fn):
        return lambda i: fn(*make(i))

    for b, s, d in [(BATCH, s_, d_) for s_, d_ in LEVELS] + [B1_ROW]:
        h = 8
        c = h * d
        shape = f"B{b} H{h} S{s} d{d}"
        scale = d ** -0.5
        full_flops = 4.0 * b * h * s * s * d
        io = 4.0 * b * s * c * 2  # q, k, v read once, the output written once (bf16)
        make = bsc_maker(b, s, c, bf16)
        sets = []
        yard_hc = hot_cold_ms(make, _sdpa(h), io, sets)
        yard = yard_hc.cold_ms
        print(f"  {'(yardstick)':14s} {'SDPA':34s} {shape:18s} hot {yard_hc.hot_ms:.4f} ms "
              f"cold {yard:.4f} ms ({card})", flush=True)

        def probe(**kw):
            return lambda q, k, v: PA.attention_probe(q, k, v, h, scale, **kw)

        if b == BATCH:
            # perf_attn8: the (bq, bk) sweep of the online-softmax kernel
            dmk = derived(make, lambda q, k, v: tuple(PA.to_dmajor(t, h) for t in (q, k, v)))
            timed("perf_attn8", "flash_t: K5 d-major, 64-key tiles", shape, dmk, [],
                  lambda q, k, v: attention_dmajor(q, k, v, scale), full_flops, io, bf16, yard)
            timed("perf_attn8", "K1 (sm90 body)", shape, make, sets,
                  lambda q, k, v: flash_attention(q, k, v, h, scale), full_flops, io, bf16, yard)
            timed("perf_attn8", "K7 full, 128-key tiles", shape, make, sets,
                  probe(kv_tile=128), full_flops, io, bf16, yard)
            # perf_attn9: denominator and exp (V1 sum/exp, V2 ones/exp, V3 ones/exp2)
            for variant, denom, ex in (("V1: sum, exp", "sum", "exp"),
                                       ("V2: ones column, exp", "ones", "exp"),
                                       ("V3: ones column, exp2", "ones", "exp2"),
                                       ("K1's: sum, exp2", "sum", "exp2")):
                timed("perf_attn9", f"onepass {variant}", shape, make, sets,
                      probe(denom=denom, exp=ex), full_flops, io, bf16, yard)
            # perf_attn10: the ablation, at every level
            for variant, mode, flops in (("A scores", "scores", full_flops / 2),
                                         ("B +max", "max", full_flops / 2),
                                         ("C +exp2", "exp", full_flops / 2),
                                         ("G +row sum", "rowsum", full_flops / 2),
                                         ("D full", "full", full_flops),
                                         ("E PV only", "pv", full_flops / 2),
                                         ("(loads only)", "loads", 0.0)):
                timed("perf_attn10", variant, shape, make, sets, probe(mode=mode), flops, io,
                      bf16, yard if mode == "full" else None)
            if (s, d) == LEVELS[0]:
                timed("perf_attn10", "F scores, f32 operands", shape, bsc_maker(b, s, c, f32), [],
                      probe(mode="scores"), full_flops / 2, 2 * io, f32)
                # perf_attn11: h1 (K5 kcanon on ready operands) and h2 (ones
                # column, unnormalized f32 out), then both with their copies
                kcm = derived(make, lambda q, k, v: (
                    PA.to_dmajor(q, h), k.view(b, s, h, d).permute(0, 2, 1, 3),
                    PA.to_dmajor(v, h)))
                timed("perf_attn11", "H1: K5 kcanon", shape, kcm, [],
                      lambda q, k, v: attention_dmajor(q, k, v, scale, k_canonical=True),
                      full_flops, io, bf16, yard)
                unnorm_io = 3.0 * b * s * c * 2 + b * h * s * (d + 8) * 4
                timed("perf_attn11", "H2: K7 ones column, unnormalized f32", shape, make, sets,
                      probe(denom="ones", unnormalized=True), full_flops, unnorm_io, bf16, yard)
                timed("perf_attn11", "H1+prep: kcanon route", shape, make, sets,
                      lambda q, k, v: attention_kcanon(q, k, v, h, scale), full_flops, io, bf16,
                      yard)
                timed("perf_attn11", "H2+prep: h2 form", shape, make, sets,
                      lambda q, k, v: PA.h2_attention(q, k, v, h, scale), full_flops, io, bf16,
                      yard)

        # perf_attn12: the UNet interface [B, S, H*D], every copy inside
        def h1_scores(q, k, v):
            return PA.attention_dmajor_scores(PA.to_dmajor(q, h),
                                              k.view(b, s, h, d).permute(0, 2, 1, 3),
                                              PA.to_dmajor(v, h), scale, True)

        for variant, fn, flops, dt in (
                ("cur: K1", lambda q, k, v: flash_attention(q, k, v, h, scale), full_flops, bf16),
                ("h1: kcanon route (K5)", lambda q, k, v: attention_kcanon(q, k, v, h, scale),
                 full_flops, bf16),
                ("v3: K5 d-major + 3 copies", lambda q, k, v: PA.v3_attention(q, k, v, h, scale),
                 full_flops, bf16),
                ("v3-f32: K5 f32 on f32 copies", lambda q, k, v: PA.v3_attention(
                    q.float(), k.float(), v.float(), h, scale), full_flops, f32),
                ("cur QK-only: K7 scores", probe(mode="scores"), full_flops / 2, bf16),
                ("v3 QK-only: K5 scores + copies", lambda q, k, v: PA.v3_attention(
                    q, k, v, h, scale, attn=PA.attention_dmajor_scores), full_flops / 2, bf16),
                ("h1 QK-only: K5 scores + copies", h1_scores, full_flops / 2, bf16)):
            full = "QK-only" not in variant
            timed("perf_attn12", variant, shape, make, sets, fn, flops, io, dt,
                  yard if full else None)
    return rows


# ---- the SASS of the built library ----

# Itanium-mangled template arguments: ILi48E... = <48, ...>, Lb1E = true
_K1_RE = re.compile(r"attention_bf16_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])"
                    r"ELb([01])E")
_K5_RE = re.compile(r"attention_cm_bf16_kernelILi(\d+)ELb([01])ELi(\d+)E")
_F32_RE = re.compile(r"attention_f32_kernelILi(\d+)E")


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which(name), CUDA_HOME and str(Path(CUDA_HOME) / "bin" / name)):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(f"{name} not found (not on PATH, not under CUDA_HOME/bin)")


SASS_OPS = ("HMMA", "FFMA", "SHFL", "MUFU.RSQ", "HGMMA", "UTMALDG", "UBLKCP")


def sass_counts() -> dict:
    """{mangled kernel name: {op: n for op in SASS_OPS}} over the SASS of
    the kernel library (each function's static instruction count)."""
    lib = _build.kernel_library()
    sass = subprocess.run([_tool("cuobjdump"), "-sass", lib._name], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(SASS_OPS, 0)
        elif name is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{re.escape(op)}\b", ln):
                    counts[name][op] += 1
    return counts


def check_sass(counts: dict) -> tuple:
    """(lines, ok): each ablated mode's HMMA count against the MMAs of the
    steps it keeps, per 64-key tile: QK = DP/16 x 64/8 = DP/2 (the score
    product), PV = 64/16 x DP/8 = DP/2 (the PV product)."""
    k1, k5, f32 = {}, {}, {}
    for name, c in counts.items():
        if (m := _K1_RE.search(name)):
            k1[tuple(int(x) for x in m.groups())] = c
        elif (m := _K5_RE.search(name)):
            k5[tuple(int(x) for x in m.groups())] = c
        elif (m := _F32_RE.search(name)):
            f32[int(m.group(1))] = c
    lines = [f"{len(counts)} kernels in the library's SASS; {len(k1)} instantiations of K1's "
             f"bf16 loop, {len(k5)} of K5's prior loop, {len(f32)} of K1's f32 loop"]
    ok = True
    mode_names = {v: k for k, v in PA.MODES.items()}
    for dp in (48, 80, 160):
        qk = pv = dp // 2
        for mode in range(len(PA.MODES)):
            c = k1.get((dp, dp, 64, mode, 0, 1, 0))
            want = {PA.MODES["full"]: qk + pv, PA.MODES["pv"]: pv, PA.MODES["loads"]: 0}.get(mode,
                                                                                          qk)
            if c is None:
                ok = False
                lines.append(f"K7 DP{dp} {mode_names[mode]}: not in the library")
                continue
            ok &= c["HMMA"] == want
            lines.append(f"K7 (K1's loop) DP{dp} {mode_names[mode]:6s}: {c['HMMA']} HMMA a KV "
                         f"tile (the steps it keeps: {want})")
        for canon in (0, 1):
            cf, cs = k5.get((dp, canon, 0)), k5.get((dp, canon, 1))
            if cf is None or cs is None:
                ok = False
                lines.append(f"K5 DP{dp} k_canonical={bool(canon)}: an instantiation is missing")
                continue
            ok &= cs["HMMA"] == qk and cf["HMMA"] == qk + pv
            lines.append(f"K5's prior loop (attention_dmajor_prior; K7's K5 scores) DP{dp} "
                         f"k_canonical={bool(canon)}: scores {cs['HMMA']} HMMA, full "
                         f"{cf['HMMA']} (QK {qk}, PV {pv})")
    if 0 in f32 and 1 in f32:
        ok &= f32[1]["FFMA"] > 0
        lines.append(f"K1's f32 loop: scores {f32[1]['FFMA']} FFMA, full {f32[0]['FFMA']} FFMA "
                     f"(static counts)")
    else:
        ok = False
        lines.append("K1's f32 loop: an instantiation is missing")
    if not ok:
        lines.append("kernels: " + " ".join(sorted(counts))[:4000])
    return lines, ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sass", action="store_true", help="only count the SASS MMAs")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the attention probes need a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lines, ok = check_sass(sass_counts())
    for ln in lines:
        print(ln)
    if args.sass:
        return 0 if ok else 1
    dev = torch.device("cuda")
    bad = [c for c in check_small(dev) if not c[1] <= c[2]]
    if bad:
        raise SystemExit(f"probe disagrees with its plain twin: {bad}")
    run(dev, card)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
