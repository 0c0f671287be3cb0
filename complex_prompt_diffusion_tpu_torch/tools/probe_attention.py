"""The attention probes on the card: the counterparts of the TPU scripts
``scripts/perf_attn8.py`` .. ``perf_attn12.py``, through K7
(``csrc/probe_attention.cu``: K1's and K5's Hopper loops, K1's fused f32
body), K1 and K5.

Run from the repository root on a machine with the GPU and nvcc::

    python -m complex_prompt_diffusion_tpu_torch.tools.probe_attention
    python -m complex_prompt_diffusion_tpu_torch.tools.probe_attention --sass

It checks every mode and flag against its plain twin at a small shape (and
K7's full mode at K1's choices against K1's own output, bit for bit), then
prints one row per script variant at the scripts' shapes (B8 H8 = the
scripts' BH64, at the UNet levels S4096 d40, S1024 d80, S256 d160; B2 for
``perf_attn12``'s batch-1 row): the kernel's time with the L2 hot and cold
(``tools/hotcold.py``), the bound (the least time an H100 could take for
the row's work: flops over 989 TFLOP/s bf16 or 165 TFLOP/s of f32 work as
three TF32 products, or bytes over 3.35 TB/s), the bound's share of the
cold time, SDPA's time on the same inputs where the row computes the
attention, and the replaced loop's time (``attention_probe_prior``, the
mma.sync and FMA loops K7 ran before) where a K7 row has one. After the
ablation rows of each level it prints each mode's share of the full mode's
time, hot and cold. ``--sass`` counts the wgmma (HGMMA) instructions of
every K7 instantiation and the HMMA of the replaced loops in the built
library's SASS (``cuobjdump``) and holds each ablated mode to the products
of the steps it keeps.
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
    k1_bf16_key_tile,
)
from complex_prompt_diffusion_tpu_torch.ops.probes import attention as PA
from complex_prompt_diffusion_tpu_torch.tools.hotcold import hot_cold_ms
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import HBM_BYTES_PER_S, PEAK_FLOPS

__all__ = ["ProbeRow", "SASS_OPS", "check_small", "run", "sass_counts", "check_sass",
           "sm90_hgmma", "f32x3_hgmma"]

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
    replaced_hot_ms: Optional[float] = None  # the replaced loop's times, where it has the row
    replaced_cold_ms: Optional[float] = None

    def line(self, card: str) -> str:
        yard = ("" if self.yardstick is None else
                f" | {self.yardstick} cold {self.yard_cold_ms:.4f} ms")
        if self.replaced_cold_ms is not None:
            yard += (f" | replaced loop hot {self.replaced_hot_ms:.4f} ms cold "
                     f"{self.replaced_cold_ms:.4f} ms")
        return (f"  {self.script:14s} {self.variant:34s} {self.shape:18s} hot "
                f"{self.hot_ms:.4f} ms cold {self.cold_ms:.4f} ms | bound {self.bound_ms:.4f} ms "
                f"({self.bound_by}) = {self.bound_ms / self.cold_ms:.3f} of cold{yard} ({card})")


def _bound(flops: float, nbytes: float, dtype) -> tuple:
    """The least time of a row: bf16 products at the bf16 rate, f32 ones at
    the rate of three TF32 products (K7's f32 scores and K5's f32 body run
    so)."""
    t_ops = flops / PEAK_FLOPS["tf32x3" if dtype == torch.float32 else "bfloat16"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _prior_kw(kw: dict) -> dict:
    """The replaced loop's arguments for a K7 row: the same flags, at its
    64-key tiles unless the row asks for 128 (its ablated modes and flags
    ran at 64)."""
    return {**kw, "kv_tile": 128 if kw.get("kv_tile") == 128 else 64}


def _randn(gen, shape, dev, dtype):
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def _split(t, heads):
    b, s, inner = t.shape
    return t.view(b, s, heads, inner // heads).transpose(1, 2)


def _sdpa(heads):
    return lambda q, k, v: F.scaled_dot_product_attention(_split(q, heads), _split(k, heads),
                                                          _split(v, heads))


def check_small(dev) -> list:
    """Every mode and flag of K7, and of its replaced loops, against the
    plain twin at small ragged shapes, and K7's full mode at K1's choices
    against K1's own output (tolerance 0: the same loop); returns [(label,
    error, tolerance)]."""
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
        combos = [dict(), dict(exp="exp"), dict(denom="ones"), dict(denom="ones", exp="exp"),
                  dict(denom="ones", unnormalized=True)]
        if k1_bf16_key_tile(d) == 128:
            combos.append(dict(kv_tile=64))
        combos += [dict(mode=m) for m in ("scores", "max", "exp", "pv", "rowsum", "loads")]
        for kw in combos:
            tag = " ".join(f"{key}={val}" for key, val in kw.items()) or "K1's choices"
            want = PA.attention_probe_plain(q, k, v, h, scale, **kw)
            out.append((f"K7 bf16 d{d} {tag}", rel(PA.attention_probe(q, k, v, h, scale, **kw),
                                                  want), TOL[torch.bfloat16]))
            out.append((f"K7's replaced loop bf16 d{d} {tag}",
                        rel(PA.attention_probe_prior(q, k, v, h, scale, **_prior_kw(kw)), want),
                        TOL[torch.bfloat16]))
        same = PA.attention_probe(q, k, v, h, scale)
        k1 = flash_attention(q, k, v, h, scale)
        out.append((f"K7 full at K1's choices vs K1 (max |difference|) bf16 d{d}",
                    float((same.float() - k1.float()).abs().max()), 0.0))
        qd, kd, vd = (PA.to_dmajor(t, h) for t in (q, k, v))
        kc = k.view(b, skv, h, d).permute(0, 2, 1, 3)
        for kk, canon in ((kd, False), (kc, True)):
            want = PA.attention_dmajor_scores_plain(qd, kk, vd, scale, canon)
            for fn, name in ((PA.attention_dmajor_scores, "K7 (K5's loop)"),
                             (PA.attention_dmajor_scores_prior, "K7's replaced K5 loop")):
                out.append((f"{name} bf16 d{d} scores k_canonical={canon}",
                            rel(fn(qd, kk, vd, scale, canon), want), TOL[torch.bfloat16]))
        q, k, v = (t.float() for t in (q, k, v))
        want = PA.attention_probe_plain(q, k, v, h, scale, "scores")
        for fn, name in ((PA.attention_probe, "K7 (K1's fused f32 body)"),
                         (PA.attention_probe_prior, "K7's replaced f32 loop")):
            out.append((f"{name} d{d} scores", rel(fn(q, k, v, h, scale, "scores"), want),
                        TOL[torch.float32]))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def run(dev, card: str) -> list:
    """Every script variant at the scripts' shapes; returns the ProbeRows."""
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []

    def timed(script, variant, shape, make, sets, fn, flops, nbytes, dtype, yard=None,
              prior=None):
        hc = hot_cold_ms(make, fn, nbytes, sets)
        ph = hot_cold_ms(make, prior, nbytes, sets) if prior is not None else None
        bound_ms, by = _bound(flops, nbytes, dtype)
        row = ProbeRow(script, variant, shape, hc.hot_ms, hc.cold_ms, bound_ms, by,
                       None if yard is None else "SDPA", None if yard is None else yard,
                       None if ph is None else ph.hot_ms, None if ph is None else ph.cold_ms)
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

        def prior(**kw):
            kw = _prior_kw(kw)
            return lambda q, k, v: PA.attention_probe_prior(q, k, v, h, scale, **kw)

        if b == BATCH:
            # perf_attn8: the (bq, bk) sweep of the online-softmax kernel
            dmk = derived(make, lambda q, k, v: tuple(PA.to_dmajor(t, h) for t in (q, k, v)))
            timed("perf_attn8", "flash_t: K5 d-major", shape, dmk, [],
                  lambda q, k, v: attention_dmajor(q, k, v, scale), full_flops, io, bf16, yard)
            timed("perf_attn8", "K1 (sm90 body)", shape, make, sets,
                  lambda q, k, v: flash_attention(q, k, v, h, scale), full_flops, io, bf16, yard)
            if k1_bf16_key_tile(d) == 128:
                timed("perf_attn8", "K7 full, 64-key tiles", shape, make, sets,
                      probe(kv_tile=64), full_flops, io, bf16, yard, prior(kv_tile=64))
            timed("perf_attn8", "K7 full, K1's key tile", shape, make, sets,
                  probe(), full_flops, io, bf16, yard,
                  prior(kv_tile=k1_bf16_key_tile(d)))
            # perf_attn9: denominator and exp (V1 sum/exp, V2 ones/exp, V3 ones/exp2)
            for variant, denom, ex in (("V1: sum, exp", "sum", "exp"),
                                       ("V2: ones column, exp", "ones", "exp"),
                                       ("V3: ones column, exp2", "ones", "exp2"),
                                       ("K1's: sum, exp2", "sum", "exp2")):
                timed("perf_attn9", f"onepass {variant}", shape, make, sets,
                      probe(denom=denom, exp=ex), full_flops, io, bf16, yard,
                      prior(denom=denom, exp=ex))
            # perf_attn10: the ablation of K1's loop, at every level
            abl = {}
            for variant, mode, flops in (("A scores", "scores", full_flops / 2),
                                         ("B +max", "max", full_flops / 2),
                                         ("C +exp2", "exp", full_flops / 2),
                                         ("G +row sum", "rowsum", full_flops / 2),
                                         ("D full", "full", full_flops),
                                         ("E PV only", "pv", full_flops / 2),
                                         ("(loads only)", "loads", 0.0)):
                abl[mode] = timed("perf_attn10", variant, shape, make, sets, probe(mode=mode),
                                  flops, io, bf16, yard if mode == "full" else None,
                                  prior(mode=mode))
            full = abl["full"]
            print(f"  ablation of K1's sm90 loop at {shape}, each mode's share of the full "
                  f"mode's time, hot / cold: " + ", ".join(
                      f"{m} {r.hot_ms / full.hot_ms:.3f} / {r.cold_ms / full.cold_ms:.3f}"
                      for m, r in abl.items()) + f" ({card})", flush=True)
            if (s, d) == LEVELS[0]:
                timed("perf_attn10", "F scores, f32 operands", shape, bsc_maker(b, s, c, f32), [],
                      probe(mode="scores"), full_flops / 2, 2 * io, f32, None,
                      prior(mode="scores"))
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
                      probe(denom="ones", unnormalized=True), full_flops, unnorm_io, bf16, yard,
                      prior(denom="ones", unnormalized=True))
                timed("perf_attn11", "H1+prep: kcanon route", shape, make, sets,
                      lambda q, k, v: attention_kcanon(q, k, v, h, scale), full_flops, io, bf16,
                      yard)
                timed("perf_attn11", "H2+prep: h2 form", shape, make, sets,
                      lambda q, k, v: PA.h2_attention(q, k, v, h, scale), full_flops, io, bf16,
                      yard)

        # perf_attn12: the UNet interface [B, S, H*D], every copy inside
        def h1_scores(scores):
            return lambda q, k, v: scores(PA.to_dmajor(q, h),
                                          k.view(b, s, h, d).permute(0, 2, 1, 3),
                                          PA.to_dmajor(v, h), scale, True)

        def v3_scores(scores):
            return lambda q, k, v: PA.v3_attention(q, k, v, h, scale, attn=scores)

        for variant, fn, flops, dt, replaced in (
                ("cur: K1", lambda q, k, v: flash_attention(q, k, v, h, scale), full_flops, bf16,
                 None),
                ("h1: kcanon route (K5)", lambda q, k, v: attention_kcanon(q, k, v, h, scale),
                 full_flops, bf16, None),
                ("v3: K5 d-major + 3 copies", lambda q, k, v: PA.v3_attention(q, k, v, h, scale),
                 full_flops, bf16, None),
                ("v3-f32: K5 f32 on f32 copies", lambda q, k, v: PA.v3_attention(
                    q.float(), k.float(), v.float(), h, scale), full_flops, f32, None),
                ("cur QK-only: K7 scores", probe(mode="scores"), full_flops / 2, bf16,
                 prior(mode="scores")),
                ("v3 QK-only: K5 scores + copies", v3_scores(PA.attention_dmajor_scores),
                 full_flops / 2, bf16, v3_scores(PA.attention_dmajor_scores_prior)),
                ("h1 QK-only: K5 scores + copies", h1_scores(PA.attention_dmajor_scores),
                 full_flops / 2, bf16, h1_scores(PA.attention_dmajor_scores_prior))):
            full = "QK-only" not in variant
            timed("perf_attn12", variant, shape, make, sets, fn, flops, io, dt,
                  yard if full else None, replaced)
    return rows


# ---- the SASS of the built library ----

# Itanium-mangled template arguments: ILi48E... = <48, ...>, Lb1E = true.
# K7 on the Hopper loops: K1's <DV, BKV, MODE, DENOM, EXP2, UNNORM>, K5's
# <DV, KCANON, MODE>, the fused f32 body's <DV, LAYOUT, MODE>
_SM90_RE = re.compile(r"attention_sm90_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])"
                      r"ELb([01])E")
_K5_SM90_RE = re.compile(r"attention_cm_sm90_kernelILi(\d+)ELb([01])ELi(\d+)E")
_F32X3_RE = re.compile(r"attention_f32x3_kernelILi(\d+)ELi(\d+)ELi(\d+)E")
# the replaced loops: K1's mma.sync loop, K5's, K1's f32 FMA loop
_K1_RE = re.compile(r"attention_bf16_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb([01])"
                    r"ELb([01])E")
_K5_RE = re.compile(r"attention_cm_bf16_kernelILi(\d+)ELb([01])ELi(\d+)E")
_F32_RE = re.compile(r"attention_f32_kernelILi(\d+)E")
_ROWS = 2  # f32x3::kRows


def _tool(name: str) -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    for cand in (shutil.which(name), CUDA_HOME and str(Path(CUDA_HOME) / "bin" / name)):
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError(f"{name} not found (not on PATH, not under CUDA_HOME/bin)")


SASS_OPS = ("HMMA", "FFMA", "SHFL", "MUFU.RSQ", "HGMMA", "UTMALDG", "UBLKCP")


def sass_counts() -> dict:
    """{mangled kernel name: {op: n for op in SASS_OPS}} over the SASS of
    the kernel library (each function's static instruction count), and
    "HGMMA.TF32": the wgmma instructions on TF32 operands."""
    lib = _build.kernel_library()
    sass = subprocess.run([_tool("cuobjdump"), "-sass", lib._name], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1)
            counts[name] = dict.fromkeys(SASS_OPS + ("HGMMA.TF32",), 0)
        elif name is not None:
            for op in SASS_OPS:
                if re.search(rf"\b{re.escape(op)}\b", ln):
                    counts[name][op] += 1
            if re.search(r"\bHGMMA\.\S*TF32", ln):
                counts[name]["HGMMA.TF32"] += 1
    return counts


def sm90_hgmma(dv: int, bkv: int, mode: int) -> int:
    """The wgmma instructions K1's Hopper loop holds at head dim ``dv`` with
    ``bkv``-key tiles in ``mode``: Q K^T of ceil(dv / 16) k-steps issued in
    three places (before the loop and in each of the two tile steps it
    unrolls), P V of bkv / 16 k-steps in two (the tile steps), and in a mode
    only the products of the steps it keeps."""
    qk, pv = -(-dv // 16), bkv // 16
    keeps_qk = mode not in (PA.MODES["pv"], PA.MODES["loads"])
    keeps_pv = mode in (PA.MODES["full"], PA.MODES["pv"])
    return 3 * qk * keeps_qk + 2 * pv * keeps_pv


def f32x3_hgmma(dv: int, mode: int) -> int:
    """The wgmma instructions of the fused 3xTF32 body at width ``dv``: three
    products a k-step, Q K^T over dv / 8 k-steps and (the full mode) P V
    over bkv / 8 (64 keys up to width 80, 32 above)."""
    bkv = 64 if dv <= 80 else 32
    return 3 * dv // 8 + (3 * bkv // 8 if mode == PA.MODES["full"] else 0)


def _k7_sm90_instances() -> list:
    """(DV, BKV, MODE, DENOM, EXP2, UNNORM) of every K7 instantiation of K1's
    Hopper loop (csrc/probe_attention_sm90.cuh)."""
    out = []
    for dv in (40, 80, 160):
        own = k1_bf16_key_tile(dv)
        out += [(dv, own, m, 0, 1, 0) for m in range(len(PA.MODES))]
        if own == 128:
            out.append((dv, 64, 0, 0, 1, 0))
        out += [(dv, own, 0, 0, 0, 0), (dv, own, 0, 1, 1, 0), (dv, own, 0, 1, 0, 0),
                (dv, own, 0, 1, 1, 1)]
    return out


def check_sass(counts: dict) -> tuple:
    """(lines, ok): each K7 instantiation's wgmma (HGMMA) count against the
    products of the steps its mode keeps (:func:`sm90_hgmma`,
    :func:`f32x3_hgmma`; K5's loop as K1's), and beside them the replaced
    loops' HMMA counts against theirs, per 64-key tile: QK = DP/16 x 64/8 =
    DP/2 (the score product), PV = 64/16 x DP/8 = DP/2."""
    sm90, k5s, f3, k1, k5, f32 = {}, {}, {}, {}, {}, {}
    for name, c in counts.items():
        for rx, into in ((_SM90_RE, sm90), (_K5_SM90_RE, k5s), (_F32X3_RE, f3), (_K1_RE, k1),
                         (_K5_RE, k5), (_F32_RE, f32)):
            if (m := rx.search(name)):
                key = tuple(int(x) for x in m.groups())
                into[key if len(key) > 1 else key[0]] = c
                break
    lines = [f"{len(counts)} kernels in the library's SASS; {len(sm90)} instantiations of K1's "
             f"Hopper loop, {len(k5s)} of K5's, {len(f3)} of the fused f32 body; replaced loops: "
             f"{len(k1)} of K1's mma.sync loop, {len(k5)} of K5's, {len(f32)} of K1's f32 FMA "
             f"loop"]
    ok = True
    mode_names = {v: k for k, v in PA.MODES.items()}
    for key in _k7_sm90_instances():
        dv, bkv, mode, denom, exp2, unnorm = key
        c = sm90.get(key)
        want = sm90_hgmma(dv, bkv, mode)
        flags = "" if (denom, exp2, unnorm) == (0, 1, 0) else (
            f" denom={'ones' if denom else 'sum'} {'exp2' if exp2 else 'exp'}"
            f"{' unnormalized' if unnorm else ''}")
        label = f"K7 (K1's Hopper loop) d{dv} {bkv}-key {mode_names[mode]}{flags}"
        if c is None:
            ok = False
            lines.append(f"{label}: not in the library")
            continue
        ok &= c["HGMMA"] == want and c["UTMALDG"] > 0
        lines.append(f"{label}: {c['HGMMA']} HGMMA (the steps it keeps: {want}), "
                     f"{c['UTMALDG']} UTMALDG")
    for dv in (40, 80, 160):
        bkv = k1_bf16_key_tile(dv)  # K5's tiles are K1's
        for canon in (0, 1):
            cf, cs = k5s.get((dv, canon, 0)), k5s.get((dv, canon, 1))
            if cf is None or cs is None:
                ok = False
                lines.append(f"K7 (K5's Hopper loop) d{dv} k_canonical={bool(canon)}: an "
                             f"instantiation is missing")
                continue
            want_s, want_f = sm90_hgmma(dv, bkv, 1), sm90_hgmma(dv, bkv, 0)
            ok &= cs["HGMMA"] == want_s and cf["HGMMA"] == want_f
            lines.append(f"K7 (K5's Hopper loop) d{dv} k_canonical={bool(canon)}: scores "
                         f"{cs['HGMMA']} HGMMA (want {want_s}), full {cf['HGMMA']} (want "
                         f"{want_f})")
        cs, cf = f3.get((dv, _ROWS, 1)), f3.get((dv, _ROWS, 0))
        if cs is None or cf is None:
            ok = False
            lines.append(f"K7 (K1's fused f32 body) d{dv}: an instantiation is missing")
            continue
        want_s, want_f = f32x3_hgmma(dv, 1), f32x3_hgmma(dv, 0)
        ok &= cs["HGMMA"] == want_s and cf["HGMMA"] == want_f
        lines.append(f"K7 (K1's fused f32 body) d{dv}: scores {cs['HGMMA']} HGMMA (want "
                     f"{want_s}), full {cf['HGMMA']} (want {want_f})")
    for dp in (48, 80, 160):
        qk = pv = dp // 2
        for mode in range(len(PA.MODES)):
            c = k1.get((dp, dp, 64, mode, 0, 1, 0))
            want = {PA.MODES["full"]: qk + pv, PA.MODES["pv"]: pv, PA.MODES["loads"]: 0}.get(mode,
                                                                                          qk)
            if c is None:
                ok = False
                lines.append(f"replaced loop DP{dp} {mode_names[mode]}: not in the library")
                continue
            ok &= c["HMMA"] == want
            lines.append(f"replaced loop (K1's mma.sync loop) DP{dp} {mode_names[mode]:6s}: "
                         f"{c['HMMA']} HMMA a KV tile (the steps it keeps: {want})")
        for canon in (0, 1):
            cf, cs = k5.get((dp, canon, 0)), k5.get((dp, canon, 1))
            if cf is None or cs is None:
                ok = False
                lines.append(f"K5 DP{dp} k_canonical={bool(canon)}: an instantiation is missing")
                continue
            ok &= cs["HMMA"] == qk and cf["HMMA"] == qk + pv
            lines.append(f"replaced loop (K5's mma.sync loop, attention_dmajor_prior) DP{dp} "
                         f"k_canonical={bool(canon)}: scores {cs['HMMA']} HMMA, full "
                         f"{cf['HMMA']} (QK {qk}, PV {pv})")
    if 0 in f32 and 1 in f32:
        ok &= f32[1]["FFMA"] > 0
        lines.append(f"replaced loop (K1's f32 FMA loop): scores {f32[1]['FFMA']} FFMA, full "
                     f"{f32[0]['FFMA']} FFMA (static counts)")
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
