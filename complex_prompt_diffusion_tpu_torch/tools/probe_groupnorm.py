"""The GroupNorm and streaming probes on the card: the counterparts of the TPU
scripts ``scripts/perf_gn4.py`` .. ``perf_gn8.py``, through K3, K8
(``csrc/probe_groupnorm.cu``) and K9 (``csrc/probe_copy_sm90.cu``, with its
replaced body ``csrc/probe_copy.cu`` beside it).

Run from the repository root on a machine with the GPU and nvcc::

    python -m complex_prompt_diffusion_tpu_torch.tools.probe_groupnorm

It checks in the built library's SASS (``cuobjdump``) that K8's ablated
modes keep their statistics, every mode, split and copy variant against
its plain twin at small shapes, and every copy mode at the copy scripts'
shapes bit-exact on both K9 bodies, then prints one row per script variant
at the scripts' shapes (batch 8, bf16; each K9 row followed by its replaced
body's): the time with the L2 hot and cold
(``tools/hotcold.py``), the bound (one read and one write of the plane over
3.35 TB/s), the bound's share of the cold time, and the library call on the
same inputs (``F.group_norm`` + ``F.silu`` on the channels_last view, or
``Tensor.copy_``). Its last line is the card's streaming rate: the best
cold row of K9's shipped body, its bytes over its time.
"""

from __future__ import annotations

import argparse
import re
import subprocess

import torch
import torch.nn.functional as F

from complex_prompt_diffusion_tpu_torch.ops.groupnorm import group_norm_nhwc
from complex_prompt_diffusion_tpu_torch.ops.probes.groupnorm import (
    GN_MODES,
    group_norm_probe,
    group_norm_probe_plain,
)
from complex_prompt_diffusion_tpu_torch.ops.probes.stream import (
    STAGES,
    stream_copy,
    stream_copy_plain,
    stream_copy_prior,
)
from complex_prompt_diffusion_tpu_torch.tools.hotcold import hot_cold_ms
from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import HBM_BYTES_PER_S
from complex_prompt_diffusion_tpu_torch.tools.probe_attention import ProbeRow, sass_counts

__all__ = ["check_copies", "check_sass", "check_small", "run", "streaming_rate"]

GN4_PLANES = ((64, 320), (64, 640), (32, 640), (32, 1280), (16, 1280), (16, 2560), (8, 1280))
GN5_PLANES = ((64, 320), (64, 640), (32, 1280), (16, 1280))
GN6_PLANES = ((64, 320), (64, 640), (32, 1280))
COPY_SHAPES = ((4096, 320), (4096, 640), (1024, 1280))  # perf_gn7 / perf_gn8 [8, hw, c]
BATCH = 8
TOL_BF16 = 2e-2  # max |kernel - plain| / max |plain|; the copies and "stats" are exact


def check_small(dev) -> list:
    """Every K8 mode (and the tensor-core statistics and forced splits) and
    every K9 variant against its plain twin; returns [(label, error,
    tolerance)] (relative error, or for the exact ones the count of
    differing elements with tolerance 0)."""
    gen = torch.Generator(device=dev).manual_seed(22)
    out = []
    for shape in ((2, 16, 16, 64), (2, 12, 12, 320), (1, 8, 8, 1280)):  # C/G = 2, 10, 40
        c = shape[-1]
        x = (torch.randn(shape, generator=gen, device=dev) * 2 + 0.5).to(torch.bfloat16)
        gamma = (torch.randn(c, generator=gen, device=dev) * 0.5 + 1).to(torch.bfloat16)
        beta = (torch.randn(c, generator=gen, device=dev) * 0.5).to(torch.bfloat16)
        variants = [(m, None, False) for m in GN_MODES] + [("full", None, True)]
        variants += [("full", s, False) for s in (1, 3, shape[1] * shape[2])]
        for mode, splits, mma in variants:
            got = group_norm_probe(x, gamma, beta, mode, splits=splits, mma=mma).float()
            want = group_norm_probe_plain(x, gamma, beta, mode, splits=splits, mma=mma).float()
            label = f"K8 {'x'.join(map(str, shape))} {mode} splits={splits} mma={mma}"
            if mode in ("copy", "stats"):
                out.append((label, float((got != want).sum()), 0.0))
            else:
                out.append((label, float((got - want).abs().max() / want.abs().max()), TOL_BF16))
    x = torch.randn((2, 256, 64), generator=gen, device=dev).to(torch.bfloat16)
    for rows in (4, 64, 256):
        for convert in (False, True):
            for stages in STAGES:
                got = stream_copy(x, rows, convert, stages)
                want = stream_copy_plain(x, rows, convert, stages)
                out.append((f"K9 [2,256,64] rows={rows} convert={convert} stages={stages}",
                            float((got != want).sum()), 0.0))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


def copy_modes(hw: int) -> list:
    """(script, rows, convert, stages) of every K9 variant ``run`` times on a
    plane of ``hw`` rows: perf_gn7's tiles plain and through f32 (one
    stage), perf_gn8's rings (plain)."""
    gn7 = [("perf_gn7", ch, cv, 1) for ch in dict.fromkeys((hw, 2048, 1024, 512, 256, 64, 16))
           if ch <= hw and hw % ch == 0 for cv in (False, True)]
    return gn7 + [("perf_gn8", ch, False, st) for ch in (2048, 1024, 512, 64)
                  if ch <= hw and hw % ch == 0 for st in STAGES]


def check_copies(dev) -> list:
    """Every K9 mode (each tile size of ``run``, plain and through f32, at
    every depth) at the copy scripts' shapes, on the shipped body and the
    replaced one: [(label, differing elements, 0)]."""
    gen = torch.Generator(device=dev).manual_seed(23)
    out = []
    for hw, c in COPY_SHAPES:
        x = torch.randn((BATCH, hw, c), generator=gen, device=dev).to(torch.bfloat16)
        for rows in dict.fromkeys(m[1] for m in copy_modes(hw)):
            for convert in (False, True):
                for stages in STAGES:
                    for name, fn in (("K9", stream_copy), ("K9 replaced body", stream_copy_prior)):
                        got = fn(x, rows, convert, stages)
                        out.append((f"{name} [{BATCH},{hw},{c}] rows={rows} convert={convert} "
                                    f"stages={stages}", float((got != x).sum()), 0.0))
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return out


# Itanium-mangled template arguments of K3's fused bf16 kernel: <bf16, VEC, MODE, MMA>
_FUSED_RE = re.compile(r"group_norm_kernelI13__nv_bfloat16Li(\d+)ELi(\d+)ELb([01])E")


def check_sass(counts: dict) -> tuple:
    """(lines, ok): K8's modes keep their statistics. The "stats" mode
    writes ``x + rstd * 0``, which equals its plain twin ``x`` whether or not
    the statistics ran, so the SASS shows it: at every pack width its warp
    shuffles (the two block sums) equal the full mode's, its rsqrt is there,
    and the copy mode (no statistics) has no shuffle. The tensor-core
    statistics hold HMMAs."""
    fused = {}
    for name, c in counts.items():
        if (m := _FUSED_RE.search(name)):
            fused[tuple(int(x) for x in m.groups())] = c
    lines, ok = [f"{len(fused)} instantiations of K3's fused bf16 kernel"], True
    for vec in (8, 4, 2, 1):
        full, copy, stats = (fused.get((vec, GN_MODES[m], 0)) for m in ("full", "copy", "stats"))
        mma = fused.get((vec, GN_MODES["full"], 1))
        if None in (full, copy, stats, mma):
            ok = False
            lines.append(f"K8 VEC{vec}: an instantiation is missing")
            continue
        ok &= (stats["SHFL"] == full["SHFL"] > 0 == copy["SHFL"] and stats["MUFU.RSQ"] > 0
               and mma["HMMA"] > 0)
        lines.append(f"K8 (K3's fused kernel) VEC{vec}: SHFL / MUFU.RSQ / FFMA full "
                     f"{full['SHFL']} / {full['MUFU.RSQ']} / {full['FFMA']}, stats {stats['SHFL']} / "
                     f"{stats['MUFU.RSQ']} / {stats['FFMA']}, copy {copy['SHFL']} / "
                     f"{copy['MUFU.RSQ']} / {copy['FFMA']}; mma statistics {mma['HMMA']} HMMA")
    return lines, ok


def _gn_lib(x, gamma, beta, silu=True):
    y = F.group_norm(x.permute(0, 3, 1, 2), 32, gamma, beta, 1e-5)
    return F.silu(y) if silu else y


def run(dev, card: str) -> list:
    """Every script variant at the scripts' shapes; returns the ProbeRows."""
    rows = []

    def timed(script, variant, shape, make, sets, fn, nbytes, yard=None, yard_name=None):
        hc = hot_cold_ms(make, fn, nbytes, sets)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        row = ProbeRow(script, variant, shape, hc.hot_ms, hc.cold_ms, bound_ms, "bytes",
                       None if yard is None else yard_name, yard)
        rows.append(row)
        print(row.line(card), flush=True)
        return row

    def gn_maker(shape):
        def make(i):
            g = torch.Generator(device=dev).manual_seed(2000 + i)
            c = shape[-1]
            x = (torch.randn(shape, generator=g, device=dev) * 2 + 0.5).to(torch.bfloat16)
            return (x, torch.ones(c, device=dev, dtype=torch.bfloat16),
                    torch.zeros(c, device=dev, dtype=torch.bfloat16))
        return make

    gn_sets = {}  # plane -> (input sets, the library call's cold ms), shared by the scripts

    def gn_case(hw_side, c):
        shape = (BATCH, hw_side, hw_side, c)
        nbytes = 2.0 * BATCH * hw_side * hw_side * c * 2 + 4 * c  # 1R + 1W, gamma and beta
        make = gn_maker(shape)
        if shape not in gn_sets:
            sets = []
            gn_sets[shape] = (sets, hot_cold_ms(make, _gn_lib, nbytes, sets).cold_ms)
        sets, yard = gn_sets[shape]
        return f"B{BATCH} {hw_side}x{hw_side}x{c}", make, sets, nbytes, yard

    lib = "F.group_norm+F.silu"
    for side, c in GN4_PLANES:
        shape, make, sets, nbytes, yard = gn_case(side, c)
        hw = side * side
        timed("perf_gn4", "ship: K3", shape, make, sets,
              lambda x, g, b: group_norm_nhwc(x, g, b, 32, 1e-5, True), nbytes, yard, lib)
        for ch in dict.fromkeys((hw, 2048, 1024, 512, 256)):
            if ch <= hw and hw % ch == 0:
                timed("perf_gn4", f"chunk{ch}: K3 split kernels, {hw // ch} splits", shape, make,
                      sets, lambda x, g, b, s_=hw // ch: group_norm_probe(x, g, b, splits=s_),
                      nbytes, yard, lib)
        timed("perf_gn4", "flat_onepass: K3 fused kernel", shape, make, sets,
              lambda x, g, b: group_norm_probe(x, g, b), nbytes, yard, lib)
    for side, c in GN5_PLANES:
        shape, make, sets, nbytes, yard = gn_case(side, c)
        merged = timed("perf_gn5", "merged: K3 fused kernel", shape, make, sets,
                       lambda x, g, b: group_norm_probe(x, g, b), nbytes, yard, lib)
        row = merged._replace(variant="nohi: = merged (an index map, no matmul)")
        rows.append(row)
        print(row.line(card), flush=True)
        timed("perf_gn5", "mxu: K8 tensor-core statistics", shape, make, sets,
              lambda x, g, b: group_norm_probe(x, g, b, mma=True), nbytes, yard, lib)
    for side, c in GN6_PLANES:
        shape, make, sets, nbytes, yard = gn_case(side, c)
        for mode in ("copy", "stats", "norm", "full", "bf16sig"):
            timed("perf_gn6", f"{mode}: K8", shape, make, sets,
                  lambda x, g, b, m_=mode: group_norm_probe(x, g, b, m_), nbytes,
                  yard if mode in ("full", "bf16sig") else None, lib)
    gn_sets.clear()
    torch.cuda.empty_cache()

    for hw, c in COPY_SHAPES:
        shape = f"[{BATCH},{hw},{c}]"
        nbytes = 2.0 * BATCH * hw * c * 2

        def make(i, hw=hw, c=c):
            g = torch.Generator(device=dev).manual_seed(3000 + i)
            x = torch.randn((BATCH, hw, c), generator=g, device=dev).to(torch.bfloat16)
            return x, torch.empty_like(x)

        sets = []
        yard = hot_cold_ms(make, lambda x, y: y.copy_(x), nbytes, sets).cold_ms
        for script, ch, convert, stages in copy_modes(hw):
            for body, fn in (("K9", stream_copy), ("K9 replaced body", stream_copy_prior)):
                variant = (f"{'f' if convert else 'p'}{ch}: {body} {ch}-row tiles"
                           if script == "perf_gn7" else
                           f"c{ch}b{stages}: {body} {stages}-stage ring")
                timed(script, variant, shape, make, sets,
                      lambda x, y, r=ch, cv=convert, st=stages, f=fn: f(x, r, cv, st),
                      nbytes, yard, "copy_")
        sets.clear()
        torch.cuda.empty_cache()
    return rows


def streaming_rate(rows) -> tuple:
    """(TB/s, row) of the fastest cold row of K9's shipped body: bytes read
    and written over its cold time."""
    best = min((r for r in rows if r.script in ("perf_gn7", "perf_gn8")
                and "replaced" not in r.variant),
               key=lambda r: r.cold_ms / r.bound_ms)
    return best.bound_ms / best.cold_ms * HBM_BYTES_PER_S / 1e12, best


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the GroupNorm probes need a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lines, ok = check_sass(sass_counts())
    for ln in lines:
        print(ln)
    dev = torch.device("cuda")
    bad = [c for c in check_small(dev) if not c[1] <= c[2]]
    if bad:
        raise SystemExit(f"probe disagrees with its plain twin: {bad}")
    rows = run(dev, card)
    rate, best = streaming_rate(rows)
    print(f"streaming rate: {rate:.3f} TB/s (cold, {best.script} {best.variant} {best.shape}; "
          f"nominal {HBM_BYTES_PER_S / 1e12:.2f}) ({card})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
