#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It imports only
``complex_prompt_diffusion_tpu_torch`` (never jax or the JAX package) and:

  phase 0  builds the hand-written CUDA kernels from ``csrc/`` (nvcc, one
           process per source, in parallel), and checks in their SASS
           (``cuobjdump``) that the Hopper bodies of K1, K2, K4 and K5
           (``attention_sm90.cu``, ``attention_bf16_wide_sm90.cu``,
           ``attention_f32_sm90.cu``, ``attention_f32_fused_sm90.cu``,
           ``geglu_ff_sm90.cu``, ``geglu_ff_f32_sm90.cu``, ``conv3x3_sm90.cu``,
           ``conv3x3_f32_sm90.cu``, ``attention_cm_sm90.cu``,
           ``attention_cm_f32_sm90.cu``), of K6
           (``winograd_sm90.cu``, ``winograd_f32_sm90.cu``) and of K7
           (``probe_attention*.cu``: K1's and K5's Hopper loops and the fused
           f32 body in its modes) hold wgmma (HGMMA) and TMA load (UTMALDG)
           instructions in every instantiation (K7's loads-only mode, which
           computes nothing, TMA loads alone; K2's, K4's and K6's f32 bodies
           TF32 wgmma only), and K3's and K8's (``groupnorm_sm90.cu``,
           ``probe_groupnorm.cu``: K3's kernels in K8's modes) and K9's
           (``probe_copy_sm90.cu``) a TMA or bulk-copy load (UTMALDG or
           UBLKCP) in every one, K8's tensor-core statistics HMMA;
  phase 1  runs each kernel at its paths' shapes against its plain PyTorch
           twin on the card (TF32 off): error, the times (CUDA-graph
           replays, ``tools/hotcold.py``, one input repeated) of the kernel,
           the body it replaced where it is still built (K1's and K4's
           mma.sync bodies, K1's f32 FMA body, K3's, K5's, K6's, K7's, K8's
           and K9's first bodies; held to the same twin), the
           twin and the one
           PyTorch call that computes the same function (where there is
           one), and the bound from this case's bytes and flops, with the
           bound's share of the kernel's time (for the 3xTF32 bodies the
           FMA rate's bound beside it); the sums over the 22 convs
           of a batch-1 UNet call (bf16 and f32), over the 16 GEGLU FF
           calls of a b4 step (bf16 and f32) and of a b1 step (f32), and
           over the 61 GroupNorms of a b4 and of a b1 step; the host cost
           of one TMA tensor-map encode and of one call of the K1, K2, K4
           and K5 wrappers;
  phase 2  the main path: SD-1.5 at full width with random weights from a
           seed, txt2img at 512x512, batch 4, DDIM eta=0, CFG 7.5, then the
           exact-f32 VAE decode to uint8;
  phase 3  holds the kernel path to the plain path on small inputs at full
           width: one UNet eval (CUDA kernels vs the plain twins on CPU
           copies of the same weights), the f32 VAE decode, and the bf16
           VAE decode and encode;
  phase 4  the batch-1 render: txt2img at 512x512, batch 1, DDIM, CFG 7.5,
           bf16 VAE decode (``cast_vae("bfloat16")``): seconds to first
           image, s/step, decode ms, peak memory;
  phase 5  the bf16 VAE decode of phase 2's latents at batch 4, against
           their f32 decode;
  phase 6  img2img (DDIM, strength 0.75) of a phase-2 image at batch 1;
  phase 7  the k-diffusion render: txt2img at 512x512, batch 4, DPM++ 2M on
           the Karras schedule, 20 steps, CFG 7.5, the UNet's channel-major
           attention route on (``attn_route="cm"``: K5's bf16 body at
           levels 1 and 2), f32 decode; and one UNet eval with that route
           held against the same eval without it; then the UNet's 10 cm
           sites, each through the cm block against the default route on
           one input: in bf16 (K5's bf16 body against K1's sm90 body) and
           with the weights cast to f32 (K5's f32 body against K1's fused
           3xTF32 body); the sites' launches count as a path of their own;
  phase 8  k-family img2img at batch 1 (Euler Ancestral, strength 0.75: 6 of
           20 steps) with the canonical-K attention route switched on for
           the phase (K5's bf16 body at every self-attention site), bf16
           VAE;
  phase 9  the Winograd probe (K6), which no layer dispatches, called as
           its user would call it: on the weights of the UNet's 20 ResBlock
           convs of the 32x32 and 16x16 planes at UNet batch 2, each held
           against the same conv through ``layers.conv2d`` (K4): in bf16 on
           K6's Hopper body, in f32 on its 3xTF32 body (the kernels their
           plans predict), the f32 ones also against the plain twin at 1e-5
           (TF32 off); then the 20 convs of each dtype timed on K6's Hopper
           body, on its first body, through K4 and through cuDNN;
  phase 10 the probes of the TPU tuning scripts (``scripts/perf_attn8..12``,
           ``perf_gn4..8``), which no layer dispatches: every mode and flag
           of K7 (attention ablations), K8 (GroupNorm modes, tensor-core
           statistics, forced splits) and K9 (streaming copy), and of K7's,
           K8's and K9's replaced bodies, against its plain twin at small
           shapes, K7's full mode at K1's choices bit-exact against K1, K8's
           full mode at K3's plan bit-exact against K3, and every K9
           mode at the copy scripts' shapes bit-exact on both of K9's
           bodies; the SASS wgmma count of every K7 mode (and the replaced
           loops' HMMA) and the statistics of every GroupNorm mode
           (``cuobjdump``); then every script variant timed at the scripts'
           shapes with the L2 hot and cold, K7's, K8's and K9's replaced
           bodies beside their rows, and each K7 mode's share of the full mode's
           time at every UNet level (``tools/probe_attention.py``,
           ``tools/probe_groupnorm.py``);
  phase 11 the exact-f32 render: one SD-1.5 UNet eval cast to f32 on a
           16x16 latent against the plain twins on CPU copies (TF32 off);
           txt2img at 512x512, batch 1, DDIM, CFG 7.5 with the UNet in f32
           (``bundle.cast("float32")``: K2's and K4's 3xTF32 bodies, K1's
           fused 3xTF32 body), then the f32 decode: seconds to image,
           s/step, decode ms, peak memory; and a short txt2img of the
           default bundle, ``ModelBundle.random()`` with no arguments (the
           tiny config, f32 UNet: K4's FMA body at its narrow widths), a
           path of its own.

Each path of phases 2 and 4 to 11 runs with every launch count set to 0
just before it and read just after, and fails unless the kernels it must
run were launched: in phases 2, 4, 6 and 7 every UNet self-attention site
on K1's sm90 body (phase 11: its fused 3xTF32 body), in phases 2, 4 and 6
every GEGLU FF call on K2's bf16 body with the kernels its plan predicts
(the library reports what it launched; phase 11: its f32 body, none on the
bf16 one), in phases 2 and 11 the f32 VAE mid-block on K1's 3xTF32 body
(its split, scores, softmax and output kernels), in phase 7's f32 cm sites
K1's fused 3xTF32 body and K5's f32 body once a site, in phases 4, 6, 8 and
9 every batch-1 UNet conv on K4's sm90 body (phase 11: its f32 body, none
on the bf16 one), in phases 2 to 8 and 11 every GroupNorm (61 a UNet call, 30 a decode, 22 an
encode) on K3's Hopper body with the kernels its plans predict (the library
reports what it launched) and none on its replaced body, and in phases 3 to
6 and 8 every bf16 VAE mid-block attention on K1's wgmma wide body (its
scores, softmax and output kernels).
Any failure exits non-zero before the result lines. On success the
last three lines are the kernels JSON, the card's name and power limit
(from nvidia-smi) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "complex_prompt_diffusion_tpu_torch"

# kernel -> (source, the TPU kernel(s) it replaces)
KERNELS = {
    "attention_bf16_wide_sm90": (
        f"{PKG}/csrc/attention_bf16_wide_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:48 _attn_kernel (bf16, 256 < d <= 512)",
    ),
    "attention_f32_sm90": (
        f"{PKG}/csrc/attention_f32_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:48 _attn_kernel (f32, 160 < d <= 512)",
    ),
    "attention_f32_fused_sm90": (
        f"{PKG}/csrc/attention_f32_fused_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:48 _attn_kernel; "
        "complex_prompt_diffusion_tpu/ops/attention.py:152 _onepass_kernel (f32, d <= 160)",
    ),
    "attention_sm90": (
        f"{PKG}/csrc/attention_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:152 _onepass_kernel; "
        "complex_prompt_diffusion_tpu/ops/attention.py:48 _attn_kernel (bf16, d <= 256)",
    ),
    "geglu_ff": (
        f"{PKG}/csrc/geglu_ff_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/mlp.py:51 _ff_kernel (bf16)",
    ),
    "geglu_ff_f32_sm90": (
        f"{PKG}/csrc/geglu_ff_f32_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/mlp.py:51 _ff_kernel (f32)",
    ),
    "group_norm": (
        f"{PKG}/csrc/groupnorm_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:59 _gn_kernel; "
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:142 _gn_stats_kernel; "
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:175 _gn_stats2_kernel; "
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:221 _gn_apply_kernel",
    ),
    "conv3x3": (
        f"{PKG}/csrc/conv3x3.cu",
        "complex_prompt_diffusion_tpu/ops/conv.py:38 _kernel (f32 with C % 32 or Co % 64 != 0; "
        "bf16 with C or Co % 64 != 0)",
    ),
    "conv3x3_sm90": (
        f"{PKG}/csrc/conv3x3_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/conv.py:38 _kernel (bf16, C % 64 == Co % 64 == 0)",
    ),
    "conv3x3_f32_sm90": (
        f"{PKG}/csrc/conv3x3_f32_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/conv.py:38 _kernel (f32, C % 32 == Co % 64 == 0)",
    ),
    "attention_cm_sm90": (
        f"{PKG}/csrc/attention_cm_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:187 _onepass_kernel_hdbs; "
        "complex_prompt_diffusion_tpu/ops/attention.py:378 _onepass_kernel_kcanon (bf16)",
    ),
    "attention_cm_f32_sm90": (
        f"{PKG}/csrc/attention_cm_f32_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:187 _onepass_kernel_hdbs; "
        "complex_prompt_diffusion_tpu/ops/attention.py:378 _onepass_kernel_kcanon (f32)",
    ),
    "winograd": (
        f"{PKG}/csrc/winograd.cu",
        "complex_prompt_diffusion_tpu/ops/probes/winograd.py:82 _wino_kernel (f32 with C % 32 or "
        "Co % 64 != 0; bf16 with C or Co % 64 != 0)",
    ),
    "winograd_sm90": (
        f"{PKG}/csrc/winograd_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/probes/winograd.py:82 _wino_kernel (bf16, C % 64 == "
        "Co % 64 == 0)",
    ),
    "winograd_f32_sm90": (
        f"{PKG}/csrc/winograd_f32_sm90.cu",
        "complex_prompt_diffusion_tpu/ops/probes/winograd.py:82 _wino_kernel (f32, C % 32 == "
        "Co % 64 == 0)",
    ),
    "probe_attention": (
        f"{PKG}/csrc/probe_attention.cu",  # with the sources in PROBE_ATTENTION_SOURCES
        "scripts/perf_attn8.py:88 flash_t; scripts/perf_attn9.py:81 onepass; "
        "scripts/perf_attn10.py:84 run_mode; scripts/perf_attn11.py:92 h2; "
        "scripts/perf_attn12.py:51 v3_call, :105 h1_call (QK-only forms); "
        "scripts/perf_attn11.py:56 h1 is K5 (attention_cm_sm90)",
    ),
    "probe_groupnorm": (
        f"{PKG}/csrc/probe_groupnorm.cu",
        "scripts/perf_gn4.py:43,63 chunked, :96 flat_onepass; scripts/perf_gn5.py:111 make; "
        "scripts/perf_gn6.py:73 make",
    ),
    "probe_copy": (
        f"{PKG}/csrc/probe_copy_sm90.cu",
        "scripts/perf_gn7.py:36 make; scripts/perf_gn8.py:29 make",
    ),
}
# K7's sources: its entries, its instantiations of K1's Hopper loop (one
# file a head dim) and the loops it runs
PROBE_ATTENTION_SOURCES = tuple(f"{PKG}/csrc/{f}" for f in (
    "probe_attention.cu", "probe_attention_w40.cu", "probe_attention_w80.cu",
    "probe_attention_w160.cu", "probe_attention_sm90.cuh", "attention_sm90.cuh",
    "attention_cm_sm90.cuh", "attention_f32_fused.cuh"))
# the probes: no layer calls them; phase 10 runs the last three
PROBES = ("winograd", "winograd_sm90", "winograd_f32_sm90", "probe_attention", "probe_groupnorm",
          "probe_copy")
PHASE10_PROBES = PROBES[3:]
# K1's, K2's f32, K4's, K5's and K6's Hopper bodies, counted inside
# "attention", "geglu_ff", "conv3x3", "attention_cm" (K5's f32 body inside
# its Hopper count) and "winograd"
SM90 = {"attention_sm90": "attention", "attention_f32_sm90": "attention",
        "attention_f32_fused_sm90": "attention",
        "attention_bf16_wide_sm90": "attention", "conv3x3_sm90": "conv3x3",
        "conv3x3_f32_sm90": "conv3x3", "geglu_ff_f32_sm90": "geglu_ff",
        "attention_cm_sm90": "attention_cm", "attention_cm_f32_sm90": "attention_cm_sm90",
        "winograd_sm90": "winograd", "winograd_f32_sm90": "winograd"}
# phase 1's K1 f32, K5 and K6 cases (kernels "attention", "attention_cm" and
# "winograd", the routes) by the body they run
K1_BODY = {"float32": "attention_f32_fused_sm90"}
K5_BODY = {"bfloat16": "attention_cm_sm90", "float32": "attention_cm_f32_sm90"}
K6_BODY = {"bfloat16": "winograd_sm90", "float32": "winograd_f32_sm90"}
# the Hopper kernels phase 0 finds in the SASS: every instantiation must hold
# wgmma (HGMMA) and TMA loads (UTMALDG). attention_sm90_kernel is K1's and
# K7's (K1's loop in K7's modes), attention_cm_sm90_kernel K5's bf16 and
# K7's, attention_f32x3_kernel the fused 3xTF32 body of K1, K5 and K7;
# geglu_gemm_f32_sm90_kernel, conv3x3_f32_sm90_kernel and
# wino3x3_f32_sm90_kernel K2's, K4's and K6's f32 bodies, whose wgmma must be
# TF32 ones (TF32_FUNCTIONS)
SM90_FUNCTIONS = ("attention_sm90_kernel", "tf32x3_gemm_kernel", "wide_gemm_kernel",
                  "geglu_gemm_sm90_kernel", "conv3x3_sm90_kernel", "attention_cm_sm90_kernel",
                  "attention_f32x3_kernel", "wino3x3_sm90_kernel", "geglu_gemm_f32_sm90_kernel",
                  "conv3x3_f32_sm90_kernel", "wino3x3_f32_sm90_kernel")
TF32_FUNCTIONS = ("geglu_gemm_f32_sm90_kernel", "conv3x3_f32_sm90_kernel",
                  "wino3x3_f32_sm90_kernel")
# K7's loads-only mode of K1's loop (MODE 6 of attention_sm90_kernel<DV, BKV,
# MODE, ...>) computes nothing: TMA loads, no wgmma
LOADS_ONLY = re.compile(r"attention_sm90_kernelILi\d+ELi\d+ELi6E")
# K3's, K8's (K3's kernels in K8's modes) and K9's kernels: every
# instantiation must load by TMA (UTMALDG) or bulk copy (UBLKCP)
BULK_FUNCTIONS = ("gn_slab_kernel", "gn_stats_kernel", "gn_apply_kernel", "copy_bulk_kernel")
# K8's instantiations with the tensor-core statistics (MMA = true: the slab
# kernel <bf16, full, true>, the statistics kernel <bf16, true>) must hold
# mma.sync (HMMA) or wgmma (HGMMA)
MMA_STATS = re.compile(r"gn_slab_kernelI13__nv_bfloat16Li0ELb1E|"
                       r"gn_stats_kernelI13__nv_bfloat16Lb1E")

TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # max |a - b| / max |b|

DDIM_PATH_KERNELS = ("attention", "geglu_ff", "group_norm", "conv3x3")  # phases 4 and 6
UNET_CONVS_PER_CALL_B1 = 22  # 3x3 convs on the 16^2/32^2 planes at UNet batch 2
UNET_CONVS_16_LATENT = 13  # of a UNet call on a 16x16 latent: conv_in, out conv and 11 more
UNET_FF_SITES = 16  # GEGLU FF calls a UNet call: 5 at each of three levels, 1 in the middle
K_STEPS = 20  # steps of the k-diffusion paths (phases 7 and 8)
UNET_SELF_ATTN_SITES = 15  # self-attention sites above S = 128 at 512x512: 5 a level
UNET_CM_SITES = 10  # of them inside the cm gate (levels 1 and 2: C = 640, 1280)
UNET_GN_CALLS = 61  # GroupNorms a UNet call (tools/kernel_cases.py: GN_B4_CALLS)
VAE_DECODE_GN_CALLS = 30  # GroupNorms a VAE decode: mid-block 5, up levels 24, out 1
VAE_ENCODE_GN_CALLS = 22  # a VAE encode: down levels 16, mid-block 5, out 1


class SmokeFailure(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise SmokeFailure("nvidia-smi printed no card")
    return out[0].strip()


def rel_err(got, want) -> tuple:
    """(max |got - want|, that over max |want|); non-finite output, or
    output of another shape, fails."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise SmokeFailure(f"output of shape {list(got.shape)}, want {list(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise SmokeFailure("kernel output has non-finite values")
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-30)


def phase0_sass(card: str) -> None:
    """The TMA + wgmma bodies of K1, K2, K4, K5, K6 and K7 as built: every
    instantiation must hold HGMMA (wgmma) and UTMALDG (TMA tensor load)
    instructions (K7's loads-only mode UTMALDG alone), K2's, K4's and K6's
    f32 bodies TF32 wgmma only; K3's, K8's and K9's kernels a TMA or
    bulk-copy load (UTMALDG or UBLKCP), K8's tensor-core statistics HMMA or
    HGMMA."""
    from complex_prompt_diffusion_tpu_torch.tools import probe_attention as PA

    counts = PA.sass_counts()
    for body in SM90_FUNCTIONS:
        fns = {n: c for n, c in counts.items() if body in n}
        bad = [n for n, c in fns.items()
               if (c["HGMMA"] == 0 and not LOADS_ONLY.search(n)) or c["UTMALDG"] == 0]
        hg = sorted(c["HGMMA"] for c in fns.values())
        tm = sorted(c["UTMALDG"] for c in fns.values())
        print(f"phase0: SASS (cuobjdump) of {body}: {len(fns)} instantiations, HGMMA "
              f"{hg[0] if hg else 0}..{hg[-1] if hg else 0}, UTMALDG {tm[0] if tm else 0}.."
              f"{tm[-1] if tm else 0} a function ({card})")
        if not fns or bad:
            raise SmokeFailure(f"{body}: no instantiation, or one without HGMMA or UTMALDG: "
                               f"{bad or 'none built'}")
        if body in TF32_FUNCTIONS:
            not_tf32 = [n for n, c in fns.items() if c["HGMMA.TF32"] != c["HGMMA"]]
            print(f"phase0: {body}: HGMMA on TF32 operands "
                  f"{sorted(c['HGMMA.TF32'] for c in fns.values())} a function ({card})")
            if not_tf32:
                raise SmokeFailure(f"{body}: wgmma other than TF32 in {not_tf32}")
    for body in BULK_FUNCTIONS:
        fns = {n: c["UTMALDG"] + c["UBLKCP"] for n, c in counts.items() if body in n}
        bad = [n for n, c in fns.items() if c == 0]
        print(f"phase0: SASS (cuobjdump) of {body}: {len(fns)} instantiations, UTMALDG + UBLKCP "
              f"{sorted(fns.values())} ({card})")
        if not fns or bad:
            raise SmokeFailure(f"{body}: no instantiation, or one without a TMA or bulk-copy "
                               f"load: {bad or 'none built'}")
    mma = {n: c["HMMA"] + c["HGMMA"] for n, c in counts.items() if MMA_STATS.search(n)}
    print(f"phase0: SASS (cuobjdump) of K8's tensor-core statistics: {len(mma)} instantiations, "
          f"HMMA + HGMMA {sorted(mma.values())} ({card})")
    if len(mma) < 2 or not all(mma.values()):
        raise SmokeFailure(f"K8's tensor-core statistics: want the slab and statistics kernels "
                           f"with HMMA or HGMMA, got {mma or 'none built'}")


def phase1(dev, card: str) -> dict:
    """Each kernel against its plain twin at its paths' shapes."""
    import torch

    from complex_prompt_diffusion_tpu_torch import _build
    from complex_prompt_diffusion_tpu_torch.tools.hotcold import L2_BYTES, METHOD, graph_ms
    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import (
        B1_UNET_CONV_COUNTS,
        B1_UNET_CONVS,
        GEGLU_B1_ROWS,
        GEGLU_B4_CALLS,
        GEGLU_ROWS,
        GN_B4_CALLS,
        GN_UNET_PLANES,
        HBM_BYTES_PER_S,
        PEAK_FLOPS,
        host_us,
        kernel_cases,
    )

    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0, "replaced_ms": None,
                      "by": {"bytes": 0.0, "operations": 0.0}}
               for name in KERNELS}
    conv_ms = {}  # K4's time by case label, printed beside K6's at the same shape
    conv_rows = {}  # the sm90 K4 cases: label -> (kernel, mma.sync body, library, bound) ms
    ff_rows = {}  # K2's cases: label -> (kernel, plain, bound) ms
    gn_rows = {}  # K3's cases: label -> (kernel, replaced body, library, bound) ms
    print(f"phase1: kernel vs plain twin on {card} (times: {METHOD}, one input repeated, "
          f"L2 hot; bound = max(flops / peak, bytes / 3.35 TB/s); working set = those bytes, "
          f"'< L2' where it fits the 50 MB L2)")
    for case in kernel_cases(dev):
        got = case.run()
        want = case.plain()
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, want)
        # the replaced body computes the same function on the same inputs:
        # held to the same twin, so that its time is the same work's
        prior_rel = rel_err(case.prior(), want)[1] if case.prior is not None else None
        del got, want
        prior_ms = graph_ms(case.prior) if case.prior is not None else None
        ms = graph_ms(case.run)
        plain_ms = graph_ms(case.plain)
        lib_ms = graph_ms(case.library) if case.library is not None else None
        bound_ms, by = case.bound()
        # the 3xTF32 bodies (K1's, K2's, K4's, K5's and K6's f32 ones) are
        # held to 1e-5, as the card tests hold them: one TF32 product (~1e-3)
        # would miss it. K4's and K6's replaced FMA bodies keep the f32
        # tolerance they were held to as the kernel: K4's sequential f32 sums
        # over K = 9C (up to 23040) differ from the twin's by up to ~1e-5
        tol = 1e-5 if case.rate == "tf32x3" else TOL[case.dtype]
        prior_tol = (TOL[case.dtype] if case.kernel in ("conv3x3_f32_sm90", "winograd")
                     else tol)
        ok = rel <= tol and (prior_rel is None or prior_rel <= prior_tol)
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        if case.kernel in ("conv3x3", "conv3x3_sm90", "conv3x3_f32_sm90"):
            conv_ms[case.label] = ms
        if case.kernel in ("conv3x3_sm90", "conv3x3_f32_sm90"):
            conv_rows[case.label] = (ms, prior_ms, lib_ms, bound_ms)
        elif case.kernel in ("geglu_ff", "geglu_ff_f32_sm90"):
            ff_rows[case.label] = (ms, plain_ms, bound_ms)
        elif case.kernel == "group_norm":
            gn_rows[case.label] = (ms, prior_ms, lib_ms, bound_ms)
        elif case.kernel == "winograd":
            k4 = conv_ms.get(case.label)
            lib_txt += f" K4={k4:.4f} ms" if k4 is not None else " K4=no case at this shape"
        l2 = " < L2" if case.nbytes < L2_BYTES else ""
        prior_txt = (f" replaced body={prior_ms:.4f} ms (rel {prior_rel:.3e})"
                     if prior_ms is not None else "")
        if case.rate == "tf32x3":  # the FMA rate's bound beside the 3xTF32 one
            fma_ms = max(case.flops / PEAK_FLOPS["float32"], case.nbytes / HBM_BYTES_PER_S) * 1e3
            lib_txt += f" bound at the f32 FMA rate={fma_ms:.4f} ms"
        print(f"  {case.kernel:10s} {case.label:30s} max_abs_err={abs_err:.3e} rel={rel:.3e} "
              f"(tol {tol:.0e}) kernel={ms:.4f} ms{prior_txt} plain={plain_ms:.4f} ms "
              f"library={lib_txt} bound={bound_ms:.4f} ms ({by}; {100 * bound_ms / ms:.1f}% "
              f"of the kernel's time) working set {case.nbytes / 1e6:.1f} MB{l2} ({card}) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SmokeFailure(f"{case.kernel} {case.label}: relative error {rel:.3e} (tol "
                               f"{tol}; replaced body {prior_rel}, tol {prior_tol})")
        body = {"attention": K1_BODY, "attention_cm": K5_BODY, "winograd": K6_BODY}.get(
            case.kernel)
        sm = summary[body[case.dtype] if body else case.kernel]
        sm["max_abs_err"] = max(sm["max_abs_err"], abs_err)
        sm["ms"] += ms
        sm["plain_ms"] += plain_ms
        sm["bound_ms"] += bound_ms
        sm["by"][by] += bound_ms
        if lib_ms is None:
            sm["library_ms"] = None
        elif sm["library_ms"] is not None:
            sm["library_ms"] += lib_ms
        if prior_ms is not None:
            sm["replaced_ms"] = (sm["replaced_ms"] or 0.0) + prior_ms
        torch.cuda.empty_cache()
    for dt, body, prior in (("bf16", "sm90 K4", "mma.sync body"),
                            ("f32", "K4's 3xTF32 body", "FMA body it replaced")):
        # the 22 convs of one batch-1 UNet call, each shape times its count
        sums = [0.0] * 4
        for (hw, c, co), n in zip(B1_UNET_CONVS, B1_UNET_CONV_COUNTS):
            row = conv_rows.get(f"{dt} B2 {hw}x{hw} {c}->{co}")
            if row is None:
                break
            sums = [a + n * (b or 0.0) for a, b in zip(sums, row)]
        else:
            print(f"phase1: the {sum(B1_UNET_CONV_COUNTS)} {dt} convs of a batch-1 UNet call: "
                  f"{body} {sums[0]:.4f} ms, {prior} {sums[1]:.4f} ms, cuDNN {sums[2]:.4f} ms, "
                  f"bound {sums[3]:.4f} ms ({100 * sums[3] / sums[0]:.1f}% of the kernel's "
                  f"time; {card})")
    for dt, step, rows in (("bf16", "b4", GEGLU_ROWS[:4]), ("f32", "b4", GEGLU_ROWS[:4]),
                           ("f32", "b1", GEGLU_B1_ROWS)):
        # the 16 GEGLU FF calls of one CFG step (UNet batch 8 or 2), by level
        sums = [0.0] * 3
        for (m, c), n in zip(rows, GEGLU_B4_CALLS):
            row = ff_rows.get(f"{dt} M{m} C{c} H4 {4 * c}")
            if row is None:
                break
            sums = [a + n * b for a, b in zip(sums, row)]
        else:
            print(f"phase1: the {sum(GEGLU_B4_CALLS)} {dt} GEGLU FF calls of a {step} CFG step "
                  f"({'/'.join(map(str, GEGLU_B4_CALLS))} over "
                  f"{'/'.join(f'M{m}' for m, _ in rows)}): K2 {sums[0]:.4f} ms, plain twin "
                  f"{sums[1]:.4f} ms, bound {sums[2]:.4f} ms ({100 * sums[2] / sums[0]:.1f}% of "
                  f"K2's time; {card})")
    for ub, step in ((8, "b4"), (2, "b1")):
        # the 61 GroupNorms of one CFG step (UNet batch 2 x batch), by shape
        sums = [0.0] * 4
        for (side, c), n in zip(GN_UNET_PLANES, GN_B4_CALLS):
            row = gn_rows.get(f"bf16 {ub}x{side}x{side}x{c} silu")
            if row is None:
                break
            sums = [a + n * (b or 0.0) for a, b in zip(sums, row)]
        else:
            print(f"phase1: the {sum(GN_B4_CALLS)} GroupNorms of a {step} CFG step (UNet batch "
                  f"{ub}): K3 {sums[0]:.4f} ms, replaced body {sums[1]:.4f} ms, F.group_norm + "
                  f"F.silu {sums[2]:.4f} ms, bound {sums[3]:.4f} ms ("
                  f"{100 * sums[3] / sums[0]:.1f}% of K3's time; {card})")
    lib = _build.kernel_library()
    base = torch.empty(2 * 32 * 32 * 640, dtype=torch.bfloat16, device=dev)
    ns = ctypes.c_double()
    _build.check(lib.cpd_tmap_encode_bench(20000, ctypes.byref(ns), base.data_ptr()),
                 "tensor-map encode")
    print(f"phase1: host cost of one TMA tensor-map encode (cuTensorMapEncodeTiled, a 4-D bf16 "
          f"map): {ns.value / 1e3:.3f} us, mean of 20000; a launch encodes 2 (K4) or 3 (K1)")
    print(f"phase1: host cost of one wrapper call, eager, at shapes where the card's work is a "
          f"few us (so the loop runs at the host's pace): "
          f"{', '.join(f'{n} {us:.1f} us' for n, us in host_us(dev).items())} ({card})")
    return summary


def geglu_launches_per_step(batch: int, dtype: str = "bfloat16", latent: int = 64) -> int:
    """K2's launches in one CFG step at a ``latent`` x ``latent`` latent
    (512x512: 64; UNet batch 2 x batch) in ``dtype``: 5 calls at each of the
    three levels with transformer blocks and 1 in the middle block, each with
    the launches of its plan."""
    import torch

    from complex_prompt_diffusion_tpu_torch.ops.mlp import geglu_plan

    ub, s = 2 * batch, latent * latent
    sites = ((ub * s, 320, 5), (ub * s // 4, 640, 5), (ub * s // 16, 1280, 5),
             (ub * s // 64, 1280, 1))
    return sum(n * geglu_plan(m, c, 4 * c, getattr(torch, dtype)).launches
               for m, c, n in sites)


def check_geglu(launches: dict, batch: int, steps: int, what: str,
                dtype: str = "bfloat16") -> None:
    """Every GEGLU FF call of a path's ``steps`` CFG steps on K2's body for
    ``dtype``, with the kernels its plans predict; none on the other body."""
    want = geglu_launches_per_step(batch, dtype) * steps
    f32 = launches["geglu_ff_f32_sm90"]
    if launches["geglu_ff"] != want or f32 != (want if dtype == "float32" else 0):
        raise SmokeFailure(f"K2 launched {launches['geglu_ff']} kernels in {what}, {f32} on its "
                           f"f32 body: want {want} ({steps} steps of batch {batch}, by their "
                           f"plans), all on its {dtype} body")


def reset_launches() -> None:
    from complex_prompt_diffusion_tpu_torch import ops
    from complex_prompt_diffusion_tpu_torch.ops import groupnorm as G

    for w in ops.KERNEL_WRAPPERS.values():
        w.launches = 0
    G.group_norm_nhwc.calls = G.group_norm_nhwc.planned = G.group_norm_prior.launches = 0


def read_launches() -> dict:
    """Each wrapper's launches; and K3's calls, the kernels its plans
    predicted, and the launches of its replaced body (which no path may
    reach)."""
    from complex_prompt_diffusion_tpu_torch import ops
    from complex_prompt_diffusion_tpu_torch.ops import groupnorm as G

    out = {name: w.launches for name, w in ops.KERNEL_WRAPPERS.items()}
    out["group_norm calls"] = G.group_norm_nhwc.calls
    out["group_norm planned"] = G.group_norm_nhwc.planned
    out["group_norm_prior"] = G.group_norm_prior.launches
    return out


def check_gn(launches: dict, unet_calls: int, decodes: int, encodes: int, what: str) -> None:
    """Every GroupNorm of a path on K3's Hopper body: as many calls as its
    UNet calls, VAE decodes and encodes have, the kernels the library
    reported equal to what the calls' plans predict, none on the replaced
    body."""
    want = (UNET_GN_CALLS * unet_calls + VAE_DECODE_GN_CALLS * decodes
            + VAE_ENCODE_GN_CALLS * encodes)
    if (launches["group_norm calls"] != want or launches["group_norm"] <= 0
            or launches["group_norm"] != launches["group_norm planned"]
            or launches["group_norm_prior"]):
        raise SmokeFailure(f"K3 in {what}: {launches['group_norm calls']} calls (want {want}: "
                           f"{unet_calls} UNet calls, {decodes} decodes, {encodes} encodes), "
                           f"{launches['group_norm']} kernels launched against "
                           f"{launches['group_norm planned']} planned, the replaced body "
                           f"{launches['group_norm_prior']}")


def check_wide(launches: dict, calls: int, batch: int, what: str, s: int = 4096) -> None:
    """Every bf16 VAE mid-block attention of a path (``calls`` of them, at
    ``batch`` and S = ``s``) on K1's wgmma wide body, with the kernels its
    passes need; no other K1 launch outside the Hopper bodies."""
    from complex_prompt_diffusion_tpu_torch.ops.attention import bf16_wide_launches

    want = calls * bf16_wide_launches(batch, 1, s, s)
    own = (launches["attention"] - launches["attention_sm90"] - launches["attention_f32_sm90"]
           - launches["attention_f32_fused_sm90"])
    if launches["attention_bf16_wide_sm90"] != want or own != want:
        raise SmokeFailure(f"K1 in {what}: the bf16 wide body launched "
                           f"{launches['attention_bf16_wide_sm90']} kernels and K1 {own} outside "
                           f"its sm90 and 3xTF32 bodies; want {want} on the wide body ({calls} "
                           f"bf16 d=512 mid-blocks at batch {batch})")


def check_k5_bf16(launches: dict, want: int, what: str) -> None:
    """``want`` K5 launches in a path, every one on its bf16 Hopper body."""
    if (launches["attention_cm"] != want or launches["attention_cm_sm90"] != want
            or launches["attention_cm_f32_sm90"]):
        raise SmokeFailure(f"K5 launched {launches['attention_cm']} kernels in {what}, "
                           f"{launches['attention_cm_sm90']} on its Hopper bodies, "
                           f"{launches['attention_cm_f32_sm90']} on the f32 one: want {want}, "
                           f"all on the bf16 body")


def check_image(images, shape) -> None:
    if images.dtype.name != "uint8" or images.shape != shape:
        raise SmokeFailure(f"images {images.dtype} {images.shape}, want uint8 {shape}")
    if int(images.max()) == int(images.min()):
        raise SmokeFailure("decoded images are constant")


def check_latents(latents, shape) -> None:
    import torch

    if tuple(latents.shape) != shape or not bool(torch.isfinite(latents).all()):
        raise SmokeFailure(f"latents are not finite {list(shape)}")


def phase2(dev, card: str, steps: int):
    """The main path at full SD-1.5 width; returns (bundle, launch counts,
    latents, images)."""
    import torch

    from complex_prompt_diffusion_tpu_torch.ops.attention import f32_sm90_launches
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        ModelBundle,
        RenderConfig,
        decode_latents,
        txt2img,
    )

    t0 = time.perf_counter()
    bundle = ModelBundle.random("sd15", seed=0, device=dev)
    torch.cuda.synchronize()
    print(f"phase2: SD-1.5 random bundle (UNet bf16, VAE f32) built in "
          f"{time.perf_counter() - t0:.2f} s")
    cfg = RenderConfig(steps=steps, sampler="DDIM", eta=0.0, guidance_scale=7.5,
                       width=512, height=512, batch_size=4, seed=0)

    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, latents = txt2img(bundle, "a photograph of an astronaut riding a horse",
                         cfg=cfg, decode=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    images = decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()

    check_image(images, (4, 512, 512, 3))
    check_latents(latents, (4, 64, 64, 4))
    for name in ("attention", "geglu_ff", "group_norm"):
        if launches[name] <= 0:
            raise SmokeFailure(f"kernel {name} was not launched on the main path")
    if launches["conv3x3"] != 0:  # UNet batch 8 is outside the conv gate
        raise SmokeFailure(f"conv3x3 launched {launches['conv3x3']} times on the main path")
    # every UNet self-attention site on K1's sm90 body; the f32 VAE mid-block
    # (d = 512) on the 3xTF32 body, whose call launches the kernels its
    # passes need
    want_f32 = f32_sm90_launches(4, 1, 4096, 4096)
    if (launches["attention_sm90"] != UNET_SELF_ATTN_SITES * steps
            or launches["attention_f32_sm90"] != want_f32
            or launches["attention"] - launches["attention_sm90"] != want_f32):
        raise SmokeFailure(f"K1 launched {launches['attention']} times, the sm90 body "
                           f"{launches['attention_sm90']}, the 3xTF32 body "
                           f"{launches['attention_f32_sm90']}: want {UNET_SELF_ATTN_SITES} x "
                           f"{steps} on the sm90 body and the f32 d=512 decode on the 3xTF32 "
                           f"body ({want_f32} kernels)")
    check_geglu(launches, 4, steps, "the main path")
    check_gn(launches, steps, 1, 0, "the main path")
    check_wide(launches, 0, 4, "the main path")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase2: txt2img 512x512 b4 DDIM {steps} steps CFG 7.5 on {card}: "
          f"sampling {t1 - t0:.3f} s = {(t1 - t0) / steps:.4f} s/step (incl. prompt "
          f"encode and first-call warm-up), decode {1000 * (t2 - t1) / 4:.2f} ms/img, "
          f"end to end {4 / (t2 - t0):.4f} img/s, peak memory {peak_gb:.2f} GiB")
    print(f"phase2: launches {json.dumps(launches)}; latents mean "
          f"{float(latents.mean()):.5f} std {float(latents.std()):.5f}; "
          f"image mean {float(images.mean()):.2f}")
    return bundle, launches, latents, images


def phase3(bundle, dev, card: str) -> None:
    """Kernel path vs plain path on small inputs at full width."""
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(7)

    def to_cpu(params):
        return _tree_map(lambda a: a.to(cpu), params)

    def compare(what, got, want, tol):
        rel = float((got.float() - want.float()).norm() / want.float().norm())
        print(f"phase3: {what}, CUDA kernels vs CPU plain twins: rel L2 err {rel:.3e} "
              f"(tol {tol:.0e}) ({card})")
        if not (rel <= tol):
            raise SmokeFailure(f"{what}: kernel path disagrees with the plain path: {rel:.3e}")

    # UNet: 16x16 latent (S = 256 self-attention reaches K1), uncond+cond;
    # level 0 runs on the 16^2 plane, inside the conv gate: its 13 3x3 convs,
    # conv_in (C = 4) and the out conv (Co = 4) among them, go through K4
    x = torch.randn((2, 16, 16, 4), generator=gen)
    t = torch.tensor([801, 801])
    ctx = torch.randn((2, 77, 768), generator=gen)
    reset_launches()
    with torch.inference_mode():
        got = M.unet_apply(bundle.unet_cfg, bundle.unet_params, x.to(dev), t.to(dev),
                           ctx.to(dev)).cpu()
        n_conv = read_launches()["conv3x3"]
        n_sm90 = read_launches()["conv3x3_sm90"]
        want = M.unet_apply(bundle.unet_cfg, to_cpu(bundle.unet_params), x, t, ctx)
    if n_conv != 13 or n_sm90 != 11:
        raise SmokeFailure(f"the 16x16 UNet eval launched K4 {n_conv} times, {n_sm90} on the "
                           "sm90 body: want 13, all but conv_in (C = 4) and the out conv "
                           "(Co = 4) on the sm90 body")
    compare("UNet eps 16x16 latent b2, bf16 weights, 13 convs through K4", got, want, 5e-2)
    # VAE decode in f32: 16x16 latent -> 128x128 image (mid attention S = 256;
    # the convs on the 16^2 and 32^2 planes through K4's f32 path)
    z = torch.randn((1, 16, 16, 4), generator=gen)
    reset_launches()
    with torch.inference_mode():
        got = M.vae_decode(bundle.vae_cfg, bundle.vae_params, z.to(dev)).cpu()
        n_conv = read_launches()["conv3x3"]
        want = M.vae_decode(bundle.vae_cfg, to_cpu(bundle.vae_params), z)
    if n_conv <= 0:
        raise SmokeFailure("the small f32 VAE decode launched no K4 conv")
    compare(f"VAE decode 16x16 latent f32 (TF32 off), {n_conv} convs through K4", got, want,
            1e-4)
    # the bf16 VAE: decode the same latent and encode a 128x128 image (mid
    # attention bf16 at S = 256, d = 512; the 16^2 and 32^2 planes through K4)
    vae16 = bundle.cast_vae("bfloat16")
    cpu16 = to_cpu(vae16.vae_params)
    img = torch.rand((1, 128, 128, 3), generator=gen) * 2 - 1
    reset_launches()
    with torch.inference_mode():
        got = M.vae_decode(vae16.vae_cfg, vae16.vae_params, z.to(dev)).cpu()
        got_enc = M.vae_encode(vae16.vae_cfg, vae16.vae_params, img.to(dev))
        launches = read_launches()
        want = M.vae_decode(vae16.vae_cfg, cpu16, z)
        want_enc = M.vae_encode(vae16.vae_cfg, cpu16, img)
    if launches["conv3x3"] <= 0:
        raise SmokeFailure(f"the small bf16 VAE decode and encode launched {launches}")
    check_wide(launches, 2, 1, "the small bf16 VAE decode and encode", s=256)
    check_gn(launches, 0, 1, 1, "the small bf16 VAE decode and encode")
    compare("VAE decode 16x16 latent bf16", got, want, 5e-2)
    compare("VAE encode 128x128 image bf16 (posterior mean)", got_enc.mean.cpu(),
            want_enc.mean, 5e-2)


def phase4(bundle, dev, card: str, steps: int) -> dict:
    """The batch-1 render with a bf16 VAE decode (the JAX package's latency
    row); returns its launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch.pipeline import RenderConfig, decode_latents, txt2img

    cfg = RenderConfig(steps=steps, sampler="DDIM", eta=0.0, guidance_scale=7.5,
                       width=512, height=512, batch_size=1, seed=1)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, latents = txt2img(bundle, "a watercolor painting of a lighthouse at dusk", cfg=cfg,
                         decode=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = read_launches()
    images = decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()
    decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t3 = time.perf_counter()

    check_image(images, (1, 512, 512, 3))
    check_latents(latents, (1, 64, 64, 4))
    for name in DDIM_PATH_KERNELS:
        if launches[name] <= 0:
            raise SmokeFailure(f"kernel {name} was not launched in the batch-1 render")
    want = UNET_CONVS_PER_CALL_B1 * steps
    if launches["conv3x3"] != want or launches["conv3x3_sm90"] != want:
        raise SmokeFailure(f"conv3x3 launched {launches['conv3x3']} times, the sm90 body "
                           f"{launches['conv3x3_sm90']}: want {want}, all on the sm90 body")
    if launches["attention_sm90"] != UNET_SELF_ATTN_SITES * steps:
        raise SmokeFailure(f"K1's sm90 body launched {launches['attention_sm90']} times, want "
                           f"{UNET_SELF_ATTN_SITES} x {steps}")
    check_geglu(launches, 1, steps, "the batch-1 render")
    check_gn(launches, steps, 1, 0, "the batch-1 render")
    check_wide(launches, 1, 1, "the batch-1 render")
    decode_attn = launches["attention"] - before["attention"]
    if bundle.vae_cfg.dtype != "bfloat16" or decode_attn != launches["attention_bf16_wide_sm90"]:
        raise SmokeFailure(f"the bf16 decode launched K1 {decode_attn} times (VAE "
                           f"{bundle.vae_cfg.dtype}), want the one bf16 d=512 mid-block")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase4: batch-1 txt2img 512x512 DDIM {steps} steps CFG 7.5, bf16 VAE decode, on "
          f"{card}: seconds to first image {t2 - t0:.3f} s end to end (incl. prompt encode "
          f"and first-call warm-up), {(t1 - t0) / steps:.4f} s/step, decode "
          f"{1000 * (t2 - t1):.2f} ms (first call), {1000 * (t3 - t2):.2f} ms (second), "
          f"peak memory {peak_gb:.2f} GiB")
    print(f"phase4: launches {json.dumps(launches)} (conv3x3 = {UNET_CONVS_PER_CALL_B1} x "
          f"{steps} steps; attention in the decode: {decode_attn} kernels, bf16 d=512)")
    return launches


def phase5(bundle, latents, images_f32, card: str) -> dict:
    """Phase 2's latents through the bf16 VAE decode at batch 4, held to
    their f32 decode; returns its launch counts."""
    import numpy as np
    import torch

    from complex_prompt_diffusion_tpu_torch.pipeline import decode_latents

    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images = decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_launches()
    decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t2 = time.perf_counter()

    check_image(images, (4, 512, 512, 3))
    check_wide(launches, 1, 4, "the b4 bf16 decode")
    check_gn(launches, 0, 1, 0, "the b4 bf16 decode")
    diff = images.astype(np.float64) - images_f32.astype(np.float64)
    max_u8 = int(np.abs(diff).max())
    rel = float(np.linalg.norm(diff) / np.linalg.norm(images_f32.astype(np.float64)))
    print(f"phase5: bf16 VAE decode b4 512x512 on {card}: {1000 * (t1 - t0) / 4:.2f} ms/img "
          f"(first call), {1000 * (t2 - t1) / 4:.2f} ms/img (second); against the f32 "
          f"decode of the same latents: max |u8| diff {max_u8}, rel L2 {rel:.3e} (tol 5e-2)")
    print(f"phase5: launches {json.dumps(launches)}")
    if not rel <= 5e-2:
        raise SmokeFailure(f"bf16 decode differs from the f32 decode: rel L2 {rel:.3e}")
    return launches


def phase6(bundle, image, card: str, steps: int) -> dict:
    """img2img (DDIM, strength 0.75) of one phase-2 image at batch 1;
    returns its launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch.pipeline import RenderConfig, img2img, img2img_t_enc

    cfg = RenderConfig(steps=steps, sampler="DDIM", eta=0.0, guidance_scale=7.5, width=512,
                       height=512, batch_size=1, seed=2, denoising_strength=0.75)
    t_enc = img2img_t_enc(cfg.denoising_strength, steps, "t")
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    images, latents = img2img(bundle, image, "an oil painting of an astronaut", cfg=cfg)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = read_launches()

    check_image(images, (1, 512, 512, 3))
    check_latents(latents, (1, 64, 64, 4))
    for name in DDIM_PATH_KERNELS:
        if launches[name] <= 0:
            raise SmokeFailure(f"kernel {name} was not launched in img2img")
    want = UNET_CONVS_PER_CALL_B1 * t_enc
    if launches["conv3x3"] != want or launches["conv3x3_sm90"] != want:
        raise SmokeFailure(f"img2img ran conv3x3 {launches['conv3x3']} times, the sm90 body "
                           f"{launches['conv3x3_sm90']}: want {UNET_CONVS_PER_CALL_B1} x "
                           f"{t_enc} steps, all on the sm90 body")
    if launches["attention_sm90"] != UNET_SELF_ATTN_SITES * t_enc:
        raise SmokeFailure(f"K1's sm90 body launched {launches['attention_sm90']} times in "
                           f"img2img, want {UNET_SELF_ATTN_SITES} x {t_enc}")
    check_geglu(launches, 1, t_enc, "img2img")
    check_gn(launches, t_enc, 1, 1, "img2img")
    check_wide(launches, 2, 1, "img2img")
    print(f"phase6: img2img 512x512 b1 strength 0.75 DDIM {steps} ({t_enc} steps run) CFG "
          f"7.5, bf16 VAE encode and decode, on {card}: {t1 - t0:.3f} s end to end; "
          f"launches {json.dumps(launches)}; image mean {float(images.mean()):.2f}")
    return launches


def phase7(bundle, dev, card: str, steps: int) -> tuple:
    """The k-diffusion render at full width with the UNet's channel-major
    attention route on, then one UNet eval with that route against the same
    eval without it, then the cm sites in bf16 and f32; returns the render's
    launch counts and the sites' (both dtypes together)."""
    import dataclasses

    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.pipeline import RenderConfig, decode_latents, txt2img

    cm = dataclasses.replace(
        bundle, unet_cfg=dataclasses.replace(bundle.unet_cfg, attn_route="cm"))
    cfg = RenderConfig(steps=steps, sampler="DPM++ 2m", sigma_schedule="karras",
                       guidance_scale=7.5, width=512, height=512, batch_size=4, seed=3)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, latents = txt2img(cm, "a castle on a cliff above the sea, oil on canvas", cfg=cfg,
                         decode=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    images = decode_latents(cm, latents)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()

    check_image(images, (4, 512, 512, 3))
    check_latents(latents, (4, 64, 64, 4))
    check_k5_bf16(launches, UNET_CM_SITES * steps, "the k-diffusion render")
    if launches["attention_sm90"] != (UNET_SELF_ATTN_SITES - UNET_CM_SITES) * steps:
        raise SmokeFailure(f"K1's sm90 body launched {launches['attention_sm90']} times, want "
                           f"the level-0 sites of {steps} steps")
    if launches["geglu_ff"] <= 0:
        raise SmokeFailure("kernel geglu_ff was not launched in the k-diffusion render")
    check_gn(launches, steps, 1, 0, "the k-diffusion render")
    check_wide(launches, 0, 4, "the k-diffusion render")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase7: txt2img 512x512 b4 DPM++ 2M Karras {steps} steps CFG 7.5, cm attention "
          f"route, on {card}: sampling {t1 - t0:.3f} s = {(t1 - t0) / steps:.4f} s/step "
          f"(incl. prompt encode), f32 decode {1000 * (t2 - t1) / 4:.2f} ms/img, end to end "
          f"{4 / (t2 - t0):.4f} img/s, peak memory {peak_gb:.2f} GiB")
    print(f"phase7: launches {json.dumps(launches)}; latents mean "
          f"{float(latents.mean()):.5f} std {float(latents.std()):.5f}; "
          f"image mean {float(images.mean()):.2f}")

    # one UNet eval at the render's plane (UNet batch 2): cm route vs default
    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.randn((2, 64, 64, 4), generator=gen, device=dev)
    t = torch.tensor([601.5, 601.5], device=dev)  # a fractional timestep, as the denoiser gives
    ctx = torch.randn((2, 77, 768), generator=gen, device=dev)
    reset_launches()
    with torch.inference_mode():
        got = M.unet_apply(cm.unet_cfg, cm.unet_params, x, t, ctx)
        n_cm = read_launches()
        want = M.unet_apply(bundle.unet_cfg, bundle.unet_params, x, t, ctx)
    n_all = read_launches()
    n_k1 = n_all["attention"] - n_cm["attention"]
    if (n_cm["attention_cm"] != UNET_CM_SITES or n_all["attention_cm"] != UNET_CM_SITES
            or n_cm["attention"] != UNET_SELF_ATTN_SITES - UNET_CM_SITES
            or n_k1 != UNET_SELF_ATTN_SITES
            or n_all["attention_sm90"] != n_all["attention"]):
        raise SmokeFailure(f"the cm UNet eval launched {n_cm}, the two evals together {n_all}: "
                           f"want K5 at {UNET_CM_SITES} sites of the first and K1 at all "
                           f"{UNET_SELF_ATTN_SITES} of the second")
    check_k5_bf16(n_all, UNET_CM_SITES, "the cm UNet eval")
    rel = float((got - want).norm() / want.norm())
    # the attention sites' share of eps lies below bf16's resolution of the
    # residual stream on random weights, so this comparison mostly checks the
    # path; phase7_sites below holds K5's own output at each site
    print(f"phase7: UNet eps 64x64 latent b2, cm route (K5 at {n_cm['attention_cm']} sites, K1 "
          f"at {n_cm['attention']}) vs default route (K1 at {n_k1}), bf16: rel L2 {rel:.3e} "
          f"(tol 2e-2), max |eps| {float(want.abs().max()):.3f} ({card})")
    if not rel <= 2e-2:
        raise SmokeFailure(f"the cm route disagrees with the default route: rel L2 {rel:.3e}")
    sites = phase7_sites(bundle, dev, card, "bfloat16")
    sites_f32 = phase7_sites(bundle, dev, card, "float32")
    return launches, {k: sites[k] + sites_f32[k] for k in sites}


def phase7_sites(bundle, dev, card: str, dtype: str) -> dict:
    """The UNet's cm sites (levels 1 and 2 of the input and output blocks)
    with their weights in ``dtype`` (the bundle's bf16, or cast to f32), each
    through the cm block (K5's bf16 or f32 Hopper body) and through the
    default route (K1's sm90 or fused 3xTF32 body) on the same input at the
    render's plane (UNet batch 2); returns the launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.models import unet as U
    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map

    sites, hw = [], 64
    input_plan, _, output_plan = M.build_plan(bundle.unet_cfg)
    blocks = list(zip(input_plan, bundle.unet_params["input_blocks"])) + list(
        zip(output_plan, bundle.unet_params["output_blocks"]))
    for plan, params in blocks:
        for desc, p in zip(plan, params):
            if desc[0] == "attn" and desc[1] % 128 == 0 and hw * hw > 128:
                sites += [(hw, desc[1], desc[2], blk["attn1"]) for blk in p["blocks"]]
            elif desc[0] == "down":
                hw //= 2
            elif desc[0] == "up":
                hw *= 2
    if len(sites) != UNET_CM_SITES:
        raise SmokeFailure(f"found {len(sites)} cm sites in the UNet, want {UNET_CM_SITES}")
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(12)
    worst = 0.0
    reset_launches()
    with torch.inference_mode():
        for side, c, heads, p in sites:
            p = _tree_map(lambda a: a.to(dt), p)
            x = torch.randn((2, side * side, c), generator=gen, device=dev).to(dt)
            got = U._cross_attention(p, x, None, heads, attn_route="cm")
            want = U._cross_attention(p, x, None, heads, attn_route="bsc")
            if not bool(torch.isfinite(got).all()):
                raise SmokeFailure(f"the {dtype} cm site at {side}^2 x {c} gave non-finite values")
            worst = max(worst, float((got.float() - want.float()).norm() / want.float().norm()))
    launches = read_launches()
    n = len(sites)
    if dtype == "bfloat16":
        check_k5_bf16(launches, n, "the bf16 cm sites")
        k1_body, k1_ok = "K1's sm90 body", launches["attention_sm90"] == n
    else:
        k5_ok = launches["attention_cm_f32_sm90"] == launches["attention_cm_sm90"] == n
        if launches["attention_cm"] != n or not k5_ok:
            raise SmokeFailure(f"the f32 cm sites launched {launches}: want K5's f32 body once "
                               f"at each of the {n} sites")
        k1_body = "K1's fused 3xTF32 body"
        k1_ok = launches["attention_f32_fused_sm90"] == n and not launches["attention_sm90"]
    if launches["attention"] != n or not k1_ok or launches["attention_f32_sm90"]:
        raise SmokeFailure(f"the {dtype} cm sites launched {launches}: want {k1_body} once at "
                           f"each of the {n} sites")
    body = "bf16 TMA + wgmma" if dtype == "bfloat16" else "3xTF32"
    tf32 = "" if dtype == "bfloat16" else ", TF32 off"
    print(f"phase7: the UNet's {n} cm sites in {dtype} (S 1024 / 256, d 80 / 160, UNet batch 2), "
          f"cm block (K5's {body} body) vs default route ({k1_body}){tf32}: worst rel L2 "
          f"{worst:.3e} (tol {TOL[dtype]:.0e}) ({card})")
    if not worst <= TOL[dtype]:
        raise SmokeFailure(f"a {dtype} cm site disagrees with the default route: rel L2 "
                           f"{worst:.3e}")
    return launches


def phase8(bundle, image, card: str, steps: int) -> dict:
    """k-family img2img (Euler Ancestral, strength 0.75) of one phase-2
    image at batch 1, with the canonical-K attention route on for the phase;
    returns its launch counts."""
    import importlib

    import torch

    from complex_prompt_diffusion_tpu_torch.pipeline import RenderConfig, img2img, img2img_t_enc

    attn = importlib.import_module(f"{PKG}.ops.attention")
    cfg = RenderConfig(steps=steps, sampler="Euler Ancestral", guidance_scale=7.5, width=512,
                       height=512, batch_size=1, seed=4, denoising_strength=0.75)
    n_run = min(steps, img2img_t_enc(cfg.denoising_strength, steps, "k") + 1)
    flag = attn._USE_KCANON
    attn._USE_KCANON = True
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images, latents = img2img(bundle, image, "a pencil sketch of an astronaut", cfg=cfg)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        launches = read_launches()
    finally:
        attn._USE_KCANON = flag

    check_image(images, (1, 512, 512, 3))
    check_latents(latents, (1, 64, 64, 4))
    check_k5_bf16(launches, UNET_SELF_ATTN_SITES * n_run, "the k-family img2img")
    # K1: the encoder's and the decoder's d = 512 mid-blocks, nothing else
    check_wide(launches, 2, 1, "the k-family img2img under the kcanon route")
    check_gn(launches, n_run, 1, 1, "the k-family img2img")
    if launches["conv3x3_sm90"] < UNET_CONVS_PER_CALL_B1 * n_run or launches["attention_sm90"]:
        raise SmokeFailure(f"conv3x3's sm90 body launched {launches['conv3x3_sm90']} times (want "
                           f"at least {UNET_CONVS_PER_CALL_B1} x {n_run} steps), K1's "
                           f"{launches['attention_sm90']} (want 0: K5 takes the UNet)")
    if launches["geglu_ff"] <= 0:
        raise SmokeFailure("kernel geglu_ff was not launched in the k-family img2img")
    print(f"phase8: img2img 512x512 b1 strength 0.75 Euler Ancestral {steps} ({n_run} steps "
          f"run) CFG 7.5, kcanon attention route, bf16 VAE encode and decode, on {card}: "
          f"{t1 - t0:.3f} s end to end; launches {json.dumps(launches)}; image mean "
          f"{float(images.mean()):.2f}")
    return launches


def phase9(bundle, dev, card: str) -> dict:
    """The Winograd probe on the UNet's own ResBlock conv weights at the
    batch-1 render's planes, against the same convs through K4: in bf16 on
    K6's Hopper body, in f32 on its 3xTF32 body (and against the plain twin
    at 1e-5, TF32 off); then the 20 convs of each dtype timed on both of
    K6's bodies, through K4 and through cuDNN; returns its launch counts."""
    import torch
    import torch.nn.functional as F

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.models import layers as L
    from complex_prompt_diffusion_tpu_torch.ops.probes.winograd import (
        wino3x3,
        wino3x3_plain,
        wino3x3_plan,
        wino3x3_prior,
        winograd_weights,
    )
    from complex_prompt_diffusion_tpu_torch.tools.hotcold import METHOD, graph_ms

    # (plane side, conv params) of every ResBlock conv, walking the plan from
    # a 64x64 latent
    convs, hw = [], 64
    input_plan, _, output_plan = M.build_plan(bundle.unet_cfg)
    blocks = list(zip(input_plan, bundle.unet_params["input_blocks"])) + list(
        zip(output_plan, bundle.unet_params["output_blocks"]))
    for plan, params in blocks:
        for desc, p in zip(plan, params):
            if desc[0] == "res":
                convs += [(hw, p["in_conv"]), (hw, p["out_conv"])]
            elif desc[0] == "down":
                hw //= 2
            elif desc[0] == "up":
                hw *= 2
    convs = [(side, p) for side, p in convs if side in (16, 32)]
    gen = torch.Generator(device=dev).manual_seed(13)
    cases = []
    for side, p in convs:
        co, c = p["weight"].shape[:2]
        x = torch.randn((2, side, side, c), generator=gen, device=dev).to(torch.bfloat16)
        cases.append((x, p, p["weight"].permute(2, 3, 1, 0)))  # HWIO view of the weight
    # the same convs in f32 (an f32 UNet's: weights, bias and input cast)
    cases32 = [(x.float(), {k: v.float() for k, v in p.items()}, k.float()) for x, p, k in cases]
    want_sm90 = sum(wino3x3_plan(*x.shape, k.shape[3]).launches for x, _, k in cases)
    want_f32 = sum(wino3x3_plan(*x.shape, k.shape[3], dtype=torch.float32).launches
                   for x, _, k in cases32)

    reset_launches()
    worst = {"bf16": 0.0, "f32": 0.0, "f32 twin": 0.0}
    with torch.inference_mode():
        for (x, p, k_hwio), (x32, p32, k32) in zip(cases, cases32):
            for dt, got, want in (("bf16", wino3x3(x, k_hwio, p["bias"]), L.conv2d(p, x)),
                                  ("f32", wino3x3(x32, k32, p32["bias"]), L.conv2d(p32, x32))):
                rel = float((got.float() - want.float()).norm() / want.float().norm())
                if not (rel <= TOL["bfloat16"]) or not bool(torch.isfinite(got).all()):
                    raise SmokeFailure(f"the Winograd probe ({dt}) disagrees with K4 on a "
                                       f"{tuple(k_hwio.shape)} conv: rel L2 {rel:.3e}")
                worst[dt] = max(worst[dt], rel)
                if dt == "f32":  # K6's f32 body against its twin: max |a - b| / max |b|
                    twin = wino3x3_plain(x32, winograd_weights(k32), p32["bias"])
                    rel = rel_err(got, twin)[1]
                    if not rel <= 1e-5:
                        raise SmokeFailure(f"K6's f32 body disagrees with its plain twin on a "
                                           f"{tuple(k32.shape)} conv: {rel:.3e} (tol 1e-5)")
                    worst["f32 twin"] = max(worst["f32 twin"], rel)
    torch.cuda.synchronize()
    launches = read_launches()
    n = len(cases)
    if (launches["winograd_sm90"] != want_sm90 or launches["winograd_f32_sm90"] != want_f32
            or launches["winograd"] != want_sm90 + want_f32 or launches["conv3x3"] != 2 * n
            or launches["conv3x3_sm90"] != n or launches["conv3x3_f32_sm90"] != n or not cases):
        raise SmokeFailure(f"the probe phase launched {launches} for {n} convs of each dtype "
                           f"(want {want_sm90} kernels of K6's bf16 Hopper body and {want_f32} "
                           f"of its f32 one by their plans, none of its first body, {n} of K4's "
                           f"sm90 body and {n} of its f32 one)")
    times = {}
    with torch.inference_mode():
        for dt, cs in (("bf16", cases), ("f32", cases32)):
            us = [winograd_weights(k).to(x.dtype) for x, _, k in cs]
            ws = [p["weight"].contiguous(memory_format=torch.channels_last) for _, p, _ in cs]
            times[dt] = {
                "K6 with the weight transform in each call": graph_ms(
                    lambda cs=cs: [wino3x3(x, k, p["bias"]) for x, p, k in cs]),
                "K6 Hopper body": graph_ms(lambda cs=cs, us=us: [
                    wino3x3(x, k, p["bias"], u=u) for (x, p, k), u in zip(cs, us)]),
                "K6 first body": graph_ms(lambda cs=cs, us=us: [
                    wino3x3_prior(x, k, p["bias"], u=u) for (x, p, k), u in zip(cs, us)]),
                "K4": graph_ms(lambda cs=cs: [L.conv2d(p, x) for x, p, _ in cs]),
                "cuDNN": graph_ms(lambda cs=cs, ws=ws: [
                    F.conv2d(x.permute(0, 3, 1, 2), w, p["bias"], padding=1)
                    for (x, p, _), w in zip(cs, ws)]),
            }
    for dt in ("bf16", "f32"):
        t = times[dt]
        print(f"phase9: Winograd probe on the UNet's {n} ResBlock convs of the 32^2 and 16^2 "
              f"planes (UNet batch 2) in {dt}, U made ahead, on {card}: "
              f"{', '.join(f'{k} {v:.4f} ms' for k, v in t.items())}; Hopper / first body "
              f"{t['K6 Hopper body'] / t['K6 first body']:.3f}, / K4 "
              f"{t['K6 Hopper body'] / t['K4']:.3f} ({METHOD})")
    print(f"phase9: worst rel L2 vs K4 {worst['bf16']:.3e} (bf16), {worst['f32']:.3e} (f32) (tol "
          f"2e-2); f32 body vs its plain twin {worst['f32 twin']:.3e} (tol 1e-5, TF32 off); "
          f"launches {json.dumps(launches)} ({card})")
    return launches


def phase10(dev, card: str) -> dict:
    """The probes of the TPU tuning scripts: every mode and flag against its
    plain twin at small shapes, K8's full mode against K3's bits at the
    scripts' planes, the SASS MMA counts of the attention ablations and the
    GroupNorm modes' statistics, then every script variant at the scripts'
    shapes; returns the timed run's launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch.tools import probe_attention as PA
    from complex_prompt_diffusion_tpu_torch.tools import probe_groupnorm as PG
    from complex_prompt_diffusion_tpu_torch.tools.hotcold import METHOD

    checks = PA.check_small(dev) + PG.check_small(dev) + PG.check_k3_bits(dev)
    for label, err, tol in checks:
        print(f"phase10: {label}: error {err:.3e} (tol {tol:.0e}) ({card})")
    copies = PG.check_copies(dev)
    print(f"phase10: every K9 mode at the copy scripts' shapes, both bodies: {len(copies)} "
          f"copies, {sum(1 for c in copies if c[1])} with a differing element (tol 0) ({card})")
    bad = [c for c in checks + copies if not c[1] <= c[2]]
    if bad:
        raise SmokeFailure(f"{len(bad)} probe variants disagree with their plain twins: {bad}")
    counts = PA.sass_counts()
    lines, ok = PA.check_sass(counts)
    gn_lines, gn_ok = PG.check_sass(counts)
    for ln in lines + gn_lines:
        print(f"phase10: SASS {ln}")
    if not ok:
        raise SmokeFailure("an ablated attention mode lost MMAs of the steps it keeps")
    if not gn_ok:
        raise SmokeFailure("an ablated GroupNorm mode lost the statistics it keeps")

    print(f"phase10: the TPU probe scripts' variants at their shapes on {card}: {METHOD}, "
          f"L2 hot (one input) and cold (inputs rotated past 2 x 50 MB); bound = "
          f"max(flops / peak, bytes / 3.35 TB/s)", flush=True)
    reset_launches()
    rows = PA.run(dev, card) + PG.run(dev, card)
    torch.cuda.synchronize()
    launches = read_launches()
    rate, best = PG.streaming_rate(rows)
    print(f"phase10: {len(rows)} probe rows; K9 streaming rate {rate:.3f} TB/s (cold, "
          f"{best.script} {best.variant} {best.shape}) against the nominal 3.35 TB/s of the "
          f"bytes bounds ({card})")
    for name in PHASE10_PROBES:
        if launches[name] <= 0:
            raise SmokeFailure(f"probe kernel {name} was not launched in phase 10")
    print(f"phase10: launches {json.dumps(launches)}")
    return launches


def phase11(dev, card: str, steps: int) -> dict:
    """The exact-f32 render: (a) one SD-1.5 UNet eval cast to f32 on a 16x16
    latent, kernels against the plain twins on CPU copies (TF32 off); (b)
    txt2img at 512x512, batch 1, DDIM, CFG 7.5 with the UNet in f32, then the
    f32 decode; (c) the default bundle, ``ModelBundle.random()`` with no
    arguments (the tiny config on the card, f32 UNet), renders a short
    txt2img. Returns (b)'s and (c)'s launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.ops.attention import f32_sm90_launches
    from complex_prompt_diffusion_tpu_torch.pipeline import (
        ModelBundle,
        RenderConfig,
        _tree_map,
        decode_latents,
        txt2img,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    bundle = ModelBundle.random("sd15", seed=0, device=dev).cast("float32")
    if bundle.unet_cfg.dtype != "float32" or bundle.vae_cfg.dtype != "float32":
        raise SmokeFailure(f"the f32 bundle runs its UNet in {bundle.unet_cfg.dtype}, its VAE "
                           f"in {bundle.vae_cfg.dtype}")

    # (a) one UNet eval on a 16x16 latent (S = 256 self-attention reaches K1;
    # level 0 on the 16^2 plane, inside the conv gate)
    cpu = torch.device("cpu")
    gen = torch.Generator(device=cpu).manual_seed(17)
    x = torch.randn((2, 16, 16, 4), generator=gen)
    t = torch.tensor([801, 801])
    ctx = torch.randn((2, 77, 768), generator=gen)
    reset_launches()
    with torch.inference_mode():
        got = M.unet_apply(bundle.unet_cfg, bundle.unet_params, x.to(dev), t.to(dev),
                           ctx.to(dev)).cpu()
        n = read_launches()
        want = M.unet_apply(bundle.unet_cfg, _tree_map(lambda a: a.to(cpu), bundle.unet_params),
                            x, t, ctx)
    want_ff = geglu_launches_per_step(1, "float32", latent=16)
    if (n["conv3x3"] != UNET_CONVS_16_LATENT or n["conv3x3_f32_sm90"] != UNET_CONVS_16_LATENT - 2
            or n["conv3x3_sm90"] or n["geglu_ff"] != want_ff
            or n["geglu_ff_f32_sm90"] != want_ff or n["attention_sm90"]):
        raise SmokeFailure(f"the f32 16x16 UNet eval launched {n}: want K4 {UNET_CONVS_16_LATENT} "
                           f"times, all but conv_in (C = 4) and the out conv (Co = 4) on its f32 "
                           f"body, K2's f32 body {want_ff} kernels for its {UNET_FF_SITES} calls "
                           f"(by their plans), no bf16 body")
    rel = float((got - want).norm() / want.norm())
    print(f"phase11: f32 UNet eps 16x16 latent b2 (TF32 off), CUDA kernels vs CPU plain twins: "
          f"rel L2 {rel:.3e} (tol 1e-4); K4 {n['conv3x3']} convs, {n['conv3x3_f32_sm90']} on "
          f"its 3xTF32 body; K2 {UNET_FF_SITES} calls, {n['geglu_ff_f32_sm90']} kernels on its "
          f"f32 body ({card})", flush=True)
    if not rel <= 1e-4:
        raise SmokeFailure(f"the f32 UNet's kernel path disagrees with the plain path: {rel:.3e}")

    # (b) the exact-f32 batch-1 render
    cfg = RenderConfig(steps=steps, sampler="DDIM", eta=0.0, guidance_scale=7.5,
                       width=512, height=512, batch_size=1, seed=5)
    reset_launches()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, latents = txt2img(bundle, "a lighthouse on a rocky coast, exact f32", cfg=cfg,
                         decode=False)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    before = read_launches()
    images = decode_latents(bundle, latents)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = read_launches()

    check_image(images, (1, 512, 512, 3))
    check_latents(latents, (1, 64, 64, 4))
    check_geglu(launches, 1, steps, "the f32 render", "float32")
    want_conv = UNET_CONVS_PER_CALL_B1 * steps
    if (launches["conv3x3"] != want_conv or launches["conv3x3_f32_sm90"] != want_conv
            or launches["conv3x3_sm90"]):
        raise SmokeFailure(f"the f32 render ran K4 {launches['conv3x3']} times, its f32 body "
                           f"{launches['conv3x3_f32_sm90']}, its bf16 body "
                           f"{launches['conv3x3_sm90']}: want {want_conv}, all on the f32 body")
    want_dec = f32_sm90_launches(1, 1, 4096, 4096)
    if (launches["attention_f32_fused_sm90"] != UNET_SELF_ATTN_SITES * steps
            or launches["attention_f32_sm90"] != want_dec or launches["attention_sm90"]
            or launches["attention"] != UNET_SELF_ATTN_SITES * steps + want_dec):
        raise SmokeFailure(f"K1 in the f32 render: {launches}; want every UNet self-attention "
                           f"site on the fused 3xTF32 body ({UNET_SELF_ATTN_SITES} x {steps}) and "
                           f"the decode's mid-block on the unfused one ({want_dec} kernels)")
    check_gn(launches, steps, 1, 0, "the f32 render")
    check_wide(launches, 0, 1, "the f32 render")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase11: exact-f32 txt2img 512x512 b1 DDIM {steps} steps CFG 7.5 (UNet f32, TF32 "
          f"off; f32 decode) on {card}: seconds to image {t2 - t0:.3f} s end to end (incl. "
          f"prompt encode and first-call warm-up), {(t1 - t0) / steps:.4f} s/step, decode "
          f"{1000 * (t2 - t1):.2f} ms, peak memory {peak_gb:.2f} GiB; K2 "
          f"{launches['geglu_ff_f32_sm90']} kernels on its f32 body "
          f"({geglu_launches_per_step(1, 'float32')} a step), K4 {launches['conv3x3_f32_sm90']} "
          f"convs on its f32 body; decode K1 kernels "
          f"{launches['attention'] - before['attention']}", flush=True)
    print(f"phase11: launches {json.dumps(launches)}; latents mean {float(latents.mean()):.5f} "
          f"std {float(latents.std()):.5f}; image mean {float(images.mean()):.2f}")

    # (c) the default bundle: ModelBundle.random() with no arguments
    default = ModelBundle.random()
    reset_launches()
    images, latents = txt2img(default, "a cat", cfg=RenderConfig(
        steps=4, width=128, height=128, batch_size=2, seed=6))
    torch.cuda.synchronize()
    n = read_launches()
    check_image(images, (2, 32, 32, 3))
    check_latents(latents, (2, 16, 16, 4))
    if (default.unet_cfg.dtype != "float32" or n["geglu_ff_f32_sm90"] <= 0
            or n["geglu_ff"] != n["geglu_ff_f32_sm90"] or n["conv3x3_f32_sm90"] <= 0
            or n["conv3x3"] <= n["conv3x3_f32_sm90"] or n["conv3x3_sm90"]):
        raise SmokeFailure(f"the default bundle (UNet {default.unet_cfg.dtype}) rendered with "
                           f"launches {n}: want K2 on its f32 body and K4 on its f32 bodies "
                           f"(the 3xTF32 one, and the FMA one at the narrow widths)")
    print(f"phase11: ModelBundle.random() (no arguments: tiny, UNet {default.unet_cfg.dtype}, on "
          f"{default.device}) txt2img 128x128 b2 4 steps: images {tuple(images.shape)} "
          f"{images.dtype}; launches {json.dumps(n)} ({card})")
    return launches, n


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="DDIM steps of the renders (phases 2, 4, 6 and 11)")
    args = ap.parse_args(argv)

    if not (ROOT / PKG / "csrc").is_dir():
        raise SmokeFailure(f"{PKG}/csrc not found beside chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no CUDA device")
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    from complex_prompt_diffusion_tpu_torch import _build

    t0 = time.perf_counter()
    _build.kernel_library()
    print(f"phase0: kernels built (nvcc, unless this checkout had built them) and "
          f"loaded in {time.perf_counter() - t0:.2f} s ({card})", flush=True)

    phase0_sass(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = phase1(dev, card)
    bundle, main_launches, latents, images = phase2(dev, card, args.steps)
    phase3(bundle, dev, card)
    bundle16 = bundle.cast_vae("bfloat16")
    paths = {"txt2img_b4": main_launches,
             "txt2img_b1_bf16_decode": phase4(bundle16, dev, card, args.steps),
             "bf16_decode_b4": phase5(bundle16, latents, images, card),
             "img2img_b1": phase6(bundle16, images[0], card, args.steps)}
    paths["txt2img_b4_dpmpp2m_cm"], paths["unet_cm_sites_bf16_f32"] = phase7(
        bundle, dev, card, K_STEPS)
    paths["img2img_b1_euler_a_kcanon"] = phase8(bundle16, images[0], card, K_STEPS)
    for name in PROBES:
        if any(p[name] for p in paths.values()):
            raise SmokeFailure(f"the probe {name} was launched in a render: no layer "
                               "dispatches it")
    paths["winograd_probe_unet_convs"] = phase9(bundle, dev, card)
    paths["tpu_probe_scripts"] = phase10(dev, card)
    del bundle, bundle16
    torch.cuda.empty_cache()
    paths["txt2img_b1_f32"], paths["txt2img_default_bundle"] = phase11(dev, card, args.steps)

    kernels = []
    # "attention" and "conv3x3" count every body of K1 and K4: their own
    # bodies' launches are those less the sm90 bodies'
    own = {k: {n: p[n] - sum(p[s] for s, total in SM90.items() if total == n) for n in p}
           for k, p in paths.items()}
    for name, (src, rep) in KERNELS.items():
        sm = summary[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(p[name] for p in own.values()),
            "launches_by_path": {k: p[name] for k, p in own.items()},
            "max_abs_err": sm["max_abs_err"], "ms": sm["ms"], "plain_ms": sm["plain_ms"],
            "bound_ms": sm["bound_ms"],
            "bound_by": max(sm["by"], key=sm["by"].get),
            "library_ms": sm["library_ms"],
        }
        if sm["replaced_ms"] is not None:
            entry["replaced_body_ms"] = sm["replaced_ms"]
        if name == "probe_attention":
            entry["sources"] = list(PROBE_ATTENTION_SOURCES)
        elif name == "probe_groupnorm":  # K3's kernels, in K8's modes
            entry["sources"] = [src, f"{PKG}/csrc/groupnorm_sm90.cuh"]
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
