#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It imports only
``complex_prompt_diffusion_tpu_torch`` (never jax or the JAX package) and:

  phase 0  builds the hand-written CUDA kernels from ``csrc/`` (nvcc, one
           process per source, in parallel);
  phase 1  runs each kernel at its paths' shapes against its plain PyTorch
           twin on the card (TF32 off): error, the times (CUDA-graph
           replays, ``tools/hotcold.py``, one input repeated) of the kernel,
           the twin and the one PyTorch call that computes the same function
           (where there is one), and the bound from this case's bytes and
           flops;
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
           attention route on (``attn_route="cm"``: K5 at levels 1 and 2),
           f32 decode; and one UNet eval with that route held against the
           same eval without it;
  phase 8  k-family img2img at batch 1 (Euler Ancestral, strength 0.75: 6 of
           20 steps) with the canonical-K attention route switched on for
           the phase (K5 at every self-attention site), bf16 VAE;
  phase 9  the Winograd probe (K6), which no layer dispatches, called as
           its user would call it: on the weights of the UNet's 20 ResBlock
           convs of the 32x32 and 16x16 planes at UNet batch 2, each held
           against the same conv through ``layers.conv2d`` (K4);
  phase 10 the probes of the TPU tuning scripts (``scripts/perf_attn8..12``,
           ``perf_gn4..8``), which no layer dispatches: every mode and flag
           of K7 (attention ablations), K8 (GroupNorm modes, tensor-core
           statistics, forced splits) and K9 (streaming copy) against its
           plain twin at small shapes; the SASS MMA count of every ablated
           attention mode and the statistics of every GroupNorm mode
           (``cuobjdump``); then every script variant timed
           at the scripts' shapes with the L2 hot and cold
           (``tools/probe_attention.py``, ``tools/probe_groupnorm.py``).

Each path of phases 2 and 4 to 10 runs with every launch count set to 0
just before it and read just after, and fails unless the kernels it must
run were launched. Any failure exits non-zero before the result lines. On
success the last three lines are the kernels JSON, the card's name and
power limit (from nvidia-smi) and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "complex_prompt_diffusion_tpu_torch"

# kernel -> (source, the TPU kernel(s) it replaces)
KERNELS = {
    "attention": (
        f"{PKG}/csrc/attention.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:152 _onepass_kernel; "
        "complex_prompt_diffusion_tpu/ops/attention.py:48 _attn_kernel",
    ),
    "geglu_ff": (
        f"{PKG}/csrc/geglu_ff.cu",
        "complex_prompt_diffusion_tpu/ops/mlp.py:51 _ff_kernel",
    ),
    "group_norm": (
        f"{PKG}/csrc/groupnorm.cu",
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:59 _gn_kernel; "
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:142 _gn_stats_kernel; "
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:175 _gn_stats2_kernel; "
        "complex_prompt_diffusion_tpu/ops/groupnorm.py:221 _gn_apply_kernel",
    ),
    "conv3x3": (
        f"{PKG}/csrc/conv3x3.cu",
        "complex_prompt_diffusion_tpu/ops/conv.py:38 _kernel",
    ),
    "attention_cm": (
        f"{PKG}/csrc/attention_cm.cu",
        "complex_prompt_diffusion_tpu/ops/attention.py:187 _onepass_kernel_hdbs; "
        "complex_prompt_diffusion_tpu/ops/attention.py:378 _onepass_kernel_kcanon",
    ),
    "winograd": (
        f"{PKG}/csrc/winograd.cu",
        "complex_prompt_diffusion_tpu/ops/probes/winograd.py:82 _wino_kernel",
    ),
    "probe_attention": (
        f"{PKG}/csrc/probe_attention.cu",
        "scripts/perf_attn8.py:88 flash_t; scripts/perf_attn9.py:81 onepass; "
        "scripts/perf_attn10.py:84 run_mode; scripts/perf_attn11.py:92 h2; "
        "scripts/perf_attn12.py:51 v3_call, :105 h1_call (QK-only forms); "
        "scripts/perf_attn11.py:56 h1 is K5 (attention_cm)",
    ),
    "probe_groupnorm": (
        f"{PKG}/csrc/probe_groupnorm.cu",
        "scripts/perf_gn4.py:43,63 chunked, :96 flat_onepass; scripts/perf_gn5.py:111 make; "
        "scripts/perf_gn6.py:73 make",
    ),
    "probe_copy": (
        f"{PKG}/csrc/probe_copy.cu",
        "scripts/perf_gn7.py:36 make; scripts/perf_gn8.py:29 make",
    ),
}
PROBES = ("winograd", "probe_attention", "probe_groupnorm", "probe_copy")  # no layer calls them

TOL = {"bfloat16": 2e-2, "float32": 1e-4}  # max |a - b| / max |b|

DDIM_PATH_KERNELS = ("attention", "geglu_ff", "group_norm", "conv3x3")  # phases 4 and 6
UNET_CONVS_PER_CALL_B1 = 22  # 3x3 convs on the 16^2/32^2 planes at UNet batch 2
K_STEPS = 20  # steps of the k-diffusion paths (phases 7 and 8)
UNET_SELF_ATTN_SITES = 15  # self-attention sites above S = 128 at 512x512: 5 a level
UNET_CM_SITES = 10  # of them inside the cm gate (levels 1 and 2: C = 640, 1280)


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
    """(max |got - want|, that over max |want|); non-finite output fails."""
    import torch

    got, want = got.float(), want.float()
    if not bool(torch.isfinite(got).all()):
        raise SmokeFailure("kernel output has non-finite values")
    abs_err = float((got - want).abs().max())
    return abs_err, abs_err / max(float(want.abs().max()), 1e-30)


def phase1(dev, card: str) -> dict:
    """Each kernel against its plain twin at its paths' shapes."""
    import torch

    from complex_prompt_diffusion_tpu_torch.tools.hotcold import L2_BYTES, METHOD, graph_ms
    from complex_prompt_diffusion_tpu_torch.tools.kernel_cases import kernel_cases

    summary = {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
                      "library_ms": 0.0, "by": {"bytes": 0.0, "operations": 0.0}}
               for name in KERNELS}
    conv_ms = {}  # K4's time by case label, printed beside K6's at the same shape
    print(f"phase1: kernel vs plain twin on {card} (times: {METHOD}, one input repeated, "
          f"L2 hot; bound = max(flops / peak, bytes / 3.35 TB/s); working set = those bytes, "
          f"'< L2' where it fits the 50 MB L2)")
    for case in kernel_cases(dev):
        got = case.run()
        want = case.plain()
        torch.cuda.synchronize()
        abs_err, rel = rel_err(got, want)
        del got, want
        ms = graph_ms(case.run)
        plain_ms = graph_ms(case.plain)
        lib_ms = graph_ms(case.library) if case.library is not None else None
        bound_ms, by = case.bound()
        tol = TOL[case.dtype]
        ok = rel <= tol
        lib_txt = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        if case.kernel == "conv3x3":
            conv_ms[case.label] = ms
        elif case.kernel == "winograd":
            k4 = conv_ms.get(case.label)
            lib_txt += f" K4={k4:.4f} ms" if k4 is not None else " K4=no case at this shape"
        l2 = " < L2" if case.nbytes < L2_BYTES else ""
        print(f"  {case.kernel:10s} {case.label:30s} max_abs_err={abs_err:.3e} rel={rel:.3e} "
              f"(tol {tol:.0e}) kernel={ms:.4f} ms plain={plain_ms:.4f} ms "
              f"library={lib_txt} bound={bound_ms:.4f} ms ({by}) working set "
              f"{case.nbytes / 1e6:.1f} MB{l2} ({card}) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SmokeFailure(f"{case.kernel} {case.label}: relative error {rel:.3e} > {tol}")
        sm = summary[case.kernel]
        sm["max_abs_err"] = max(sm["max_abs_err"], abs_err)
        sm["ms"] += ms
        sm["plain_ms"] += plain_ms
        sm["bound_ms"] += bound_ms
        sm["by"][by] += bound_ms
        if lib_ms is None:
            sm["library_ms"] = None
        elif sm["library_ms"] is not None:
            sm["library_ms"] += lib_ms
        torch.cuda.empty_cache()
    return summary


def reset_launches() -> None:
    from complex_prompt_diffusion_tpu_torch import ops

    for w in ops.KERNEL_WRAPPERS.values():
        w.launches = 0


def read_launches() -> dict:
    from complex_prompt_diffusion_tpu_torch import ops

    return {name: w.launches for name, w in ops.KERNEL_WRAPPERS.items()}


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
        want = M.unet_apply(bundle.unet_cfg, to_cpu(bundle.unet_params), x, t, ctx)
    if n_conv != 13:
        raise SmokeFailure(f"the 16x16 UNet eval launched K4 {n_conv} times, want 13")
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
    if launches["conv3x3"] <= 0 or launches["attention"] != 2:
        raise SmokeFailure(f"the small bf16 VAE decode and encode launched {launches}")
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
    if launches["conv3x3"] != want:
        raise SmokeFailure(f"conv3x3 launched {launches['conv3x3']} times, want {want}")
    decode_attn = launches["attention"] - before["attention"]
    if bundle.vae_cfg.dtype != "bfloat16" or decode_attn != 1:
        raise SmokeFailure(f"the bf16 decode launched K1 {decode_attn} times (VAE "
                           f"{bundle.vae_cfg.dtype}), want the one bf16 d=512 mid-block")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"phase4: batch-1 txt2img 512x512 DDIM {steps} steps CFG 7.5, bf16 VAE decode, on "
          f"{card}: seconds to first image {t2 - t0:.3f} s end to end (incl. prompt encode "
          f"and first-call warm-up), {(t1 - t0) / steps:.4f} s/step, decode "
          f"{1000 * (t2 - t1):.2f} ms (first call), {1000 * (t3 - t2):.2f} ms (second), "
          f"peak memory {peak_gb:.2f} GiB")
    print(f"phase4: launches {json.dumps(launches)} (conv3x3 = {UNET_CONVS_PER_CALL_B1} x "
          f"{steps} steps; attention in the decode: {decode_attn}, bf16 d=512)")
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
    for name in ("attention", "group_norm"):
        if launches[name] <= 0:
            raise SmokeFailure(f"kernel {name} was not launched in the bf16 decode")
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
    if launches["conv3x3"] != UNET_CONVS_PER_CALL_B1 * t_enc:
        raise SmokeFailure(f"img2img ran conv3x3 {launches['conv3x3']} times, want "
                           f"{UNET_CONVS_PER_CALL_B1} x {t_enc} steps")
    print(f"phase6: img2img 512x512 b1 strength 0.75 DDIM {steps} ({t_enc} steps run) CFG "
          f"7.5, bf16 VAE encode and decode, on {card}: {t1 - t0:.3f} s end to end; "
          f"launches {json.dumps(launches)}; image mean {float(images.mean()):.2f}")
    return launches


def phase7(bundle, dev, card: str, steps: int) -> dict:
    """The k-diffusion render at full width with the UNet's channel-major
    attention route on, then one UNet eval with that route against the same
    eval without it; returns the render's launch counts."""
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
    if launches["attention_cm"] != UNET_CM_SITES * steps:
        raise SmokeFailure(f"K5 launched {launches['attention_cm']} times in the k-diffusion "
                           f"render, want {UNET_CM_SITES} sites x {steps} steps")
    if launches["attention"] < (UNET_SELF_ATTN_SITES - UNET_CM_SITES) * steps:
        raise SmokeFailure(f"K1 launched {launches['attention']} times, want the level-0 "
                           f"sites of {steps} steps at least")
    for name in ("geglu_ff", "group_norm"):
        if launches[name] <= 0:
            raise SmokeFailure(f"kernel {name} was not launched in the k-diffusion render")
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
            or n_k1 != UNET_SELF_ATTN_SITES):
        raise SmokeFailure(f"the cm UNet eval launched {n_cm}, the two evals together {n_all}: "
                           f"want K5 at {UNET_CM_SITES} sites of the first and K1 at all "
                           f"{UNET_SELF_ATTN_SITES} of the second")
    rel = float((got - want).norm() / want.norm())
    # K5 runs K1's arithmetic in K1's order on transposed tiles, so the two
    # routes may agree to the bit; the tolerance is bf16's
    print(f"phase7: UNet eps 64x64 latent b2, cm route (K5 at {n_cm['attention_cm']} sites, K1 "
          f"at {n_cm['attention']}) vs default route (K1 at {n_k1}), bf16: rel L2 {rel:.3e} "
          f"(tol 2e-2), max |eps| {float(want.abs().max()):.3f} ({card})")
    if not rel <= 2e-2:
        raise SmokeFailure(f"the cm route disagrees with the default route: rel L2 {rel:.3e}")
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
    if launches["attention_cm"] != UNET_SELF_ATTN_SITES * n_run:
        raise SmokeFailure(f"K5 launched {launches['attention_cm']} times in the k-family "
                           f"img2img, want {UNET_SELF_ATTN_SITES} sites x {n_run} steps")
    if launches["attention"] != 2:  # the encoder's and the decoder's d = 512 mid-blocks
        raise SmokeFailure(f"K1 launched {launches['attention']} times under the kcanon "
                           "route, want the two d = 512 VAE mid-blocks")
    if launches["conv3x3"] < UNET_CONVS_PER_CALL_B1 * n_run:
        raise SmokeFailure(f"conv3x3 launched {launches['conv3x3']} times, want at least "
                           f"{UNET_CONVS_PER_CALL_B1} x {n_run} steps")
    for name in ("geglu_ff", "group_norm"):
        if launches[name] <= 0:
            raise SmokeFailure(f"kernel {name} was not launched in the k-family img2img")
    print(f"phase8: img2img 512x512 b1 strength 0.75 Euler Ancestral {steps} ({n_run} steps "
          f"run) CFG 7.5, kcanon attention route, bf16 VAE encode and decode, on {card}: "
          f"{t1 - t0:.3f} s end to end; launches {json.dumps(launches)}; image mean "
          f"{float(images.mean()):.2f}")
    return launches


def phase9(bundle, dev, card: str) -> dict:
    """The Winograd probe on the UNet's own ResBlock conv weights at the
    batch-1 render's planes, against the same convs through K4; returns its
    launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch import models as M
    from complex_prompt_diffusion_tpu_torch.models import layers as L
    from complex_prompt_diffusion_tpu_torch.ops.probes.winograd import wino3x3, winograd_weights
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

    reset_launches()
    worst = 0.0
    with torch.inference_mode():
        for x, p, k_hwio in cases:
            got = wino3x3(x, k_hwio, p["bias"])
            want = L.conv2d(p, x)
            rel = float((got.float() - want.float()).norm() / want.float().norm())
            if not (rel <= TOL["bfloat16"]) or not bool(torch.isfinite(got).all()):
                raise SmokeFailure(f"the Winograd probe disagrees with K4 on a "
                                   f"{tuple(k_hwio.shape)} conv: rel L2 {rel:.3e}")
            worst = max(worst, rel)
    torch.cuda.synchronize()
    launches = read_launches()
    if launches["winograd"] != len(cases) or launches["conv3x3"] != len(cases) or not cases:
        raise SmokeFailure(f"the probe phase launched {launches} for {len(cases)} convs")
    with torch.inference_mode():
        us = [winograd_weights(k).to(x.dtype) for x, _, k in cases]
        ms_w = graph_ms(lambda: [wino3x3(x, k, p["bias"]) for x, p, k in cases])
        ms_u = graph_ms(lambda: [wino3x3(x, k, p["bias"], u=u)
                                 for (x, p, k), u in zip(cases, us)])
        ms_k4 = graph_ms(lambda: [L.conv2d(p, x) for x, p, _ in cases])
    print(f"phase9: Winograd probe on the UNet's {len(cases)} ResBlock convs of the 32^2 and "
          f"16^2 planes (UNet batch 2, bf16), on {card}: worst rel L2 vs K4 {worst:.3e} (tol "
          f"2e-2); all {len(cases)} convs {ms_u:.3f} ms through K6 with U made ahead, "
          f"{ms_w:.3f} ms with the weight transform in each call, {ms_k4:.3f} ms through K4 "
          f"({METHOD}); launches {json.dumps(launches)}")
    return launches


def phase10(dev, card: str) -> dict:
    """The probes of the TPU tuning scripts: every mode and flag against its
    plain twin at small shapes, the SASS MMA counts of the attention
    ablations, then every script variant at the scripts' shapes; returns the
    timed run's launch counts."""
    import torch

    from complex_prompt_diffusion_tpu_torch.tools import probe_attention as PA
    from complex_prompt_diffusion_tpu_torch.tools import probe_groupnorm as PG
    from complex_prompt_diffusion_tpu_torch.tools.hotcold import METHOD

    checks = PA.check_small(dev) + PG.check_small(dev)
    for label, err, tol in checks:
        print(f"phase10: {label}: error {err:.3e} (tol {tol:.0e}) ({card})")
    bad = [c for c in checks if not c[1] <= c[2]]
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
    for name in PROBES[1:]:
        if launches[name] <= 0:
            raise SmokeFailure(f"probe kernel {name} was not launched in phase 10")
    print(f"phase10: launches {json.dumps(launches)}")
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=50,
                    help="DDIM steps of the renders (phases 2, 4 and 6)")
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

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    summary = phase1(dev, card)
    bundle, main_launches, latents, images = phase2(dev, card, args.steps)
    phase3(bundle, dev, card)
    bundle16 = bundle.cast_vae("bfloat16")
    paths = {"txt2img_b4": main_launches,
             "txt2img_b1_bf16_decode": phase4(bundle16, dev, card, args.steps),
             "bf16_decode_b4": phase5(bundle16, latents, images, card),
             "img2img_b1": phase6(bundle16, images[0], card, args.steps),
             "txt2img_b4_dpmpp2m_cm": phase7(bundle, dev, card, K_STEPS),
             "img2img_b1_euler_a_kcanon": phase8(bundle16, images[0], card, K_STEPS)}
    for name in PROBES:
        if any(p[name] for p in paths.values()):
            raise SmokeFailure(f"the probe {name} was launched in a render: no layer "
                               "dispatches it")
    paths["winograd_probe_unet_convs"] = phase9(bundle, dev, card)
    paths["tpu_probe_scripts"] = phase10(dev, card)

    kernels = []
    for name, (src, rep) in KERNELS.items():
        sm = summary[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(p[name] for p in paths.values()),
            "launches_by_path": {k: p[name] for k, p in paths.items()},
            "max_abs_err": sm["max_abs_err"], "ms": sm["ms"], "plain_ms": sm["plain_ms"],
            "bound_ms": sm["bound_ms"],
            "bound_by": max(sm["by"], key=sm["by"].get),
            "library_ms": sm["library_ms"],
        })
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
