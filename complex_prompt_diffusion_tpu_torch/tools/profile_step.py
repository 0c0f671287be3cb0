"""Where the time of one sampling step and one VAE decode goes, on the card.

Run from the repository root on a machine with the GPU::

    python -m complex_prompt_diffusion_tpu_torch.tools.profile_step --batch 1 --vae bfloat16
    python -m complex_prompt_diffusion_tpu_torch.tools.profile_step --batch 4 --attn-route cm
    python -m complex_prompt_diffusion_tpu_torch.tools.profile_step --batch 1 --unet-dtype float32 \
        --vae float32
    python -m complex_prompt_diffusion_tpu_torch.tools.profile_step --batch 4 --three-factor

Builds the SD-1.5 bundle with random weights (seed 0), renders 512x512 at
``--batch`` with DDIM and CFG 7.5 for a few warm-up steps, then times
``--steps`` steady CFG steps (host clock, synchronised) without the
profiler, profiles the same steps and one decode with ``torch.profiler``,
and prints the device time by kernel family, the device busy time and the
idle share of each, beside the card's name and power limit. ``--attn-route``
takes the UNet's self-attention through the default route (``bsc``: K1), the
channel-major block (``cm``: K5 at levels 1 and 2) or the canonical-K route
(``kcanon``: K5 at every site, behind its d-major copies). ``--unet-dtype
float32`` casts the UNet to f32 (the exact-f32 render: K2's and K4's 3xTF32
bodies, K1's fused 3xTF32 body), TF32 off. ``--three-factor`` guides by
the 3-factor CompositionalPrompt of ``chip_smoke.py``'s phase 14 (an AND
factor on the left half at scale 1.5, a NOT factor off the top third at
0.5: UNet batch 4 x ``--batch``) with its switches on and the blur on in
every step: uc blur (k 7, 5 rounds), dynamic thresholding of eps, the
dynamic scale clip (the sampler's ``clip_sample`` is not in the step).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import subprocess
import time
from collections import defaultdict

import torch

from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch.guidance import (
    GuidanceConfig,
    cfg_epsilon,
    stacked_context,
)
from complex_prompt_diffusion_tpu_torch.pipeline import (
    ModelBundle,
    RenderConfig,
    decode_latents,
    make_guidance_spec,
)
from complex_prompt_diffusion_tpu_torch.prompts import CompositionalPrompt

# kernel-name substrings -> family, first match wins
FAMILIES = (
    ("attention_sm90", "K1 attention bf16 (sm90 body)"),
    ("wide_gemm", "K1 attention bf16 d512 (wgmma body)"),
    ("wide_softmax", "K1 attention bf16 d512 (wgmma body)"),
    ("tf32x3_gemm", "K1 attention f32 (3xTF32 body)"),
    ("split_rows", "K1 attention f32 (3xTF32 body)"),
    ("split_transpose", "K1 attention f32 (3xTF32 body)"),
    ("softmax_rows", "K1 attention f32 (3xTF32 body)"),
    ("attention_cm_f32_sm90", "K5 attention f32 (3xTF32 body)"),
    ("attention_cm_split", "K5 attention f32 (3xTF32 body)"),
    ("attention_cm_sm90", "K5 attention bf16 (sm90 body)"),
    ("attention_cm", "K5 attention (replaced body)"),
    ("attention_bf16_wide", "K1 attention bf16 d512"),
    ("attention_bf16", "K1 attention bf16"),
    ("attention_f32", "K1 attention f32"),
    ("geglu_gemm_sm90", "K2 GEGLU GEMMs"),
    ("geglu_splitk", "K2 GEGLU GEMMs"),
    ("geglu_gemm_f32_sm90", "K2 GEGLU GEMMs (f32 3xTF32 body)"),
    ("geglu_f32_reduce", "K2 GEGLU GEMMs (f32 3xTF32 body)"),
    ("gn_slab", "K3 GroupNorm"),
    ("gn_stats", "K3 GroupNorm"),
    ("gn_apply", "K3 GroupNorm"),
    ("group_norm", "K3 GroupNorm (replaced body)"),
    ("conv3x3_f32_sm90", "K4 conv3x3 (f32 3xTF32 body)"),
    ("conv3x3_f32_reduce", "K4 conv3x3 (f32 3xTF32 body)"),
    ("conv3x3_sm90", "K4 conv3x3 (sm90 body)"),
    ("conv3x3_splitk", "K4 conv3x3 (sm90 body)"),
    ("conv3x3", "K4 conv3x3"),
    ("conv", "cuDNN convs"),
    ("fprop", "cuDNN convs"),
    ("cudnn", "cuDNN convs"),
    ("nchw", "cuDNN layout transposes"),
    ("nhwc", "cuDNN layout transposes"),
    ("gemm", "cuBLAS GEMMs"),
    ("nvjet", "cuBLAS GEMMs"),  # cuBLASLt's Hopper GEMM kernels
    ("layer_norm", "LayerNorm"),
    ("softmax", "softmax"),
    ("elementwise", "elementwise / misc"),
    ("reduce", "elementwise / misc"),
    ("copy", "copies / casts"),
    ("memcpy", "copies / casts"),
    ("memset", "copies / casts"),
)


def _family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            return fam
    return "other"


def _breakdown(prof, label: str, wall_ms: float, card: str) -> None:
    by = defaultdict(float)
    others = defaultdict(float)  # kernels of no family, by name
    n = 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", 0.0)
        if dev_us > 0 and evt.device_type == torch.autograd.DeviceType.CUDA:
            fam = _family(evt.key)
            by[fam] += dev_us / 1e3
            if fam == "other":
                others[evt.key] += dev_us / 1e3
            n += evt.count
    busy = sum(by.values())
    print(f"{label}: {busy:.2f} ms device busy over {wall_ms:.2f} ms wall with the profiler "
          f"on, {n} kernels, idle {100 * (1 - busy / wall_ms):.1f}% ({card})")
    for fam, ms in sorted(by.items(), key=lambda kv: -kv[1]):
        print(f"  {fam:28s} {ms:9.3f} ms  {100 * ms / busy:5.1f}%")
    for name, ms in sorted(others.items(), key=lambda kv: -kv[1])[:4]:
        print(f"    other: {ms:9.3f} ms  {name[:100]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--vae", default="bfloat16", help="VAE dtype (float32 or bfloat16)")
    ap.add_argument("--steps", type=int, default=3, help="steady CFG steps timed and profiled")
    ap.add_argument("--attn-route", default="bsc", choices=("bsc", "cm", "kcanon"),
                    help="route of the UNet's self-attention sites")
    ap.add_argument("--unet-dtype", default="bfloat16", choices=("bfloat16", "float32"),
                    help="UNet dtype (float32: the exact-f32 render)")
    ap.add_argument("--three-factor", action="store_true",
                    help="phase 14's 3-factor prompt with every guidance switch on")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    bundle = ModelBundle.random("sd15", seed=0, device=dev).cast_vae(args.vae).cast(
        args.unet_dtype)
    if args.attn_route == "cm":
        bundle = dataclasses.replace(
            bundle, unet_cfg=dataclasses.replace(bundle.unet_cfg, attn_route="cm"))
    elif args.attn_route == "kcanon":
        importlib.import_module(
            "complex_prompt_diffusion_tpu_torch.ops.attention")._USE_KCANON = True
    cfg = RenderConfig(steps=50, width=512, height=512, batch_size=args.batch, seed=0)
    if args.three_factor:
        prompt = CompositionalPrompt("a castle on a hill at dawn", negative_prompt="blurry",
                                     bundle=bundle)
        prompt.add_conjunction("a red dragon", scale=1.5, mask="left_half_valid")
        prompt.add_negation("fog", scale=0.5, mask="top_third_hidden")
        spec = prompt.build_spec(*cfg.latent_shape[:2])
        gcfg = GuidanceConfig(guidance_scale=7.5, uc_blur=True, uc_blur_k=7, uc_blur_rounds=5,
                              threshold_e="dynamic_thresholding", dynamic_scale_clip=True)
    else:
        spec = make_guidance_spec(bundle, "a photograph of an astronaut riding a horse")
        gcfg = cfg.guidance
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((args.batch,) + cfg.latent_shape, generator=gen, device=dev)
    t = torch.tensor(801, device=dev)
    scale = torch.tensor(7.5, device=dev)
    with torch.inference_mode():
        cross_kv = M.precompute_cross_kv(bundle.unet_cfg, bundle.unet_params,
                                         stacked_context(spec, args.batch))

        def unet(xx, tt, ctx):
            return M.unet_apply(bundle.unet_cfg, bundle.unet_params, xx, tt, ctx,
                                cross_kv=cross_kv)

        def step():
            return cfg_epsilon(unet, x, t, spec, scale, gcfg=gcfg, uc_blur_on=args.three_factor)

        for _ in range(3):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
        decode_latents(bundle, x)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_latents(bundle, x)
        torch.cuda.synchronize()
        decode_ms = 1e3 * (time.perf_counter() - t0)
        print(f"profile_step: SD-1.5 512x512 batch {args.batch} (UNet batch "
              f"{(1 + spec.num_factors) * args.batch}"
              f"{', 3-factor prompt, every switch on' if args.three_factor else ''}), VAE "
              f"{args.vae}, attention route {args.attn_route}: "
              f"{step_ms:.2f} ms per steady CFG step, "
              f"{decode_ms:.2f} ms per decode, without the profiler ({card})")

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                step()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        _breakdown(prof, f"{args.steps} CFG steps", wall, card)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            decode_latents(bundle, x)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        _breakdown(prof, "one decode", wall, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
