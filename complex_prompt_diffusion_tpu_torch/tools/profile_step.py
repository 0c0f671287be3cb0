"""Where the time of one sampling step and one VAE decode goes, on the card.

Run from the repository root on a machine with the GPU::

    python -m complex_prompt_diffusion_tpu_torch.tools.profile_step --batch 1 --vae bfloat16
    python -m complex_prompt_diffusion_tpu_torch.tools.profile_step --batch 4 --attn-route cm
    python -m complex_prompt_diffusion_tpu_torch.tools.profile_step --batch 1 --unet-dtype float32 \
        --vae float32
    python -m complex_prompt_diffusion_tpu_torch.tools.profile_step --batch 4 --three-factor
    python -m complex_prompt_diffusion_tpu_torch.tools.profile_step --train --batch 2
    python -m complex_prompt_diffusion_tpu_torch.tools.profile_step --clip-guided

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

``--train`` profiles the training step instead (``train.make_train_step``'s
parts): SD-1.5 at 512x512, ``--batch`` latents, f32 master weights under
the UNet's bf16 compute, a random context, Adan lr 1e-4. It times
``--steps`` steady steps without the profiler, then profiles the forward
(the loss: the hand-written kernels), the backward (``torch.autograd.grad``:
the kernels' backward rules recompute their plain twins, and the rest of
the graph's own backward) and the optimizer update apart, and names the top
device kernels of the backward.

``--clip-guided`` profiles one CLIP-guided DDIM step at ``--batch``
(``sample_latents(clip_guidance=)``'s eps model: a ViT-B/32 guide with
random weights, a unit random text embedding, ``grad_scale`` 1; the VAE in
f32, whatever ``--vae`` says): it times ``--steps`` steady guided steps
without the profiler, then profiles the whole guided eps, and apart the
CFG call, the guide's forward in three parts (the UNet's eps under grad,
the f32 decode of the predicted x0, the resize, the vision tower and the
loss) and its backward (``torch.autograd.grad`` with respect to the
latents), each with its device busy time and idle share.
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


def _top(prof, label: str, card: str, n: int = 10) -> None:
    """The ``n`` kernels with the most device time in ``prof``."""
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and getattr(e, "self_device_time_total", 0.0) > 0]
    total = sum(r[0] for r in rows)
    print(f"{label}: top {n} device kernels of {total:.2f} ms ({card})")
    for ms, count, name in sorted(rows, reverse=True)[:n]:
        print(f"  {ms:9.3f} ms {100 * ms / total:5.1f}% x{count:<5d} {_family(name):28s} "
              f"{name[:90]}")


def _train(args, card: str) -> int:
    """The ``--train`` mode (see the module docstring)."""
    from complex_prompt_diffusion_tpu_torch import train as T
    from complex_prompt_diffusion_tpu_torch.pipeline import _tree_map
    from complex_prompt_diffusion_tpu_torch.train.loop import p_losses
    from complex_prompt_diffusion_tpu_torch.train.optimizers import (
        apply_updates,
        tree_leaves,
        tree_map,
    )

    dev = torch.device("cuda")
    bundle = ModelBundle.random("sd15", seed=0, device=dev)
    ucfg, tables = bundle.unet_cfg, bundle.tables
    params = _tree_map(lambda a: a.float(), bundle.unet_params)
    del bundle
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"latents": torch.randn((args.batch, 64, 64, 4), generator=gen, device=dev),
             "context": torch.randn((args.batch, 77, 768), generator=gen, device=dev)}
    opt = T.adan(learning_rate=1e-4)
    state = opt.init(params)
    step = T.make_train_step(ucfg, tables, opt)
    for _ in range(2):
        params, state, _ = step(params, state, batch, gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        params, state, _ = step(params, state, batch, gen)
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
    print(f"profile_step: SD-1.5 train step, batch {args.batch} at 512x512, f32 master weights, "
          f"bf16 compute, Adan: {step_ms:.2f} ms per steady step without the profiler ({card})")

    def apply_fn(p, x, t, c):
        return M.unet_apply(ucfg, p, x, t, c)

    t = torch.randint(0, 1000, (args.batch,), generator=gen, device=dev)
    noise = torch.randn(batch["latents"].shape, generator=gen, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
    it = iter(leaves)
    diff = tree_map(lambda _: next(it), params)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        loss = p_losses(apply_fn, diff, tables, batch["latents"], batch["context"], t, noise)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    _breakdown(prof, "train step forward (the loss)", wall, card)
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    _breakdown(prof, "train step backward (autograd.grad)", wall, card)
    _top(prof, "train step backward", card)
    grads_tree = iter(grads)
    grads_tree = tree_map(lambda _: next(grads_tree), params)
    with torch.profiler.profile(activities=acts) as prof, torch.no_grad():
        t0 = time.perf_counter()
        updates, state = opt.update(grads_tree, state, params)
        params = apply_updates(params, updates)
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    _breakdown(prof, "Adan update", wall, card)
    return 0


def _clip_guided(args, card: str) -> int:
    """The ``--clip-guided`` mode (see the module docstring)."""
    import numpy as np

    from complex_prompt_diffusion_tpu_torch import convert
    from complex_prompt_diffusion_tpu_torch import schedules as S
    from complex_prompt_diffusion_tpu_torch.guidance import GuidanceSpec
    from complex_prompt_diffusion_tpu_torch.guidance.clip_guidance import (
        ClipGuidanceConfig,
        clip_normalize,
        spherical_dist_loss,
    )
    from complex_prompt_diffusion_tpu_torch.pipeline import LATENT_SCALE, _clip_guided_eps
    from complex_prompt_diffusion_tpu_torch.utils.resize import resize

    dev = torch.device("cuda")
    bundle = ModelBundle.random("sd15", seed=0, device=dev)
    ucfg, params = bundle.unet_cfg, bundle.unet_params
    gen = torch.Generator(device=dev).manual_seed(0)
    vcfg = M.CLIPVisionConfig.vit_b32()
    vparams = convert.clip_vision_params(M.init_clip_vision(gen, vcfg, dev), dev)
    text = torch.randn((vcfg.projection_dim,), generator=gen, device=dev)
    text = text / text.norm()
    cg = ClipGuidanceConfig(grad_scale=1.0)
    spec = make_guidance_spec(bundle, "a photograph of an astronaut riding a horse")
    spec = GuidanceSpec(*(a.clone() for a in (spec.uncond, spec.factors, spec.scales,
                                              spec.masks)))
    it = S.make_inference_tables(bundle.tables, 50)
    idx = 40
    t = torch.tensor(int(it.timesteps[idx]), device=dev)
    a_t = np.float32(it.alphas_cumprod_t[idx])
    x = torch.randn((args.batch, 64, 64, 4), generator=gen, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]

    def unet(xx, tt, ctx):
        return M.unet_apply(ucfg, params, xx, tt, ctx)

    def cfg_call(xx, tt, uc, blur_on):
        return cfg_epsilon(unet, xx, tt, spec, uc)

    eps_fn = _clip_guided_eps(cfg_call, unet, bundle, spec, it, (vcfg, vparams, text, cg), None)

    def profiled(label, fn):
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        _breakdown(prof, label, wall, card)
        return out

    with torch.inference_mode(False), torch.no_grad():
        for _ in range(2):
            eps_fn(x, t, 7.5, False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            eps_fn(x, t, 7.5, False)
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / args.steps
        print(f"profile_step: SD-1.5 512x512 batch {args.batch}, one CLIP-guided DDIM step "
              f"(CFG at UNet batch {2 * args.batch}, the guide's UNet at {args.batch}, f32 "
              f"decode and ViT-B/32 under grad): {step_ms:.2f} ms per steady step without the "
              f"profiler ({card})")
        profiled("one guided step (the whole eps model)", lambda: eps_fn(x, t, 7.5, False))
        profiled("CFG call", lambda: cfg_call(x, t, 7.5, False))
        one = np.float32(1)
        with torch.enable_grad():
            xl = x.detach().clone().requires_grad_(True)
            t_b = t.reshape(1).expand(args.batch)
            ctx = spec.factors[:1].expand(args.batch, -1, -1)
            eps = profiled("guide forward: UNet under grad", lambda: unet(xl, t_b, ctx))

            def decode():
                x0 = (xl - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
                return M.vae_decode(bundle.vae_cfg, bundle.vae_params, x0 / LATENT_SCALE)

            img = profiled("guide forward: f32 decode under grad", decode)

            def vision():
                im = torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
                im = resize(im, (im.shape[0], vcfg.image_size, vcfg.image_size, 3), "bilinear")
                emb = M.clip_vision_apply(vcfg, vparams, clip_normalize(im))
                return spherical_dist_loss(emb, text[None]).mean()

            loss = profiled("guide forward: resize, vision tower, loss", vision)
            profiled("guide backward (autograd.grad w.r.t. the latents)",
                     lambda: torch.autograd.grad(loss, xl))
    return 0


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
    ap.add_argument("--train", action="store_true",
                    help="profile the training step (f32 master weights, bf16 compute, Adan)")
    ap.add_argument("--clip-guided", action="store_true",
                    help="profile one CLIP-guided DDIM step (ViT-B/32 guide, f32 decode)")
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.train:
        return _train(args, card)
    if args.clip_guided:
        return _clip_guided(args, card)
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
