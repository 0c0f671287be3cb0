"""CLIP-guided txt2img (standalone).

Counterpart of ``complex_prompt_diffusion_tpu/pipeline_clip_guided.py``:
every DDIM step's CFG eps is corrected by the gradient, with respect to the
latents, of a guide CLIP's spherical distance to a text embedding. The
loss runs the UNet on the conditional prompt, blends the predicted x0 with
the latents as PNDM does (sample = x0 * sqrt(1 - a) + x * (1 - sqrt(1 -
a))), decodes the blend with the VAE, takes random cutouts (or a plain
resize) to the guide's input size and embeds them with its vision tower.

The cutout plan is drawn on the host from ``np.random.default_rng(seed)``,
the JAX package's plan for the same seed. The render runs outside
inference mode without grad; only the loss records a graph, and the
gradient is ``torch.autograd.grad`` with respect to a fresh leaf made from
the step's latents (no weight takes a gradient). The kernels under the
loss run their forward on the card and their backward through the plain
twins' VJPs (``_build.kernel_with_plain_vjp``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.guidance.clip_guidance import (
    clip_normalize,
    spherical_dist_loss,
)
from complex_prompt_diffusion_tpu_torch.models.clip import CLIPVisionConfig, clip_vision_apply
from complex_prompt_diffusion_tpu_torch.pipeline import (
    LATENT_SCALE,
    ModelBundle,
    RenderConfig,
    decode_latents,
    encode_prompt,
)
from complex_prompt_diffusion_tpu_torch.utils.resize import resize

__all__ = ["make_cutout_plan", "apply_cutouts", "clip_guided_txt2img"]


def make_cutout_plan(
    rng: np.random.Generator,
    side: int,
    cut_size: int,
    num_cutouts: int,
    cut_power: float = 1.0,
) -> List[Tuple[int, int, int]]:
    """Random (size, offset_y, offset_x) square cutouts of a ``side`` x
    ``side`` image, sizes between min(side, cut_size) and side, drawn on the
    host."""
    max_size = side
    min_size = min(side, cut_size)
    plan = []
    for _ in range(num_cutouts):
        size = int(rng.random() ** cut_power * (max_size - min_size) + min_size)
        oy = int(rng.integers(0, side - size + 1))
        ox = int(rng.integers(0, side - size + 1))
        plan.append((size, oy, ox))
    return plan


def apply_cutouts(images: torch.Tensor, plan, cut_size: int) -> torch.Tensor:
    """Each cutout of the plan cropped and resized ("linear", antialiased
    as ``jax.image.resize``) to ``cut_size``: images [N, H, W, 3] ->
    [len(plan) * N, cut_size, cut_size, 3], cutout-major."""
    n, c = images.shape[0], images.shape[-1]
    return torch.cat([
        resize(images[:, oy: oy + size, ox: ox + size], (n, cut_size, cut_size, c), "linear")
        for size, oy, ox in plan
    ], dim=0)


def clip_guided_txt2img(
    bundle: ModelBundle,
    vision_cfg: CLIPVisionConfig,
    vision_params,
    prompt: str,
    clip_prompt: Optional[str] = None,
    negative_prompt: str = "",
    cfg: RenderConfig = RenderConfig(),
    *,
    clip_guidance_scale: float = 100.0,
    num_cutouts: int = 4,
    use_cutouts: bool = True,
    generator: Optional[torch.Generator] = None,
    x_T: Optional[torch.Tensor] = None,
    text_embedding_clip: Optional[torch.Tensor] = None,
):
    """txt2img with per-step CLIP cutout guidance over the DDIM chain (eta
    ``cfg.eta``'s table, CFG ``cfg.guidance.guidance_scale``).

    ``text_embedding_clip``: the normalised guide-CLIP text embedding [P];
    if None, the bundle's text tower's pooled embedding of ``clip_prompt``
    (or ``prompt``) stands in. Its width must be the vision tower's
    ``projection_dim`` (ValueError otherwise: SD-1.5's 768 fits ViT-L/14,
    not ViT-B/32's 512; the JAX package fails there too). ``x_T`` [B, h, w,
    4]: the start, else drawn from ``generator`` (default: seeded from
    ``cfg.seed``). The cutout plan comes from ``np.random.default_rng(
    cfg.seed)``. Returns (images_uint8, latents)."""
    device = bundle.device
    ucfg, params = bundle.unet_cfg, bundle.unet_params
    if text_embedding_clip is None:
        with torch.inference_mode():
            tokens = torch.as_tensor(bundle.tokenizer(clip_prompt or prompt), device=device)
            text_embedding_clip = M.clip_text_apply(bundle.clip_cfg, bundle.clip_params,
                                                    tokens, layer="pooled")
    width = text_embedding_clip.shape[-1]
    if width != vision_cfg.projection_dim:
        raise ValueError(
            f"the guide text embedding has width {width} and the vision tower's embedding "
            f"{vision_cfg.projection_dim}: the spherical distance needs one width (pass "
            "text_embedding_clip of the guide CLIP's text tower)")
    cond = encode_prompt(bundle, prompt)
    uncond = encode_prompt(bundle, negative_prompt)

    it = S.make_inference_tables(bundle.tables, cfg.steps, eta=cfg.eta)
    s_steps = it.num_steps
    a_t_all = np.asarray(it.alphas_cumprod_t, np.float32)
    a_prev_all = np.asarray(it.alphas_cumprod_prev_t, np.float32)
    timesteps = torch.as_tensor(np.asarray(it.timesteps), device=device)
    b = cfg.batch_size
    if x_T is None:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(cfg.seed)
        x_T = torch.randn((b,) + cfg.latent_shape, generator=generator, device=device)

    cut = vision_cfg.image_size
    # the decoded image's side: latent side times the VAE's upsampling
    decoded_side = (cfg.height // 8) * 2 ** (len(bundle.vae_cfg.ch_mult) - 1)
    plan = (make_cutout_plan(np.random.default_rng(cfg.seed), decoded_side,
                             min(cut, decoded_side), num_cutouts)
            if use_cutouts else None)
    gs = cfg.guidance.guidance_scale
    one = np.float32(1)

    with torch.inference_mode(False), torch.no_grad():
        # copies outside inference mode: autograd saves them in the loss
        text_emb = torch.atleast_2d(text_embedding_clip).clone()
        cond, uncond = cond.clone().expand(b, -1, -1), uncond.clone().expand(b, -1, -1)
        ctx_cfg = torch.cat([uncond, cond])
        x = torch.as_tensor(x_T, dtype=torch.float32, device=device).clone()

        def cond_loss(latents, t, a_t):
            eps = M.unet_apply(ucfg, params, latents, t.reshape(1).expand(b), cond,
                               shard=bundle.shard)
            fac = float(np.sqrt(one - a_t))
            pred_x0 = (latents - fac * eps) / float(np.sqrt(a_t))
            sample = pred_x0 * fac + latents * (1 - fac)  # the PNDM blend
            img = M.vae_decode(bundle.vae_cfg, bundle.vae_params, sample / LATENT_SCALE)
            img = torch.clamp(img / 2 + 0.5, 0.0, 1.0)
            if use_cutouts:
                img = apply_cutouts(img, plan, cut)
            else:
                img = resize(img, (img.shape[0], cut, cut, 3), "linear")
            emb = clip_vision_apply(vision_cfg, vision_params, clip_normalize(img))
            emb = emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
            dists = spherical_dist_loss(emb, text_emb)
            if use_cutouts:
                dists = dists.reshape(num_cutouts, b, -1)
                return dists.sum(dim=2).mean(dim=0).sum() * clip_guidance_scale
            return dists.mean() * clip_guidance_scale

        for i in range(s_steps):
            idx = s_steps - 1 - i
            t = timesteps[idx]
            a_t, a_prev = a_t_all[idx], a_prev_all[idx]
            out = M.unet_apply(ucfg, params, torch.cat([x, x]), t.reshape(1).expand(2 * b),
                               ctx_cfg, shard=bundle.shard)
            e_u, e_c = out.chunk(2)
            e_t = e_u + gs * (e_c - e_u)
            with torch.enable_grad():
                x_leaf = x.detach().clone().requires_grad_(True)
                (grad,) = torch.autograd.grad(cond_loss(x_leaf, t, a_t), x_leaf)
            e_t = e_t + float(np.sqrt(one - a_t)) * grad
            pred_x0 = (x - float(np.sqrt(one - a_t)) * e_t) / float(np.sqrt(a_t))
            x = float(np.sqrt(a_prev)) * pred_x0 + float(np.sqrt(one - a_prev)) * e_t
    return decode_latents(bundle, x), x
