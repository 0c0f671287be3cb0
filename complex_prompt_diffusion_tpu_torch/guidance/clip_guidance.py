"""CLIP gradient guidance.

Counterpart of ``complex_prompt_diffusion_tpu/guidance/clip_guidance.py``:
predict x0 from (x, eps), decode it with the VAE, resize to the guide
CLIP's input, normalise, embed with the vision tower, and take the mean of
three spherical distance losses against the text embedding (the image
embedding, the midpoint and the difference); the gradient of that loss
with respect to x, divided by its per-pixel inf-norm over the channels and
scaled by ``grad_scale / 100``, corrects the eps:
e_t = e_t - sqrt(1 - a_t) * grads.

The gradient is ``torch.autograd.grad`` with respect to a fresh leaf made
from x: the UNet, VAE and vision weights take no gradient. The kernels the
loss reaches (the UNet's under ``eps_in_grad_fn``, the VAE decode's) run
their forward on the card and their backward through the plain twins'
VJPs (``_build.kernel_with_plain_vjp``). The guide records a graph only
inside :func:`make_clip_guidance`'s call; what it returns carries none.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.models.clip import (
    CLIP_IMAGE_MEAN,
    CLIP_IMAGE_STD,
    CLIPVisionConfig,
    clip_vision_apply,
)
from complex_prompt_diffusion_tpu_torch.utils.resize import resize

__all__ = ["ClipGuidanceConfig", "spherical_dist_loss", "make_clip_guidance", "clip_normalize"]


def spherical_dist_loss(x, y):
    """2 * arcsin(||x_hat - y_hat|| / 2)^2 over the last axis."""
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    return 2.0 * torch.arcsin(torch.linalg.vector_norm(x - y, dim=-1) / 2.0) ** 2


def clip_normalize(img: torch.Tensor) -> torch.Tensor:
    """NHWC images in [0, 1] normalised with CLIP's mean and std."""
    mean = torch.tensor(CLIP_IMAGE_MEAN, dtype=img.dtype, device=img.device)
    std = torch.tensor(CLIP_IMAGE_STD, dtype=img.dtype, device=img.device)
    return (img - mean) / std


@dataclasses.dataclass(frozen=True)
class ClipGuidanceConfig:
    """The JAX package's flag surface."""

    loss_scale: float = 1.0
    grad_scale: float = 1.0
    freq: int = 1  # guide the steps whose integer timestep divides by freq
    mode: int = 0  # 0: closed-form x0; 1: scheduler-step x0 (read by neither package)
    factor_limit: int = 1  # the prompt factors the pipeline's guided eps re-runs


def make_clip_guidance(
    vae_decode_fn: Callable,
    vision_cfg: CLIPVisionConfig,
    vision_params,
    text_embedding: torch.Tensor,
    gcfg: ClipGuidanceConfig = ClipGuidanceConfig(),
    latent_scale: float = 0.18215,
    eps_in_grad_fn: Optional[Callable] = None,
):
    """Build clip_guide(x, e_t, a_t) -> the corrected e_t.

    ``vae_decode_fn(latents_unscaled)`` -> images in [-1, 1];
    ``text_embedding`` [P] or [1, P]: the normalised guide-CLIP text
    embedding. ``eps_in_grad_fn(x) -> eps``: when given, the eps of the x0
    prediction inside the loss is recomputed from x, so the gradient flows
    through the UNet; without it e_t is a constant of the loss. ``a_t``: the
    step's alphas_cumprod, an f32 host scalar."""
    with torch.inference_mode(False):
        # a copy outside inference mode: autograd saves it in the loss
        text_embedding = torch.atleast_2d(text_embedding).clone()

    def loss_fn(x, e_t, a_t):
        if eps_in_grad_fn is not None:
            e_t = eps_in_grad_fn(x)
        pred_x0 = (x - float(np.sqrt(np.float32(1) - a_t)) * e_t) / float(np.sqrt(a_t))
        img = vae_decode_fn(pred_x0 / latent_scale)
        img = torch.clamp(img / 2.0 + 0.5, 0.0, 1.0)
        size = vision_cfg.image_size
        img = resize(img, (img.shape[0], size, size, img.shape[-1]), "bilinear")
        image_emb = clip_vision_apply(vision_cfg, vision_params, clip_normalize(img))
        mean_emb = (image_emb + text_embedding) / 2.0
        diff_emb = image_emb - text_embedding
        return (
            spherical_dist_loss(image_emb, text_embedding).mean()
            + spherical_dist_loss(mean_emb, text_embedding).mean()
            + spherical_dist_loss(diff_emb, text_embedding).mean()
        ) * (gcfg.loss_scale / 3.0)

    def clip_guide(x, e_t, a_t):
        """x: latents; e_t: the step's guided eps; a_t: alphas_cumprod at
        this step. Returns the corrected eps."""
        a_t = np.float32(a_t)
        with torch.inference_mode(False), torch.enable_grad():
            x_leaf = x.detach().clone().requires_grad_(True)
            loss = loss_fn(x_leaf, e_t.detach().clone(), a_t)
            (grad,) = torch.autograd.grad(loss, x_leaf)
        grads = -grad
        if gcfg.grad_scale > 0:
            # a per-pixel max over the channels (the last axis in NHWC)
            inf_norm = grads.abs().amax(dim=-1, keepdim=True)
            grads = grads / torch.clamp(inf_norm, min=1e-12)
            grads = grads * (gcfg.grad_scale / 100.0)
        return e_t - float(np.sqrt(np.float32(1) - a_t)) * grads

    return clip_guide
