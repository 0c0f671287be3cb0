"""Attention-saliency guidance as a stand-alone step function.

Counterpart of ``complex_prompt_diffusion_tpu/guidance/attn_guidance.py``:
on the last sampling steps a saliency mask comes from one of the UNet's
encoder skip tensors (channel mean, binarized at a percentile, resized to
the latent), the predicted x0 is blurred inside it and re-noised, and a
second UNet evaluation on that input gives a contrast signal:

    e_t_final = e_attn + scale * (e_t_cfg - e_attn)

(a SAG-style self-guidance). The pipeline's guided steps use
``guidance/cfg.py``'s ``cfg_epsilon_attn_guided``, which folds the same
rule into the CFG sum through this module's mask and blur.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.ops.blur import gaussian_blur
from complex_prompt_diffusion_tpu_torch.utils.resize import resize

__all__ = ["AttnGuidanceConfig", "saliency_mask", "blur_renoise", "make_attn_guidance"]


@dataclasses.dataclass(frozen=True)
class AttnGuidanceConfig:
    scale: float = 1.1  # attn_guide_scale
    rounds: int = 4  # apply on the last N steps
    skip_idx: int = -1  # the skip tensor that gives the saliency map
    mask_threshold: float = 90.0  # percentile
    blur_k: int = 31
    mask_batch_idx: int = 0


def saliency_mask(skip_feat: torch.Tensor, threshold_pct: float, out_hw,
                  batch_idx: Optional[int] = 0):
    """Feature map [N, h, w, C] -> binary f32 mask [1, H, W, 1]: the channel
    mean, 1 above its ``threshold_pct`` percentile over the whole batch
    (``torch.quantile``, linear), sample ``batch_idx`` (None: every sample,
    [N, H, W, 1]), resized "nearest" to ``out_hw``."""
    m = skip_feat.float().mean(dim=-1, keepdim=True)
    s = torch.quantile(m.reshape(-1), threshold_pct / 100.0)
    m = torch.where(m > s, 1.0, 0.0)
    if batch_idx is not None:
        m = m[batch_idx: batch_idx + 1]
    return resize(m, m.shape[:1] + tuple(out_hw) + (1,), "nearest")


def blur_renoise(x, eps_u, mask, sqrt_a: float, sqrt_1m: float, blur_k: int):
    """``x`` with its predicted x0 (from ``eps_u``) blurred by a ``blur_k``
    Gaussian and re-noised inside ``mask``, unchanged outside."""
    pred_x0 = (x - sqrt_1m * eps_u) / sqrt_a
    blur_x = sqrt_a * gaussian_blur(pred_x0, blur_k) + sqrt_1m * eps_u
    return blur_x * mask + x * (1.0 - mask)


def make_attn_guidance(unet_skips_fn: Callable, unet_uncond_fn: Callable, itables,
                       acfg: AttnGuidanceConfig = AttnGuidanceConfig()):
    """attn_guide(x, t, idx, e_t_cfg) -> e_t: unet_skips_fn(x, t) -> (eps,
    skips) and unet_uncond_fn(x, t) -> eps take the unconditional input;
    ``idx`` is the descending table index of ``itables`` (a host int), whose
    f32 coefficients step x to x0 and back. The caller decides on which
    steps it runs (the reference: the last ``acfg.rounds``)."""
    ac_t = np.asarray(itables.alphas_cumprod_t, np.float32)
    s1m_t = np.asarray(itables.sqrt_one_minus_alphas_cumprod_t, np.float32)

    def attn_guide(x, t, idx, e_t_cfg):
        eps_u, skips = unet_skips_fn(x, t)
        mask = saliency_mask(skips[acfg.skip_idx], acfg.mask_threshold, x.shape[1:3],
                             acfg.mask_batch_idx)
        guide_x = blur_renoise(x, eps_u, mask, float(np.sqrt(ac_t[idx])), float(s1m_t[idx]),
                               acfg.blur_k)
        e_attn = unet_uncond_fn(guide_x, t)
        return e_attn + acfg.scale * (e_t_cfg - e_attn)

    return attn_guide
