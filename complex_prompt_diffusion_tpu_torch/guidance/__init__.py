"""Classifier-free guidance for the port (with its DeepCache and
attention-guided forms), the thresholders (``threshold.py``) its switches
use, attention-saliency guidance (``attn_guidance.py``), DAAM heat maps
(``daam.py``) and CLIP gradient guidance (``clip_guidance.py``)."""

from complex_prompt_diffusion_tpu_torch.guidance.cfg import (
    GuidanceConfig,
    GuidanceSpec,
    cfg_epsilon,
    cfg_epsilon_attn_guided,
    cfg_epsilon_deepcache,
    make_denoiser,
    make_denoiser_deepcache,
    make_uc_blur_schedule,
    make_uc_scale_schedule,
    sigma_to_t_cont,
    stacked_context,
)
from complex_prompt_diffusion_tpu_torch.guidance.threshold import THRESHOLDERS, get_thresholder

__all__ = [
    "GuidanceConfig",
    "GuidanceSpec",
    "cfg_epsilon",
    "cfg_epsilon_deepcache",
    "cfg_epsilon_attn_guided",
    "make_denoiser_deepcache",
    "make_uc_scale_schedule",
    "make_uc_blur_schedule",
    "stacked_context",
    "sigma_to_t_cont",
    "make_denoiser",
    "THRESHOLDERS",
    "get_thresholder",
]
