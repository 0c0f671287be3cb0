"""Classifier-free guidance for the port, and the thresholders
(``threshold.py``) its switches use."""

from complex_prompt_diffusion_tpu_torch.guidance.cfg import (
    GuidanceConfig,
    GuidanceSpec,
    cfg_epsilon,
    make_denoiser,
    make_uc_blur_schedule,
    make_uc_scale_schedule,
    sigma_to_t_cont,
    stacked_context,
)

__all__ = [
    "GuidanceConfig",
    "GuidanceSpec",
    "cfg_epsilon",
    "make_uc_scale_schedule",
    "make_uc_blur_schedule",
    "stacked_context",
    "sigma_to_t_cont",
    "make_denoiser",
]
