"""Samplers of the port: DDIM and the k-diffusion family, by name through
the registry."""

from complex_prompt_diffusion_tpu_torch.samplers.ddim import (
    DeviceTables,
    ddim_step,
    sample_ddim,
)
from complex_prompt_diffusion_tpu_torch.samplers.kdiff import (
    get_ancestral_step,
    lms_coefficients,
    sample_dpm2,
    sample_dpm2_ancestral,
    sample_dpm_fast,
    sample_dpmpp_2m,
    sample_dpmpp_2s_ancestral,
    sample_euler,
    sample_euler_ancestral,
    sample_heun,
    sample_lms,
)
from complex_prompt_diffusion_tpu_torch.samplers.registry import (
    SAMPLERS,
    get_sampler,
    register,
)

__all__ = [
    "DeviceTables",
    "ddim_step",
    "sample_ddim",
    "sample_euler",
    "sample_euler_ancestral",
    "sample_heun",
    "sample_dpm2",
    "sample_dpm2_ancestral",
    "sample_dpmpp_2m",
    "sample_dpmpp_2s_ancestral",
    "sample_lms",
    "lms_coefficients",
    "sample_dpm_fast",
    "get_ancestral_step",
    "SAMPLERS",
    "get_sampler",
    "register",
]
