"""Samplers of the port, by name through the registry: DDIM and PLMS (and
DDIM inversion), the k-diffusion family and DPM Adaptive, the continuous-time
DPM-Solver and UniPC, iPNDM and blur diffusion. RePaint inpainting
(``sample_repaint``) is driven by the manager's masked img2img, not by the
registry; ``callbacks`` holds the per-step preview hooks."""

from complex_prompt_diffusion_tpu_torch.samplers.blur import BlurDiffusion, sample_blur
from complex_prompt_diffusion_tpu_torch.samplers.ddim import (
    DeviceTables,
    ddim_encode,
    ddim_step,
    sample_ddim,
    sample_plms,
)
from complex_prompt_diffusion_tpu_torch.samplers.dpm_adaptive import sample_dpm_adaptive
from complex_prompt_diffusion_tpu_torch.samplers.ipndm import sample_ipndm
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
from complex_prompt_diffusion_tpu_torch.samplers.repaint import sample_repaint
from complex_prompt_diffusion_tpu_torch.samplers.registry import (
    SAMPLERS,
    get_sampler,
    register,
)
from complex_prompt_diffusion_tpu_torch.samplers.solver import (
    NoiseScheduleVP,
    model_wrapper,
    sample_dpm_solver,
    sample_dpm_solver_adaptive,
)
from complex_prompt_diffusion_tpu_torch.samplers.unipc import sample_unipc

__all__ = [
    "DeviceTables",
    "ddim_step",
    "sample_ddim",
    "sample_plms",
    "ddim_encode",
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
    "sample_dpm_adaptive",
    "get_ancestral_step",
    "NoiseScheduleVP",
    "model_wrapper",
    "sample_dpm_solver",
    "sample_dpm_solver_adaptive",
    "sample_unipc",
    "sample_ipndm",
    "BlurDiffusion",
    "sample_blur",
    "sample_repaint",
    "SAMPLERS",
    "get_sampler",
    "register",
]
