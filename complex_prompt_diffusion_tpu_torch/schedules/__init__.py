"""Noise-schedule math: beta schedules, coefficient tables, timestep grids,
sigma schedules.

Host-side numpy in float64, copied from ``complex_prompt_diffusion_tpu/
schedules`` (that package imports jax). The sampling loop converts the
finished tables to device tensors.
"""

from complex_prompt_diffusion_tpu_torch.schedules.beta import make_beta_schedule
from complex_prompt_diffusion_tpu_torch.schedules.sigma import (
    append_zero,
    exponential_sigmas,
    karras_scalings,
    karras_sigmas,
    linear_sigmas,
    make_sigma_schedule,
    quadratic_sigmas,
    sigma_to_t,
    sigmoid_sigmas,
    t_to_sigma,
    vp_sigmas,
)
from complex_prompt_diffusion_tpu_torch.schedules.tables import (
    DiffusionTables,
    InferenceTables,
    make_diffusion_tables,
    make_inference_tables,
)
from complex_prompt_diffusion_tpu_torch.schedules.timesteps import (
    jump_timesteps,
    make_timesteps,
    quad_timesteps,
    uniform_timesteps,
)

__all__ = [
    "make_beta_schedule",
    "make_timesteps",
    "uniform_timesteps",
    "quad_timesteps",
    "jump_timesteps",
    "DiffusionTables",
    "InferenceTables",
    "make_diffusion_tables",
    "make_inference_tables",
    "append_zero",
    "karras_sigmas",
    "exponential_sigmas",
    "quadratic_sigmas",
    "sigmoid_sigmas",
    "vp_sigmas",
    "linear_sigmas",
    "make_sigma_schedule",
    "sigma_to_t",
    "t_to_sigma",
    "karras_scalings",
]
