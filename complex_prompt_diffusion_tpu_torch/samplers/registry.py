"""Sampler registry: the reference's display-name strings -> sampler entries.

Counterpart of ``complex_prompt_diffusion_tpu/samplers/registry.py``. Names
are matched case-insensitively (including the reference's "Huen" spelling
for Heun). Each entry is (family, sample_fn), where family is "t"
(DDIM-style, drives InferenceTables), "sigma" (k-diffusion, drives a sigma
schedule), "solver" (continuous-time VP solvers), "trig" (iPNDM's own
schedule) or "blur" (inverse-heat blur diffusion).

Every name the JAX package registers resolves to a ported function with
the same family; "Log" is the log-likelihood estimator
(``loglik.sample_log_likelihood``), which returns log-likelihoods [B], not
latents.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from complex_prompt_diffusion_tpu_torch.samplers import blur as _blur
from complex_prompt_diffusion_tpu_torch.samplers import ddim as _ddim
from complex_prompt_diffusion_tpu_torch.samplers import dpm_adaptive as _dpma
from complex_prompt_diffusion_tpu_torch.samplers import ipndm as _ipndm
from complex_prompt_diffusion_tpu_torch.samplers import kdiff as _k
from complex_prompt_diffusion_tpu_torch.samplers import loglik as _loglik
from complex_prompt_diffusion_tpu_torch.samplers import solver as _solver
from complex_prompt_diffusion_tpu_torch.samplers import unipc as _unipc

__all__ = ["SAMPLERS", "get_sampler", "register"]

SAMPLERS: Dict[str, Tuple[str, Callable]] = {}


def register(name: str, family: str):
    def deco(fn):
        SAMPLERS[name.lower()] = (family, fn)
        return fn

    return deco


def get_sampler(name: str) -> Tuple[str, Callable]:
    """Look up by the reference's display name (e.g. "DDIM", "Euler",
    "Euler Ancestral", "DPM++ 2m", "Huen", "LMS", "DPM2", "DPM Fast")."""
    key = name.lower()
    if key not in SAMPLERS:
        raise KeyError(
            f"unknown sampler {name!r}; options: {sorted(SAMPLERS)}"
        )
    return SAMPLERS[key]


# t-space family
register("DDIM", "t")(_ddim.sample_ddim)
register("PLMS", "t")(_ddim.sample_plms)

# sigma-space (k-diffusion) family, names as registered by the reference
register("Euler", "sigma")(_k.sample_euler)
register("Euler Ancestral", "sigma")(_k.sample_euler_ancestral)
register("Huen", "sigma")(_k.sample_heun)  # the reference's spelling
register("Heun", "sigma")(_k.sample_heun)
register("DPM2", "sigma")(_k.sample_dpm2)
register("DPM2 Ancestral", "sigma")(_k.sample_dpm2_ancestral)
register("DPM++ 2m", "sigma")(_k.sample_dpmpp_2m)
register("DPM++ 2s Ancestral", "sigma")(_k.sample_dpmpp_2s_ancestral)
register("LMS", "sigma")(_k.sample_lms)
register("DPM Fast", "sigma")(_k.sample_dpm_fast)
register("DPM Adaptive", "sigma")(_dpma.sample_dpm_adaptive)
register("Log", "sigma")(_loglik.sample_log_likelihood)  # log-likelihood estimator

# continuous-time solver family
register("dpm_solver", "solver")(_solver.sample_dpm_solver)
register("DPM Solver", "solver")(_solver.sample_dpm_solver)
register("UniPC", "solver")(_unipc.sample_unipc)

# trig family (iPNDM's own sin^2 schedule)
register("iPNDM", "trig")(_ipndm.sample_ipndm)

# blur-diffusion family
register("Blur", "blur")(_blur.sample_blur)
