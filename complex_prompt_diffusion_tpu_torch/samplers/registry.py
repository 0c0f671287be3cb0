"""Sampler registry: the reference's display-name strings -> sampler entries.

Counterpart of ``complex_prompt_diffusion_tpu/samplers/registry.py``. Names
are matched case-insensitively (including the reference's "Huen" spelling
for Heun). Each entry is (family, sample_fn), where family is "t"
(DDIM-style, drives InferenceTables) or "sigma" (k-diffusion, drives a sigma
schedule).

Ported: DDIM and the nine k-diffusion samplers of ``kdiff.py``. The other
names the JAX package registers (PLMS, DPM Adaptive, Log, dpm_solver / DPM
Solver, UniPC, iPNDM, Blur) are registered too, with their families, to a
function that raises NotImplementedError naming the sampler.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

from complex_prompt_diffusion_tpu_torch.samplers import ddim as _ddim
from complex_prompt_diffusion_tpu_torch.samplers import kdiff as _k

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


def _not_ported(name: str) -> Callable:
    def sample(*args, **kwargs):
        raise NotImplementedError(f"sampler {name!r} is not ported yet")

    sample.not_ported = True
    return sample


# t-space family
register("DDIM", "t")(_ddim.sample_ddim)

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

# registered by the JAX package, not ported yet
for _name, _family in (
    ("PLMS", "t"),
    ("DPM Adaptive", "sigma"),
    ("Log", "sigma"),
    ("dpm_solver", "solver"),
    ("DPM Solver", "solver"),
    ("UniPC", "solver"),
    ("iPNDM", "trig"),
    ("Blur", "blur"),
):
    register(_name, _family)(_not_ported(_name))
