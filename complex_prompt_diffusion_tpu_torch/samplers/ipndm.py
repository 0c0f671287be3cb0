"""iPNDM: improved pseudo numerical methods (a trig schedule and
Adams-Bashforth steps of order up to 4).

Counterpart of ``complex_prompt_diffusion_tpu/samplers/ipndm.py``. Schedule
on the unit grid t_i = linspace(1, 0, steps + 1): beta_i = sin(t_i pi/2)^2,
alpha_i = sqrt(1 - beta_i^2) (the reference's quirk: not cos). Step i
blends the model output into the history as ets = x beta_i + e_t alpha_i,
combines the newest 1-4 entries by Adams-Bashforth, then
pred = (x - beta_i ets_ab) / alpha_i and x = alpha_{i+1} pred +
beta_{i+1} ets_ab. The schedule is host float32; the history is a Python
list of the newest four entries.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

__all__ = ["ipndm_schedule", "sample_ipndm"]


def ipndm_schedule(steps: int):
    """(beta, alpha) float32 arrays of length steps + 1 on the unit grid."""
    t = np.linspace(1.0, 0.0, steps + 1)
    beta = np.sin(t * math.pi / 2) ** 2
    alpha = np.sqrt(1.0 - beta**2)
    return beta.astype(np.float32), alpha.astype(np.float32)


def _ab_combine(ets: List[torch.Tensor]) -> torch.Tensor:
    """Adams-Bashforth blend of the newest 1-4 history entries; ``ets[0]``
    is the newest."""
    if len(ets) == 1:
        return ets[0]
    if len(ets) == 2:
        return (3 * ets[0] - ets[1]) / 2
    if len(ets) == 3:
        return (23 * ets[0] - 16 * ets[1] + 5 * ets[2]) / 12
    return (55 * ets[0] - 59 * ets[1] + 37 * ets[2] - 9 * ets[3]) / 24


def sample_ipndm(
    eps_fn: Callable,
    x: torch.Tensor,
    steps: int,
    uc_scales=None,
    *,
    num_train_timesteps: int = 1000,
):
    """Run the iPNDM loop: ``steps`` calls of the t-space denoiser
    ``eps_fn(x, t, uc_scale)``, with t an f32 [B] tensor on the trig map
    atan2(beta, alpha) / pi * 2 scaled by ``num_train_timesteps``. Returns
    (x, None)."""
    beta, alpha = ipndm_schedule(steps)
    t_unit = np.arctan2(beta, alpha) / math.pi * 2.0
    t_f32 = np.asarray(t_unit * num_train_timesteps, np.float32)
    if uc_scales is None:
        uc_scales = 1.0
    ucs = np.broadcast_to(np.asarray(uc_scales, np.float32), (steps,))
    eps_floor = np.float32(1e-8)
    ets = []  # newest first
    for i in range(steps):
        t = torch.full((x.shape[0],), float(t_f32[i]), dtype=torch.float32, device=x.device)
        e_t = eps_fn(x, t, float(ucs[i]))
        ets = [x * float(beta[i]) + e_t * float(alpha[i])] + ets[:3]
        ets_ab = _ab_combine(ets)
        pred = (x - float(beta[i]) * ets_ab) / float(max(alpha[i], eps_floor))
        x = float(alpha[i + 1]) * pred + ets_ab * float(beta[i + 1])
    return x, None
