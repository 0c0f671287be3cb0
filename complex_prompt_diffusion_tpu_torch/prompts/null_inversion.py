"""Null-text inversion (prompt-to-prompt editing support).

Counterpart of ``complex_prompt_diffusion_tpu/prompts/null_inversion.py``
(Mokady et al., arXiv:2211.09794):

  1. :func:`ddim_invert_loop`: deterministic DDIM inversion of an image
     latent, recording the latent at every step;
  2. :func:`null_optimization`: walking the chain back from the most noisy
     latent, optimize the *unconditional* embedding at each step so that
     the CFG-guided DDIM step reproduces the recorded latent: Adam with
     optax's defaults (``torch.optim.Adam``, b1 0.9, b2 0.999, eps 1e-8),
     its state started afresh at every step as the JAX loop's ``opt.init``
     does, a fixed budget of inner iterations.

Returns the per-step optimized uncond embeddings, most noisy first, which a
sampling loop consumes as a per-step conditioning table. The step
coefficients are host f32 scalars, rounded where the JAX package's f32
arrays round; the timestep reaches the callables as a 0-d int64 tensor on
the latents' device. The optimization takes the UNet's gradient with
respect to its context, through the kernels' backward rules on the card;
its inputs are copied out of inference mode first, so the pipeline's
outputs (``encode_image``, ``encode_prompt``) can be passed as they are.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.schedules import InferenceTables

__all__ = ["ddim_invert_loop", "null_optimization", "null_text_inversion"]


def _step_coeffs(it: InferenceTables):
    """(a_t, a_prev) of every table index, f32 on the host."""
    return (np.asarray(it.alphas_cumprod_t, np.float32),
            np.asarray(it.alphas_cumprod_prev_t, np.float32))


def _sqrt(a) -> float:
    return float(np.sqrt(np.float32(a)))


@torch.no_grad()
def ddim_invert_loop(cond_eps_fn: Callable, z0: torch.Tensor,
                     itables: InferenceTables) -> torch.Tensor:
    """Forward DDIM inversion, recording every latent.

    ``cond_eps_fn(x, t) -> eps`` with the *conditional* embedding only (the
    inversion runs without CFG). Returns latents [S+1, ...] with
    ``latents[0] = z0`` and ``latents[-1]`` the inverted noise."""
    a_t, a_prev = _step_coeffs(itables)
    one = np.float32(1)
    timesteps = torch.as_tensor(itables.timesteps, dtype=torch.int64, device=z0.device)
    x = z0
    traj = [z0]
    for i in range(int(itables.num_steps)):
        eps = cond_eps_fn(x, timesteps[i])
        # invert: x_{t+1} from x_t (next-step semantics)
        x0 = (x - _sqrt(one - a_prev[i]) * eps) / _sqrt(a_prev[i])
        x = _sqrt(a_t[i]) * x0 + _sqrt(one - a_t[i]) * eps
        traj.append(x)
    return torch.stack(traj)


def null_optimization(
    cfg_eps_fn: Callable,
    latents: torch.Tensor,
    uncond_init: torch.Tensor,
    itables: InferenceTables,
    guidance_scale: float = 7.5,
    num_inner_steps: int = 10,
    lr: float = 1e-2,
) -> torch.Tensor:
    """Optimize a per-step uncond embedding table.

    ``cfg_eps_fn(x, t, uncond) -> (eps_uncond, eps_cond)``. Walks from the
    most noisy recorded latent down: at step index idx (descending), finds
    the uncond for which the CFG DDIM step from ``latents[idx + 1]`` lands
    on ``latents[idx]``, starting from the previous step's result. Returns
    the uncond table [S, L, D], most noisy first."""
    a_t, a_prev = _step_coeffs(itables)
    one = np.float32(1)
    s = int(itables.num_steps)
    with torch.inference_mode(False):
        latents = latents.detach().clone()
        uncond = uncond_init.detach().clone()
        timesteps = torch.as_tensor(itables.timesteps, dtype=torch.int64, device=latents.device)
        out = []
        for i in range(s):
            idx = s - 1 - i
            x_cur, target, t = latents[idx + 1], latents[idx], timesteps[idx]
            u = uncond.clone().requires_grad_(True)
            opt = torch.optim.Adam([u], lr=lr, betas=(0.9, 0.999), eps=1e-8)
            for _ in range(num_inner_steps):
                with torch.enable_grad():
                    e_u, e_c = cfg_eps_fn(x_cur, t, u)
                    eps = e_u + guidance_scale * (e_c - e_u)
                    pred_x0 = (x_cur - _sqrt(one - a_t[idx]) * eps) / _sqrt(a_t[idx])
                    x_prev = _sqrt(a_prev[idx]) * pred_x0 + _sqrt(one - a_prev[idx]) * eps
                    loss = torch.mean((x_prev - target) ** 2)
                    (grad,) = torch.autograd.grad(loss, u)
                u.grad = grad
                opt.step()
            uncond = u.detach()
            out.append(uncond)
        return torch.stack(out)


def null_text_inversion(
    cond_eps_fn: Callable,
    cfg_eps_fn: Callable,
    z0: torch.Tensor,
    uncond_init: torch.Tensor,
    itables: InferenceTables,
    guidance_scale: float = 7.5,
    num_inner_steps: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DDIM inversion, then the null-text optimization along its chain:
    returns (x_T, the per-step uncond table, most noisy first)."""
    latents = ddim_invert_loop(cond_eps_fn, z0, itables)
    unconds = null_optimization(cfg_eps_fn, latents, uncond_init, itables,
                                guidance_scale=guidance_scale,
                                num_inner_steps=num_inner_steps)
    return latents[-1], unconds
