"""RePaint inpainting sampler (Lugmayr et al. 2022, arXiv:2201.09865).

Counterpart of ``complex_prompt_diffusion_tpu/samplers/repaint.py``, whose
loop is a ``lax.scan`` over per-transition coefficient rows; here the rows
are host f32 numpy and the loop is Python on the device:

  * the jump walk is ``schedules.jump_timesteps`` (trained timesteps);
  * a reverse transition is the DDIM-style update of the unknown region
    (eta defaults to 1) and the known region re-noised from the original
    to the *previous* timestep, merged as x = mask * known + (1 - mask) *
    unknown (mask == 1 keeps the original);
  * a forward (undo) transition renoises x by the product of (1 - beta)
    over the jumped range: x = sqrt(keep) x + sqrt(1 - keep) noise.

Noise: each transition takes one draw, reverse or undo, as the JAX loop
does; the draws come from ``noises`` ([len(walk), *shape], injected) or a
``torch.Generator`` (x_T first, when it is not given, then one a
transition).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.schedules import DiffusionTables
from complex_prompt_diffusion_tpu_torch.schedules.timesteps import jump_timesteps

__all__ = ["sample_repaint", "repaint_rows"]


def repaint_rows(tables: DiffusionTables, steps: int, jump_length: int, jump_n_sample: int,
                 eta: float = 1.0) -> dict:
    """The walk's per-transition coefficients as host f32 arrays: timestep
    ``t``, ``reverse`` (bool), ``a_t``, ``a_prev``, ``sigma_t``, and the undo
    renoise weights ``keep`` and ``add``. Transition i goes from walk[i] to
    walk[i + 1] (or to walk[-1] - stride at the end)."""
    walk = jump_timesteps(steps, tables.num_train_timesteps, jump_length, jump_n_sample)
    t_stride = tables.num_train_timesteps // steps
    ac = np.asarray(tables.alphas_cumprod)
    betas = np.asarray(tables.betas)
    t_cur = np.asarray(walk)
    t_next = np.append(t_cur[1:], max(t_cur[-1] - t_stride, 0))
    is_reverse = t_next < t_cur
    a_t = ac[np.clip(t_cur, 0, None)]
    a_prev = ac[np.clip(t_next, 0, None)]
    sigma_t = eta * np.sqrt(
        np.where(
            is_reverse,
            (1 - a_prev) / np.maximum(1 - a_t, 1e-12) * (1 - a_t / np.maximum(a_prev, 1e-12)),
            0.0,
        )
    )
    keep = np.ones(len(t_cur))
    add = np.zeros(len(t_cur))
    for i in range(len(t_cur)):
        if not is_reverse[i]:
            kp = np.prod(1.0 - betas[t_cur[i]:t_next[i]])
            keep[i], add[i] = np.sqrt(kp), np.sqrt(1.0 - kp)
    f32 = np.float32
    return {"t": t_cur.astype(f32), "reverse": is_reverse, "a_t": a_t.astype(f32),
            "a_prev": a_prev.astype(f32), "sigma_t": sigma_t.astype(f32),
            "keep": keep.astype(f32), "add": add.astype(f32)}


def sample_repaint(
    eps_fn: Callable,
    original: torch.Tensor,
    mask: torch.Tensor,
    tables: DiffusionTables,
    steps: int = 50,
    jump_length: int = 10,
    jump_n_sample: int = 10,
    eta: float = 1.0,
    *,
    generator: Optional[torch.Generator] = None,
    noises=None,
    x_T: Optional[torch.Tensor] = None,
    uc_scale: float = 7.5,
) -> torch.Tensor:
    """Inpaint ``original`` where ``mask == 0`` (mask == 1 keeps the image).

    eps_fn(x, t, uc_scale, blur_on) — the guidance closure, called with
    blur off at every reverse transition (the undo transitions call no
    model). The step arithmetic is f32, its scalars host f32 values."""
    rows = repaint_rows(tables, steps, jump_length, jump_n_sample, eta)
    device = original.device
    if noises is not None:
        noises = torch.as_tensor(noises, dtype=torch.float32, device=device)
    elif generator is None:
        raise ValueError("sample_repaint needs a generator or injected noises")
    if x_T is None:
        if generator is None:
            raise ValueError("sample_repaint needs x_T or a generator to draw it")
        x_T = torch.randn(original.shape, generator=generator, device=device)
    x = torch.as_tensor(x_T, dtype=torch.float32, device=device)
    mask = torch.as_tensor(mask, dtype=torch.float32, device=device)
    one = np.float32(1.0)
    for i in range(len(rows["t"])):
        if noises is not None:
            noise = noises[i]
        else:
            noise = torch.randn(x.shape, generator=generator, device=device)
        if rows["reverse"][i]:
            at, ap, st = rows["a_t"][i], rows["a_prev"][i], rows["sigma_t"][i]
            e_t = eps_fn(x, rows["t"][i], uc_scale, False)
            pred_x0 = (x - float(np.sqrt(one - at)) * e_t) / float(np.sqrt(at))
            dir_xt = float(np.sqrt(np.maximum(one - ap - st * st, np.float32(0.0)))) * e_t
            unknown = float(np.sqrt(ap)) * pred_x0 + dir_xt + float(st) * noise
            known = float(np.sqrt(ap)) * original + float(np.sqrt(one - ap)) * noise
            x = mask * known + (1.0 - mask) * unknown
        else:
            x = float(rows["keep"][i]) * x + float(rows["add"][i]) * noise
    return x
