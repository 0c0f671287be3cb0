"""DPM Adaptive: the PID-controlled adaptive-step DPM-Solver.

Counterpart of ``complex_prompt_diffusion_tpu/samplers/dpm_adaptive.py``:
embedded order-(2, 3) or (1, 2) solver pairs in t = -log(sigma), the local
error against atol/rtol, and the PID step-size controller with the atan
limiter. Where the JAX package runs one ``lax.while_loop`` on the device,
this is a Python loop whose step state (t, h, the error history) is host
float32, rounded as the JAX package's f32 scalars round. Each iteration
makes ``order`` denoiser calls and reads ONE scalar to the host, the error
norm, which decides accept or reject and the next step size.

``eta`` > 0 adds k-diffusion's ancestral noise: each step aims at the
sigma_down of an ancestral step and an accepted step adds sigma_up times
``s_noise`` times a noise draw, injected (``noises[k]`` for the k-th
accepted step) or from a ``torch.Generator``. The JAX function has no
``eta``; at the default 0 the two run the same steps.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["sample_dpm_adaptive"]

_F = np.float32


def sample_dpm_adaptive(
    den: Callable,
    x: torch.Tensor,
    sigmas: np.ndarray,
    uc_scales=1.0,
    *,
    generator: Optional[torch.Generator] = None,
    noises=None,
    order: int = 3,
    rtol: float = 0.05,
    atol: float = 0.0078,
    h_init: float = 0.05,
    pcoeff: float = 0.0,
    icoeff: float = 1.0,
    dcoeff: float = 0.0,
    accept_safety: float = 0.81,
    max_iters: int = 200,
    eta: float = 0.0,
    s_noise: float = 1.0,
):
    """den(x, sigma, uc_scale) -> denoised, ``sigma`` a host scalar.
    ``sigmas``: the descending schedule; the integration runs t from
    -log sigmas[0] to -log sigmas[-2], at the first guidance scale. Returns
    (x, {"nfe", "steps", "accepted"}) with host ints."""
    sigmas = np.asarray(sigmas, np.float64)
    t_start = -math.log(sigmas[0])
    t_end64 = -math.log(sigmas[-2])
    t_end = _F(t_end64)
    uc = float(np.asarray(uc_scales, np.float32).ravel()[0])
    noises = None if noises is None else torch.as_tensor(
        noises, dtype=torch.float32, device=x.device)

    b1 = _F((pcoeff + icoeff + dcoeff) / order)
    b2 = _F(-(pcoeff + 2 * dcoeff) / order)
    b3 = _F(dcoeff / order)

    def sig_of(t):
        return np.exp(-_F(t))

    def t_of(sigma):
        return -np.log(_F(sigma))

    def eps_of(x, t):
        sigma = sig_of(t)
        return (x - den(x, sigma, uc)) / float(sigma)

    def solver_1(x, t, t_next, eps):
        h = t_next - t
        return x - float(sig_of(t_next) * np.expm1(h)) * eps

    def solver_2(x, t, t_next, eps, r1=0.5):
        h = t_next - t
        s1 = t + _F(r1) * h
        u1 = x - float(sig_of(s1) * np.expm1(_F(r1) * h)) * eps
        eps_r1 = eps_of(u1, s1)
        c = sig_of(t_next) / _F(2 * r1) * np.expm1(h)
        return x - float(sig_of(t_next) * np.expm1(h)) * eps - float(c) * (eps_r1 - eps), eps_r1

    def solver_3(x, t, t_next, eps, eps_r1):
        """The third-order step; its first stage is solver_2's at r1 = 1/3,
        whose evaluation ``eps_r1`` it reuses."""
        h = t_next - t
        r2 = _F(2 / 3)
        s2 = t + r2 * h
        c2 = sig_of(s2) * _F(2.0) * (np.expm1(r2 * h) / (r2 * h) - _F(1))  # r2 / r1 = 2
        u2 = x - float(sig_of(s2) * np.expm1(r2 * h)) * eps - float(c2) * (eps_r1 - eps)
        eps_r2 = eps_of(u2, s2)
        c = sig_of(t_next) / r2 * (np.expm1(h) / h - _F(1))
        return x - float(sig_of(t_next) * np.expm1(h)) * eps - float(c) * (eps_r2 - eps)

    def noise_at(k):
        if noises is not None:
            return noises[k]
        if generator is not None:
            return torch.randn(x.shape, generator=generator, device=x.device)
        return torch.zeros_like(x)

    x_prev = x
    s, h = _F(t_start), _F(h_init)
    e2 = e3 = _F(1)
    nfe = steps = accepted = 0
    while s < _F(t_end64 - 1e-5) and steps < max_iters:
        t_next = np.minimum(t_end, s + h)
        t_, su = t_next, 0.0
        if eta:
            # aim at the ancestral sigma_down; add sigma_up's noise on accept
            sig_s, sig_t = sig_of(s), sig_of(t_next)
            su = min(sig_t, eta * (sig_t**2 * (sig_s**2 - sig_t**2) / sig_s**2) ** 0.5)
            sd = (sig_t**2 - su**2) ** 0.5
            t_ = np.minimum(t_end, t_of(sd))
            su = float((sig_t**2 - sig_of(t_) ** 2) ** 0.5)
        eps = eps_of(x, s)
        if order == 2:
            x_low = solver_1(x, s, t_, eps)
            x_high, _ = solver_2(x, s, t_, eps)
        else:
            x_low, eps_r1 = solver_2(x, s, t_, eps, r1=1 / 3)
            x_high = solver_3(x, s, t_, eps, eps_r1)
        delta = torch.clamp(rtol * torch.maximum(x_low.abs(), x_prev.abs()), min=atol)
        # the loop's one host read: accept or reject
        error = (_F(torch.linalg.vector_norm((x_low - x_high) / delta).item())
                 * _F(x_low.numel() ** -0.5))
        inv_err = _F(1) / (error + _F(1e-8))
        if steps == 0:  # the first iteration seeds the history
            e2 = e3 = inv_err
        factor = inv_err**b1 * e2**b2 * e3**b3
        factor = _F(1) + np.arctan(factor - _F(1))  # the limiter
        if factor >= _F(accept_safety):
            x_prev = x_low
            x = x_high
            if su:
                x = x + noise_at(accepted) * (su * s_noise)
            s = t_next
            e2, e3 = inv_err, e2
            accepted += 1
        h = h * factor
        nfe += order
        steps += 1
    return x, {"nfe": nfe, "steps": steps, "accepted": accepted}
