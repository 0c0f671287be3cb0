"""Log-likelihood estimation via the probability-flow ODE (the "Log"
sampler).

Counterpart of ``complex_prompt_diffusion_tpu/samplers/loglik.py``:
integrate the Karras ODE dx/dsigma = (x - D(x, sigma)) / sigma from
sigma_min to sigma_max while accumulating Hutchinson's estimate of the
divergence, then add the Gaussian prior's log-density at sigma_max. Each
evaluation takes one vector-Jacobian product through the denoiser,
``torch.autograd.grad((d * v).sum(), x)`` (the reference's own form), so
through the UNet's kernels and their backward rules on the card. Two
integrators:

  * :func:`log_likelihood_adaptive`: adaptive Dormand-Prince 5(4)
    ("dopri5") with atol/rtol step control. Where the JAX package runs one
    ``lax.while_loop``, this is a host loop that reads ONE scalar an
    iteration, the error norm, which decides accept or reject and the next
    step; the step state (sigma, h) is host float32, rounded as the JAX
    package's f32 scalars round. The default of :func:`sample_log_likelihood`.
  * :func:`log_likelihood`: fixed-grid RK4 on log-spaced sigmas, four
    evaluations a step.

The Rademacher probe v (+-1, f32) comes from a ``torch.Generator`` or is
passed in (``probe=``: the tests pass JAX's ``jax.random.rademacher`` draw).
The denoiser is ``den(x, sigma, uc_scale) -> denoised`` with ``sigma`` a host
scalar, as the sigma-family samplers call it. Inputs are copied out of
inference mode, and the estimates come back detached.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = ["log_likelihood", "log_likelihood_adaptive", "sample_log_likelihood",
           "rademacher"]

_F = np.float32

# Dormand-Prince 5(4) tableau (the 'dopri5' method)
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)


def rademacher(shape, generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """A Rademacher draw (+-1 with probability 1/2 each), f32."""
    bits = torch.randint(0, 2, tuple(shape), generator=generator, device=device)
    return (2 * bits - 1).to(torch.float32)


def _probe(x, generator, probe):
    if probe is not None:
        return torch.as_tensor(probe, dtype=torch.float32, device=x.device).detach().clone()
    if generator is None:
        generator = torch.Generator(device=x.device).manual_seed(0)
    return rademacher(x.shape, generator, x.device)


def _ode_fn(den_fn: Callable, v: torch.Tensor, uc: float):
    """f(x, sigma) -> (dx/dsigma, Hutchinson's divergence [B]), both
    detached: one VJP through the denoiser an evaluation."""
    b = v.shape[0]

    def f(x, sigma):
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            d = (xx - den_fn(xx, sigma, uc)) / float(sigma)
            (vt_j,) = torch.autograd.grad((d * v).sum(), xx)
        return d.detach(), (v * vt_j).reshape(b, -1).sum(dim=1)

    return f


def _prior(latent: torch.Tensor, sigma_max: float) -> torch.Tensor:
    """log N(latent; 0, sigma_max^2 I) per sample."""
    b = latent.shape[0]
    return (-0.5 * (latent / sigma_max) ** 2 - math.log(sigma_max)
            - 0.5 * math.log(2 * math.pi)).reshape(b, -1).sum(dim=1)


def log_likelihood(
    den_fn: Callable,
    x: torch.Tensor,
    sigma_min: float,
    sigma_max: float,
    *,
    generator: Optional[torch.Generator] = None,
    probe: Optional[torch.Tensor] = None,
    steps: int = 100,
    uc_scale: float = 1.0,
) -> torch.Tensor:
    """Estimate log p(x) in nats per sample [B]: RK4 on ``steps``
    log-spaced sigmas from max(sigma_min, 1e-3) to sigma_max (4 * steps
    VJPs)."""
    with torch.inference_mode(False):
        x = x.detach().clone().float()
        v = _probe(x, generator, probe)
        f = _ode_fn(den_fn, v, float(uc_scale))
        sigmas = np.exp(np.linspace(math.log(max(sigma_min, 1e-3)), math.log(sigma_max),
                                    steps + 1)).astype(_F)
        ll = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for i in range(steps):
            s0, s1 = sigmas[i], sigmas[i + 1]
            h = s1 - s0
            mid = s0 + _F(0.5) * h
            half, sixth = float(_F(0.5) * h), float(h / _F(6.0))
            d1, g1 = f(x, s0)
            d2, g2 = f(x + half * d1, mid)
            d3, g3 = f(x + half * d2, mid)
            d4, g4 = f(x + float(h) * d3, s1)
            x = x + sixth * (d1 + 2 * d2 + 2 * d3 + d4)
            ll = ll + sixth * (g1 + 2 * g2 + 2 * g3 + g4)
        return _prior(x, sigma_max) + ll


def log_likelihood_adaptive(
    den_fn: Callable,
    x: torch.Tensor,
    sigma_min: float,
    sigma_max: float,
    *,
    generator: Optional[torch.Generator] = None,
    probe: Optional[torch.Tensor] = None,
    atol: float = 1e-4,
    rtol: float = 1e-4,
    uc_scale: float = 1.0,
    max_steps: int = 512,
):
    """Adaptive dopri5 log-likelihood: the augmented (x, delta_ll) system
    from max(sigma_min, 1e-3) to sigma_max, seven VJPs an iteration; a step
    is rejected when the scaled RMS error over the augmented state exceeds
    1, and h *= clip(0.9 * err^(-1/5), 0.2, 10) either way. One step size
    for the whole batch. Returns (log-likelihoods [B], iterations run: the
    accepted and rejected steps, at most ``max_steps``)."""
    with torch.inference_mode(False):
        x = x.detach().clone().float()
        v = _probe(x, generator, probe)
        f = _ode_fn(den_fn, v, float(uc_scale))
        s_min, s_max = float(max(sigma_min, 1e-3)), float(sigma_max)
        n = float(x.numel() + x.shape[0])
        ll = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        sigma, h = _F(s_min), _F((s_max - s_min) / 100.0)
        end = _F(s_max - 1e-9)
        nsteps = 0
        while sigma < end and nsteps < max_steps:
            h_eff = min(h, _F(s_max) - sigma)
            kx, kl = [], []
            for i in range(7):
                xi, li = x, ll
                for j, a in enumerate(_DP_A[i]):
                    if a != 0.0:
                        ha = float(h_eff * _F(a))
                        xi = xi + ha * kx[j]
                        li = li + ha * kl[j]
                dx, dl = f(xi, sigma + _F(_DP_C[i]) * h_eff)
                kx.append(dx)
                kl.append(dl)
            x5, ll5 = x, ll
            ex, el = torch.zeros_like(x), torch.zeros_like(ll)
            for i in range(7):
                if _DP_B5[i] != 0.0:
                    hb = float(h_eff * _F(_DP_B5[i]))
                    x5 = x5 + hb * kx[i]
                    ll5 = ll5 + hb * kl[i]
                db = _DP_B5[i] - _DP_B4[i]
                if db != 0.0:
                    hd = float(h_eff * _F(db))
                    ex = ex + hd * kx[i]
                    el = el + hd * kl[i]
            # scaled RMS error over the augmented state (torchdiffeq's norm)
            tol_x = atol + rtol * torch.maximum(x.abs(), x5.abs())
            tol_l = atol + rtol * torch.maximum(ll.abs(), ll5.abs())
            se = ((ex / tol_x) ** 2).sum() + ((el / tol_l) ** 2).sum()
            err = _F(torch.sqrt(se / n).item())  # the loop's one host read
            if err <= 1.0:
                x, ll, sigma = x5, ll5, _F(sigma + h_eff)
            factor = np.clip(_F(0.9) * np.power(max(err, _F(1e-10)), _F(-0.2)), _F(0.2),
                             _F(10.0))
            h = max(_F(h_eff * factor), _F(1e-6))
            nsteps += 1
        return _prior(x, s_max) + ll, nsteps


def sample_log_likelihood(den, x, sigmas, uc_scales=1.0, *,
                          generator: Optional[torch.Generator] = None, noises=None,
                          steps: Optional[int] = None, atol: float = 1e-4, rtol: float = 1e-4):
    """Sigma-family adapter, the registry's "Log" entry: integrates over the
    given sigma schedule's range (its positive sigmas) at the first
    guidance scale and returns (log-likelihoods [B], None). ``steps=None``
    (the default) runs the adaptive dopri5 with atol/rtol; an explicit
    ``steps`` the fixed-grid RK4 with that step budget. ``noises``, when
    given, is the Hutchinson probe (the injected draw, as the other
    samplers take theirs); else it is drawn from ``generator`` (default:
    seed 0)."""
    sig = np.asarray(sigmas, np.float64)
    sig = sig[sig > 0]
    uc = float(np.asarray(uc_scales).ravel()[0])
    if steps is None:
        ll, _ = log_likelihood_adaptive(den, x, float(sig.min()), float(sig.max()),
                                        generator=generator, probe=noises, atol=atol,
                                        rtol=rtol, uc_scale=uc)
    else:
        ll = log_likelihood(den, x, float(sig.min()), float(sig.max()), generator=generator,
                            probe=noises, steps=steps, uc_scale=uc)
    return ll, None
