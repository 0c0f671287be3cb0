"""The k-diffusion (Karras) sampler family as Python loops on the device.

Counterpart of ``complex_prompt_diffusion_tpu/samplers/kdiff.py``, whose
samplers are ``lax.scan`` bodies: Euler / Euler Ancestral, Heun, DPM2 /
DPM2 Ancestral, DPM++ 2M / DPM++ 2S Ancestral, LMS (integrated Lagrange
coefficients via scipy) and DPM Fast.

Contract: ``den(x, sigma, uc_scale) -> denoised x0-prediction``; the ODE
derivative is d = (x - denoised) / sigma. ``sigma`` and ``uc_scale`` reach
the denoiser as host scalars.

Sigma schedules are host-side numpy (descending, terminal 0 appended). The
per-step scalars (sigmas, churn gammas, ancestral steps, LMS coefficients)
stay on the host as float32, rounded where the JAX package's f32 arrays
round, so a loop body holds only model calls and tensor arithmetic and never
waits for the device.

RNG contract: per-step noise is either injected (``noises``, indexed
``noises[i]``) or drawn from a ``torch.Generator``; with neither it is zero.

``den_state`` (the DeepCache feature cache) switches the eight samplers
that take it to the JAX package's stateful protocol, ``den(x, sigma,
uc_scale, i, state) -> (denoised, state)`` (:class:`Stateful`): ``i`` is the
step index, which a multi-eval sampler's evaluations of one step share.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch

__all__ = [
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
]

_F = np.float32
_THIRD = _F(1 / 3)


def _to_d(x, sigma, denoised):
    """Karras ODE derivative."""
    return (x - denoised) / float(sigma)


def get_ancestral_step(sigma_from, sigma_to, eta: float = 1.0):
    """(sigma_down, sigma_up) for an ancestral step, with the eta/min
    clamp."""
    if not eta:
        return sigma_to, np.zeros_like(sigma_to)
    sigma_up = np.minimum(
        sigma_to,
        eta
        * (sigma_to**2 * (sigma_from**2 - sigma_to**2) / sigma_from**2) ** 0.5,
    )
    sigma_down = (sigma_to**2 - sigma_up**2) ** 0.5
    return sigma_down, sigma_up


def _churn_gammas(sigmas: np.ndarray, s_churn, s_tmin, s_tmax) -> np.ndarray:
    """Per-step churn gamma: min(churn / n, sqrt2 - 1) when
    tmin <= sigma <= tmax."""
    n = len(sigmas) - 1
    g = np.where(
        (sigmas[:-1] >= s_tmin) & (sigmas[:-1] <= s_tmax),
        min(s_churn / n, 2**0.5 - 1) if n > 0 else 0.0,
        0.0,
    )
    return g.astype(np.float64)


def _noise_source(generator: Optional[torch.Generator], noises, x: torch.Tensor):
    """noise_at(i, tag=0): injected array lookup, a generator draw, or
    zeros (``tag`` names the stream in the JAX package; a generator has one
    stream)."""
    if noises is not None:
        noises = torch.as_tensor(noises, dtype=torch.float32, device=x.device)
        return lambda i, tag=0: noises[i]
    if generator is not None:
        return lambda i, tag=0: torch.randn(x.shape, generator=generator, device=x.device)
    return lambda i, tag=0: torch.zeros_like(x)


def _f32(a) -> np.ndarray:
    return np.asarray(a, np.float64).astype(_F)


def _uc(uc_scales, n: int) -> np.ndarray:
    return np.broadcast_to(np.asarray(uc_scales, np.float64), (n,)).astype(_F)


class Stateful:
    """A model behind one call form, ``(*args, i) -> out``, for DDIM, PLMS
    and the k-samplers alike: with a state (``state`` given) the stateful
    protocol ``model(*args, i, state) -> (out, state)``, its state kept here
    between evaluations; without, ``model(*args)``."""

    def __init__(self, model: Callable, state):
        self.model, self.state, self.on = model, state, state is not None

    def __call__(self, *args):
        *args, i = args
        if not self.on:
            return self.model(*args)
        out, self.state = self.model(*args, i, self.state)
        return out


def _churn(x, noise_at, i: int, sig_i, gamma, s_noise: float):
    """(x with this step's churn noise, sigma_hat)."""
    sigma_hat = sig_i * (gamma + _F(1))
    if gamma > 0:
        amp = _F(s_noise) * np.sqrt(np.maximum(sigma_hat**2 - sig_i**2, _F(0)))
        x = x + noise_at(i, 1) * float(amp)
    return x, sigma_hat


def sample_euler(
    den: Callable, x: torch.Tensor, sigmas: np.ndarray, uc_scales,
    *, generator=None, noises=None,
    s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = math.inf,
    s_noise: float = 1.0, den_state=None,
):
    """Karras Algorithm 2, Euler steps + churn."""
    den = Stateful(den, den_state)
    n = len(sigmas) - 1
    sig = _f32(sigmas)
    gammas = _f32(_churn_gammas(sigmas, s_churn, s_tmin, s_tmax))
    ucs = _uc(uc_scales, n)
    noise_at = _noise_source(generator, noises, x)
    traj = []
    for i in range(n):
        x, sigma_hat = _churn(x, noise_at, i, sig[i], gammas[i], s_noise)
        denoised = den(x, sigma_hat, float(ucs[i]), i)
        d = _to_d(x, sigma_hat, denoised)
        x = x + d * float(sig[i + 1] - sigma_hat)
        traj.append(denoised)
    return x, torch.stack(traj)


def sample_euler_ancestral(
    den: Callable, x: torch.Tensor, sigmas: np.ndarray, uc_scales,
    *, generator=None, noises=None, eta: float = 1.0, temperature: float = 1.0,
    den_state=None,
):
    """Euler ancestral."""
    den = Stateful(den, den_state)
    n = len(sigmas) - 1
    sig = _f32(sigmas)
    down, up = (_f32(a) for a in get_ancestral_step(sigmas[:-1], sigmas[1:], eta))
    ucs = _uc(uc_scales, n)
    noise_at = _noise_source(generator, noises, x)
    traj = []
    for i in range(n):
        denoised = den(x, sig[i], float(ucs[i]), i)
        d = _to_d(x, sig[i], denoised)
        x = x + d * float(down[i] - sig[i])
        x = x + noise_at(i) * float(up[i]) * temperature
        traj.append(denoised)
    return x, torch.stack(traj)


def sample_heun(
    den: Callable, x: torch.Tensor, sigmas: np.ndarray, uc_scales,
    *, generator=None, noises=None,
    s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = math.inf,
    s_noise: float = 1.0, den_state=None,
):
    """Heun 2nd-order; falls back to Euler on the last step."""
    den = Stateful(den, den_state)
    n = len(sigmas) - 1
    sig = _f32(sigmas)
    gammas = _f32(_churn_gammas(sigmas, s_churn, s_tmin, s_tmax))
    ucs = _uc(uc_scales, n)
    noise_at = _noise_source(generator, noises, x)
    traj = []
    for i in range(n):
        x, sigma_hat = _churn(x, noise_at, i, sig[i], gammas[i], s_noise)
        uc = float(ucs[i])
        denoised = den(x, sigma_hat, uc, i)
        d = _to_d(x, sigma_hat, denoised)
        dt = float(sig[i + 1] - sigma_hat)
        if sig[i + 1] == 0:
            x = x + d * dt
        else:
            x_2 = x + d * dt
            denoised_2 = den(x_2, sig[i + 1], uc, i)
            d_2 = _to_d(x_2, sig[i + 1], denoised_2)
            x = x + (d + d_2) / 2 * dt
        traj.append(denoised)
    return x, torch.stack(traj)


def _rho3_mid(a, b):
    """Midpoint of two sigmas in sigma^(1/3) space (f32)."""
    m = (a**_THIRD + b**_THIRD) / _F(2)
    return m * m * m


def sample_dpm2(
    den: Callable, x: torch.Tensor, sigmas: np.ndarray, uc_scales,
    *, generator=None, noises=None,
    s_churn: float = 0.0, s_tmin: float = 0.0, s_tmax: float = math.inf,
    s_noise: float = 1.0, den_state=None,
):
    """DPM-Solver-2 midpoint with rho=3 midpoint selection.

    Like the reference, the midpoint formula is used on every step; the
    terminal sigma=0 makes the last midpoint sigma_mid = (sigma_hat^(1/3)/2)^3.
    """
    den = Stateful(den, den_state)
    n = len(sigmas) - 1
    sig = _f32(sigmas)
    gammas = _f32(_churn_gammas(sigmas, s_churn, s_tmin, s_tmax))
    ucs = _uc(uc_scales, n)
    noise_at = _noise_source(generator, noises, x)
    traj = []
    for i in range(n):
        x, sigma_hat = _churn(x, noise_at, i, sig[i], gammas[i], s_noise)
        uc = float(ucs[i])
        denoised = den(x, sigma_hat, uc, i)
        d = _to_d(x, sigma_hat, denoised)
        sigma_mid = _rho3_mid(sigma_hat, sig[i + 1])
        x_2 = x + d * float(sigma_mid - sigma_hat)
        denoised_2 = den(x_2, sigma_mid, uc, i)
        d_2 = _to_d(x_2, sigma_mid, denoised_2)
        x = x + d_2 * float(sig[i + 1] - sigma_hat)
        traj.append(denoised)
    return x, torch.stack(traj)


def sample_dpm2_ancestral(
    den: Callable, x: torch.Tensor, sigmas: np.ndarray, uc_scales,
    *, generator=None, noises=None, eta: float = 1.0, den_state=None,
):
    """DPM2 ancestral."""
    den = Stateful(den, den_state)
    n = len(sigmas) - 1
    sig = _f32(sigmas)
    down, up = (_f32(a) for a in get_ancestral_step(sigmas[:-1], sigmas[1:], eta))
    ucs = _uc(uc_scales, n)
    noise_at = _noise_source(generator, noises, x)
    traj = []
    for i in range(n):
        uc = float(ucs[i])
        denoised = den(x, sig[i], uc, i)
        d = _to_d(x, sig[i], denoised)
        sigma_mid = _rho3_mid(sig[i], down[i])
        x_2 = x + d * float(sigma_mid - sig[i])
        denoised_2 = den(x_2, sigma_mid, uc, i)
        d_2 = _to_d(x_2, sigma_mid, denoised_2)
        x = x + d_2 * float(down[i] - sig[i])
        x = x + noise_at(i) * float(up[i])
        traj.append(denoised)
    return x, torch.stack(traj)


def sample_dpmpp_2m(
    den: Callable, x: torch.Tensor, sigmas: np.ndarray, uc_scales,
    *, generator=None, noises=None, den_state=None,
):
    """DPM-Solver++(2M) multistep in t = -log(sigma) space."""
    den = Stateful(den, den_state)
    n = len(sigmas) - 1
    sig = _f32(sigmas)
    ucs = _uc(uc_scales, n)
    old_denoised = None
    traj = []
    with np.errstate(divide="ignore", invalid="ignore"):  # -log(0) on the last step
        for i in range(n):
            denoised = den(x, sig[i], float(ucs[i]), i)
            t, t_next = -np.log(sig[i]), -np.log(sig[i + 1])
            h = t_next - t
            ratio = float(np.exp(-t_next) / np.exp(-t))
            if i == 0 or sig[i + 1] == 0:
                denoised_d = denoised
            else:
                h_last = t - (-np.log(sig[i - 1]))
                r = h_last / h
                c = _F(1) / (_F(2) * r)
                denoised_d = float(_F(1) + c) * denoised - float(c) * old_denoised
            x = ratio * x - float(np.expm1(-h)) * denoised_d
            old_denoised = denoised
            traj.append(denoised)
    return x, torch.stack(traj)


def sample_dpmpp_2s_ancestral(
    den: Callable, x: torch.Tensor, sigmas: np.ndarray, uc_scales,
    *, generator=None, noises=None, eta: float = 1.0, temperature: float = 1.0,
    den_state=None,
):
    """DPM-Solver++(2S) ancestral."""
    den = Stateful(den, den_state)
    n = len(sigmas) - 1
    sig = _f32(sigmas)
    down, up = (_f32(a) for a in get_ancestral_step(sigmas[:-1], sigmas[1:], eta))
    ucs = _uc(uc_scales, n)
    noise_at = _noise_source(generator, noises, x)
    traj = []
    for i in range(n):
        uc = float(ucs[i])
        denoised = den(x, sig[i], uc, i)
        if down[i] == 0:
            d = _to_d(x, sig[i], denoised)
            x = x + d * float(down[i] - sig[i])
        else:
            t, t_next = -np.log(sig[i]), -np.log(np.maximum(down[i], _F(1e-10)))
            r = _F(0.5)
            h = t_next - t
            s_mid = t + r * h
            x_2 = float(np.exp(-s_mid) / np.exp(-t)) * x - float(np.expm1(-h * r)) * denoised
            denoised_2 = den(x_2, np.exp(-s_mid), uc, i)
            x = float(np.exp(-t_next) / np.exp(-t)) * x - float(np.expm1(-h)) * denoised_2
        x = x + noise_at(i) * float(up[i]) * temperature
        traj.append(denoised)
    return x, torch.stack(traj)


def lms_coefficients(sigmas: np.ndarray, order: int = 4) -> np.ndarray:
    """Integrated Lagrange coefficients [n, order], computed host-side with
    scipy quadrature; column j weights the j-th newest derivative."""
    from scipy import integrate

    n = len(sigmas) - 1
    out = np.zeros((n, order))

    def coeff(cur_order, i, j):
        def fn(tau):
            prod = 1.0
            for k in range(cur_order):
                if j == k:
                    continue
                prod *= (tau - sigmas[i - k]) / (sigmas[i - j] - sigmas[i - k])
            return prod

        return integrate.quad(fn, sigmas[i], sigmas[i + 1], epsrel=1e-4)[0]

    for i in range(n):
        cur_order = min(i + 1, order)
        for j in range(cur_order):
            out[i, j] = coeff(cur_order, i, j)
    return out


def sample_lms(
    den: Callable, x: torch.Tensor, sigmas: np.ndarray, uc_scales,
    *, generator=None, noises=None, order: int = 4, den_state=None,
):
    """Linear multistep: a buffer of the ``order`` newest derivatives,
    integrated coefficients."""
    den = Stateful(den, den_state)
    n = len(sigmas) - 1
    sig = _f32(sigmas)
    coeffs = _f32(lms_coefficients(np.asarray(sigmas, np.float64), order))
    ucs = _uc(uc_scales, n)
    ds = []  # ds[0] = newest derivative
    traj = []
    for i in range(n):
        denoised = den(x, sig[i], float(ucs[i]), i)
        ds = [_to_d(x, sig[i], denoised)] + ds[: order - 1]
        # the coefficient row is zero beyond the current order
        for c, d in zip(coeffs[i], ds):
            x = x + float(c) * d
        traj.append(denoised)
    return x, torch.stack(traj)


def sample_dpm_fast(
    den: Callable, x: torch.Tensor, sigmas: np.ndarray, uc_scales,
    *, generator=None, noises=None, eta: float = 0.0, s_noise: float = 1.0,
):
    """DPM Fast: NFE-budgeted order-1/2/3 solver steps on a uniform grid in
    t = -log(sigma) (m ~ steps/3 iterations, 3 model evals each). Returns
    (x, None): it keeps no trajectory."""
    sigmas = np.asarray(sigmas, np.float64)
    t_start = -math.log(sigmas[0])
    t_end = -math.log(sigmas[-2])
    nfe = len(sigmas) - 1
    m = nfe // 3 + 1
    ts = np.linspace(t_start, t_end, m + 1)
    if nfe % 3 == 0:
        orders = [3] * (m - 2) + [2, 1]
    else:
        orders = [3] * (m - 1) + [nfe % 3]

    # the order-grouped walk has fewer outer steps than NFE; resample the
    # per-step scale schedule onto the group grid
    uc_arr = np.broadcast_to(np.asarray(uc_scales, np.float64), (nfe,))
    grid = np.linspace(0, nfe - 1, len(orders))
    ucs = _uc(np.interp(grid, np.arange(nfe), uc_arr), len(orders))
    noise_at = _noise_source(generator, noises, x)
    sig_of = lambda t: math.exp(-t)  # noqa: E731

    def eps_of(x, t, uc):
        sigma = _F(sig_of(t))
        return _to_d(x, sigma, den(x, sigma, float(uc)))

    for i, order in enumerate(orders):
        t, t_next = ts[i], ts[i + 1]
        if eta:
            gamma = eta * math.sqrt(2 * (t_next - t))
            t_up = max(t_start, t - math.log1p(gamma))
            if t_up < t:
                x = x + noise_at(i) * s_noise * math.sqrt(
                    sig_of(t_up) ** 2 - sig_of(t) ** 2
                )
            t = t_up
        h = t_next - t
        eps = eps_of(x, t, ucs[i])
        if order == 1:
            x = x - sig_of(t_next) * math.expm1(h) * eps
        elif order == 2:
            r1 = 1 / 2
            s1 = t + r1 * h
            u1 = x - sig_of(s1) * math.expm1(r1 * h) * eps
            eps_r1 = eps_of(u1, s1, ucs[i])
            x = (
                x
                - sig_of(t_next) * math.expm1(h) * eps
                - sig_of(t_next) / (2 * r1) * math.expm1(h) * (eps_r1 - eps)
            )
        else:
            r1, r2 = 1 / 3, 2 / 3
            s1, s2 = t + r1 * h, t + r2 * h
            u1 = x - sig_of(s1) * math.expm1(r1 * h) * eps
            eps_r1 = eps_of(u1, s1, ucs[i])
            u2 = (
                x
                - sig_of(s2) * math.expm1(r2 * h) * eps
                - sig_of(s2)
                * (r2 / r1)
                * (math.expm1(r2 * h) / (r2 * h) - 1)
                * (eps_r1 - eps)
            )
            eps_r2 = eps_of(u2, s2, ucs[i])
            x = (
                x
                - sig_of(t_next) * math.expm1(h) * eps
                - sig_of(t_next) / r2 * (math.expm1(h) / h - 1) * (eps_r2 - eps)
            )
    return x, None
