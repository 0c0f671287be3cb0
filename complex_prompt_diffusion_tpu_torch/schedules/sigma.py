"""Continuous (k-diffusion style) sigma schedules and sigma<->t conversion.

A copy of ``complex_prompt_diffusion_tpu/schedules/sigma.py`` (host-side
float64 numpy, the Karras et al. 2022, arXiv:2206.00364, formulas); a test
holds every function equal to the original.

A "model sigma table" here is the per-trained-timestep table
``sigma_i = sqrt((1 - alphas_cumprod_i) / alphas_cumprod_i)`` (the CompVis /
k-diffusion convention); ``sigma_to_t`` / ``t_to_sigma`` interpolate
continuously against it.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
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


def append_zero(x: np.ndarray) -> np.ndarray:
    """Append the terminal sigma=0."""
    return np.concatenate([x, np.zeros((1,), dtype=x.dtype)])


def karras_sigmas(
    n: int, sigma_min: float = 0.1, sigma_max: float = 10.0, rho: float = 7.0
) -> np.ndarray:
    """Karras et al. (2022) eq. 5 noise schedule."""
    ramp = np.linspace(0, 1, n, dtype=np.float64)
    min_inv_rho = sigma_min ** (1 / rho)
    max_inv_rho = sigma_max ** (1 / rho)
    return (max_inv_rho + ramp * (min_inv_rho - max_inv_rho)) ** rho


def exponential_sigmas(
    n: int, sigma_min: float = 0.1, sigma_max: float = 10.0
) -> np.ndarray:
    """Log-linear schedule."""
    return np.exp(
        np.linspace(math.log(sigma_max), math.log(sigma_min), n, dtype=np.float64)
    )


def quadratic_sigmas(
    n: int, sigma_min: float = 0.1, sigma_max: float = 10.0
) -> np.ndarray:
    """Quadratic schedule."""
    return (
        np.linspace(math.sqrt(sigma_max), math.sqrt(sigma_min), n, dtype=np.float64)
        ** 2
    )


def sigmoid_sigmas(
    n: int, sigma_min: float = 0.1, sigma_max: float = 10.0
) -> np.ndarray:
    """Sigmoid schedule, with the reference scheduler's (peculiar)
    ``* (sigma_max - sigma_min) * sigma_min`` scaling.
    """
    x = np.linspace(-6.0, 6.0, n, dtype=np.float64)
    return 1.0 / (1.0 + np.exp(-x)) * (sigma_max - sigma_min) * sigma_min


def vp_sigmas(
    n: int, beta_d: float = 19.9, beta_min: float = 0.1, eps_s: float = 1e-3
) -> np.ndarray:
    """Continuous VP schedule (Karras table 1)."""
    t = np.linspace(1, eps_s, n, dtype=np.float64)
    return np.sqrt(np.exp(beta_d * t**2 / 2 + beta_min * t) - 1)


def linear_sigmas(n: int | None, model_sigmas: np.ndarray) -> np.ndarray:
    """Even spacing in trained-timestep space, mapped through the model sigma
    table. ``n=None`` returns the full reversed table.

    Does NOT append the terminal zero; callers use :func:`make_sigma_schedule`.
    """
    model_sigmas = np.asarray(model_sigmas, dtype=np.float64)
    if n is None:
        return model_sigmas[::-1].copy()
    t_max = len(model_sigmas) - 1
    t = np.linspace(t_max, 0, n, dtype=np.float64)
    return t_to_sigma(t, model_sigmas)


def make_sigma_schedule(
    algorithm: str,
    n: int,
    model_sigmas: np.ndarray | None = None,
    **kwargs,
) -> np.ndarray:
    """Build a descending sigma schedule with terminal 0 appended.

    ``algorithm``: 'linear'/'default', 'karras', 'exp'/'exponential',
    'quad'/'quadratic', 'vp'/'variance_preserving', 'sig'/'sigmoid'.
    """
    if algorithm in ("linear", "default"):
        if model_sigmas is None:
            raise ValueError("'linear' sigma schedule requires model_sigmas")
        sigmas = linear_sigmas(n, model_sigmas)
    elif algorithm == "karras":
        sigmas = karras_sigmas(n, **kwargs)
    elif algorithm in ("exp", "exponential"):
        sigmas = exponential_sigmas(n, **kwargs)
    elif algorithm in ("quad", "quadratic"):
        sigmas = quadratic_sigmas(n, **kwargs)
    elif algorithm in ("vp", "variance_preserving"):
        sigmas = vp_sigmas(n, **kwargs)
    elif algorithm in ("sig", "sigmoid"):
        sigmas = sigmoid_sigmas(n, **kwargs)
    else:
        raise NotImplementedError(f"unknown sigma schedule: {algorithm!r}")
    return append_zero(np.asarray(sigmas, dtype=np.float64))


def sigma_to_t(
    sigma: np.ndarray, model_sigmas: np.ndarray, quantize: bool = False
) -> np.ndarray:
    """Map sigma(s) to a (fractional) trained-timestep index.

    Continuous interpolation between the two nearest entries of the model
    sigma table (k-diffusion convention).
    """
    sigma = np.atleast_1d(np.asarray(sigma, dtype=np.float64))
    table = np.asarray(model_sigmas, dtype=np.float64)
    dists = np.abs(sigma[None, :] - table[:, None])  # [T, N]
    if quantize:
        return np.argmin(dists, axis=0)
    # two smallest distances, sorted by index
    idx2 = np.argpartition(dists, 1, axis=0)[:2]  # [2, N]
    low_idx = np.minimum(idx2[0], idx2[1])
    high_idx = np.maximum(idx2[0], idx2[1])
    low, high = table[low_idx], table[high_idx]
    w = np.where(low == high, 0.0, (low - sigma) / np.where(low == high, 1.0, low - high))
    w = np.clip(w, 0.0, 1.0)
    return (1 - w) * low_idx + w * high_idx


def t_to_sigma(t: np.ndarray, model_sigmas: np.ndarray) -> np.ndarray:
    """Map (fractional) trained-timestep index to sigma by linear
    interpolation."""
    t = np.asarray(t, dtype=np.float64)
    table = np.asarray(model_sigmas, dtype=np.float64)
    low_idx = np.floor(t).astype(np.int64)
    high_idx = np.ceil(t).astype(np.int64)
    w = t - np.floor(t)
    return (1 - w) * table[low_idx] + w * table[high_idx]


def karras_scalings(sigma):
    """(c_out, c_in) scalings for an eps-parameterized denoiser wrapped in the
    k-diffusion convention: c_out = -sigma, c_in = 1/sqrt(sigma^2 + 1).
    Works on numpy arrays and torch tensors.
    """
    c_out = -sigma
    c_in = 1.0 / (sigma**2 + 1.0) ** 0.5
    return c_out, c_in
