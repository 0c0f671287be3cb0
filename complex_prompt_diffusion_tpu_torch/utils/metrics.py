"""Embedding distances and image quality metrics, in numpy.

Counterpart of ``complex_prompt_diffusion_tpu/utils/metrics.py``:
``spherical_dist``, ``euclidean_dist`` (the reference's formula sqrt(x^2 -
y^2), NaN where |y| > |x|, kept as it is), ``true_euclidean``, ``cosine_sim``,
and ``psnr`` / ``ssim`` for the approximate modes' error against the exact
render.
"""

from __future__ import annotations

import numpy as np

__all__ = ["spherical_dist", "euclidean_dist", "true_euclidean", "cosine_sim", "psnr", "ssim"]


def _normalize(x):
    x = np.asarray(x, np.float64)
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def spherical_dist(x, y, reduce: bool = False):
    x, y = _normalize(x), _normalize(y)
    d = 2.0 * np.arcsin(np.linalg.norm(x - y, axis=-1) / 2.0) ** 2
    return d.mean() if reduce else d


def euclidean_dist(x, y, reduce: bool = False):
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    d = np.sqrt(x**2 - y**2)
    return d.mean() if reduce else d


def true_euclidean(x, y, reduce: bool = False):
    d = np.linalg.norm(np.asarray(x, np.float64) - np.asarray(y, np.float64), axis=-1)
    return d.mean() if reduce else d


def cosine_sim(x, y, axis: int = -1):
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    num = np.sum(x * y, axis=axis)
    den = np.linalg.norm(x, axis=axis) * np.linalg.norm(y, axis=axis)
    return num / np.maximum(den, 1e-12)


def psnr(a, b, data_range: float = 255.0) -> float:
    """Peak signal-to-noise ratio in dB between two images or batches."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def ssim(a, b, data_range: float = 255.0, win: int = 7) -> float:
    """Mean structural similarity over a uniform ``win`` x ``win`` window
    (K1 = 0.01, K2 = 0.03), averaged over channels and batch; local
    moments by box filters from cumulative sums. [..., H, W, C] or
    [H, W, C]."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.ndim == 3:
        a, b = a[None], b[None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    def box(x):
        # mean filter over the spatial axes (1, 2), clipped at the borders
        for ax in (1, 2):
            c = np.cumsum(x, axis=ax)
            lo = np.concatenate([np.zeros_like(np.take(c, [0], axis=ax)), c], axis=ax)
            n = x.shape[ax]
            hi_idx = np.minimum(np.arange(n) + win // 2 + 1, n)
            lo_idx = np.maximum(np.arange(n) - win // 2, 0)
            x = (np.take(lo, hi_idx, axis=ax) - np.take(lo, lo_idx, axis=ax)) / (
                hi_idx - lo_idx
            ).reshape((1,) * ax + (n,) + (1,) * (x.ndim - ax - 1))
        return x

    mu_a, mu_b = box(a), box(b)
    var_a = box(a * a) - mu_a**2
    var_b = box(b * b) - mu_b**2
    cov = box(a * b) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (var_a + var_b + c2)
    )
    return float(s.mean())
