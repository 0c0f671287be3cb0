"""Sample/score thresholding ("ScoreCorrector") family as pure functions.

Counterpart of ``complex_prompt_diffusion_tpu/guidance/threshold.py``. Each
is a pure ``fn(x, threshold) -> x`` on [N, H, W, C] that stays on the
tensor's device: the percentile/quantile variants use ``torch.quantile``
(linear interpolation, as ``jnp.quantile``), and no thresholder reads a
value back to the host, so a sampling loop that calls one does not wait
for the device.

``torch.quantile`` takes f32 or f64 only, so the quantile variants raise on
a bf16 tensor rather than cast it; the pipeline feeds them f32, as the JAX
package does: ``threshold_e`` and ``dynamic_clip`` see the CFG sum, which
the f32 guidance scales and masks promote from the bf16 UNet output, and
``clip_sample`` sees ``pred_x0``, which the f32 step tables make f32.

As in the JAX package: f32 in and out, and ``norm_thresholding`` is the RMS
clamp of CompVis's ``norm_thresholding``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

__all__ = ["THRESHOLDERS", "get_thresholder", "dynamic_clip"]


def _per_sample_abs_quantile(x, q01):
    """quantile of |x| over all non-batch dims -> [N, 1, 1, 1]."""
    n = x.shape[0]
    flat = torch.abs(x.reshape(n, -1))
    s = torch.quantile(flat, q01, dim=1)
    return s.reshape((n,) + (1,) * (x.ndim - 1))


def _norm01(x):
    x_max, x_min = torch.max(x), torch.min(x)
    y = (x - x_min) / (x_max - x_min)
    return 2.0 * y - 1.0, x_max, x_min


def _denorm01(y, x_max, x_min):
    y = (y + 1.0) / 2.0
    return (x_max - x_min) * y + x_min


def none_thresholding(x, threshold=None):
    return x


def static_thresholding(x, threshold=1.0):
    """clamp to [-threshold, threshold]."""
    return torch.clamp(x, -threshold, threshold)


def dynamic_thresholding(x, threshold=99.66):
    """Imagen-style: clamp at the global max of per-sample |x| percentiles,
    floored at 1.0 (percentile given in [0, 100])."""
    s = _per_sample_abs_quantile(x, threshold / 100.0)
    s = torch.clamp_min(torch.max(s), 1.0)
    return torch.clamp(x, -s, s)


def dynanormic_thresholding(x, threshold=99.66):
    """Per-sample quantile clamp + renormalize by s."""
    q = threshold / 100.0 if 1.0 < threshold <= 100.0 else threshold
    s = torch.clamp_min(_per_sample_abs_quantile(x, q), 1.0)
    return torch.clamp(x, -s, s) / s


def scaled_dynamic_perc_thresholding(x, threshold=99.66):
    """dynamic_thresholding applied in [-1, 1]-normalized space."""
    y, x_max, x_min = _norm01(x)
    s = torch.clamp_min(torch.max(_per_sample_abs_quantile(y, threshold / 100.0)), 1.0)
    y = torch.clamp(y, -s, s)
    return _denorm01(y, x_max, x_min)


def renorm_thresholding(x, threshold=99.66):
    """Per-sample quantile clamp in normalized space."""
    y, x_max, x_min = _norm01(x)
    q = threshold / 100.0 if 1.0 < threshold <= 100.0 else threshold
    s = torch.clamp_min(_per_sample_abs_quantile(y, q), 1.0)
    y = torch.clamp(y, -s, s)
    return _denorm01(y, x_max, x_min)


def norm_thresholding(x, threshold=0.9966):
    """RMS clamp: s = max(RMS(x), threshold); x * threshold / s."""
    n = x.shape[0]
    s = torch.sqrt(torch.mean(x.reshape(n, -1) ** 2, dim=1))
    s = torch.clamp_min(s, threshold).reshape((n,) + (1,) * (x.ndim - 1))
    return x * (threshold / s)


def scaled_norm_thresholding(x, threshold=99.66):
    """norm_thresholding in normalized space, threshold scaled by the
    normalized max."""
    y, x_max, x_min = _norm01(x)
    th = threshold / 100.0 * torch.max(y)
    n = y.shape[0]
    s = torch.sqrt(torch.mean(y.reshape(n, -1) ** 2, dim=1))
    s = torch.maximum(s, th).reshape((n,) + (1,) * (y.ndim - 1))
    y = y * (th / s)
    return _denorm01(y, x_max, x_min)


def spatial_norm_thresholding(x, threshold=99.66):
    """Per-pixel channel-RMS clamp. NHWC: the channel axis is -1."""
    s = torch.sqrt(torch.mean(x**2, dim=-1, keepdim=True))
    s = torch.clamp_min(s, threshold)
    return x * (threshold / s)


def scaled_spatial_norm_thresholding(x, threshold=99.66):
    """spatial_norm_thresholding in normalized space."""
    y, x_max, x_min = _norm01(x)
    th = threshold / 100.0 * torch.max(y)
    s = torch.sqrt(torch.mean(y**2, dim=-1, keepdim=True))
    s = torch.maximum(s, th)
    y = y * (th / s)
    return _denorm01(y, x_max, x_min)


THRESHOLDERS: Dict[str, Callable] = {
    "none": none_thresholding,
    "static_thresholding": static_thresholding,
    "dynamic_thresholding": dynamic_thresholding,
    "dynanormic_thresholding": dynanormic_thresholding,
    "scaled_dynamic_perc_thresholding": scaled_dynamic_perc_thresholding,
    "renorm_thresholding": renorm_thresholding,
    "norm_thresholding": norm_thresholding,
    "scaled_norm_thresholding": scaled_norm_thresholding,
    "spatial_norm_thresholding": spatial_norm_thresholding,
    "scaled_spatial_norm_thresholding": scaled_spatial_norm_thresholding,
}


def get_thresholder(name: str) -> Callable:
    if name not in THRESHOLDERS:
        raise KeyError(
            f"unknown thresholding algorithm {name!r}; options: {sorted(THRESHOLDERS)}"
        )
    return THRESHOLDERS[name]


def dynamic_clip(x, threshold=99.5):
    """Post-CFG dynamic scale clip: divide by the max per-sample percentile,
    floored at 1."""
    s = _per_sample_abs_quantile(x, threshold / 100.0)
    s = torch.clamp_min(torch.max(s), 1.0)
    return x / s
