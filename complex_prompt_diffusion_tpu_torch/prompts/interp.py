"""Embedding interpolation: slerp / lerp / plerp / bleed.

A copy of ``complex_prompt_diffusion_tpu/prompts/interp.py``: host-side
float64 numpy, run once per rendered frame, not per step.

Behavior carried over exactly:
  * slerp: dot computed over the *flattened* embeddings; falls back to lerp
    when |dot| > threshold; output is clipped to the joint min/max range of
    the inputs.
  * lerp: also range-clipped (limits extrapolation artifacts).
  * plerp: piecewise-linear keypoint interpolation y=f(x) with linear
    extrapolation from the outermost segments.
  * bleed: downward-smearing 15x15 single-column correlation.
"""

from __future__ import annotations

import numpy as np

__all__ = ["slerp", "lerp", "plerp", "bleed", "interpolate_lookup"]


def slerp(v0, v1, t: float, threshold: float = 0.9995) -> np.ndarray:
    v0 = np.asarray(v0, dtype=np.float64)
    v1 = np.asarray(v1, dtype=np.float64)
    lo = min(v0.min(), v1.min())
    hi = max(v0.max(), v1.max())

    dot = np.sum(v0 * v1 / (np.linalg.norm(v0) * np.linalg.norm(v1)))
    if np.abs(dot) > threshold:
        v2 = (1 - t) * v0 + t * v1
    else:
        theta_0 = np.arccos(dot)
        sin_theta_0 = np.sin(theta_0)
        theta_t = theta_0 * t
        s0 = np.sin(theta_0 - theta_t) / sin_theta_0
        s1 = np.sin(theta_t) / sin_theta_0
        v2 = s0 * v0 + s1 * v1
    return np.clip(v2, lo, hi)


def lerp(v0, v1, t: float, threshold: float = 0.0) -> np.ndarray:
    v0 = np.asarray(v0, dtype=np.float64)
    v1 = np.asarray(v1, dtype=np.float64)
    lo = min(v0.min(), v1.min())
    hi = max(v0.max(), v1.max())
    return np.clip((1 - t) * v0 + t * v1, lo, hi)


def plerp(xp, yp, x: float, threshold: float = 0.0) -> np.ndarray:
    """Piecewise-linear f(x) through keypoints (xp, yp), each [C, K];
    linear extrapolation beyond the keypoint range. Returns [1, C]."""
    xp = np.asarray(xp, dtype=np.float64)
    yp = np.asarray(yp, dtype=np.float64)
    c, k = xp.shape
    out = np.zeros((1, c))
    for ci in range(c):
        xs, ys = xp[ci], yp[ci]
        order = np.argsort(xs)
        xs, ys = xs[order], ys[order]
        # segment index with linear extrapolation at both ends
        i = np.searchsorted(xs, x)
        i = int(np.clip(i - 1, 0, k - 2))
        out[0, ci] = ys[i] + (x - xs[i]) * (ys[i + 1] - ys[i]) / (xs[i + 1] - xs[i])
    return out


_BLEED_KERNEL = np.zeros((15, 15), dtype=np.float64)
_BLEED_KERNEL[:8, 7] = [0.025, 0.050, 0.100, 0.200, 0.250, 0.300, 0.400, 1.000]


def bleed(x) -> np.ndarray:
    """Smear values downward along the token axis:
    correlate with a single-column kernel, same padding (pad 7, 15-tap)."""
    x = np.asarray(x, dtype=np.float64)
    h, w = x.shape[-2], x.shape[-1]
    img = x.reshape(h, w)
    padded = np.pad(img, ((7, 7), (7, 7)))
    # cross-correlation, stride 1: the (h, w) window at offset 0
    out = np.zeros((h, w))
    for dy in range(15):
        wcol = _BLEED_KERNEL[dy, 7]
        if wcol == 0.0:
            continue
        out += wcol * padded[dy : dy + h, 7 : 7 + w]
    return out.reshape(x.shape)


interpolate_lookup = {"plerp": plerp, "slerp": slerp, "lerp": lerp}
