"""Depth estimation and depth-mask conditioning.

Counterpart of the conditioning half of ``complex_prompt_diffusion_tpu/
depth.py``: the ``DepthEstimator`` protocol, the offline
``SobelDepthEstimator`` (pseudo-depth from blurred luminance contrast and a
vertical prior; no weights), the depth -> mask arithmetic
(``create_depth_mask``: bicubic resize, then [-1, 1]; ``build_depth_mask``,
``rescale``, ``shave``, ``get_depth``) and ``DepthManager``, whose
``conditioning_channel`` is depth2img's fifth UNet input. Host-side numpy,
with ``utils/resize.py`` for ``jax.image.resize``; a depth map is made once
an image, not a step.

Not ported yet: the boosted-depth half (``double_estimate``,
``merge_depth``, ``boost_depth``, the patch selection) and the MiDaS,
AdaBins and LeReS estimators, which need downloaded weights or external
checkouts.
"""

from __future__ import annotations

from typing import Optional, Protocol, Tuple

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.utils.resize import resize

__all__ = [
    "DepthEstimator",
    "SobelDepthEstimator",
    "DepthManager",
    "create_depth_mask",
    "build_depth_mask",
    "get_depth",
    "rescale",
    "shave",
]


class DepthEstimator(Protocol):
    def estimate(self, img: np.ndarray) -> np.ndarray:
        """uint8/float [H, W, 3] image -> depth [H, W] (near = larger)."""
        ...


class SobelDepthEstimator:
    """Offline stand-in for a monocular depth model: pseudo-depth from the
    box-blurred gradient magnitude of the luminance and a vertical prior
    (the bottom of the frame nearer). Deterministic; needs no weights."""

    def estimate(self, img: np.ndarray) -> np.ndarray:
        img = np.asarray(img, np.float32)
        if img.max() > 2.0:
            img = img / 255.0
        grey = img.mean(axis=-1)
        h, w = grey.shape
        prior = np.linspace(0.0, 1.0, h)[:, None] * np.ones((1, w))
        gy, gx = np.gradient(grey)
        mag = np.sqrt(gx**2 + gy**2)
        k = max(3, min(h, w) // 16)
        kernel = np.ones(k) / k
        mag = np.apply_along_axis(lambda r: np.convolve(r, kernel, mode="same"), 1, mag)
        mag = np.apply_along_axis(lambda c: np.convolve(c, kernel, mode="same"), 0, mag)
        d = 0.6 * prior + 0.4 * (mag / (mag.max() + 1e-8))
        return d.astype(np.float32)


def rescale(x):
    """(x - min) / (max - min)."""
    return (x - x.min()) / (x.max() - x.min() + 1e-12)


def shave(x, q: float):
    """Zero the values below the ``q`` quantile of each row."""
    x = np.array(x, np.float32, copy=True)
    v = np.quantile(x, q, axis=-1, keepdims=True)
    x[x < v] = 0.0
    return x


def create_depth_mask(depth_map: np.ndarray, size: Tuple[int, int] = (64, 64)) -> np.ndarray:
    """Depth map [H, W] -> mask [h, w] in [-1, 1]: a bicubic resize (as
    ``jax.image.resize``), then a min/max rescale, in f32."""
    sized = resize(torch.as_tensor(np.asarray(depth_map, np.float32)), size, "bicubic")
    lo, hi = sized.min(), sized.max()
    return (2.0 * (sized - lo) / (hi - lo + 1e-12) - 1.0).numpy()


def build_depth_mask(img: np.ndarray, estimator: Optional[DepthEstimator] = None,
                     q: float = 0.35, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """Image -> spatial mask with 1 nearest: 1 - the depth mask, the lowest
    ``q`` quantile shaved to 0, rescaled to [0, 1]; ``size`` defaults to the
    depth map's / 8."""
    estimator = estimator or SobelDepthEstimator()
    depth = estimator.estimate(img)
    if size is None:
        size = (depth.shape[0] // 8, depth.shape[1] // 8)
    mask = 1.0 - create_depth_mask(depth, size=size)
    return rescale(shave(mask, q))


def get_depth(img: np.ndarray, estimators: Tuple[DepthEstimator, ...],
              weights: Optional[Tuple[float, ...]] = None) -> np.ndarray:
    """The weighted sum of several estimators' depth maps (equal weights by
    default)."""
    if weights is None:
        weights = tuple([1.0 / len(estimators)] * len(estimators))
    out = None
    for est, w in zip(estimators, weights):
        d = est.estimate(img)
        out = d * w if out is None else out + d * w
    return out


class DepthManager:
    """An estimator (``SobelDepthEstimator`` by default), a shave quantile
    ``q`` and the mask's ``size``; ``conditioning_channel`` puts depth2img's
    channel on ``device`` (the GPU unless asked otherwise)."""

    def __init__(self, estimator: Optional[DepthEstimator] = None, q: float = 0.0,
                 size: Tuple[int, int] = (64, 64), device="cuda"):
        from complex_prompt_diffusion_tpu_torch.pipeline import _device

        self.estimator = estimator or SobelDepthEstimator()
        self.q = q
        self.size = size
        self.device = _device(device)

    def apply_depth(self, img) -> np.ndarray:
        return self.estimator.estimate(img)

    def get(self, img) -> np.ndarray:
        """The spatial mask of ``img`` (1 nearest, in [0, 1]), as
        :func:`build_depth_mask` with this manager's ``q`` and ``size``."""
        return build_depth_mask(img, self.estimator, self.q, self.size)

    def conditioning_channel(self, img) -> torch.Tensor:
        """depth2img's UNet channel: :func:`create_depth_mask` of the
        image's depth at ``size``, f32 [h, w, 1] on the device."""
        d = create_depth_mask(self.apply_depth(img), size=self.size)
        return torch.as_tensor(d, device=self.device)[..., None]
