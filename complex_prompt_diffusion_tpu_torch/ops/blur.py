"""Separable Gaussian blur (NHWC) in plain PyTorch.

Counterpart of ``complex_prompt_diffusion_tpu/ops/blur.py``, which is XLA
(depthwise convolutions) in the JAX package, with no Pallas kernel: here
two depthwise ``F.conv2d(groups=C)`` passes in f32, the caller's dtype out.
Used by unconditional-guidance blur (``GuidanceConfig.uc_blur``); sigma
defaults to torchvision's ``0.3 * ((ksize - 1) * 0.5 - 1) + 0.8``.

Edges are reflected (``jnp.pad(..., "reflect")``: no edge repeat) by index,
so a pad as large as the plane or larger (``attn_guide_blur_k=31`` pads 15)
reflects back and forth as numpy and JAX do, where ``F.pad(mode="reflect")``
would raise.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["gaussian_blur", "gaussian_kernel1d"]


def gaussian_kernel1d(kernel_size: int, sigma: Optional[float] = None) -> np.ndarray:
    if sigma is None:
        sigma = 0.3 * ((kernel_size - 1) * 0.5 - 1) + 0.8
    half = (kernel_size - 1) / 2
    x = np.linspace(-half, half, kernel_size)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _reflect_index(n: int, pad: int) -> np.ndarray:
    """Source rows of a reflect pad of ``pad`` on both sides of ``n`` rows:
    the mirror image repeats with period 2 (n - 1)."""
    i = np.arange(-pad, n + pad)
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    i = np.mod(i, period)
    return np.where(i >= n, period - i, i)


def gaussian_blur(x: torch.Tensor, kernel_size: int = 31, sigma: Optional[float] = None):
    """Blur [N, H, W, C] with a separable Gaussian, reflect-padded edges
    (torchvision's GaussianBlur default)."""
    n, h, w, c = x.shape
    pad = kernel_size // 2
    k = torch.as_tensor(gaussian_kernel1d(kernel_size, sigma), device=x.device)
    xf = x.to(torch.float32).permute(0, 3, 1, 2)  # NCHW
    rows = torch.as_tensor(_reflect_index(h, pad), device=x.device)
    xf = F.conv2d(xf.index_select(2, rows), k.reshape(1, 1, kernel_size, 1).expand(c, 1, -1, -1),
                  groups=c)
    cols = torch.as_tensor(_reflect_index(w, pad), device=x.device)
    xf = F.conv2d(xf.index_select(3, cols), k.reshape(1, 1, 1, kernel_size).expand(c, 1, -1, -1),
                  groups=c)
    return xf.permute(0, 2, 3, 1).contiguous().to(x.dtype)
