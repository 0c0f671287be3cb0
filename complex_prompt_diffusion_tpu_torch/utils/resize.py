"""``jax.image.resize`` for the port: the methods the JAX package calls it
with, on 2-D [H, W], [H, W, C] or NHWC tensors ("linear" is JAX's alias
of "bilinear").

``jax.image.resize`` antialiases whenever it scales down: its kernel is
widened by the scale factor and renormalized at the borders, and upscales
use the same renormalized kernels (Keys' cubic with a = -0.5 for
"bicubic"). ``F.interpolate(..., antialias=True)`` computes those weights;
without ``antialias`` it samples differently (bicubic a = -0.75, clamped
borders, no widening) and misses by up to 0.4 on a 64 -> 8 downscale.
"nearest" picks the pixel under each output's centre, which is
``mode="nearest-exact"`` (``mode="nearest"`` floors the source index
instead). The antialiased bilinear and bicubic modes have a backward on
the CPU and on CUDA: CLIP guidance differentiates through the resize."""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

__all__ = ["resize", "METHODS"]

# jax.image.resize's method names -> F.interpolate's modes
METHODS = {"nearest": "nearest-exact", "bilinear": "bilinear", "linear": "bilinear",
           "bicubic": "bicubic"}


def resize(x: torch.Tensor, shape: Sequence[int], method: str) -> torch.Tensor:
    """``x`` resized to ``shape`` by ``method`` ("nearest", "bilinear" (or
    "linear") or "bicubic") as ``jax.image.resize(x, shape, method)`` resizes it, in f32
    on ``x``'s device. ``x`` is [H, W], [H, W, C] or [N, H, W, C]; only H and
    W may change."""
    if method not in METHODS:
        raise ValueError(f"unknown resize method {method!r} ({'|'.join(METHODS)})")
    shape = tuple(int(n) for n in shape)
    if len(shape) != x.ndim or x.ndim not in (2, 3, 4):
        raise ValueError(f"resize takes [H, W], [H, W, C] or NHWC to a shape of the same rank: "
                         f"{tuple(x.shape)} -> {shape}")
    # the axes other than H and W: none, C, or N and C
    others = [i for i in range(x.ndim) if i not in ((0, 1) if x.ndim < 4 else (1, 2))]
    if any(x.shape[i] != shape[i] for i in others):
        raise ValueError(f"resize changes only H and W: {tuple(x.shape)} -> {shape}")
    if x.ndim == 2:
        nchw, (h, w) = x[None, None], shape
    elif x.ndim == 3:
        nchw, (h, w) = x.permute(2, 0, 1)[None], shape[:2]
    else:
        nchw, (h, w) = x.permute(0, 3, 1, 2), shape[1:3]
    mode = METHODS[method]
    kw = {} if mode == "nearest-exact" else {"antialias": True, "align_corners": False}
    y = F.interpolate(nchw.float(), size=(h, w), mode=mode, **kw)
    if x.ndim == 2:
        return y[0, 0]
    if x.ndim == 3:
        return y[0].permute(1, 2, 0)
    return y.permute(0, 2, 3, 1)
