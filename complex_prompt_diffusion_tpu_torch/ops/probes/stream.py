"""The streaming-copy probe, through the K9 CUDA kernel
(``csrc/probe_copy.cu``): the rate at which this card streams a plane
through a kernel. A probe no layer dispatches.

Counterpart of ``scripts/perf_gn7.py`` (an NHWC copy over (n, hw / ch)
blocks, plain or through f32) and ``scripts/perf_gn8.py`` (the same copy
with multi-buffered DMA). :func:`stream_copy` copies an [N, HW, C] bf16
tensor in tiles of ``rows`` whole rows, one block a tile; ``convert`` takes
every value through f32 and back; ``stages`` 1 is a plain 16-byte load and
store a thread, 3 / 4 / 8 a cp.async ring of that depth.

CPU tensors run :func:`stream_copy_plain`; CUDA tensors launch K9 or raise.
``stream_copy.launches`` counts launches.
"""

from __future__ import annotations

import torch

from complex_prompt_diffusion_tpu_torch import _build

__all__ = ["STAGES", "stream_copy", "stream_copy_plain"]

STAGES = (1, 3, 4, 8)


def _check(x, rows, stages):
    if x.ndim != 3:
        raise ValueError(f"stream_copy takes [N, HW, C], got {tuple(x.shape)}")
    n, hw, c = x.shape
    if rows <= 0 or hw % rows or (rows * c) % 8:
        raise ValueError(f"rows must divide HW and rows * C must be a multiple of 8; got "
                         f"rows={rows} for {tuple(x.shape)}")
    if stages not in STAGES:
        raise ValueError(f"stages must be one of {STAGES}, got {stages}")


def stream_copy_plain(x, rows: int, convert: bool = False, stages: int = 1):
    """Plain twin of K9: a copy (through f32 with ``convert``)."""
    _check(x, rows, stages)
    return x.float().to(x.dtype) if convert else x.clone()


def stream_copy(x, rows: int, convert: bool = False, stages: int = 1):
    """K9 wrapper: a fresh copy of x [N, HW, C] bf16."""
    _check(x, rows, stages)
    if not x.is_cuda:
        return stream_copy_plain(x, rows, convert, stages)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K9 copies bf16 tensors, got {x.dtype}")
    x = x.contiguous()
    y = torch.empty_like(x)
    n, hw, c = x.shape
    err = _build.kernel_library().cpd_probe_copy_bf16(
        x.data_ptr(), y.data_ptr(), n, hw, c, int(rows), int(convert), int(stages),
        _build.stream_ptr(x.device))
    _build.check(err, "streaming copy probe (K9)")
    stream_copy.launches += 1
    return y


stream_copy.launches = 0
