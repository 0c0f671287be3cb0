"""The GroupNorm probe: K3's kernels in the forms the TPU GroupNorm was
tuned with, through the K8 CUDA kernel (``csrc/probe_groupnorm.cu``). A
probe no layer dispatches. bf16 NHWC, as the TPU scripts.

Counterpart of ``scripts/perf_gn4.py`` .. ``perf_gn6.py``.
:func:`group_norm_probe`:

  * ``splits=None``, ``mode``: K3's fused kernel (one block a (sample,
    group), the statistics then the normalization), writing
    ``"full"``: GroupNorm + SiLU (K3; ``perf_gn5`` merged and nohi);
    ``"copy"``: x through f32 and back, no statistics (``perf_gn6`` copy);
    ``"stats"``: the statistics, then ``x + rstd * 0``; ``"norm"``: no SiLU;
    ``"bf16sig"``: the normalized value rounded to bf16 and SiLU in bf16
    arithmetic. ``mma=True`` (mode full) takes the channel sums on the
    tensor cores with a ones operand (``perf_gn5`` mxu): s1 of the bf16
    values as they are, s2 of x^2 rounded once to bf16;
  * ``splits=S``: K3's split schedule (a statistics kernel and an apply
    kernel over S HW splits) with S forced: ``perf_gn4``'s chunked form,
    S = hw / chunk. GroupNorm + SiLU.

CPU tensors run :func:`group_norm_probe_plain`; CUDA tensors launch K8 or
raise. ``group_norm_probe.launches`` counts K8's kernel launches (2 a call
with ``splits``).
"""

from __future__ import annotations

import torch

from complex_prompt_diffusion_tpu_torch import _build
from complex_prompt_diffusion_tpu_torch.ops.groupnorm import group_norm_plain

__all__ = ["GN_MODES", "group_norm_probe", "group_norm_probe_plain"]

GN_MODES = {"full": 0, "copy": 1, "stats": 2, "norm": 3, "bf16sig": 4}


def _check(x, mode, splits, mma, num_groups):
    if mode not in GN_MODES:
        raise ValueError(f"unknown GroupNorm probe mode {mode!r}")
    if (splits is not None or mma) and mode != "full":
        raise ValueError("forced splits and tensor-core statistics run mode 'full'")
    if splits is not None and mma:
        raise ValueError("forced splits use K3's own statistics")
    if x.ndim != 4 or x.shape[-1] % num_groups:
        raise ValueError(f"group norm probe expects NHWC with C % groups == 0, got "
                         f"{tuple(x.shape)}")
    if splits is not None and not 1 <= splits <= x.shape[1] * x.shape[2]:
        raise ValueError(f"splits must be in [1, H*W], got {splits}")


def group_norm_probe_plain(x, gamma, beta, mode: str = "full", num_groups: int = 32,
                           eps: float = 1e-5, splits=None, mma: bool = False):
    """Plain twin of K8 (``splits`` changes no value)."""
    _check(x, mode, splits, mma, num_groups)
    if mode in ("copy", "stats"):  # x through f32 (+ rstd * 0): x itself for finite x
        return x.float().to(x.dtype)
    if mode == "norm":
        return group_norm_plain(x, gamma, beta, num_groups, eps, silu=False)
    if mode == "full" and not mma:
        return group_norm_plain(x, gamma, beta, num_groups, eps, silu=True)
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, num_groups, c // num_groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    x2 = xf.square().to(torch.bfloat16).float() if mma else xf.square()
    var = torch.clamp(x2.mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    y = y * gamma.float() + beta.float()
    if mode == "full":  # the tensor-core statistics
        return (y * torch.sigmoid(y)).to(x.dtype)
    yb = y.to(torch.bfloat16)  # bf16sig: SiLU in bf16 arithmetic
    one = torch.ones_like(yb)
    return (yb * (one / (one + torch.exp(-yb)))).to(x.dtype)


def group_norm_probe(x, gamma, beta, mode: str = "full", num_groups: int = 32,
                     eps: float = 1e-5, splits=None, mma: bool = False):
    """K8 wrapper: x [N, H, W, C] bf16, gamma and beta [C]."""
    _check(x, mode, splits, mma, num_groups)
    if not x.is_cuda:
        return group_norm_probe_plain(x, gamma, beta, mode, num_groups, eps, splits, mma)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K8 takes bf16 activations (the TPU scripts'), got {x.dtype}")
    _build.refuse_grad("group norm probe (K8)", x, gamma, beta)
    n, h, w, c = x.shape
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError("gamma and beta must have shape [C]")
    x = x.contiguous()
    gamma = gamma.to(x.dtype).contiguous()
    beta = beta.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    part = None
    if splits is not None:
        part = torch.empty((n * num_groups * splits, 2), dtype=torch.float32, device=x.device)
    err = _build.kernel_library().cpd_probe_group_norm_bf16(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), n, h * w, c, num_groups,
        0 if splits is None else int(splits), float(eps), GN_MODES[mode], int(mma),
        _build.stream_ptr(x.device))
    _build.check(err, f"group norm probe (K8, {mode})")
    group_norm_probe.launches += 1 if splits is None else 2
    return y


group_norm_probe.launches = 0
