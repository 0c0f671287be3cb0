"""GroupNorm(+SiLU) over NHWC activations, with the K3 CUDA kernel.

Counterpart of ``complex_prompt_diffusion_tpu/ops/groupnorm.py``. One
dispatch rule, no TPU gates carried over: every CUDA tensor goes through
``csrc/groupnorm.cu`` (the bf16 UNet sites, the bf16 VAE planes and the f32
VAE-decode planes alike); CPU tensors go through the plain twin
:func:`group_norm_plain`. Statistics are f32, with the JAX package's rule by
dtype: one pass (E[x^2] - E[x]^2, clamped at 0) for <= 16-bit inputs, as in
``_gn_xla_mm`` and ``_gn_stats_kernel``; two passes (centered variance) for
f32, as in ``_gn_stats2_kernel``.
"""

from __future__ import annotations

import functools

import torch

from complex_prompt_diffusion_tpu_torch import _build

__all__ = ["group_norm", "group_norm_silu", "group_norm_nhwc", "group_norm_plain", "gn_splits"]


def group_norm_plain(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                     silu: bool = False):
    """Plain PyTorch GroupNorm over NHWC with f32 statistics: one-pass for
    <= 16-bit inputs (``_gn_xla_mm`` of the JAX package), two-pass for f32
    (``_gn_xla``)."""
    n, h, w, c = x.shape
    xf = x.float().reshape(n, h * w, num_groups, c // num_groups)
    if x.element_size() <= 2:
        mean = xf.mean(dim=(1, 3), keepdim=True)
        ex2 = xf.square().mean(dim=(1, 3), keepdim=True)
        var = torch.clamp(ex2 - mean * mean, min=0.0)
    else:
        var, mean = torch.var_mean(xf, dim=(1, 3), keepdim=True, correction=0)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(n, h, w, c)
    y = y * gamma.float() + beta.float()
    if silu:
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


_GN_FNS = {torch.float32: "cpd_group_norm_f32", torch.bfloat16: "cpd_group_norm_bf16"}
_GN_THREADS = 512  # threads of a K3 block
_GN_MIN_SPLIT_ELEMS = 32 * _GN_THREADS  # elements a split block handles at least


def gn_splits(n: int, hw: int, c: int, num_groups: int, sms: int) -> int:
    """HW splits per (sample, group) for K3. 1 (the fused kernel) where the
    n * num_groups blocks keep at least half the SMs busy (the VAE planes
    at batch 4, where splitting measured slower) or the slices are small
    (the UNet planes but level 0 at UNet batch 2); else enough splits for
    two blocks per SM, each with at least 32 elements a thread (4-9 on the
    VAE planes at batch 1)."""
    blocks = n * num_groups
    if 2 * blocks > sms:
        return 1
    most = hw * (c // num_groups) // _GN_MIN_SPLIT_ELEMS
    return max(1, min(-(-2 * sms // blocks), most, hw))


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def group_norm_nhwc(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5,
                    silu: bool = False):
    """K3 wrapper. CPU tensors run :func:`group_norm_plain`; CUDA tensors
    launch ``csrc/groupnorm.cu`` (f32 or bf16, NHWC; one fused kernel, or a
    statistics and an apply kernel over :func:`gn_splits` HW splits) or
    raise. ``group_norm_nhwc.launches`` counts kernel launches (1 or 2 a
    call)."""
    if x.ndim != 4:
        raise ValueError(f"group norm expects NHWC, got shape {tuple(x.shape)}")
    n, h, w, c = x.shape
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by {num_groups} groups")
    if not x.is_cuda:
        return group_norm_plain(x, gamma, beta, num_groups, eps, silu)
    if x.dtype not in _GN_FNS:
        raise TypeError(f"K3 supports float32 and bfloat16, got {x.dtype}")
    _build.refuse_grad("group_norm (K3)", x, gamma, beta)
    if tuple(gamma.shape) != (c,) or tuple(beta.shape) != (c,):
        raise ValueError("gamma and beta must have shape [C]")
    x = x.contiguous()
    gamma = gamma.to(x.dtype).contiguous()
    beta = beta.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    splits = gn_splits(n, h * w, c, num_groups, _sm_count(x.device.index))
    part = None  # per-split partial statistics, [n * num_groups * splits, 2] f32
    if splits > 1:
        part = torch.empty((n * num_groups * splits, 2), dtype=torch.float32, device=x.device)
    fn = getattr(_build.kernel_library(), _GN_FNS[x.dtype])
    err = fn(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(),
        n, h * w, c, num_groups, splits, float(eps), int(silu),
        _build.stream_ptr(x.device),
    )
    _build.check(err, "group_norm (K3)")
    group_norm_nhwc.launches += 1 if splits == 1 else 2
    return y


group_norm_nhwc.launches = 0


def group_norm(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5):
    """GroupNorm over NHWC (torch GroupNorm32 semantics)."""
    return group_norm_nhwc(x, gamma, beta, num_groups, eps, silu=False)


def group_norm_silu(x, gamma, beta, num_groups: int = 32, eps: float = 1e-5):
    """Fused GroupNorm + SiLU (the ResBlock in_layers / out_layers prefix)."""
    return group_norm_nhwc(x, gamma, beta, num_groups, eps, silu=True)
