"""The GroupNorm probe: K3's Hopper kernels in the forms the TPU GroupNorm was
tuned with, through the K8 CUDA kernel (``csrc/probe_groupnorm.cu``, its
kernels in ``csrc/groupnorm_sm90.cuh``). A probe no layer dispatches. bf16
NHWC, as the TPU scripts.

Counterpart of ``scripts/perf_gn4.py`` .. ``perf_gn6.py``.
:func:`group_norm_probe` runs K3's slab or split form, as
:func:`probe_plan` says, writing

  * ``mode`` ``"full"``: GroupNorm + SiLU (K3's own kernels at K3's plan:
    ``perf_gn4`` flat_onepass, ``perf_gn5`` merged and nohi);
    ``"copy"``: x through f32 and back, no statistics (``perf_gn6`` copy;
    the split form then launches its apply kernel alone); ``"stats"``: the
    statistics, then ``x + rstd * gamma * 0``; ``"norm"``: no SiLU;
    ``"bf16sig"``: the normalized value rounded to bf16 and SiLU in bf16
    arithmetic. ``mma=True`` (mode full) takes the statistics' channel sums
    on the tensor cores with a ones operand (``perf_gn5`` mxu): s1 of the
    bf16 values as they are, s2 of x^2 rounded once to bf16;
  * ``splits=S``: ``perf_gn4``'s chunked form (S = hw / chunk, the chunks
    of a sample streamed in turn by one TPU core): K3's split form with the
    sample cut into S runs, each of K3's split tiles streaming its share of
    every run in turn, so that the grid stays K3's one full wave.
    GroupNorm + SiLU.

CPU tensors run :func:`group_norm_probe_plain`; CUDA tensors launch K8 or
raise (a shape K3's Hopper forms refuse raises ValueError).
``group_norm_probe.launches`` counts the kernels the library reports it
launched (1 a slab call, 2 a split call, 1 the copy mode's split call). The
body K8 ran before, one block a (sample, group) slice on K3's first kernels,
stays callable as :func:`group_norm_probe_prior`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from complex_prompt_diffusion_tpu_torch import _build
from complex_prompt_diffusion_tpu_torch.ops.groupnorm import (
    _FORMS,
    _nhwc_args,
    _sm_count,
    _split_parts,
    group_norm_plain,
    group_norm_plan,
)

__all__ = ["GN_MODES", "ProbePlan", "group_norm_probe", "group_norm_probe_plain",
           "group_norm_probe_prior", "probe_plan"]

GN_MODES = {"full": 0, "copy": 1, "stats": 2, "norm": 3, "bf16sig": 4}


class ProbePlan(NamedTuple):
    """How K8 runs one call: K3's ``form``, ``tiles`` and ``launches``
    (:class:`~complex_prompt_diffusion_tpu_torch.ops.groupnorm.GnPlan`), and
    the ``runs`` a sample each split tile takes its share of in turn (1 but
    with forced splits)."""

    form: str
    tiles: int
    launches: int
    runs: int = 1


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


def probe_plan(n: int, hw: int, c: int, groups: int, mode: str = "full",
               splits: Optional[int] = None, sms: int = 132) -> ProbePlan:
    """The form, tiles, kernel launches and runs of one K8 call on a card of
    ``sms`` SMs: K3's plan (:func:`group_norm_plan` in bf16), or with
    ``splits`` S the split form over K3's split tiles (``sms // n``, at most
    hw // S so that each tile has a pixel of every run) and S runs; the copy
    mode's split form launches its apply kernel alone. Raises ValueError
    where K3's Hopper forms refuse the shape. Pure Python."""
    plan = ProbePlan(*group_norm_plan(n, hw, c, groups, torch.bfloat16, sms))
    if splits is not None:
        if not 1 <= splits <= hw:
            raise ValueError(f"splits must be in [1, H*W], got {splits}")
        plan = ProbePlan("split", max(1, min(sms // n, hw // splits)), 2, splits)
    if mode == "copy" and plan.form == "split":
        plan = plan._replace(launches=1)
    return plan


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
    plan = probe_plan(n, h * w, c, num_groups, mode, splits, _sm_count(x.device.index))
    x, gamma, beta = _nhwc_args(x, gamma, beta)
    y = torch.empty_like(x)
    stream = _build.stream_ptr(x.device)
    parts = None
    if plan.form == "split":
        parts = _split_parts(n * plan.tiles * num_groups, x.device, stream)
    launched = ctypes.c_int(0)
    err = _build.kernel_library().cpd_probe_group_norm_sm90(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        None if parts is None else parts.data_ptr(), n, h * w, c, num_groups, float(eps),
        GN_MODES[mode], int(mma), _FORMS[plan.form], plan.tiles, plan.runs,
        ctypes.addressof(launched), stream)
    group_norm_probe.launches += launched.value
    _build.check(err, f"group norm probe (K8, {mode})")
    return y


group_norm_probe.launches = 0


def group_norm_probe_prior(x, gamma, beta, mode: str = "full", num_groups: int = 32,
                           eps: float = 1e-5, splits=None, mma: bool = False):
    """The body K8 ran until it moved onto K3's Hopper forms
    (``csrc/probe_groupnorm_prior.cu``: K3's first fused kernel, one block
    a (sample, group) slice, in each mode; ``splits=S``: its statistics and
    apply kernels over S splits of each slice); kept to be timed beside K8.
    CPU tensors run :func:`group_norm_probe_plain`.
    ``group_norm_probe_prior.launches`` counts its launches."""
    _check(x, mode, splits, mma, num_groups)
    if not x.is_cuda:
        return group_norm_probe_plain(x, gamma, beta, mode, num_groups, eps, splits, mma)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K8 takes bf16 activations (the TPU scripts'), got {x.dtype}")
    _build.refuse_grad("group norm probe (K8, replaced body)", x, gamma, beta)
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
    err = _build.kernel_library().cpd_probe_group_norm_prior_bf16(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(),
        None if part is None else part.data_ptr(), n, h * w, c, num_groups,
        0 if splits is None else int(splits), float(eps), GN_MODES[mode], int(mma),
        _build.stream_ptr(x.device))
    _build.check(err, f"group norm probe (K8, replaced body, {mode})")
    group_norm_probe_prior.launches += 1 if splits is None else 2
    return y


group_norm_probe_prior.launches = 0
