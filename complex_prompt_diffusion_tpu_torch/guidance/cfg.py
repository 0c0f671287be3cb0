"""Classifier-free guidance over one batched UNet call.

Counterpart of ``complex_prompt_diffusion_tpu/guidance/cfg.py``:

  * the uncond and all K prompt factors go through ONE UNet call;
  * eps = e_uncond + scale_t * sum_k mask_k * scale_k * (e_k - e_uncond),
    with negative scales for "not" factors;
  * optional per-step scale decay (:func:`make_uc_scale_schedule`), the
    dynamic scale clip of the guided sum, unconditional blur on the last
    steps (:func:`make_uc_blur_schedule`: a host bool a step, so a step's
    blur is a Python ``if``, no device read) and eps thresholding by the
    score-corrector chain (``threshold.py``);
  * :func:`make_denoiser` wraps the eps model for the sigma-space
    (k-diffusion) samplers: input scaled by c_in, sigma mapped to a
    fractional timestep (:func:`sigma_to_t_cont`), output x - sigma * eps,
    or for a v-model c_skip * x + c_out * v.

A concat-conditioned UNet (the 9-channel inpaint model, SD-2's 5-channel
depth model, the latent upscaler) takes its conditioning channels as
``depth_mask``: concatenated to x before the factor tiling, broadcast over
the batch; in sigma space after the c_in scaling, which scales only the
latents. Attention-saliency guidance is not ported yet and raises
NotImplementedError (it needs ``unet_apply(return_skips=True)``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.guidance.threshold import dynamic_clip, get_thresholder
from complex_prompt_diffusion_tpu_torch.ops.blur import gaussian_blur

__all__ = [
    "GuidanceSpec",
    "GuidanceConfig",
    "cfg_epsilon",
    "make_uc_scale_schedule",
    "make_uc_blur_schedule",
    "stacked_context",
    "sigma_to_t_cont",
    "make_denoiser",
]


@dataclasses.dataclass(frozen=True)
class GuidanceSpec:
    """Stacked guidance factors (the compiled form of a complex prompt).

    uncond:  [L, D]      unconditional (negative-prompt) embedding
    factors: [K, L, D]   conditioning embeddings (and-factors then not-factors)
    scales:  [K]         per-factor weights; negative for "not" factors
    masks:   [K, h, w, 1] or [K, 1, 1, 1]   spatial masks over the latent
    """

    uncond: torch.Tensor
    factors: torch.Tensor
    scales: torch.Tensor
    masks: torch.Tensor

    @staticmethod
    def single(cond: torch.Tensor, uncond: torch.Tensor, scale: float = 1.0) -> "GuidanceSpec":
        """Plain one-prompt CFG."""
        return GuidanceSpec(
            uncond=uncond,
            factors=cond[None],
            scales=torch.tensor([scale], dtype=torch.float32, device=cond.device),
            masks=torch.ones((1, 1, 1, 1), dtype=torch.float32, device=cond.device),
        )

    @property
    def num_factors(self) -> int:
        return self.factors.shape[0]


@dataclasses.dataclass(frozen=True)
class GuidanceConfig:
    """Static CFG behaviour switches (same fields as the JAX package)."""

    guidance_scale: float = 7.5
    decay_scale: bool = False
    decay_scale_min: float = 0.0
    decay_scale_start: Optional[int] = None  # default: total_steps
    dynamic_scale_clip: bool = False
    dynamic_scale_clip_threshold: float = 99.9
    uc_blur: bool = False
    uc_blur_k: int = 7
    uc_blur_rounds: Optional[int] = None
    threshold_e: Optional[str] = None
    threshold_e_value: float = 99.66
    attn_guide: bool = False
    attn_guide_rounds: int = 4
    attn_guide_scale: float = 1.1
    attn_guide_skip_idx: int = -1
    attn_guide_mask_threshold: float = 90.0
    attn_guide_blur_k: int = 31

    def unported(self) -> list:
        """Names of the switches that are on but not ported yet."""
        return ["attn_guide"] if self.attn_guide else []


def make_uc_scale_schedule(gcfg: GuidanceConfig, total_steps: int) -> np.ndarray:
    """Per-step guidance scale [S] with the reference's inline log-decay
    (t_idx is the loop iteration, 0 = most noisy)."""
    out = np.full(total_steps, gcfg.guidance_scale, dtype=np.float64)
    if gcfg.decay_scale:
        start = (
            gcfg.decay_scale_start
            if gcfg.decay_scale_start is not None
            else total_steps
        )
        uc = gcfg.guidance_scale
        for t_idx in range(total_steps):
            if start < t_idx:
                start = min(t_idx, start)
                uc = max(
                    gcfg.decay_scale_min,
                    uc - uc * (np.log(t_idx + 1 - start) / np.log(total_steps)),
                )
            out[t_idx] = uc
    return out


def make_uc_blur_schedule(gcfg: GuidanceConfig, total_steps: int) -> np.ndarray:
    """Per-step blur flag [S] (host bools): blur the unconditional eps when
    t_idx > total_steps - rounds (rounds default total_steps // 10)."""
    if not gcfg.uc_blur:
        return np.zeros(total_steps, dtype=bool)
    rounds = (
        gcfg.uc_blur_rounds
        if gcfg.uc_blur_rounds is not None
        else total_steps // 10
    )
    t_idx = np.arange(total_steps)
    return t_idx > (total_steps - rounds)


def stacked_context(spec: GuidanceSpec, batch_size: int) -> torch.Tensor:
    """The [(1+K)*B, L, D] factor-major context of the batched UNet call
    (uncond first, then factors)."""
    ctx = torch.cat([spec.uncond[None], spec.factors], dim=0)  # [1+K, L, D]
    return ctx.repeat_interleave(batch_size, dim=0)


def _batched_inputs(x, t, spec: GuidanceSpec, depth_mask=None):
    """x and t tiled for the one-call factor batch, with the stacked
    contexts; ``depth_mask`` ([h, w, c] or [1 | B, h, w, c]) is broadcast
    over the batch and concatenated to x first."""
    b = x.shape[0]
    k = spec.num_factors
    if depth_mask is not None:
        x = torch.cat([x, depth_mask.to(x.dtype).expand(x.shape[:3] + depth_mask.shape[-1:])],
                      dim=-1)
    x_in = x.repeat(1 + k, 1, 1, 1)
    t_b = torch.as_tensor(t, device=x.device).reshape(-1).expand(b)
    t_in = t_b.repeat(1 + k)
    return x_in, t_in, stacked_context(spec, b)


def cfg_epsilon(
    unet_eps: Callable,
    x: torch.Tensor,
    t,
    spec: GuidanceSpec,
    uc_scale,
    *,
    gcfg: GuidanceConfig = GuidanceConfig(),
    depth_mask: Optional[torch.Tensor] = None,
    uc_blur_on: Optional[bool] = None,
) -> torch.Tensor:
    """One guided eps evaluation.

    unet_eps(x_in, t_in, context) -> eps, with x_in [(1+K)*B, H, W, C],
    t_in [(1+K)*B], context [(1+K)*B, L, D]. x: [B, H, W, C]; t: scalar or
    [B]; uc_scale: this step's guidance scale; ``depth_mask``: a concat
    UNet's conditioning channels (see the module docstring). ``uc_blur_on`` (a host bool,
    the t family's per-step flag; None elsewhere): blur the unconditional
    eps with ``gcfg.uc_blur_k`` before the sum, when ``gcfg.uc_blur``.
    Then eps = e_uncond + scale * e_sum, the scaled sum divided by its
    dynamic clip first (``dynamic_scale_clip``), the result thresholded by
    ``threshold_e``.
    """
    unported = gcfg.unported()
    if unported:
        raise NotImplementedError(f"guidance options not ported yet: {unported}")
    b = x.shape[0]
    k = spec.num_factors
    x_in, t_in, ctx_in = _batched_inputs(x, t, spec, depth_mask)
    out = unet_eps(x_in, t_in, ctx_in)
    out = out.reshape((1 + k, b) + tuple(out.shape[1:]))
    e_uncond = out[0]
    if gcfg.uc_blur and uc_blur_on:
        e_uncond = gaussian_blur(e_uncond, gcfg.uc_blur_k)
    weights = spec.scales.reshape(k, 1, 1, 1, 1) * spec.masks[:, None]
    e_sum = torch.sum(weights * (out[1:] - e_uncond[None]), dim=0)
    scaled = uc_scale * e_sum
    if gcfg.dynamic_scale_clip:
        scaled = dynamic_clip(scaled, gcfg.dynamic_scale_clip_threshold)
    e_t = e_uncond + scaled
    if gcfg.threshold_e:
        e_t = get_thresholder(gcfg.threshold_e)(e_t, gcfg.threshold_e_value)
    return e_t


def sigma_to_t_cont(sigma, model_sigmas) -> np.ndarray:
    """Continuous sigma -> fractional trained timestep, linear interpolation
    against the ascending model sigma table, in f32. Host-side numpy: the
    samplers keep their per-step sigmas on the host, so the sampling loop
    never waits for the device."""
    table = np.asarray(model_sigmas, dtype=np.float32)
    sigma = np.asarray(sigma, dtype=np.float32)
    hi = np.clip(np.searchsorted(table, sigma), 1, table.shape[0] - 1)
    lo = hi - 1
    w = (sigma - table[lo]) / (table[hi] - table[lo])
    return lo.astype(np.float32) + np.clip(w, np.float32(0.0), np.float32(1.0))


def make_denoiser(
    unet_eps: Callable,
    spec: GuidanceSpec,
    *,
    gcfg: GuidanceConfig = GuidanceConfig(),
    model_sigmas=None,
    parameterization: str = "eps",
    depth_mask: Optional[torch.Tensor] = None,
):
    """Build the two denoising closures the samplers consume; both pass
    ``depth_mask`` to :func:`cfg_epsilon`.

    Returns (eps_fn, denoised_fn):
      * eps_fn(x, t, uc_scale, uc_blur_on=None) — t-space (DDIM family);
        ``uc_blur_on`` is the step's host blur flag.
      * denoised_fn(x, sigma, uc_scale) — sigma-space (k-diffusion family):
        scales the input by c_in = 1/sqrt(sigma^2+1), converts sigma to a
        fractional timestep, and returns x - sigma * eps; with
        ``parameterization="v"`` the guided output is v and it returns
        c_skip * x + c_out * v, c_skip = 1/(sigma^2+1) and c_out =
        -sigma/sqrt(1+sigma^2). ``sigma`` is a host scalar (the samplers
        keep their schedules on the host); the arithmetic on it is f32, as
        in the JAX package.
    """
    if parameterization not in ("eps", "v"):
        raise ValueError(f"unknown parameterization {parameterization!r} (eps|v)")

    def eps_fn(x, t, uc_scale, uc_blur_on=None):
        return cfg_epsilon(unet_eps, x, t, spec, uc_scale, gcfg=gcfg, depth_mask=depth_mask,
                           uc_blur_on=uc_blur_on)

    def denoised_fn(x, sigma, uc_scale):
        if model_sigmas is None:
            raise ValueError("denoised_fn requires model_sigmas")
        sigma = np.float32(sigma)
        c_in = np.float32(1.0) / np.sqrt(sigma**2 + np.float32(1.0))
        t = sigma_to_t_cont(sigma, model_sigmas)
        e_t = cfg_epsilon(unet_eps, x * float(c_in), t, spec, uc_scale, gcfg=gcfg,
                          depth_mask=depth_mask)
        if parameterization == "v":
            one = np.float32(1.0)
            c_skip = one / (sigma**2 + one)
            c_out = -sigma * (one / np.sqrt(one + sigma**2))
            return x * float(c_skip) + e_t * float(c_out)
        return x - float(sigma) * e_t

    return eps_fn, denoised_fn
