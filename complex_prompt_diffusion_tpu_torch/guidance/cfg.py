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
latents.

The opt-in modes of the JAX package's module are here too: DeepCache
(:func:`cfg_epsilon_deepcache`, :func:`make_denoiser_deepcache`: the full
UNet on a cache step, the shallow pass against the carried deep feature in
between) and attention-saliency guidance (:func:`cfg_epsilon_attn_guided`:
a mask from one encoder skip tensor, the predicted x0 blurred inside it and
re-noised, the UNet run again on the unconditional context, the guided sum
pushed away from that).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.guidance.attn_guidance import blur_renoise, saliency_mask
from complex_prompt_diffusion_tpu_torch.guidance.threshold import dynamic_clip, get_thresholder
from complex_prompt_diffusion_tpu_torch.ops.blur import gaussian_blur

__all__ = [
    "GuidanceSpec",
    "GuidanceConfig",
    "cfg_epsilon",
    "cfg_epsilon_deepcache",
    "cfg_epsilon_attn_guided",
    "make_denoiser_deepcache",
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
        """Names of the switches that are on but not ported yet: none."""
        return []


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


def _split_and_sum(out, spec: GuidanceSpec, b: int, gcfg: GuidanceConfig, uc_blur_on):
    """(e_uncond, the weighted masked sum of the factors' differences) of
    the batched UNet output; e_uncond blurred first when the step's flag
    is on."""
    k = spec.num_factors
    out = out.reshape((1 + k, b) + tuple(out.shape[1:]))
    e_uncond = out[0]
    if gcfg.uc_blur and uc_blur_on:
        e_uncond = gaussian_blur(e_uncond, gcfg.uc_blur_k)
    weights = spec.scales.reshape(k, 1, 1, 1, 1) * spec.masks[:, None]
    return e_uncond, torch.sum(weights * (out[1:] - e_uncond[None]), dim=0)


def _combine(e_uncond, e_sum, uc_scale, gcfg: GuidanceConfig):
    """e_uncond + scale * e_sum, the scaled sum through the dynamic clip,
    the result through the eps thresholder."""
    scaled = uc_scale * e_sum
    if gcfg.dynamic_scale_clip:
        scaled = dynamic_clip(scaled, gcfg.dynamic_scale_clip_threshold)
    e_t = e_uncond + scaled
    if gcfg.threshold_e:
        e_t = get_thresholder(gcfg.threshold_e)(e_t, gcfg.threshold_e_value)
    return e_t


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
    ``threshold_e``. ``gcfg.attn_guide`` is not read here (the t family's
    guided steps call :func:`cfg_epsilon_attn_guided`), as in the JAX
    package.
    """
    x_in, t_in, ctx_in = _batched_inputs(x, t, spec, depth_mask)
    out = unet_eps(x_in, t_in, ctx_in)
    e_uncond, e_sum = _split_and_sum(out, spec, x.shape[0], gcfg, uc_blur_on)
    return _combine(e_uncond, e_sum, uc_scale, gcfg)


def cfg_epsilon_deepcache(
    unet_full: Callable,
    unet_shallow: Callable,
    x: torch.Tensor,
    t,
    spec: GuidanceSpec,
    uc_scale,
    is_full: bool,
    deep,
    *,
    gcfg: GuidanceConfig = GuidanceConfig(),
    depth_mask: Optional[torch.Tensor] = None,
    uc_blur_on: Optional[bool] = None,
):
    """DeepCache variant of :func:`cfg_epsilon`: unet_full(x_in, t_in, ctx)
    -> (eps, deep'), unet_shallow(x_in, t_in, ctx, deep) -> eps. On a cache
    step (``is_full``, a host bool) the full UNet runs and refreshes the deep
    feature; otherwise only the shallow pass runs against the carried one.
    Returns (e_t, deep')."""
    x_in, t_in, ctx_in = _batched_inputs(x, t, spec, depth_mask)
    if is_full:
        out, deep = unet_full(x_in, t_in, ctx_in)
    else:
        out = unet_shallow(x_in, t_in, ctx_in, deep)
    e_uncond, e_sum = _split_and_sum(out, spec, x.shape[0], gcfg, uc_blur_on)
    return _combine(e_uncond, e_sum, uc_scale, gcfg), deep


def make_denoiser_deepcache(
    unet_full: Callable,
    unet_shallow: Callable,
    spec: GuidanceSpec,
    *,
    interval: int,
    gcfg: GuidanceConfig = GuidanceConfig(),
    model_sigmas=None,
    parameterization: str = "eps",
    depth_mask: Optional[torch.Tensor] = None,
) -> Callable:
    """Sigma-space DeepCache denoiser for the k-diffusion samplers:
    ``den_fn(x, sigma, uc_scale, i, deep) -> (denoised, deep')``, the
    stateful protocol of ``kdiff.Stateful``. The full UNet runs on every
    ``interval``-th sampler step (``i``, the step index; a multi-eval
    sampler's two evaluations of a step share it, so both are full on a
    cache step), the shallow pass in between. The input scaling and the
    v-model conversion are :func:`make_denoiser`'s. Without
    ``model_sigmas`` it raises ValueError, as the JAX function does."""
    if model_sigmas is None:
        raise ValueError("make_denoiser_deepcache requires model_sigmas")
    if parameterization not in ("eps", "v"):
        raise ValueError(f"unknown parameterization {parameterization!r} (eps|v)")

    def den_fn(x, sigma, uc_scale, i, deep):
        sigma = np.float32(sigma)
        c_in = np.float32(1.0) / np.sqrt(sigma**2 + np.float32(1.0))
        t = sigma_to_t_cont(sigma, model_sigmas)
        e_t, deep = cfg_epsilon_deepcache(
            unet_full, unet_shallow, x * float(c_in), t, spec, uc_scale, (i % interval) == 0,
            deep, gcfg=gcfg, depth_mask=depth_mask)
        return _denoised(x, sigma, e_t, parameterization), deep

    return den_fn


def cfg_epsilon_attn_guided(
    unet_eps: Callable,
    unet_eps_skips: Callable,
    x: torch.Tensor,
    t,
    spec: GuidanceSpec,
    uc_scale,
    step_coeffs,
    *,
    gcfg: GuidanceConfig,
    depth_mask: Optional[torch.Tensor] = None,
    uc_blur_on: Optional[bool] = None,
) -> torch.Tensor:
    """Attention-saliency-guided eps: unet_eps_skips(x_in, t_in, ctx) ->
    (eps, skip tensors) for the batched call; ``step_coeffs`` = (a_t,
    sqrt(1 - a_t)) of this step. The mask: the channel mean of skip
    ``gcfg.attn_guide_skip_idx``'s unconditional slice, binarized at one
    ``torch.quantile`` (linear, as ``jnp.quantile``) over that whole slice,
    resized "nearest" to the latent. The predicted x0 blurred
    (``attn_guide_blur_k``) and re-noised inside the mask, the UNet run on it
    with the unconditional context at batch B, and e_sum' = e_attn + scale *
    (e_sum - e_attn) combined as :func:`cfg_epsilon` combines."""
    b = x.shape[0]
    x_in, t_in, ctx_in = _batched_inputs(x, t, spec, depth_mask)
    out, skips = unet_eps_skips(x_in, t_in, ctx_in)
    e_uncond, e_sum = _split_and_sum(out, spec, b, gcfg, uc_blur_on)

    # the mask over the whole unconditional slice, one quantile for all of it
    mask = saliency_mask(skips[gcfg.attn_guide_skip_idx][:b], gcfg.attn_guide_mask_threshold,
                         x.shape[1:3], None)
    a_t, sqrt_1m = step_coeffs
    guide_x = blur_renoise(x, e_uncond, mask, float(np.sqrt(np.float32(a_t))), float(sqrt_1m),
                           gcfg.attn_guide_blur_k)
    if depth_mask is not None:
        guide_x = torch.cat([guide_x, depth_mask.to(guide_x.dtype).expand(
            guide_x.shape[:3] + depth_mask.shape[-1:])], dim=-1)
    t_b = torch.as_tensor(t, device=x.device).reshape(-1).expand(b)
    e_attn = unet_eps(guide_x, t_b, spec.uncond[None].repeat(b, 1, 1))
    e_sum = e_attn + gcfg.attn_guide_scale * (e_sum - e_attn)
    return _combine(e_uncond, e_sum, uc_scale, gcfg)


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
        return _denoised(x, sigma, e_t, parameterization)

    return eps_fn, denoised_fn


def _denoised(x, sigma, e_t, parameterization: str):
    """x - sigma * eps, or for a v-model c_skip * x + c_out * v (host f32
    coefficients)."""
    if parameterization == "v":
        one = np.float32(1.0)
        c_skip = one / (sigma**2 + one)
        c_out = -sigma * (one / np.sqrt(one + sigma**2))
        return x * float(c_skip) + e_t * float(c_out)
    return x - float(sigma) * e_t
