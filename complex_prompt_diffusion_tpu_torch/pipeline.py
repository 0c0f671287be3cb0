"""End-to-end txt2img and img2img: model bundle, prompt encoding,
sampling, VAE encode and decode.

Counterpart of ``complex_prompt_diffusion_tpu/pipeline.py``: ``txt2img`` ->
``make_guidance_spec`` -> ``encode_prompt`` (tokenizer + CLIP) ->
``sample_latents`` (the sampler ``cfg.sampler`` names, by its family: DDIM
or PLMS over the inference tables; a k-diffusion sampler or DPM Adaptive
over a sigma schedule; DPM-Solver or UniPC in continuous time, the model
called at fractional timesteps; iPNDM on its trig schedule; blur diffusion
in the blur operator's eigenbasis; CFG with uncond and cond in ONE UNet
call, cross-attention k/v hoisted out of the step loop) ->
``decode_latents`` (VAE decode to uint8); ``img2img`` encodes the image
(``encode_image``), noises it to the step ``img2img_t_enc`` picks (a DDIM
timestep, or a sigma of the schedule) and runs the last part of the chain.
``step_callback(t, x0)`` sees every denoiser evaluation of the t and sigma
families. Where the JAX package jits one scan, the port runs an eager
Python loop on the device. Entry points run on the bundle's device, which
is the GPU unless the caller asks for the CPU.

Concat-conditioned UNets take their extra input channels as ``depth_mask``
(``guidance/cfg.py``), in every sampler family: ``inpaint`` (the 9-channel
inpaint model: the hole's mask and the masked image's latents),
``depth2img`` (SD-2's 5-channel depth model: a depth map from
``depth.py``) and ``upscale_latents`` (the latent upscaler's noise-augmented
low-resolution image). The resizes are ``utils/resize.py``'s copies of
``jax.image.resize``.

A v-parameterized model (SD 2.x 768-v) is converted where the JAX package
converts it: in the t family (DDIM, PLMS, DDIM img2img) its output becomes
eps = sqrt(a_t) v + sqrt(1 - a_t) x at the clipped integer timestep, and
the sigma family's denoiser takes ``parameterization``; the solver, trig
and blur families take the UNet's output as it is, as the JAX package's
do. Bundles come from a CompVis checkpoint
(:meth:`ModelBundle.from_checkpoint`, ``.ckpt`` or ``.safetensors``), a
YAML config (``config.py``), a saved bundle (:func:`load_bundle`), the JAX
package, or random weights.

The guidance switches (uc blur, eps thresholding, the dynamic scale clip,
attention-saliency guidance) and ``clip_sample`` are ported, and so are the
UNet's opt-in modes: DeepCache (``deepcache_interval``: the full UNet every
N-th step, its shallow pass in between, for ``DEEPCACHE_SAMPLERS``), token
reduction (``tome_ratio``, ``tome_mode``: ToDo K/V pooling or ToMe merging
at the large self-attention sites) and tiled inference (``unet_tile``,
``unet_tile_stride``, ``unet_tile_chunk``; ``models/tiled.py``). The "Log"
sampler returns log-likelihoods [B] from ``sample_latents``, through the
UNet's vector-Jacobian products (the kernels' backward rules), and so does
CLIP guidance (``sample_latents(clip_guidance=)``: the t family's eps
corrected by the gradient of a guide CLIP's loss through the UNet, the VAE
decode and the vision tower; ``guidance/clip_guidance.py``). The
standalone CLIP-guided txt2img is ``pipeline_clip_guided.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple, Union

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch import convert
from complex_prompt_diffusion_tpu_torch import models as M
from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.guidance import (
    GuidanceConfig,
    GuidanceSpec,
    cfg_epsilon_attn_guided,
    cfg_epsilon_deepcache,
    make_denoiser,
    make_denoiser_deepcache,
    make_uc_blur_schedule,
    make_uc_scale_schedule,
    stacked_context,
)
from complex_prompt_diffusion_tpu_torch.guidance.clip_guidance import make_clip_guidance
from complex_prompt_diffusion_tpu_torch.models.tiled import make_tiled_unet
from complex_prompt_diffusion_tpu_torch.prompts.tokenizer import get_tokenizer
from complex_prompt_diffusion_tpu_torch.samplers import (
    BlurDiffusion,
    NoiseScheduleVP,
    get_sampler,
    sample_ddim,
    sample_unipc,
)
from complex_prompt_diffusion_tpu_torch.samplers.loglik import sample_log_likelihood
from complex_prompt_diffusion_tpu_torch.utils.resize import resize

__all__ = [
    "ModelBundle",
    "RenderConfig",
    "encode_prompt",
    "make_guidance_spec",
    "sample_latents",
    "decode_latents",
    "txt2img",
    "encode_image",
    "img2img_t_enc",
    "img2img",
    "inpaint",
    "depth2img",
    "upscale_latents",
    "initial_noise",
    "render_config_to_json",
    "render_config_from_json",
    "save_bundle",
    "load_bundle",
]

LATENT_SCALE = 0.18215

# Samplers whose loops thread the DeepCache state (ddim.py eps_state,
# kdiff.py den_state): DPM Fast, the adaptive integrators and the
# continuous-time solvers have no fixed per-step grid of evaluations.
DEEPCACHE_SAMPLERS = frozenset({
    "ddim", "plms",
    "euler", "euler ancestral", "heun", "huen",
    "dpm2", "dpm2 ancestral", "dpm++ 2m", "dpm++ 2s ancestral", "lms",
})


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _unzero_kernels(gen: torch.Generator, params, scale: float = 0.02):
    """Replace all-zero kernel leaves (ndim >= 2) with small gaussian noise.

    Used only by ModelBundle.random: the checkpoint-parity init zeroes the
    residual/projection output layers, which would make a random model's
    output constant-zero and hide conditioning. Biases and norm offsets
    (ndim < 2) stay zero."""

    def fill(a):
        if a.ndim >= 2 and not bool(a.any()):
            return scale * torch.randn(a.shape, generator=gen, device=a.device)
        return a

    return _tree_map(fill, params)


def _device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (no fallback
    to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU; pass device='cpu' to "
            "run it on the CPU"
        )
    return device


@dataclasses.dataclass
class ModelBundle:
    """Configs and parameters of the three models, the tokenizer and the
    diffusion tables, on one device. ``shard``: the tensor-parallel context
    (``ops.sharding.ShardCtx``) that ``parallel.tp.shard_bundle`` installs
    beside the UNet config, with ``unet_params`` this rank's shards; every
    UNet call of the entry points passes it on (``unet_apply(...,
    shard=)``). It is not saved and no config sees it."""

    version: str
    unet_cfg: M.UNetConfig
    unet_params: Any
    vae_cfg: M.VAEConfig
    vae_params: Any
    clip_cfg: M.CLIPTextConfig
    clip_params: Any
    tokenizer: Any
    tables: S.DiffusionTables
    device: torch.device
    parameterization: str = "eps"
    clip_layer: str = "last"
    shard: Any = None

    @staticmethod
    def random(scale: str = "tiny", seed: int = 0, device="cuda") -> "ModelBundle":
        """Random-weight bundle ("tiny", "tiny-inpaint" or "sd15"), built on
        ``device`` (the GPU unless asked otherwise) from a seeded generator
        with the JAX package's init distributions. "tiny-inpaint" is the
        tiny config with the inpaint model's 9 input channels (4 latent, the
        mask, 4 masked-image latents). The UNet weights are stored in its
        compute dtype (bf16 for "sd15")."""
        device = _device(device)
        if scale in ("tiny", "tiny-inpaint"):
            unet_cfg = dataclasses.replace(M.UNetConfig.tiny(context_dim=64), dtype="float32",
                                           in_channels=9 if scale == "tiny-inpaint" else 4)
            vae_cfg = M.VAEConfig.tiny()
            clip_cfg = M.CLIPTextConfig.tiny()
        elif scale == "sd15":
            unet_cfg = M.UNetConfig.sd15()
            vae_cfg = M.VAEConfig.sd()
            clip_cfg = M.CLIPTextConfig.sd15()
        else:
            raise ValueError(scale)
        gen = torch.Generator(device=device).manual_seed(seed)
        unet = _unzero_kernels(gen, M.init_unet(gen, unet_cfg, device))
        vae = M.init_vae(gen, vae_cfg, device)
        clip = M.init_clip_text(gen, clip_cfg, device)
        return ModelBundle(
            version="sd1",
            unet_cfg=unet_cfg,
            unet_params=convert.unet_params(unet, device, unet_cfg.compute_dtype),
            vae_cfg=vae_cfg,
            vae_params=convert.vae_params(vae, device, vae_cfg.compute_dtype),
            clip_cfg=clip_cfg,
            clip_params=convert.clip_params(clip, device, clip_cfg.compute_dtype),
            tokenizer=get_tokenizer(vocab_size=clip_cfg.vocab_size),
            tables=S.make_diffusion_tables(),
            device=device,
        )

    @staticmethod
    def from_checkpoint(
        path: str,
        vocab_path: Optional[str] = None,
        dtype: Optional[str] = None,
        *,
        device="cuda",
    ) -> "ModelBundle":
        """Bundle from a CompVis SD checkpoint (``.ckpt`` / ``.pt`` or
        ``.safetensors``; ``models/params.py``) on ``device`` (the GPU unless
        asked otherwise). The configs are the presets the checkpoint's
        version and input width pick; ``clip_layer`` and the tokenizer's
        padding follow the version (SD 2.x's OpenCLIP tokenizer pads with
        0). ``dtype`` (e.g. "bfloat16"): the UNet's weights and compute
        dtype, cast on the host before the move to the device, so the
        device never holds the f32 copy."""
        from complex_prompt_diffusion_tpu_torch.models.params import load_sd_checkpoint

        device = _device(device)
        ck = load_sd_checkpoint(path)
        version = ck["version"]
        (unet_cfg, unet), (vae_cfg, vae), (clip_cfg, clip) = ck["unet"], ck["vae"], ck["clip"]
        del ck
        if dtype is not None:
            unet_cfg = dataclasses.replace(unet_cfg, dtype=dtype)
        unet_params = convert.unet_params(unet, "cpu", getattr(torch, dtype) if dtype else None)
        return ModelBundle(
            version=version,
            unet_cfg=unet_cfg,
            unet_params=_tree_map(lambda a: a.to(device), unet_params),
            vae_cfg=vae_cfg,
            vae_params=convert.vae_params(vae, device),
            clip_cfg=clip_cfg,
            clip_params=convert.clip_params(clip, device),
            tokenizer=get_tokenizer(vocab_path, pad_with_eos=(version == "sd1")),
            tables=S.make_diffusion_tables(),
            device=device,
            clip_layer="last" if version == "sd1" else "penultimate",
        )

    @staticmethod
    def from_jax_params(
        unet_cfg, unet_params, vae_cfg, vae_params, clip_cfg, clip_params,
        *, device="cuda", tokenizer=None, version: str = "sd1",
        parameterization: str = "eps", clip_layer: Optional[str] = None,
        tables=None,
    ) -> "ModelBundle":
        """Bundle from the JAX package's configs and parameter trees (any
        objects with the same fields; arrays as numpy or JAX arrays),
        through ``convert.py``, on ``device`` (the GPU unless asked
        otherwise). Weights keep their dtypes. ``parameterization`` ("eps"
        or "v") is the model's output, as the JAX bundle's field of that
        name; ``clip_layer`` defaults to "last" for "sd1" and "penultimate"
        otherwise, as the JAX package picks it; ``tables``: the diffusion
        tables (any object with their fields; default: SD's). The tokenizer
        pads with EOS for "sd1" and with 0 otherwise. :meth:`from_jax_bundle`
        takes all four from a JAX bundle."""
        if parameterization not in ("eps", "v"):
            raise ValueError(f"unknown parameterization {parameterization!r} (eps|v)")
        device = _device(device)
        ucfg = convert.config_from(M.UNetConfig, unet_cfg)
        vcfg = convert.config_from(M.VAEConfig, vae_cfg)
        ccfg = convert.config_from(M.CLIPTextConfig, clip_cfg)
        return ModelBundle(
            version=version,
            unet_cfg=ucfg,
            unet_params=convert.unet_params(unet_params, device),
            vae_cfg=vcfg,
            vae_params=convert.vae_params(vae_params, device),
            clip_cfg=ccfg,
            clip_params=convert.clip_params(clip_params, device),
            tokenizer=tokenizer or get_tokenizer(
                vocab_size=ccfg.vocab_size, pad_with_eos=(version == "sd1")
            ),
            tables=S.make_diffusion_tables() if tables is None else convert.tables_from(tables),
            device=device,
            parameterization=parameterization,
            clip_layer=clip_layer or ("last" if version == "sd1" else "penultimate"),
        )

    @staticmethod
    def from_jax_bundle(jax_bundle, *, device="cuda", tokenizer=None) -> "ModelBundle":
        """:meth:`from_jax_params` on a JAX package bundle (any object with
        its fields, read by attribute): configs, parameter trees,
        ``version``, ``parameterization``, ``clip_layer`` and, where it has
        them, the diffusion ``tables`` (a YAML's betas). A v-model stays
        "v" and samples as one."""
        jb = jax_bundle
        return ModelBundle.from_jax_params(
            jb.unet_cfg, jb.unet_params, jb.vae_cfg, jb.vae_params, jb.clip_cfg,
            jb.clip_params, device=device, tokenizer=tokenizer, version=jb.version,
            parameterization=jb.parameterization, clip_layer=jb.clip_layer,
            tables=getattr(jb, "tables", None),
        )

    def cast(self, dtype: str) -> "ModelBundle":
        """UNet weights and compute dtype to ``dtype`` (e.g. "bfloat16")."""
        dt = getattr(torch, dtype)
        return dataclasses.replace(
            self,
            unet_params=_tree_map(lambda a: a.to(dt), self.unet_params),
            unet_cfg=dataclasses.replace(self.unet_cfg, dtype=dtype),
        )

    def cast_vae(self, dtype: str) -> "ModelBundle":
        """VAE weights and compute dtype to ``dtype``: ``vae_encode`` and
        ``vae_decode`` cast their input to it and return f32, so "bfloat16"
        runs the whole autoencoder in bf16 (decoded pixels move by about
        1/255 against the f32 decode)."""
        dt = getattr(torch, dtype)
        return dataclasses.replace(
            self,
            vae_params=_tree_map(lambda a: a.to(dt), self.vae_params),
            vae_cfg=dataclasses.replace(self.vae_cfg, dtype=dtype),
        )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Typed render options (same fields and validation as the JAX
    package's RenderConfig)."""

    steps: int = 50
    sampler: str = "DDIM"
    guidance_scale: float = 7.5
    width: int = 512
    height: int = 512
    batch_size: int = 1
    seed: int = 0
    eta: float = 0.0
    temperature: float = 1.0
    discretize: str = "uniform"  # uniform | quad | jumps
    sigma_schedule: str = "default"
    sigma_min: Optional[float] = None
    sigma_max: Optional[float] = None
    rho: float = 7.0
    clip_sample: Optional[str] = None
    clip_sample_thresh: float = 90.0
    s_churn: float = 0.0
    s_tmin: float = 0.0
    s_tmax: float = float("inf")
    s_noise: float = 1.0
    denoising_strength: float = 0.75
    unet_tile: int = 0
    unet_tile_stride: int = 0
    unet_tile_chunk: int = 1
    tome_ratio: float = 0.0
    tome_mode: str = "downsample"
    deepcache_interval: int = 0
    deepcache_block: Optional[int] = None
    unet_batch_chunk: int = 0
    solver_order: int = 2
    solver_method: str = "multistep"
    unipc_variant: str = "bh2"
    guidance: GuidanceConfig = GuidanceConfig()

    def __post_init__(self):
        if self.unet_batch_chunk < -1:
            raise ValueError(
                f"unet_batch_chunk must be >= -1, got {self.unet_batch_chunk}"
            )
        if not 1 <= self.solver_order <= 3:
            raise ValueError(
                f"solver_order must be 1-3, got {self.solver_order}"
            )
        if self.solver_method not in ("multistep", "singlestep", "adaptive"):
            raise ValueError(
                f"unknown solver_method {self.solver_method!r} "
                "(multistep|singlestep|adaptive)"
            )
        if self.solver_method == "adaptive" and self.solver_order < 2:
            raise ValueError("adaptive solver_method requires solver_order 2-3")
        if self.unipc_variant not in ("bh1", "bh2", "vary_coeff"):
            raise ValueError(
                f"unknown unipc_variant {self.unipc_variant!r} "
                "(bh1|bh2|vary_coeff)"
            )
        if self.tome_ratio > 0.0 and self.tome_mode not in (
            "downsample", "merge"
        ):
            raise ValueError(
                f"unknown tome_mode {self.tome_mode!r} (downsample|merge)"
            )
        if self.deepcache_interval >= 2:
            if self.sampler.lower() not in DEEPCACHE_SAMPLERS:
                raise ValueError(
                    f"deepcache_interval is not supported with sampler "
                    f"{self.sampler!r} (the feature cache is carried "
                    f"through the sampling scan); supported: "
                    f"{sorted(DEEPCACHE_SAMPLERS)}"
                )
            if self.unet_tile:
                raise ValueError(
                    "deepcache_interval is incompatible with unet_tile"
                )
            if self.guidance.attn_guide:
                raise ValueError(
                    "deepcache_interval is incompatible with attn_guide"
                )
        # RenderConfig(guidance_scale=9) without an explicit GuidanceConfig
        # propagates into the guidance config
        if (
            self.guidance == GuidanceConfig()
            and self.guidance_scale != GuidanceConfig().guidance_scale
        ):
            object.__setattr__(
                self, "guidance",
                dataclasses.replace(self.guidance, guidance_scale=self.guidance_scale),
            )

    @property
    def latent_shape(self) -> Tuple[int, int, int]:
        return (self.height // 8, self.width // 8, 4)


@torch.inference_mode()
def encode_prompt(bundle: ModelBundle, text: Union[str, list]) -> torch.Tensor:
    """Text -> CLIP conditioning f32 [N, 77, D] on the bundle's device."""
    tokens = torch.as_tensor(bundle.tokenizer(text), device=bundle.device)
    return M.clip_text_apply(
        bundle.clip_cfg, bundle.clip_params, tokens, layer=bundle.clip_layer
    )


def make_guidance_spec(
    bundle: ModelBundle,
    prompt: str,
    negative_prompt: str = "",
    scale: float = 1.0,
) -> GuidanceSpec:
    """Plain single-prompt CFG spec."""
    cond = encode_prompt(bundle, prompt)[0]
    uncond = encode_prompt(bundle, negative_prompt)[0]
    return GuidanceSpec.single(cond, uncond, scale)


def _check_render(bundle: ModelBundle, cfg: RenderConfig, depth_mask=None) -> None:
    """Raise, before any launch, for tiled inference with attention
    guidance (a ValueError, as in the JAX package) and for a concat UNet
    whose conditioning channels do not fill its input: in_channels must
    equal out_channels plus ``depth_mask``'s channels (so a concat UNet
    without its conditioning raises; it does not render unconditioned)."""
    if cfg.unet_tile and cfg.guidance.attn_guide:
        raise ValueError(
            "tiled UNet inference (unet_tile) is incompatible with "
            "attention-saliency guidance (skip tensors span the full canvas)"
        )
    ucfg = bundle.unet_cfg
    extra = 0 if depth_mask is None else depth_mask.shape[-1]
    if ucfg.in_channels != ucfg.out_channels + extra:
        raise ValueError(
            f"the UNet takes {ucfg.in_channels} input channels: {ucfg.out_channels} latent "
            f"channels and {extra} of depth_mask give {ucfg.out_channels + extra}"
            + ("; a concat-conditioned UNet needs its conditioning (inpaint, depth2img, "
               "upscale_latents)" if depth_mask is None else "")
        )


def _sigma_schedule(bundle: ModelBundle, cfg: RenderConfig) -> np.ndarray:
    kwargs = {}
    if cfg.sigma_min is not None:
        kwargs["sigma_min"] = cfg.sigma_min
    if cfg.sigma_max is not None:
        kwargs["sigma_max"] = cfg.sigma_max
    if cfg.sigma_schedule == "karras":
        kwargs.setdefault("sigma_min", float(bundle.tables.sigmas[0]))
        kwargs.setdefault("sigma_max", float(bundle.tables.sigmas[-1]))
        kwargs["rho"] = cfg.rho
    return S.make_sigma_schedule(
        cfg.sigma_schedule, cfg.steps, model_sigmas=bundle.tables.sigmas, **kwargs
    )


def _cut_sigmas(bundle: ModelBundle, cfg: RenderConfig, t_start) -> np.ndarray:
    """The sigma schedule, cut to its last ``t_start`` steps when given."""
    sigmas = _sigma_schedule(bundle, cfg)
    if t_start is not None:
        sigmas = sigmas[len(sigmas) - 1 - t_start:]
    return sigmas


def initial_noise(bundle: ModelBundle, cfg: RenderConfig, generator: torch.Generator,
                  t_start: Optional[int] = None) -> torch.Tensor:
    """The start :func:`sample_latents` draws when it is given none: x_T ~
    N(0, 1) of shape [B, h, w, 4] from ``generator``, scaled by the first
    sigma of the (cut) schedule for the sigma family, as the JAX package's
    ``sample_latents`` scales its draw."""
    shape = (cfg.batch_size,) + cfg.latent_shape
    x = torch.randn(shape, generator=generator, device=bundle.device)
    if get_sampler(cfg.sampler)[0] == "sigma":
        x = x * float(_cut_sigmas(bundle, cfg, t_start)[0])
    return x


def _run_sigma_sampler(sample_fn, den_fn, x, bundle, cfg, t_start, generator, noises,
                       den_state=None, loglik_steps=None):
    """The sigma-family call: the schedule cut to its last ``t_start``
    steps, the per-step scales, churn arguments for euler/heun/dpm2, eta
    for the ancestral samplers, the DeepCache state and the "Log"
    sampler's RK4 steps when given."""
    sigmas = _cut_sigmas(bundle, cfg, t_start)
    kw = {}
    name = cfg.sampler.lower()
    if name in ("euler", "huen", "heun", "dpm2"):
        kw.update(s_churn=cfg.s_churn, s_tmin=cfg.s_tmin, s_tmax=cfg.s_tmax,
                  s_noise=cfg.s_noise)
    if "ancestral" in name:
        kw["eta"] = cfg.eta if cfg.eta else 1.0
    if den_state is not None:
        kw["den_state"] = den_state
    if loglik_steps is not None:
        kw["steps"] = loglik_steps
    uc_scales = make_uc_scale_schedule(cfg.guidance, len(sigmas) - 1)
    x0, _ = sample_fn(den_fn, x, sigmas, uc_scales, generator=generator, noises=noises, **kw)
    return x0


def _v_to_eps(tables, device):
    """to_eps(out, x, t): a v-model's output as eps for the t family, eps =
    sqrt(a_t) v + sqrt(1 - a_t) x at the integer timestep t, clipped to the
    table (the JAX package's ``_to_eps``), f32 on the device."""
    sqrt_ac = torch.as_tensor(np.asarray(tables.sqrt_alphas_cumprod, np.float32), device=device)
    sqrt_1m = torch.as_tensor(
        np.asarray(tables.sqrt_one_minus_alphas_cumprod, np.float32), device=device)

    def to_eps(out, x, t):
        ti = torch.clamp(torch.as_tensor(t, device=device).to(torch.int32).reshape(-1), 0,
                         sqrt_ac.shape[0] - 1).long()
        a = sqrt_ac[ti].reshape(-1, 1, 1, 1)
        b = sqrt_1m[ti].reshape(-1, 1, 1, 1)
        return a * out + b * x[..., : out.shape[-1]]

    return to_eps


def _t_index(itables, t) -> tuple:
    """(table index, host value) of the t family's timestep ``t`` (a host
    read of a device scalar); the index as the JAX package finds it:
    searchsorted, clipped."""
    timesteps = np.asarray(itables.timesteps)
    t_host = np.asarray(t.cpu() if torch.is_tensor(t) else t).reshape(-1)[0]
    return int(np.clip(np.searchsorted(timesteps, t_host), 0, len(timesteps) - 1)), t_host


def _t_family_callback(eps_fn, itables, step_callback):
    """eps_fn with the step callback: x0 = (x - sqrt(1 - a_t) e_t) /
    sqrt(a_t) at the evaluation's timestep, from the inference tables.
    The rest of the call passes through, a stateful eps_fn's state too."""
    a_t = np.asarray(itables.alphas_cumprod_t, np.float32)
    s1m = np.asarray(itables.sqrt_one_minus_alphas_cumprod_t, np.float32)

    def eps_cb(x, t, *rest):
        out = eps_fn(x, t, *rest)
        e_t = out[0] if isinstance(out, tuple) else out
        idx, t_host = _t_index(itables, t)
        x0 = (x[..., : e_t.shape[-1]] - float(s1m[idx]) * e_t) / float(np.sqrt(a_t[idx]))
        step_callback(np.asarray(t_host), x0.cpu().numpy())
        return out

    return eps_cb


def _sigma_family_callback(den_fn, step_callback):
    """den_fn with the step callback: (sigma, denoised) at every call. The
    rest of the call passes through, a stateful den_fn's state too."""

    def den_cb(x, sigma, *rest):
        out = den_fn(x, sigma, *rest)
        denoised = out[0] if isinstance(out, tuple) else out
        step_callback(np.asarray(np.float32(sigma)), denoised.detach().cpu().numpy())
        return out

    return den_cb


def sample_latents(
    bundle: ModelBundle,
    spec: GuidanceSpec,
    cfg: RenderConfig,
    *,
    x_init: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    noises: Optional[torch.Tensor] = None,
    t_start: Optional[int] = None,
    step_callback=None,
    depth_mask=None,
    loglik_steps: Optional[int] = None,
    clip_guidance=None,
) -> torch.Tensor:
    """Run the configured sampler with CFG; returns final latents f32
    [B, h, w, 4] (unscaled model space). ``generator`` (default: seeded from
    ``cfg.seed``) draws x_T unless ``x_init`` is given (:func:`initial_noise`:
    a sigma-family sampler scales the draw by its first sigma), then the
    per-step noises unless ``noises`` is given. ``depth_mask`` ([h, w, c] or
    [1 | B, h, w, c]): a concat-conditioned UNet's extra input channels, in
    every family (the UNet must take 4 + c channels). ``t_start``
    (img2img): run only the first
    ``t_start`` timesteps of the DDIM table, or the last ``t_start`` steps
    of the sigma schedule; PLMS, like the JAX package's, ignores it and runs
    its whole schedule. The solver family (DPM-Solver, UniPC: order
    ``cfg.solver_order``, ``cfg.solver_method`` or ``cfg.unipc_variant``)
    calls the UNet at fractional timesteps (t_cont - 1/N) * 1000 with the
    constant guidance scale, as do iPNDM and Blur; Blur needs a square
    canvas and, unlike the JAX package's (which draws its own), starts from
    ``x_init`` when given. ``step_callback(t, x0)`` (numpy arrays) is called
    at every denoiser evaluation of the t and sigma families, as in the JAX
    package; the other families do not call it. A v-model's output is
    converted as the module docstring says. The guidance switches of
    ``cfg.guidance`` (dynamic scale clip, ``threshold_e``) apply in every
    family; as in the JAX package, only the t family passes the
    unconditional-blur flags (``uc_blur``) and takes ``cfg.clip_sample``,
    the other families ignore both; so with ``attn_guide``, which guides the
    t family's last ``attn_guide_rounds`` steps (refused with ``unet_tile``).
    ``tome_ratio`` > 0 renders with a copy of the UNet config switched to
    ``tome_ratio`` / ``tome_mode``; ``deepcache_interval`` >= 2 runs the full
    UNet on every N-th step and its shallow pass (``deepcache_block``)
    between; ``unet_tile`` folds the UNet over overlapping tiles
    (``models/tiled.py``), ``unet_tile_chunk`` tiles a call.

    The "Log" sampler returns the log-likelihoods [B] of ``x_init`` (or of
    the drawn x_T) instead of latents, as the JAX package's does: it takes
    the UNet's vector-Jacobian product, so it runs in grad mode on copies
    of the inputs made outside inference mode (``spec``, ``x_init``,
    ``noises``, ``depth_mask``; ``noises`` is its Hutchinson probe). It
    integrates with dopri5, the JAX package's route, or with the
    fixed-grid RK4 of ``loglik_steps`` steps when given (the port's
    ``sample_log_likelihood(steps=)``, which the JAX package's
    ``sample_latents`` does not reach).

    ``clip_guidance``: (vision_cfg, vision_params, text_embedding,
    ``ClipGuidanceConfig``) guides the t family (DDIM, PLMS) by a guide
    CLIP's gradient, as the JAX package's ``eps_fn`` does: on every step
    whose integer timestep divides by ``freq`` (uniform DDIM timesteps are
    odd, so a ``freq`` >= 2 guides none of them) the CFG eps (after
    attention guidance, when on) is corrected by
    ``guidance/clip_guidance.py`` with the eps inside the loss re-run
    through the UNet on the first ``factor_limit`` prompt factors (mask
    times scale, ``depth_mask`` concatenated) under grad. The other
    families ignore it, as in the JAX package. The cross-attention k/v are
    not hoisted (the guided call has another batch and context), and
    ``deepcache_interval`` >= 2 raises ValueError. The guided render runs
    outside inference mode without grad, on copies of its input tensors;
    only the guide's loss records a graph."""
    if clip_guidance is not None and cfg.deepcache_interval >= 2:
        raise ValueError(
            "deepcache_interval is incompatible with CLIP guidance (the "
            "guidance gradient re-runs the UNet outside the cached scan)"
        )
    family, sample_fn = get_sampler(cfg.sampler)
    guided = clip_guidance is not None and family == "t"
    kw = dict(x_init=x_init, generator=generator, noises=noises, t_start=t_start,
              step_callback=step_callback, depth_mask=depth_mask, loglik_steps=loglik_steps,
              clip_guidance=clip_guidance if guided else None)
    if sample_fn is not sample_log_likelihood:
        if loglik_steps is not None:
            raise ValueError(f"loglik_steps is the \"Log\" sampler's; got sampler "
                             f"{cfg.sampler!r}")
        if not guided:
            with torch.inference_mode():
                return _sample_latents(bundle, spec, cfg, **kw)
    # "Log" takes the UNet's VJP, and CLIP guidance its guide's gradient:
    # no inference tensor (what encode_prompt and the other entry points
    # return) where autograd saves one; CLIP guidance records a graph only
    # inside its guide
    with torch.inference_mode(False), torch.set_grad_enabled(not guided):
        spec = GuidanceSpec(*(t.clone() for t in (spec.uncond, spec.factors, spec.scales,
                                                  spec.masks)))
        kw = {k: v.clone() if torch.is_tensor(v) else v for k, v in kw.items()}
        return _sample_latents(bundle, spec, cfg, **kw).detach()


def _sample_latents(bundle, spec, cfg, *, x_init, generator, noises, t_start, step_callback,
                    depth_mask, loglik_steps, clip_guidance) -> torch.Tensor:
    """:func:`sample_latents` in the grad mode its caller chose."""
    device = bundle.device
    depth_mask = _as_device_tensor(depth_mask, bundle)
    _check_render(bundle, cfg, depth_mask)
    family, sample_fn = get_sampler(cfg.sampler)
    if cfg.tome_ratio > 0.0 and (bundle.unet_cfg.tome_ratio != cfg.tome_ratio
                                 or bundle.unet_cfg.tome_mode != cfg.tome_mode):
        # token reduction is a UNet config switch: this render's copy
        bundle = dataclasses.replace(bundle, unet_cfg=dataclasses.replace(
            bundle.unet_cfg, tome_ratio=cfg.tome_ratio, tome_mode=cfg.tome_mode))
    div = 2 ** (len(bundle.unet_cfg.channel_mult) - 1)
    lh, lw = cfg.latent_shape[0], cfg.latent_shape[1]
    if lh % div or lw % div or cfg.height % 8 or cfg.width % 8:
        raise ValueError(
            f"width/height must give latents divisible by {div} "
            f"(got latent {lh}x{lw} from {cfg.height}x{cfg.width}); "
            f"use multiples of {8 * div} pixels"
        )
    if family == "blur" and lh != lw:
        raise ValueError(
            "Blur sampler requires a square canvas (the spectral "
            f"operator diagonalizes on a square grid; got {lh}x{lw})"
        )
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(cfg.seed)
    if x_init is not None:
        x_T = torch.as_tensor(x_init, dtype=torch.float32, device=device)
    else:
        x_T = initial_noise(bundle, cfg, generator, t_start)

    ucfg, params, shard = bundle.unet_cfg, bundle.unet_params, bundle.shard
    gcfg = cfg.guidance
    # tiled inference on a bundle sharded over a data axis alone: the tiles
    # shard over that axis (one canvas all-reduce a UNet call), each rank's
    # UNet calls local (the JAX package's tile-mesh branch); tiles under
    # tensor parallelism run every tile on every rank
    tile_mesh = tile_axis = None
    if (cfg.unet_tile and shard is not None and shard.axis_size(shard.data_axis) > 1
            and shard.model_size == 1):
        tile_mesh, tile_axis, shard = shard.mesh, shard.data_axis, None
    # cross-attention k/v are loop-invariant: computed once per render,
    # except where the UNet sees another batch or context mid-step (tiles,
    # attention guidance's unconditional pass, CLIP guidance's factor
    # pass), as in the JAX package
    cross_kv = None
    if not (cfg.unet_tile or gcfg.attn_guide or clip_guidance is not None):
        cross_kv = M.precompute_cross_kv(ucfg, params, stacked_context(spec, x_T.shape[0]))

    def unet_eps(x, t, ctx):
        return M.unet_apply(ucfg, params, x, t, ctx, cross_kv=cross_kv, shard=shard)

    if cfg.unet_tile:
        unet_eps = make_tiled_unet(unet_eps, cfg.unet_tile, cfg.unet_tile_stride or None,
                                   max(cfg.unet_tile_chunk, 1), mesh=tile_mesh,
                                   axis=tile_axis or "data")
    dc_pair = None
    if cfg.deepcache_interval >= 2:
        # RenderConfig has checked the sampler (DEEPCACHE_SAMPLERS) and that
        # neither tiles nor attention guidance are on; one wide call, as the
        # JAX package's off its TPU (no batch chunking)
        dc_pair = M.make_deepcache_unets(ucfg, params, cfg.deepcache_block, cross_kv=cross_kv,
                                         shard=shard)
    # the state before the first step: never read (step 0 is a full pass)
    dc_state0 = x_T.new_zeros(0) if dc_pair is not None else None

    eps_fn, den_fn = make_denoiser(
        unet_eps, spec, gcfg=gcfg, model_sigmas=bundle.tables.sigmas,
        parameterization=bundle.parameterization, depth_mask=depth_mask,
    )
    uc = gcfg.guidance_scale
    if family == "sigma":
        if dc_pair is not None:
            den_fn = make_denoiser_deepcache(
                *dc_pair, spec, interval=cfg.deepcache_interval, gcfg=gcfg,
                model_sigmas=bundle.tables.sigmas, parameterization=bundle.parameterization,
                depth_mask=depth_mask)
        if step_callback is not None:
            den_fn = _sigma_family_callback(den_fn, step_callback)
        return _run_sigma_sampler(
            sample_fn, den_fn, x_T, bundle, cfg, t_start, generator, noises, den_state=dc_state0,
            loglik_steps=loglik_steps,
        )
    if family == "solver":
        ns = NoiseScheduleVP("discrete", alphas_cumprod=bundle.tables.alphas_cumprod)
        kw = {"order": cfg.solver_order}
        if sample_fn is sample_unipc:
            kw["variant"] = cfg.unipc_variant
        else:
            kw["method"] = cfg.solver_method
        step = np.float32(1.0 / ns.total_N)

        def model_fn(x, t_cont):
            # the fractional timestep, in f32 as the JAX package computes it
            t_disc = (np.float32(t_cont) - step) * np.float32(1000.0)
            return eps_fn(x, t_disc, uc)

        return sample_fn(model_fn, x_T, ns, steps=cfg.steps, **kw)
    if family == "trig":
        return sample_fn(eps_fn, x_T, cfg.steps, uc)[0]
    if family == "blur":
        n = cfg.steps

        def eps_model(x, i):
            # blur index i in 1..n -> the trained timestep grid
            return eps_fn(x, np.float32(i) / np.float32(n) * np.float32(999.0), uc)

        return sample_fn(eps_model, BlurDiffusion(n=n, resolution=lh), x_T.shape,
                         generator=generator, x_T=x_T, noises=noises)
    itables = S.make_inference_tables(
        bundle.tables, cfg.steps, eta=cfg.eta, discretize=cfg.discretize
    )
    to_eps = (_v_to_eps(bundle.tables, device) if bundle.parameterization == "v"
              else lambda out, x, t: out)

    def unet_eps_t(x, t, ctx):
        return to_eps(unet_eps(x, t, ctx), x, t)

    if bundle.parameterization == "v":
        eps_fn, _ = make_denoiser(unet_eps_t, spec, gcfg=gcfg, depth_mask=depth_mask)
    if gcfg.attn_guide:
        eps_fn = _attn_guided_eps(eps_fn, unet_eps_t, to_eps, ucfg, params, shard, spec, itables,
                                  gcfg, depth_mask)
    if clip_guidance is not None:
        eps_fn = _clip_guided_eps(eps_fn, unet_eps_t, bundle, spec, itables, clip_guidance,
                                  depth_mask)
    kw = {"t_start": t_start} if sample_fn is sample_ddim else {}
    if dc_pair is not None:
        raw_full, raw_shallow = dc_pair
        interval = cfg.deepcache_interval

        def unet_full(x_in, t_in, ctx):
            out, deep = raw_full(x_in, t_in, ctx)
            return to_eps(out, x_in, t_in), deep

        def unet_shallow(x_in, t_in, ctx, deep):
            return to_eps(raw_shallow(x_in, t_in, ctx, deep), x_in, t_in)

        def eps_fn(x, t, uc_scale, blur_on, i, deep):
            return cfg_epsilon_deepcache(
                unet_full, unet_shallow, x, t, spec, uc_scale, (i % interval) == 0, deep,
                gcfg=gcfg, depth_mask=depth_mask, uc_blur_on=blur_on)

        kw["eps_state"] = dc_state0
    uc_scales = make_uc_scale_schedule(gcfg, itables.num_steps)
    if step_callback is not None:
        eps_fn = _t_family_callback(eps_fn, itables, step_callback)
    x0, _ = sample_fn(
        eps_fn, x_T, itables, uc_scales,
        generator=generator, noises=noises,
        uc_blur_flags=make_uc_blur_schedule(gcfg, itables.num_steps),
        temperature=cfg.temperature, clip_sample=cfg.clip_sample,
        clip_sample_thresh=cfg.clip_sample_thresh, **kw,
    )
    return x0


def _attn_guided_eps(base_eps, unet_eps, to_eps, ucfg, params, shard, spec, itables, gcfg,
                     depth_mask):
    """The t family's eps model under attention-saliency guidance: on the
    last ``attn_guide_rounds`` table indices (idx = searchsorted(timesteps,
    t), as the JAX package gates) :func:`cfg_epsilon_attn_guided` with the
    step's f32 coefficients, else ``base_eps``. ``unet_eps`` (x, t, ctx) ->
    eps, ``to_eps`` the v-model conversion of the skips call. The gate reads
    the step's timestep to the host: one sync an evaluation."""
    a_t = np.asarray(itables.alphas_cumprod_t, np.float32)
    s1m = np.asarray(itables.sqrt_one_minus_alphas_cumprod_t, np.float32)

    def unet_eps_skips(x, t, ctx):
        out, skips = M.unet_apply(ucfg, params, x, t, ctx, return_skips=True, shard=shard)
        return to_eps(out, x, t), skips

    def eps_fn(x, t, uc_scale, blur_on):
        idx, _ = _t_index(itables, t)
        if idx < gcfg.attn_guide_rounds:
            return cfg_epsilon_attn_guided(
                unet_eps, unet_eps_skips, x, t, spec, uc_scale, (a_t[idx], s1m[idx]),
                gcfg=gcfg, depth_mask=depth_mask, uc_blur_on=blur_on)
        return base_eps(x, t, uc_scale, blur_on)

    return eps_fn


def _clip_guided_eps(base_eps, unet_eps, bundle, spec, itables, clip_guidance, depth_mask):
    """The t family's eps model under CLIP guidance (the JAX package's
    ``eps_fn``): ``base_eps`` (CFG, or attention-guided CFG), then on the
    steps whose integer timestep divides by ``freq`` the correction of
    :func:`make_clip_guidance` with a_t from the table (idx = searchsorted,
    as :func:`_t_index`) and the eps inside its loss re-run through
    ``unet_eps`` on the first ``factor_limit`` factors, mask times scale.
    The gate reads the step's timestep to the host: one sync an
    evaluation."""
    vision_cfg, vision_params, text_emb, cg_cfg = clip_guidance
    a_t = np.asarray(itables.alphas_cumprod_t, np.float32)
    k = min(max(int(cg_cfg.factor_limit), 1), spec.num_factors)
    weights = spec.masks[:k, None] * spec.scales[:k].reshape(k, 1, 1, 1, 1)

    def vae_dec(z):
        return M.vae_decode(bundle.vae_cfg, bundle.vae_params, z)

    def eps_fn(x, t, uc_scale, blur_on):
        e_t = base_eps(x, t, uc_scale, blur_on)
        idx, t_host = _t_index(itables, t)
        if not (cg_cfg.freq > 0 and int(t_host) % max(cg_cfg.freq, 1) == 0):
            return e_t

        def factor_eps(x_):
            b = x_.shape[0]
            x_in = x_.repeat(k, 1, 1, 1)
            if depth_mask is not None:
                x_in = torch.cat([x_in, depth_mask.to(x_in.dtype).expand(
                    x_in.shape[:3] + depth_mask.shape[-1:])], dim=-1)
            t_in = torch.as_tensor(t, device=x_.device).reshape(1).expand(b * k)
            ctx_in = spec.factors[:k].repeat_interleave(b, dim=0)
            out = unet_eps(x_in, t_in, ctx_in)
            return (weights * out.reshape((k, b) + tuple(out.shape[1:]))).sum(dim=0)

        guide = make_clip_guidance(vae_dec, vision_cfg, vision_params, text_emb, cg_cfg,
                                   LATENT_SCALE, eps_in_grad_fn=factor_eps)
        return guide(x, e_t, a_t[idx])

    return eps_fn


@torch.inference_mode()
def decode_latents(bundle: ModelBundle, latents: torch.Tensor) -> np.ndarray:
    """Latents -> uint8 NHWC images (/0.18215, VAE decode, [-1,1] ->
    [0,255] with round-half-even)."""
    z = torch.as_tensor(latents, dtype=torch.float32, device=bundle.device)
    img = M.vae_decode(bundle.vae_cfg, bundle.vae_params, z / LATENT_SCALE)
    img = torch.clamp((img + 1.0) / 2.0, 0.0, 1.0)
    return torch.round(img * 255).to(torch.uint8).cpu().numpy()


def _spec(bundle: ModelBundle, prompt, negative_prompt: str = "") -> GuidanceSpec:
    """A prompt's guidance spec: a spec as it is, a string through
    :func:`make_guidance_spec`."""
    if isinstance(prompt, GuidanceSpec):
        return prompt
    return make_guidance_spec(bundle, prompt, negative_prompt)


def txt2img(
    bundle: ModelBundle,
    prompt: Union[str, GuidanceSpec],
    negative_prompt: str = "",
    cfg: RenderConfig = RenderConfig(),
    *,
    generator: Optional[torch.Generator] = None,
    noises: Optional[torch.Tensor] = None,
    x_T: Optional[torch.Tensor] = None,
    depth_mask=None,
    decode: bool = True,
    step_callback=None,
):
    """Text to image. ``step_callback(t, x0_pred)``: the optional per-step
    preview hook of :func:`sample_latents` (``samplers/callbacks.py``);
    ``depth_mask``: a concat UNet's conditioning, as there. Returns
    (images_uint8 | None, latents)."""
    spec = _spec(bundle, prompt, negative_prompt)
    latents = sample_latents(
        bundle, spec, cfg, x_init=x_T, generator=generator, noises=noises,
        step_callback=step_callback, depth_mask=depth_mask,
    )
    images = decode_latents(bundle, latents) if decode else None
    return images, latents


def _as_device_tensor(a, bundle: ModelBundle) -> Optional[torch.Tensor]:
    if a is None:
        return None
    return torch.as_tensor(a, dtype=torch.float32, device=bundle.device)


@torch.inference_mode()
def encode_image(
    bundle: ModelBundle,
    image,
    generator: Optional[torch.Generator] = None,
    noise=None,
) -> torch.Tensor:
    """uint8 or float HWC/NHWC image(s) -> scaled latents f32 [N, h, w, 4]
    on the bundle's device. The image is cast to f32 first and mapped from
    [0, 255] to [-1, 1] when its maximum is above 2, whatever its dtype, as
    the JAX package does (a uint8 image with max <= 2 therefore reaches the
    VAE unscaled there, and here). The posterior is sampled with ``noise``
    if given, else with a draw from ``generator``; with neither, its mode."""
    img = _as_device_tensor(image, bundle)
    if img.ndim == 3:
        img = img[None]
    if float(img.max()) > 2.0:
        img = img / 127.5 - 1.0
    post = M.vae_encode(bundle.vae_cfg, bundle.vae_params, img)
    if noise is None and generator is None:
        z = post.mode()
    else:
        z = post.sample(generator, _as_device_tensor(noise, bundle))
    return z * LATENT_SCALE


def img2img_t_enc(strength: float, steps: int, family: str) -> int:
    """Denoise-step count for img2img: ``strength * steps`` for the DDIM
    ("t") family, ``(1 - strength) * steps`` for the k-diffusion family
    (the JAX package keeps both conventions of its reference)."""
    if family == "t":
        return max(1, min(int(min(strength, 0.999) * steps), steps))
    return int((1 - min(strength, 0.999)) * steps)


def img2img(
    bundle: ModelBundle,
    image,
    prompt: Union[str, GuidanceSpec],
    negative_prompt: str = "",
    cfg: RenderConfig = RenderConfig(),
    *,
    generator: Optional[torch.Generator] = None,
    encode_noise=None,
    noise=None,
    noises=None,
    depth_mask=None,
    decode: bool = True,
    step_callback=None,
):
    """Image to image: sample the encoder's posterior, noise the latents and
    run the last part of the reverse chain (``depth_mask``: a concat UNet's
    conditioning, as in :func:`sample_latents`).

    DDIM: to step ``t_enc = img2img_t_enc(cfg.denoising_strength, steps,
    "t")`` with x_t = sqrt(a_t) z0 + sqrt(1 - a_t) noise, then the first
    ``t_enc`` steps of the table. k-diffusion samplers: x_t = z0 + noise *
    sigmas[idx] with ``idx = max(0, steps - t_enc - 1)`` and ``t_enc =
    img2img_t_enc(..., "k")`` (the opposite convention), then the schedule
    from ``idx`` on. ``generator`` (default: seeded from ``cfg.seed``)
    draws the posterior noise, the forward noise and the per-step noises,
    each unless given (``encode_noise``, ``noise``, ``noises``).
    ``step_callback``: as in :func:`sample_latents`. The solver and trig
    families have no partial-noise start and raise ValueError, as in the
    JAX package; PLMS runs its whole schedule from x_t (the JAX package
    passes the start to DDIM only). Returns (images_uint8 | None, latents)."""
    depth_mask = _as_device_tensor(depth_mask, bundle)
    _check_render(bundle, cfg, depth_mask)
    family, _ = get_sampler(cfg.sampler)
    if family in ("solver", "trig"):
        raise ValueError(
            f"img2img is not supported with the {cfg.sampler!r} sampler "
            "(no partial-noise entry point); use a DDIM/PLMS or k-diffusion "
            "sampler"
        )
    spec = _spec(bundle, prompt, negative_prompt)
    if generator is None:
        generator = torch.Generator(device=bundle.device).manual_seed(cfg.seed)
    z0 = encode_image(bundle, image, generator=generator, noise=encode_noise)
    if noise is None:
        noise = torch.randn(z0.shape, generator=generator, device=bundle.device)
    noise = _as_device_tensor(noise, bundle)
    if family == "t":
        itables = S.make_inference_tables(
            bundle.tables, cfg.steps, eta=cfg.eta, discretize=cfg.discretize
        )
        t_enc = img2img_t_enc(cfg.denoising_strength, itables.num_steps, "t")
        a_t = float(itables.alphas_cumprod_t[t_enc - 1])
        x_t = np.sqrt(a_t) * z0 + np.sqrt(1.0 - a_t) * noise
    else:
        sigmas = _sigma_schedule(bundle, cfg)
        # start index into the sigma schedule
        idx = max(0, cfg.steps - img2img_t_enc(cfg.denoising_strength, cfg.steps, "k") - 1)
        x_t = z0 + noise * float(sigmas[idx])
        t_enc = len(sigmas) - 1 - idx
    latents = sample_latents(
        bundle, spec, cfg, x_init=x_t, generator=generator, noises=noises,
        t_start=t_enc, step_callback=step_callback, depth_mask=depth_mask,
    )
    images = decode_latents(bundle, latents) if decode else None
    return images, latents


def inpaint(
    bundle: ModelBundle,
    image,
    mask,
    prompt: Union[str, GuidanceSpec],
    negative_prompt: str = "",
    cfg: RenderConfig = RenderConfig(),
    *,
    generator: Optional[torch.Generator] = None,
    encode_noise=None,
    x_T=None,
    noises=None,
    decode: bool = True,
):
    """The inpaint model's path (``in_channels`` 9; ``UNetConfig.sd_inpaint``,
    ``ModelBundle.random("tiny-inpaint")``): ``mask`` [H, W] (or [H, W, 1])
    is thresholded at 0.5, mask = 1 marking the hole to regenerate; the
    image with the hole zeroed is encoded (posterior noise ``encode_noise``,
    else drawn from ``generator``), the mask resized to the latent grid
    ("nearest", as ``jax.image.resize``), and ``[mask, masked latents]`` (5
    channels) concatenated to the UNet's input at every step of a txt2img
    run (x_T and per-step noises from ``generator`` unless given). A UNet
    with fewer than 9 input channels raises ValueError: a plain checkpoint
    inpaints by RePaint (the manager picks). Returns (images_uint8 | None,
    latents)."""
    if bundle.unet_cfg.in_channels < 9:
        raise ValueError(
            "bundle is not an inpaint model "
            f"(unet in_channels={bundle.unet_cfg.in_channels}, need 9); "
            "use the RePaint path for plain SD checkpoints"
        )
    spec = _spec(bundle, prompt, negative_prompt)
    if generator is None:
        generator = torch.Generator(device=bundle.device).manual_seed(cfg.seed)
    m = np.asarray(mask, np.float32)
    if m.ndim == 3:
        m = m[..., 0]
    m = (m > 0.5).astype(np.float32)
    masked = np.asarray(image, np.float32) * (1.0 - m)[..., None]
    masked_z = encode_image(bundle, masked, generator=generator, noise=encode_noise)
    lh, lw = masked_z.shape[1], masked_z.shape[2]
    mask_lat = resize(torch.as_tensor(m, device=bundle.device)[None, :, :, None],
                      (1, lh, lw, 1), "nearest")
    concat = torch.cat([mask_lat, masked_z], dim=-1)  # [1, lh, lw, 5]
    latents = sample_latents(bundle, spec, cfg, x_init=x_T, generator=generator,
                             noises=noises, depth_mask=concat)
    images = decode_latents(bundle, latents) if decode else None
    return images, latents


def depth2img(
    bundle: ModelBundle,
    image,
    prompt: Union[str, GuidanceSpec],
    negative_prompt: str = "",
    cfg: RenderConfig = RenderConfig(),
    *,
    estimator=None,
    generator: Optional[torch.Generator] = None,
    encode_noise=None,
    noise=None,
    noises=None,
    decode: bool = True,
):
    """Depth-conditioned img2img (SD-2's depth model, ``in_channels`` 5):
    a depth map of the [H, W, 3] ``image`` from ``estimator`` (default
    ``depth.SobelDepthEstimator``), resized to the latent grid ``(height //
    8, width // 8)`` by ``depth.DepthManager`` and fed as the UNet's fifth
    input channel through :func:`img2img` (its draws and their overrides
    as there). An [N, H, W, 3] ``image`` renders N images, each on its own
    depth map (the JAX package's takes one image)."""
    from complex_prompt_diffusion_tpu_torch.depth import DepthManager

    mgr = DepthManager(estimator=estimator, size=(cfg.height // 8, cfg.width // 8),
                       device=bundle.device)
    img = np.asarray(image)
    depth = (torch.stack([mgr.conditioning_channel(im) for im in img]) if img.ndim == 4
             else mgr.conditioning_channel(img))
    return img2img(bundle, img, prompt, negative_prompt, cfg, generator=generator,
                   encode_noise=encode_noise, noise=noise, noises=noises, depth_mask=depth,
                   decode=decode)


def upscale_latents(
    bundle: ModelBundle,
    low_res_image,
    prompt: Union[str, GuidanceSpec],
    cfg: RenderConfig = RenderConfig(),
    *,
    noise_level: int = 20,
    generator: Optional[torch.Generator] = None,
    aug_noise=None,
    x_T=None,
    noises=None,
    decode: bool = True,
):
    """The latent upscaler's path (``UNetConfig.sd_upscaler``-shaped: 4 +
    the image's channels in): the low-resolution image ([h, w, c] or [N,
    h, w, c]; mapped to [-1, 1] when its max is above 2) resized
    bilinearly to the latent grid (as ``jax.image.resize``), noise-augmented
    to ``noise_level`` (q_sample: sqrt(a) img + sqrt(1 - a) noise, the noise
    ``aug_noise`` or drawn from ``generator``) and concatenated to the UNet's
    input (the first image's) through a txt2img run. As in the JAX package,
    the level reaches the UNet only through those channels: on the preset
    (``num_classes=1000``) ``unet_apply`` raises "class-conditional model
    requires y", because the sampler passes no class label."""
    spec = _spec(bundle, prompt)
    if generator is None:
        generator = torch.Generator(device=bundle.device).manual_seed(cfg.seed)
    img = _as_device_tensor(low_res_image, bundle)
    if img.ndim == 3:
        img = img[None]
    if float(img.max()) > 2.0:
        img = img / 127.5 - 1.0
    lh, lw = cfg.latent_shape[0], cfg.latent_shape[1]
    img = resize(img, (img.shape[0], lh, lw, img.shape[-1]), "bilinear")
    ac = np.asarray(bundle.tables.alphas_cumprod)[noise_level]
    if aug_noise is None:
        aug_noise = torch.randn(img.shape, generator=generator, device=bundle.device)
    img_aug = float(np.sqrt(ac)) * img + float(np.sqrt(1 - ac)) * _as_device_tensor(aug_noise,
                                                                                    bundle)
    latents = sample_latents(bundle, spec, cfg, x_init=x_T, generator=generator,
                             noises=noises, depth_mask=img_aug[0])
    images = decode_latents(bundle, latents) if decode else None
    return images, latents


def render_config_to_json(cfg: RenderConfig) -> dict:
    """The render options as a JSON-able dict: the JAX package's dict for
    the same options."""
    data = dataclasses.asdict(cfg)
    data["guidance"] = dataclasses.asdict(cfg.guidance)
    return data


def render_config_from_json(data: dict) -> RenderConfig:
    """Inverse of :func:`render_config_to_json`; unknown keys are dropped."""
    data = dict(data)
    g = data.pop("guidance", {})
    known_g = {f.name for f in dataclasses.fields(GuidanceConfig)}
    known = {f.name for f in dataclasses.fields(RenderConfig)} - {"guidance"}
    return RenderConfig(
        guidance=GuidanceConfig(**{k: v for k, v in g.items() if k in known_g}),
        **{k: v for k, v in data.items() if k in known},
    )


PARAMS_FILE = "params.pt"


def save_bundle(bundle: ModelBundle, path: str) -> None:
    """Write a bundle to the directory ``path``: its three parameter trees
    with ``torch.save`` (``params.pt``) and ``meta.json`` with the JAX
    package's keys (version, parameterization, clip_layer and the three
    configs). The JAX package stores the trees as an orbax checkpoint; the
    port neither writes nor reads that format. As in the JAX package, the
    diffusion tables are not stored: :func:`load_bundle` rebuilds SD's."""
    import json
    import os

    os.makedirs(path, exist_ok=True)
    torch.save({"unet": bundle.unet_params, "vae": bundle.vae_params,
                "clip": bundle.clip_params}, os.path.join(path, PARAMS_FILE))
    meta = {
        "version": bundle.version,
        "parameterization": bundle.parameterization,
        "clip_layer": bundle.clip_layer,
        "unet_cfg": dataclasses.asdict(bundle.unet_cfg),
        "vae_cfg": dataclasses.asdict(bundle.vae_cfg),
        "clip_cfg": dataclasses.asdict(bundle.clip_cfg),
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def load_bundle(path: str, vocab_path: Optional[str] = None, *, device="cuda") -> ModelBundle:
    """Read a bundle that :func:`save_bundle` wrote onto ``device`` (the GPU
    unless asked otherwise): the trees with ``torch.load(weights_only=True)``,
    the configs from ``meta.json`` (fields the port's configs lack are
    dropped)."""
    import json
    import os

    device = _device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    def _cfg(cls, data):
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in data.items() if k in fields})

    params = torch.load(os.path.join(path, PARAMS_FILE), map_location=device,
                        weights_only=True)
    return ModelBundle(
        version=meta["version"],
        unet_cfg=_cfg(M.UNetConfig, meta["unet_cfg"]),
        unet_params=params["unet"],
        vae_cfg=_cfg(M.VAEConfig, meta["vae_cfg"]),
        vae_params=params["vae"],
        clip_cfg=_cfg(M.CLIPTextConfig, meta["clip_cfg"]),
        clip_params=params["clip"],
        tokenizer=get_tokenizer(vocab_path, pad_with_eos=(meta["version"] == "sd1"),
                                vocab_size=meta["clip_cfg"].get("vocab_size", 49408)),
        tables=S.make_diffusion_tables(),
        device=device,
        parameterization=meta["parameterization"],
        clip_layer=meta["clip_layer"],
    )
