"""DiffusionModelManager: the top-level JSON-config API.

Counterpart of ``complex_prompt_diffusion_tpu/manager.py``: a checkpoint (or
a bundle) loaded once, then ``process_txt2img(config)`` /
``process_img2img(img, config, mask=None)`` driven by a JSON config of the
shape ``{"sampler": {"name", "args"}, "prompt" | "prompt_json": {...},
"negative_prompt", "render": {...}}``. ``prompt_json`` is any prompt class's
JSON (``prompts.compose.prompt_from_json``).

As in the JAX package: no fp16-halving pass and no low-VRAM hooks (the
bundle's ``cast`` / ``cast_vae`` set the dtypes); samplers resolve from the
typed registry; the reference's ``score_corrector`` becomes the guidance's
``threshold_e``; a mask runs the inpaint model (``pipeline.inpaint``) on a
9-channel UNet, RePaint (``samplers/repaint.py``) over an ordinary
4-channel one. As in the JAX package, the two read the mask in opposite
senses: mask = 1 is the hole to regenerate for the inpaint model, the
region to keep for RePaint.

The entry points run on the bundle's device. Keyword arguments beyond the
JAX package's are passed on to the pipeline (``generator``, ``x_T``,
``noises``; img2img's ``encode_noise`` and ``noise``; the inpaint
model's ``encode_noise``, ``x_T`` and ``noises``; RePaint's ``x_T``,
``noises`` and ``generator``), which is how tests hold two packages to one
trajectory; by default every draw comes from a generator seeded with the
render's ``seed``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch.guidance import GuidanceConfig
from complex_prompt_diffusion_tpu_torch.pipeline import (
    ModelBundle,
    RenderConfig,
    img2img,
    inpaint,
    txt2img,
)
from complex_prompt_diffusion_tpu_torch.prompts.compose import prompt_from_json
from complex_prompt_diffusion_tpu_torch.samplers import get_sampler
from complex_prompt_diffusion_tpu_torch.utils.resize import resize

__all__ = ["DiffusionModelManager"]


class DiffusionModelManager:
    """Load once, render many. Accepts either a checkpoint path or an
    existing ModelBundle (tests use ``ModelBundle.random`` or a bundle
    converted from the JAX package's). ``device``: where a checkpoint loads
    (the GPU unless asked otherwise)."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        bundle: Optional[ModelBundle] = None,
        cast_dtype: Optional[str] = None,
        vae_dtype: Optional[str] = None,
        vocab_path: Optional[str] = None,
        *,
        device="cuda",
    ):
        if bundle is None:
            if checkpoint_path is None:
                raise ValueError("need checkpoint_path or bundle")
            bundle = ModelBundle.from_checkpoint(checkpoint_path, vocab_path, device=device)
        if cast_dtype:
            bundle = bundle.cast(cast_dtype)
        if vae_dtype:
            bundle = bundle.cast_vae(vae_dtype)
        self.bundle = bundle

    # config assembly ----------------------------------------------------
    def _make_render_config(self, config: Dict[str, Any]) -> RenderConfig:
        sampler_cfg = config.get("sampler", {"name": "DDIM", "args": {}})
        name = sampler_cfg.get("name", "DDIM")
        get_sampler(name)  # validate early
        args = dict(sampler_cfg.get("args", {}))
        render = dict(config.get("render", {}))

        gkwargs = {}
        if "unconditional_guidance_scale" in render:
            gkwargs["guidance_scale"] = render.pop("unconditional_guidance_scale")
        if "scale" in render:
            gkwargs["guidance_scale"] = render.pop("scale")
        # score corrector -> eps thresholding
        corrector = render.pop("score_corrector", None)
        if corrector:
            gkwargs["threshold_e"] = corrector
            if "score_corrector_e_threshold" in render:
                gkwargs["threshold_e_value"] = render.pop("score_corrector_e_threshold")
        render.pop("score_corrector_x_threshold", None)

        known = {f.name for f in dataclasses.fields(RenderConfig)}
        merged = {**args, **render}
        # accept the reference's names for common options
        aliases = {
            "W": "width", "H": "height", "ddim_eta": "eta",
            "n_samples": "batch_size", "scheduler": "sigma_schedule",
        }
        for src, dst in aliases.items():
            if src in merged:
                merged[dst] = merged.pop(src)
        merged = {k: v for k, v in merged.items() if k in known}
        guidance = GuidanceConfig(**gkwargs) if gkwargs else GuidanceConfig()
        return RenderConfig(sampler=name, guidance=guidance, **merged)

    def _make_embedding(self, config: Dict[str, Any]):
        prompt_json = config.get("prompt_json")
        if prompt_json is not None:
            return prompt_from_json(prompt_json, bundle=self.bundle)
        return config.get("prompt", "")

    def _spec_or_text(self, prompt, cfg: RenderConfig):
        if isinstance(prompt, str):
            return prompt
        return prompt.build_spec(cfg.height // 8, cfg.width // 8, self.bundle)

    # entry points -------------------------------------------------------
    def process_txt2img(self, config: Dict[str, Any], **kwargs) -> np.ndarray:
        """Returns uint8 images [B, H, W, 3]. ``kwargs`` go to ``txt2img``
        (``generator``, ``x_T``, ``noises``)."""
        cfg = self._make_render_config(config)
        prompt = self._make_embedding(config)
        imgs, _ = txt2img(self.bundle, self._spec_or_text(prompt, cfg),
                          config.get("negative_prompt", ""), cfg, **kwargs)
        return imgs

    def process_img2img(
        self, img: np.ndarray, config: Dict[str, Any],
        mask: Optional[np.ndarray] = None, **kwargs,
    ) -> np.ndarray:
        """img2img of ``img``; with ``mask``, inpainting: on a 9-channel
        UNet by the inpaint model (``pipeline.inpaint``: mask = 1 is the
        hole), else by RePaint of the region where the mask is 0
        (``config["jump_length"]`` and ``["jump_n_sample"]``, default 10
        each). ``kwargs`` go to ``img2img`` (``generator``, ``encode_noise``,
        ``noise``, ``noises``), to ``inpaint`` (``generator``,
        ``encode_noise``, ``x_T``, ``noises``) or to ``sample_repaint``
        (``generator``, ``x_T``, ``noises``)."""
        cfg = self._make_render_config(config)
        prompt = self._make_embedding(config)
        if mask is not None:
            if self.bundle.unet_cfg.in_channels >= 9:
                imgs, _ = inpaint(self.bundle, img, mask, self._spec_or_text(prompt, cfg),
                                  config.get("negative_prompt", ""), cfg, **kwargs)
                return imgs
            return self._inpaint(img, mask, prompt, cfg, config, **kwargs)
        imgs, _ = img2img(self.bundle, img, self._spec_or_text(prompt, cfg),
                          config.get("negative_prompt", ""), cfg, **kwargs)
        return imgs

    @torch.inference_mode()
    def _inpaint(self, img, mask, prompt, cfg: RenderConfig, config, *,
                 generator: Optional[torch.Generator] = None, x_T=None, noises=None):
        from complex_prompt_diffusion_tpu_torch import models as M
        from complex_prompt_diffusion_tpu_torch.guidance import make_denoiser, stacked_context
        from complex_prompt_diffusion_tpu_torch.pipeline import (
            decode_latents,
            encode_image,
            make_guidance_spec,
        )
        from complex_prompt_diffusion_tpu_torch.samplers import sample_repaint

        b = self.bundle
        spec = (
            make_guidance_spec(b, prompt, config.get("negative_prompt", ""))
            if isinstance(prompt, str)
            else prompt.build_spec(cfg.height // 8, cfg.width // 8, b)
        )
        z0 = encode_image(b, img)  # the posterior's mode
        # the latent-resolution mask; mask == 1 keeps the original
        m = torch.as_tensor(np.asarray(mask, np.float32), device=b.device)
        if m.ndim == 2:
            m = m[None, :, :, None]
        m = resize(m, (1,) + tuple(z0.shape[1:3]) + (1,), "nearest").expand(z0.shape)
        cross_kv = M.precompute_cross_kv(b.unet_cfg, b.unet_params,
                                         stacked_context(spec, z0.shape[0]))

        def unet_eps(x, t, ctx):
            return M.unet_apply(b.unet_cfg, b.unet_params, x, t, ctx, cross_kv=cross_kv,
                                shard=b.shard)

        eps_fn, _ = make_denoiser(unet_eps, spec, gcfg=cfg.guidance)
        if generator is None:
            generator = torch.Generator(device=b.device).manual_seed(cfg.seed)
        lat = sample_repaint(
            eps_fn, z0, m, b.tables,
            steps=cfg.steps,
            jump_length=config.get("jump_length", 10),
            jump_n_sample=config.get("jump_n_sample", 10),
            eta=cfg.eta if cfg.eta else 1.0,
            generator=generator, noises=noises, x_T=x_T,
            uc_scale=cfg.guidance.guidance_scale,
        )
        return decode_latents(b, lat)
