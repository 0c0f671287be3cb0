"""RenderEngine: rendering loops over embedding paths.

Counterpart of ``complex_prompt_diffusion_tpu/render.py``: the frames of a
prompt's transform path (``ComplexPrompt.embedding_path``), rendered one
sampling run and one decode a frame, or with latent feedback (each frame
starts from the previous frame's latent, renoised), and the renoise
helpers ``add_noise`` / ``sqrt_lerp``.

Independent frames run one ``sample_latents`` and one decode each, as the
JAX package's code does (its docstring's "one batched run" is not what it
runs). A ``torch.Generator`` (default: seeded with ``cfg.seed``) takes the
place of the JAX package's per-frame keys: each independent frame, and the
first feedback frame, draws its x_T from it (``pipeline.initial_noise``:
scaled by the first sigma for a sigma-family sampler, as the JAX package's
``sample_latents`` scales the draw it makes from the frame's key) and
passes it as ``x_init``, then its sampler's per-step noises.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from complex_prompt_diffusion_tpu_torch import schedules as S
from complex_prompt_diffusion_tpu_torch.guidance import GuidanceSpec
from complex_prompt_diffusion_tpu_torch.pipeline import (
    ModelBundle,
    RenderConfig,
    decode_latents,
    initial_noise,
    sample_latents,
)

__all__ = ["RenderEngine", "add_noise", "sqrt_lerp", "feedback_start"]


def add_noise(x: torch.Tensor, strength: float, generator: Optional[torch.Generator] = None,
              noise: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x + noise * strength; ``noise`` drawn from ``generator`` unless
    given."""
    if noise is None:
        noise = torch.randn(x.shape, generator=generator, device=x.device, dtype=x.dtype)
    return x + noise * strength


def sqrt_lerp(x, y, a: float):
    """(1 - a) x + sqrt(a) y — the diversity renoise."""
    return (1 - a) * x + np.sqrt(a) * y


def feedback_start(prev_latent: torch.Tensor, itables, denoising_strength: float,
                   coherance: float, diversity: float, noise: torch.Tensor,
                   noise_d: torch.Tensor):
    """The start of a feedback frame, as the JAX package's loop makes it:
    ``prev_latent`` renoised by ``1 - coherance`` (``noise``), pushed toward
    ``noise_d`` by ``diversity`` (when > 0), then noised to table step
    ``t_start = max(1, int((1 - strength) * S))`` with ``noise_d`` again
    (the JAX loop draws both from one key). Returns (x_t, t_start)."""
    x = add_noise(prev_latent, 1.0 - coherance, noise=noise)
    if diversity > 0:
        x = sqrt_lerp(x, noise_d, diversity)
    t_start = max(1, int((1 - denoising_strength) * itables.num_steps))
    a_t = float(itables.alphas_cumprod_t[t_start - 1])
    return np.sqrt(a_t) * x + np.sqrt(1 - a_t) * noise_d, t_start


class RenderEngine:
    """Render a path of conditioning embeddings into frames."""

    def __init__(self, bundle: ModelBundle, cfg: RenderConfig = RenderConfig()):
        self.bundle = bundle
        self.cfg = cfg
        self.render_buffer: List[np.ndarray] = []

    def _spec_for(self, cond, uncond) -> GuidanceSpec:
        dev = self.bundle.device
        return GuidanceSpec.single(torch.as_tensor(cond, dtype=torch.float32, device=dev),
                                   torch.as_tensor(uncond, dtype=torch.float32, device=dev))

    def render_path(
        self,
        prompt,
        lerp_steps: int = 1,
        *,
        generator: Optional[torch.Generator] = None,
        coherance: float = 0.98,
        diversity: float = 0.0,
        feedback: bool = False,
    ) -> List[np.ndarray]:
        """Render ``lerp_steps`` frames along the prompt's transform path;
        returns uint8 [H, W, 3] frames (every image of a batch for
        independent frames, the first of each batch with feedback).

        feedback=False (default): frames are independent. feedback=True:
        each frame after the first starts from the previous frame's latent
        (:func:`feedback_start`: renoised by ``1 - coherance``, pushed
        toward fresh noise by ``diversity``) and runs the last part of the
        DDIM table, from ``t_start``."""
        cfg, b = self.cfg, self.bundle
        if generator is None:
            generator = torch.Generator(device=b.device).manual_seed(cfg.seed)
        path = prompt.embedding_path(steps=lerp_steps, bundle=b)
        uncond = prompt.uncond_embedding(b)

        if not feedback:
            imgs: List[np.ndarray] = []
            for cond in path:
                x_T = initial_noise(b, cfg, generator)
                lat = sample_latents(b, self._spec_for(cond, uncond), cfg, x_init=x_T,
                                     generator=generator)
                imgs.extend(decode_latents(b, lat))
            self.render_buffer.extend(imgs)
            return imgs

        frames = []
        prev_latent = None
        for cond in path:
            spec = self._spec_for(cond, uncond)
            if prev_latent is None:
                x_T = initial_noise(b, cfg, generator)
                lat = sample_latents(b, spec, cfg, x_init=x_T, generator=generator)
            else:
                noise = torch.randn(prev_latent.shape, generator=generator, device=b.device)
                noise_d = torch.randn(prev_latent.shape, generator=generator, device=b.device)
                itables = S.make_inference_tables(b.tables, cfg.steps, eta=cfg.eta)
                x_t, t_start = feedback_start(prev_latent, itables, cfg.denoising_strength,
                                              coherance, diversity, noise, noise_d)
                lat = sample_latents(b, spec, cfg, x_init=x_t, generator=generator,
                                     t_start=t_start)
            prev_latent = lat
            img = decode_latents(b, lat)
            frames.append(img[0])
            self.render_buffer.append(img[0])
        return frames
