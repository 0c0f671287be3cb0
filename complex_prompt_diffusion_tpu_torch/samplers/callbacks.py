"""Per-step render callbacks.

A numpy copy of ``complex_prompt_diffusion_tpu/samplers/callbacks.py``.
Pass ``step_callback=fn`` to ``txt2img`` / ``img2img`` / ``sample_latents``:
``fn(t, x0)`` receives, at every denoiser evaluation of a DDIM-family or a
sigma-family sampler, the evaluation's time value (t-family: the timestep;
sigma-family: sigma) and the predicted-x0 latents, as numpy arrays. The
port's step loop is Python, so the hook is a plain call that copies x0 to
the host, made only when a callback is given.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

__all__ = ["make_render_callback", "latent_preview"]


def latent_preview(x0: np.ndarray) -> np.ndarray:
    """Cheap latent -> uint8 preview without the VAE: the first three latent
    channels of the first image, normalized between their 1st and 99th
    percentiles into [0, 255]."""
    x = np.asarray(x0, np.float32)
    if x.ndim == 4:
        x = x[0]
    rgb = x[..., :3] if x.shape[-1] >= 3 else np.repeat(x[..., :1], 3, -1)
    lo, hi = np.percentile(rgb, 1), np.percentile(rgb, 99)
    rgb = (rgb - lo) / max(hi - lo, 1e-6)
    return np.clip(rgb * 255.0, 0, 255).astype(np.uint8)


def make_render_callback(
    display_fn: Optional[Callable] = None, every: int = 1
) -> Callable:
    """A ``step_callback`` that turns every ``every``-th x0 prediction into
    a uint8 preview and hands it to ``display_fn(t, image)`` (default: keep
    the images on ``cb.frames``). Exceptions raised by ``display_fn`` are
    kept on ``cb.errors`` instead of propagating: a broken preview must not
    end a render."""
    frames = []

    def cb(t, x0):
        cb.count += 1
        if (cb.count - 1) % max(every, 1):
            return
        img = latent_preview(np.asarray(x0))
        if display_fn is not None:
            try:
                display_fn(np.asarray(t), img)
            except Exception as e:  # noqa: BLE001
                cb.errors.append(e)
        else:
            frames.append(img)

    cb.count = 0
    cb.frames = frames
    cb.errors = []
    return cb
