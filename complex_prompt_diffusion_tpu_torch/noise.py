"""Noise generation: seeded sequences, exemplar matching, spectrum-shaped
outpaint noise, image -> noise inversion.

Counterpart of ``complex_prompt_diffusion_tpu/noise.py``:

  * :class:`NoiseGenerator` — the seed modes (iter / constant / loop /
    random) and the exemplar sequences, as in the JAX package. ``sample``
    draws N(0, 1) from a ``torch.Generator`` seeded with the seed on the
    generator's device, where the JAX package draws from ``PRNGKey(seed)``:
    the same seed gives other numbers in the two packages.
  * :func:`get_matched_noise`, :func:`match_histograms` — numpy copies of
    the JAX package's (equal results).
  * :func:`find_noise_for_image` — reverse Euler in sigma space through the
    port's denoiser (``guidance/cfg.py`` ``make_denoiser``), a host loop with
    host f32 coefficients, on the device of ``z0``.
"""

from __future__ import annotations

import random as _random
from collections import defaultdict
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "NoiseGenerator",
    "get_matched_noise",
    "find_noise_for_image",
    "match_histograms",
    "build_cycle_mod",
]


def match_histograms(source: np.ndarray, reference: np.ndarray) -> np.ndarray:
    """Per-channel histogram matching by quantile mapping (the semantics of
    ``skimage.exposure.match_histograms``, written out: no skimage)."""
    source = np.asarray(source)
    reference = np.asarray(reference)
    out = np.empty_like(source, dtype=np.float64)
    c = source.shape[-1]
    for ch in range(c):
        s = source[..., ch].ravel()
        r = reference[..., ch].ravel()
        s_idx = np.argsort(s, kind="stable")
        r_sorted = np.sort(r)
        quantiles = np.linspace(0, 1, len(s))
        matched = np.interp(quantiles, np.linspace(0, 1, len(r_sorted)), r_sorted)
        flat = np.empty_like(s, dtype=np.float64)
        flat[s_idx] = matched
        out[..., ch] = flat.reshape(source[..., ch].shape)
    return out.astype(source.dtype) if np.issubdtype(source.dtype, np.floating) else out


def build_cycle_mod(n: int = 5) -> List[int]:
    """[1 .. n-1] + [-(n-1) .. -1]: the "loop" mode's seeds."""
    return [x for x in range(1, n)] + [-x for x in range(1, n)][::-1]


class NoiseGenerator:
    """Seeded noise source with sequence / exemplar support.

    seed_mode: "iter" (increment each draw), "constant" ("const", "c"),
    "loop" ("l": cycle :func:`build_cycle_mod`), anything else a random seed
    in [0, 10000] from Python's ``random``. ``device``: where ``sample``
    draws (the GPU unless asked otherwise); samples come back as f32 numpy
    arrays, as the JAX package's do.
    """

    def __init__(self, shape, seed: int = 0, seed_mode: str = "iter", cycle_size: int = 5,
                 device="cuda"):
        from complex_prompt_diffusion_tpu_torch.pipeline import _device

        self.shape = tuple(shape)
        self._seed = seed
        self.seed_mode = seed_mode
        self.device = _device(device)
        self._seed_list = build_cycle_mod(cycle_size)
        self._seed_idx = 0
        self._exemplar_sequence: Dict[str, int] = {}
        self._exemplars: Dict[str, List[dict]] = defaultdict(list)

    @property
    def seed(self) -> int:
        """The next seed of the mode (reading it advances the sequence)."""
        if self.seed_mode == "iter":
            self._seed += 1
        elif self.seed_mode in ("constant", "const", "c"):
            pass
        elif self.seed_mode in ("loop", "l"):
            self._seed = self._seed_list[self._seed_idx % len(self._seed_list)]
            self._seed_idx += 1
        else:
            self._seed = _random.randint(0, 10000)
        return self._seed

    @property
    def last_seed(self) -> int:
        return self._seed

    def sample(self, seed: Optional[int] = None, match_noise=None) -> np.ndarray:
        """N(0, 1) of ``shape`` from a generator seeded with ``seed`` (the
        mode's next seed when None); histogram-matched to ``match_noise``
        when given."""
        if seed is None:
            seed = self.seed
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        out = torch.randn(self.shape, generator=gen, device=self.device).cpu().numpy()
        if match_noise is not None:
            out = match_histograms(out, np.asarray(match_noise))
        return out

    def add_exemplar(self, value, seed: int, uid: str, name: str = "") -> int:
        self._exemplar_sequence.setdefault(uid, 0)
        self._exemplars[uid].append({"value": value, "seed": seed, "name": name})
        return len(self._exemplars[uid])

    def clear_exemplars(self, uid: str):
        self._exemplar_sequence.pop(uid, None)
        self._exemplars.pop(uid, None)

    def reset_sequence(self, uid: str):
        if uid not in self._exemplar_sequence:
            raise KeyError(f"no exemplar sequence for uid {uid!r}")
        self._exemplar_sequence[uid] = 0

    def sample_sequence(self, uid: str, match: bool = False) -> np.ndarray:
        """The next exemplar of ``uid`` (cycling): a draw at its seed, or
        with ``match`` a fresh draw matched to its value."""
        if uid not in self._exemplars:
            raise KeyError(f"no exemplars for uid {uid!r}")
        ex = self._exemplars[uid][self._exemplar_sequence[uid]]
        if match:
            result = self.sample(match_noise=ex["value"])
        else:
            result = self.sample(seed=ex["seed"])
        self._exemplar_sequence[uid] += 1
        if self._exemplar_sequence[uid] >= len(self._exemplars[uid]):
            self._exemplar_sequence[uid] = 0
        return result


def _fft2(data: np.ndarray) -> np.ndarray:
    out = np.fft.fft2(np.fft.fftshift(data, axes=(0, 1)), axes=(0, 1), norm="ortho")
    return np.fft.ifftshift(out, axes=(0, 1))


def _ifft2(data: np.ndarray) -> np.ndarray:
    out = np.fft.ifft2(np.fft.fftshift(data, axes=(0, 1)), axes=(0, 1), norm="ortho")
    return np.fft.ifftshift(out, axes=(0, 1))


def _gaussian_window(width, height, std=3.14, mode=0):
    wx = float(width / min(width, height))
    wy = float(height / min(width, height))
    x = (np.arange(width) / width * 2.0 - 1.0) * wx
    y = (np.arange(height) / height * 2.0 - 1.0) * wy
    xx, yy = x[:, None], y[None, :]
    if mode == 0:
        return np.exp(-(xx**2 + yy**2) * std)
    return (1.0 / ((xx**2 + 1.0) * (yy**2 + 1.0))) ** (std / 3.14)


def get_matched_noise(src_image: np.ndarray, mask_rgb: np.ndarray, noise_q: float = 1.0,
                      color_variation: float = 0.05,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Outpainting init noise shaped by the source's spectrum, histogram
    matched to the kept pixels. ``src_image`` [W, H, C] in [0, 1];
    ``mask_rgb`` 1 where content is to be generated; ``rng`` (default
    ``default_rng(0)``) draws the noise. Returns [W, H, C] in [0, 1]."""
    rng = rng or np.random.default_rng(0)
    width, height, channels = src_image.shape

    mask_grey = np.sum(mask_rgb, axis=2) / 3.0
    img_mask = mask_grey > 1e-6
    ref_mask = mask_grey < 1e-3

    hardened = np.repeat(mask_grey[:, :, None], 3, axis=2)
    windowed = src_image * (1.0 - hardened)
    windowed /= np.max(windowed)
    windowed += np.average(src_image) * mask_rgb

    src_fft = _fft2(windowed)
    src_dist = np.absolute(src_fft)
    src_phase = src_fft / np.maximum(src_dist, 1e-12)

    noise_window = _gaussian_window(width, height, mode=1)
    noise_rgb = rng.random((width, height, channels))
    noise_grey = np.sum(noise_rgb, axis=2) / 3.0
    noise_rgb = noise_rgb * color_variation + (1.0 - color_variation) * noise_grey[:, :, None]

    noise_fft = _fft2(noise_rgb)
    noise_fft *= noise_window[:, :, None]
    noise_rgb = np.real(_ifft2(noise_fft))
    shaped_fft = _fft2(noise_rgb)
    shaped_fft = np.absolute(shaped_fft) ** 2 * (src_dist**noise_q) * src_phase

    shaped = np.real(_ifft2(shaped_fft))
    shaped -= np.min(shaped)
    shaped /= np.max(shaped)
    if img_mask.any() and ref_mask.any():
        shaped[img_mask, :] = np.asarray(_match_flat(shaped[img_mask, :], src_image[ref_mask, :]))
    shaped = src_image * (1.0 - mask_rgb) + shaped * mask_rgb
    return np.clip(shaped, 0.0, 1.0)


def _match_flat(source_px: np.ndarray, ref_px: np.ndarray) -> np.ndarray:
    """Histogram-match flattened pixel lists channel by channel."""
    out = np.empty_like(source_px)
    for c in range(source_px.shape[1]):
        s = source_px[:, c]
        r = ref_px[:, c]
        s_sorted_idx = np.argsort(s)
        r_sorted = np.sort(r)
        quantiles = np.linspace(0, 1, len(s))
        matched = np.interp(quantiles, np.linspace(0, 1, len(r_sorted)), r_sorted)
        out[s_sorted_idx, c] = matched
    return out


def find_noise_for_image(den_fn: Callable, z0: torch.Tensor, sigmas,
                         cond_scale: float = 2.0) -> torch.Tensor:
    """Reverse-Euler noise inversion in sigma space.

    ``den_fn(x, sigma, uc_scale)`` -> the denoised prediction (the port's
    sigma-space denoiser, ``make_denoiser(...)[1]``); ``sigmas`` ascending
    from ~0 to sigma_max (the sampling schedule reversed). Step i (1 .. n-1)
    evaluates at max(sigma_{i-1}, 1e-4) and divides by sigma_{i-1}, except
    the first, which divides by 2 sigma_1, as the JAX package does. The
    coefficients are host f32 scalars; ``z0`` (scaled latents) stays on its
    device. Returns x at sigma_max."""
    sig = np.asarray(sigmas, np.float32)
    x = z0
    with torch.inference_mode():
        for i in range(1, len(sig)):
            sigma_prev = sig[i - 1]
            denoised = den_fn(x, np.maximum(sigma_prev, np.float32(1e-4)), cond_scale)
            denom = np.float32(2.0) * sig[i] if i == 1 else sigma_prev
            d = (x - denoised) / float(denom)
            x = x + d * float(sig[i] - sigma_prev)
    return x
