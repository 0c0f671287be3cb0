"""Image file IO and the [-1, 1] <-> uint8 conversions.

Counterpart of ``complex_prompt_diffusion_tpu/utils/image.py``. PIL is
imported only inside the three file functions (``load_image``,
``save_image``, ``load_mask``), as the JAX package does; the conversions
are numpy.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["load_image", "save_image", "image_to_array", "array_to_image", "load_mask"]


def load_image(path: str, size: Optional[Tuple[int, int]] = None) -> np.ndarray:
    """An image file -> uint8 RGB [H, W, 3]; ``size`` (W, H) resizes it
    with Lanczos."""
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None:
        img = img.resize(size, Image.LANCZOS)
    return np.asarray(img)


def save_image(array: np.ndarray, path: str):
    from PIL import Image

    Image.fromarray(np.asarray(array, np.uint8)).save(path)


def image_to_array(img, normalize: bool = True) -> np.ndarray:
    """Image or array -> f32 [H, W, 3]; with ``normalize``, values above 2
    are read as [0, 255] and everything is mapped to [-1, 1]."""
    arr = np.asarray(img, np.float32)
    if normalize:
        if arr.max() > 2.0:
            arr = arr / 255.0
        arr = arr * 2.0 - 1.0
    return arr


def array_to_image(arr: np.ndarray) -> np.ndarray:
    """float [-1, 1] -> uint8 [0, 255] (truncating, as the JAX package)."""
    arr = np.asarray(arr, np.float32)
    arr = np.clip((arr * 0.5) + 0.5, 0.0, 1.0)
    return (arr * 255.0).astype(np.uint8)


def load_mask(path: str, size: Tuple[int, int], invert: bool = False) -> np.ndarray:
    """A mask image -> f32 [h, w] in [0, 1], resized to ``size`` (W, H)
    with Lanczos; ``invert`` gives 1 - mask."""
    from PIL import Image

    img = Image.open(path).convert("L").resize(size, Image.LANCZOS)
    mask = np.asarray(img, np.float32) / 255.0
    return 1.0 - mask if invert else mask
