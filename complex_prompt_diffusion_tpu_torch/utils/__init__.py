"""Helpers of the port: seeding and the attr-dict (``misc.py``), image IO
(``image.py``), embedding distances and image metrics (``metrics.py``), and
modules with no counterpart in the JAX package (``cv.py``, ``resize.py``,
``profiling.py``). The package re-exports what the JAX package's
``utils`` does."""

from complex_prompt_diffusion_tpu_torch.utils.image import (
    array_to_image,
    image_to_array,
    load_image,
    save_image,
)
from complex_prompt_diffusion_tpu_torch.utils.metrics import (
    cosine_sim,
    euclidean_dist,
    spherical_dist,
)
from complex_prompt_diffusion_tpu_torch.utils.misc import Map, seed_everything

__all__ = [
    "Map",
    "seed_everything",
    "load_image",
    "save_image",
    "image_to_array",
    "array_to_image",
    "spherical_dist",
    "euclidean_dist",
    "cosine_sim",
]
