"""Seeding and the ``Map`` attribute dict.

Counterpart of ``complex_prompt_diffusion_tpu/utils/misc.py``.
``seed_everything`` seeds Python's and numpy's generators, as the JAX
package's does; the port's own draws come from explicit
``torch.Generator``s passed through the pipeline, so it sets no global
torch seed either.
"""

from __future__ import annotations

import random

import numpy as np

__all__ = ["Map", "seed_everything"]


class Map(dict):
    """dict with attribute access."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for arg in args:
            if isinstance(arg, dict):
                for k, v in arg.items():
                    self[k] = v
        for k, v in kwargs.items():
            self[k] = v

    def __getattr__(self, attr):
        try:
            return self[attr]
        except KeyError as e:
            raise AttributeError(attr) from e

    def __setattr__(self, key, value):
        self[key] = value

    def __delattr__(self, item):
        del self[item]


def seed_everything(seed: int, verbose: bool = False) -> int:
    """Seed Python's ``random`` and numpy's global generator."""
    random.seed(seed)
    np.random.seed(seed)
    if verbose:
        print(f"[seed_everything] {seed}")
    return seed
