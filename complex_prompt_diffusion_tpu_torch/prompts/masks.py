"""Programmatic spatial-mask DSL: ``"<direction>_<size>_<minority>"``.

A copy of ``complex_prompt_diffusion_tpu/prompts/masks.py``. Examples:
``left_third_valid`` — only the left third of the latent passes this factor;
``top_half_hidden`` — the top half is suppressed. ``perspective`` builds the
X-diagonal mask.

Masks are numpy float32 [H, W] over the *latent* grid (H//8 x W//8 of the
pixel canvas); ``compose.py`` stacks them into GuidanceSpec.masks [K, H, W, 1].
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["make_mask"]

_SIZES = {
    "2": 2, "half": 2,
    "3": 3, "third": 3,
    "4": 4, "quarter": 4, "fourth": 4,
    "5": 5, "fifth": 5, "fifrth": 5,  # incl. the reference's typo alias
    "6": 6, "sixth": 6,
    "7": 7, "seventh": 7,
    "8": 8, "eigth": 8, "eighth": 8,
    "9": 9, "ninth": 9,
    "10": 10, "tenth": 10,
}
_DIRECTIONS = {
    "top": ("top", "t", "north"),
    "bottom": ("bottom", "bot", "b", "south"),
    "left": ("left", "l", "west"),
    "right": ("right", "r", "east"),
}
_MINOR_VALID = ("valid", "visible", "show", "v")
_MINOR_HIDDEN = ("hidden", "hide", "h")


def make_mask(style: str, height: int, width: int) -> np.ndarray:
    """Build a [height, width] float mask over the latent grid.

    ``height``/``width`` are latent dims (pixel // 8). The <size> fraction on
    the <direction> side is the minority block; <minority> says whether that
    block is valid (1) or hidden (0).
    """
    if style == "perspective":
        assert height == width, "perspective mask requires square canvas"
        eye = np.eye(height, dtype=np.float32)
        return np.clip(np.flipud(eye) + eye, 0, 1)

    parts = style.split("_")
    direction = parts[0]
    size = parts[1] if len(parts) > 1 else "half"
    minority = parts[2] if len(parts) > 2 else "valid"

    if size not in _SIZES:
        raise ValueError(f"unknown mask size {size!r}")
    n = _SIZES[size]
    minor_ratio = 1.0 / n
    major_ratio = (n - 1.0) / n

    if minority in _MINOR_VALID:
        valid_ratio, hidden_ratio = minor_ratio, major_ratio
        minority_valid = True
    elif minority in _MINOR_HIDDEN:
        valid_ratio, hidden_ratio = major_ratio, minor_ratio
        minority_valid = False
    else:
        raise ValueError(f"unknown mask minority {minority!r}")

    def block_sizes(dim):
        # reference: valid=floor, hidden=ceil
        return int(math.floor(dim * valid_ratio)), int(math.ceil(dim * hidden_ratio))

    if direction in _DIRECTIONS["left"] or direction in _DIRECTIONS["right"]:
        v, h = block_sizes(width)
        valid = np.ones((height, v), np.float32)
        hidden = np.zeros((height, h), np.float32)
        # minority block sits on the named side
        if direction in _DIRECTIONS["left"]:
            first_is_valid = (v < h) or (v == h and minority_valid)
        else:
            first_is_valid = (v > h) or (v == h and not minority_valid)
        mask = (
            np.concatenate([valid, hidden], axis=1)
            if first_is_valid
            else np.concatenate([hidden, valid], axis=1)
        )
    elif direction in _DIRECTIONS["top"] or direction in _DIRECTIONS["bottom"]:
        v, h = block_sizes(height)
        valid = np.ones((v, width), np.float32)
        hidden = np.zeros((h, width), np.float32)
        if direction in _DIRECTIONS["top"]:
            first_is_valid = (v < h) or (v == h and minority_valid)
        else:
            first_is_valid = (v > h) or (v == h and not minority_valid)
        mask = (
            np.concatenate([valid, hidden], axis=0)
            if first_is_valid
            else np.concatenate([hidden, valid], axis=0)
        )
    else:
        raise ValueError(f"unknown mask direction {direction!r}")

    assert mask.shape == (height, width)
    return mask
