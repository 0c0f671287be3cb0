"""DAAM word heat maps from cross-attention probabilities.

Counterpart of ``complex_prompt_diffusion_tpu/guidance/daam.py``: run
``models.unet_apply(..., collect_attn_maps=True)`` at the timestep of
interest, then aggregate its per-site maps here: each site's maps
upsampled (bicubic, ``utils/resize.py``'s copy of ``jax.image.resize``) to a
common grid and averaged over heads and sites. No global state.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from complex_prompt_diffusion_tpu_torch.utils.resize import resize

__all__ = ["aggregate_heat_maps", "word_heat_map"]


def aggregate_heat_maps(attn_maps: Sequence[torch.Tensor], out_size: int = 64,
                        method: str = "bicubic", batch_idx: int = 0) -> torch.Tensor:
    """Per-token heat maps [L, out_size, out_size] (f32) from the sites'
    [B, heads, HW, L] maps of sample ``batch_idx``: each reshaped to its
    square grid, resized to ``out_size`` by ``method``, averaged over heads,
    then over sites."""
    acc = None
    count = 0
    for maps in attn_maps:
        _, heads, hw, n_tok = maps.shape
        side = int(math.sqrt(hw))
        m = maps[batch_idx].float()  # [heads, HW, L]
        # [side, side, L * heads]: resize moves H and W only, channels last
        m = m.permute(1, 2, 0).reshape(side, side, n_tok * heads)
        m = resize(m, (out_size, out_size, n_tok * heads), method)
        m = m.reshape(out_size, out_size, n_tok, heads).mean(dim=-1).permute(2, 0, 1)
        acc = m if acc is None else acc + m
        count += 1
    return acc / max(count, 1)


def word_heat_map(attn_maps: Sequence[torch.Tensor], token_idxs: Sequence[int],
                  out_size: int = 64, normalize: bool = True,
                  batch_idx: int = 0) -> torch.Tensor:
    """The heat map of a word spanning ``token_idxs`` (the mean over its
    tokens), [out_size, out_size], in [0, 1] when ``normalize``."""
    maps = aggregate_heat_maps(attn_maps, out_size, batch_idx=batch_idx)
    hm = maps[torch.as_tensor(list(token_idxs), device=maps.device)].mean(dim=0)
    if normalize:
        hm = (hm - hm.min()) / (hm.max() - hm.min() + 1e-12)
    return hm
