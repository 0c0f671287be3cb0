"""Token reduction at the UNet's large self-attention sites: ToMe merging
and ToDo K/V downsampling, as plain tensor functions.

Counterpart of ``complex_prompt_diffusion_tpu/ops/tome.py``:

* :func:`downsample_kv` (ToDo): the K/V tokens average-pooled over
  ``sx x sy`` windows while Q keeps its full length, so K1 runs with
  Sq != Skv and nothing is unmerged.
* :func:`build_merge` / :func:`tome_merge` / :func:`tome_unmerge` (ToMe-SD):
  dst tokens are a fixed strided grid (one a window, offset 0), src the
  rest; each src token's best dst by cosine similarity, the ``r`` most
  similar src tokens merged into their dst by a mean, the rest kept in
  similarity order; after attention every merged position copies its
  dst's output.

Both index maps come from one stable argsort of the best-match scores and
its inverse (the rank trick), with no scatter; the merge sums are a
one-hot product, as in the JAX package. ``torch.argsort(stable=True)`` and
``torch.argmax`` (first index on ties) break ties as ``jnp.argsort`` and
``jnp.argmax`` do. On locally constant tokens both reductions leave
softmax attention exact: duplicated keys renormalize away.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["TomePlan", "build_merge", "tome_merge", "tome_unmerge", "downsample_kv"]


def downsample_kv(x: torch.Tensor, h: int, w: int, sx: int = 2, sy: int = 2) -> torch.Tensor:
    """ToDo K/V source: ``[B, S, C] -> [B, S / (sx * sy), C]``, the mean of
    each ``sy x sx`` window of the raster token grid, in f32, cast back to
    ``x``'s dtype."""
    b, s, c = x.shape
    if s != h * w:
        raise ValueError(f"x S={s} != h*w={h * w}")
    if h % sy or w % sx:
        raise ValueError(f"grid {h}x{w} not divisible by pool {sy}x{sx}")
    xi = x.float().reshape(b, h // sy, sy, w // sx, sx, c)
    pooled = xi.mean(dim=(2, 4))
    return pooled.reshape(b, (h // sy) * (w // sx), c).to(x.dtype)


class TomePlan(NamedTuple):
    """One merge assignment. ``dst_pos`` / ``src_pos`` / ``inv_perm`` are
    static raster positions (int64 on the metric's device); ``idx_src``
    maps each src token (src-list order) to its slot in the merged
    sequence; ``assign`` is the merged-src -> dst one-hot (f32, zero rows
    for kept tokens); ``kept_order`` lists the kept src tokens in slot
    order."""

    dst_pos: torch.Tensor     # [n_dst]
    src_pos: torch.Tensor     # [n_src]
    idx_src: torch.Tensor     # [B, n_src]
    assign: torch.Tensor      # [B, n_src, n_dst] f32
    kept_order: torch.Tensor  # [B, n_keep]
    inv_perm: torch.Tensor    # [S]
    r: int


@functools.lru_cache(maxsize=None)
def _grid_partition(h: int, w: int, sx: int, sy: int):
    """Raster positions of the strided-grid dst set and its complement
    (numpy int32, as the JAX package's)."""
    pos = np.arange(h * w).reshape(h, w)
    dst_mask = np.zeros((h, w), bool)
    dst_mask[::sy, ::sx] = True
    dst = pos[dst_mask].ravel()
    src = pos[~dst_mask].ravel()
    return dst.astype(np.int32), src.astype(np.int32)


@functools.lru_cache(maxsize=None)
def _static_maps(h: int, w: int, sx: int, sy: int, device: torch.device):
    """dst_pos, src_pos and the inverse of the [dst | src] -> raster
    permutation as index tensors on ``device``, made once a grid (so that a
    step copies nothing from the host)."""
    dst, src = _grid_partition(h, w, sx, sy)
    perm = np.concatenate([dst, src])
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=np.int32)
    return tuple(torch.as_tensor(a.astype(np.int64), device=device) for a in (dst, src, inv))


def build_merge(metric: torch.Tensor, h: int, w: int, r: int, sx: int = 2,
                sy: int = 2) -> TomePlan:
    """Bipartite soft matching of ``metric`` [B, S, C] (S = h * w, raster):
    the ``r`` src tokens with the highest best-match cosine similarity merge
    into their best dst. ``r`` must be in (0, n_src]."""
    b, s, _ = metric.shape
    if s != h * w:
        raise ValueError(f"metric S={s} != h*w={h * w}")
    dst_pos, src_pos, inv_perm = _static_maps(h, w, sx, sy, metric.device)
    n_dst, n_src = dst_pos.shape[0], src_pos.shape[0]
    if not (0 < r <= n_src):
        raise ValueError(f"r={r} outside (0, n_src={n_src}]")
    norm = torch.linalg.vector_norm(metric.float(), dim=-1, keepdim=True) + 1e-6
    mn = metric / norm.to(metric.dtype)
    m_src = mn[:, src_pos]
    m_dst = mn[:, dst_pos]
    scores = torch.matmul(m_src.float(), m_dst.float().transpose(1, 2))  # [B, n_src, n_dst]
    node_max = scores.amax(dim=-1)
    node_idx = torch.argmax(scores, dim=-1)
    # rank trick: rank[s] = position of src s in the descending order of
    # its best score; rank < r merges (slot: its dst's), rank >= r keeps
    # (slot n_dst + rank - r: kept tokens follow the dst block in order)
    order = torch.argsort(-node_max, dim=-1, stable=True)
    rank = torch.argsort(order, dim=-1, stable=True)
    merged = rank < r
    idx_src = torch.where(merged, node_idx, n_dst + rank - r)
    assign = (node_idx[..., None] == torch.arange(n_dst, device=metric.device)).float()
    assign = assign * merged[..., None]
    # the kept src tokens in slot order: sort by slot, merged ones last
    big = torch.iinfo(torch.int32).max
    kept_order = torch.argsort(torch.where(idx_src >= n_dst, idx_src, big), dim=-1,
                               stable=True)[:, : n_src - r]
    return TomePlan(dst_pos, src_pos, idx_src, assign, kept_order, inv_perm, r)


def tome_merge(plan: TomePlan, x: torch.Tensor) -> torch.Tensor:
    """``[B, S, C] -> [B, S - r, C]``: [pooled dst tokens | kept src tokens
    in similarity order]; each dst is the f32 mean of itself and the src
    tokens merged into it."""
    x_dst = x[:, plan.dst_pos]
    x_src = x[:, plan.src_pos]
    sums = torch.matmul(plan.assign.transpose(1, 2), x_src.float())  # [B, n_dst, C]
    counts = plan.assign.sum(dim=1)[..., None]
    pooled = (x_dst.float() + sums) / (1.0 + counts)
    x_keep = torch.gather(x_src, 1, plan.kept_order[..., None].expand(-1, -1, x.shape[-1]))
    return torch.cat([pooled.to(x.dtype), x_keep], dim=1)


def tome_unmerge(plan: TomePlan, y: torch.Tensor) -> torch.Tensor:
    """``[B, S - r, C] -> [B, S, C]``: kept positions read their own slot,
    merged ones their dst's, then the static reorder to raster order."""
    n_dst = plan.dst_pos.shape[0]
    y_src = torch.gather(y, 1, plan.idx_src[..., None].expand(-1, -1, y.shape[-1]))
    full = torch.cat([y[:, :n_dst], y_src], dim=1)
    return full[:, plan.inv_perm]
