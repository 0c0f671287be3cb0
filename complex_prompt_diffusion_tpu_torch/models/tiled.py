"""Tiled (fold/unfold) UNet inference for large canvases.

Counterpart of ``complex_prompt_diffusion_tpu/models/tiled.py``: the latent
is cut into overlapping ``tile`` x ``tile`` windows every ``stride``
pixels (the last one clamped to the edge), the model runs on ``chunk``
tiles a call (stacked along the batch), each output is weighted by a
separable linear border taper (1.0 inside, so a region one tile covers
reproduces that tile's output), and the folded sum is divided by the folded
weights. Where the JAX package scans over the padded chunks, this is a loop
with the same order of additions; padding tiles fold with weight 0.

The multi-rank form (``tiled_apply_sharded``, ``make_tiled_unet(mesh=)``)
shards the tiles over a mesh axis of ``torch.distributed`` ranks: each rank
folds its contiguous share of the padded tile list into its own canvas
sums, and one all-reduce of the sums over the axis gives every rank the
whole canvas (the JAX package's ``shard_map`` + ``psum``). No halo exchange:
the taper and the normalisation handle the seams.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["tile_positions", "tile_window", "tiled_apply", "tiled_apply_sharded",
           "make_tiled_unet"]

def tile_positions(size: int, tile: int, stride: int) -> Tuple[int, ...]:
    """Start offsets covering ``size`` with ``tile``-long windows every
    ``stride`` pixels; the last window ends exactly at ``size``."""
    if tile >= size:
        return (0,)
    pos = list(range(0, size - tile, stride))
    pos.append(size - tile)
    return tuple(pos)


def tile_window(tile: int, overlap: int, device=None) -> torch.Tensor:
    """The [tile, tile, 1] f32 blending window: a linear ramp over the
    ``overlap`` border pixels (clipped to [1e-3, 1]), 1.0 inside."""
    if overlap <= 0:
        return torch.ones((tile, tile, 1), dtype=torch.float32, device=device)
    i = torch.arange(tile, dtype=torch.float32, device=device) + 0.5
    edge = torch.minimum(i, tile - i)
    w = torch.clamp(edge / overlap, 1e-3, 1.0)
    return (w[:, None] * w[None, :])[..., None]


def tiled_apply(apply_fn: Callable, x: torch.Tensor, tile: int, stride: Optional[int] = None,
                *, chunk: int = 1) -> torch.Tensor:
    """``apply_fn`` ([n * B, tile, tile, Cin] -> [n * B, tile, tile, Cout])
    over the overlapping tiles of ``x`` [B, H, W, Cin], ``chunk`` tiles a
    call, folded back with the normalized taper. ``stride`` defaults to
    tile // 2. A tile that covers the whole canvas is one plain call."""
    b, h, w, _ = x.shape
    stride = stride or max(tile // 2, 1)
    if tile >= h and tile >= w:
        return apply_fn(x)
    ys = tile_positions(h, tile, stride)
    xs = tile_positions(w, tile, stride)
    pos = [(y0, x0) for y0 in ys for x0 in xs]
    win = tile_window(tile, tile - stride, x.device)
    # pad to a chunk multiple with copies of the last tile at weight 0 (a
    # live duplicate would not normalize out where it overlaps another tile)
    n_live = len(pos)
    while len(pos) % chunk:
        pos.append(pos[-1])
    valid = [1.0] * n_live + [0.0] * (len(pos) - n_live)
    acc, wsum = _fold_tiles(apply_fn, x, pos, valid, tile, win, chunk)
    return (acc / wsum).to(x.dtype)


def _fold_tiles(apply_fn, x, pos, valid, tile, win, chunk):
    """Run the chunks in order, each one batched call, and add each tile's
    weighted output and its weight into the canvas sums."""
    b, h, w, _ = x.shape
    acc = wsum = None
    for c0 in range(0, len(pos), chunk):
        group = pos[c0:c0 + chunk]
        out = apply_fn(torch.cat([x[:, y0:y0 + tile, x0:x0 + tile] for y0, x0 in group], dim=0))
        out = out.reshape((len(group), b, tile, tile) + tuple(out.shape[3:]))
        if acc is None:
            acc = torch.zeros((b, h, w, out.shape[-1]), dtype=torch.float32, device=x.device)
            wsum = torch.zeros((h, w, 1), dtype=torch.float32, device=x.device)
        for j, (y0, x0) in enumerate(group):
            wj = win * valid[c0 + j]
            acc[:, y0:y0 + tile, x0:x0 + tile] += out[j].float() * wj
            wsum[y0:y0 + tile, x0:x0 + tile] += wj
    return acc, wsum


def tiled_apply_sharded(apply_fn: Callable, x: torch.Tensor, tile: int,
                        stride: Optional[int] = None, *, mesh, axis: str = "data",
                        chunk: int = 1) -> torch.Tensor:
    """:func:`tiled_apply` with the tiles sharded over the ``axis`` of
    ``mesh`` (a ``torch.distributed`` ``DeviceMesh``; every rank of the axis
    calls with the same ``x``): the tile list padded with weight-0 copies
    to a multiple of ranks x ``chunk``, rank r folds the r-th contiguous
    share, and the canvas sums are all-reduced over the axis (two all-reduces
    a call: the weighted outputs and the weights). Equal to
    :func:`tiled_apply` up to the order of the fold's additions."""
    b, h, w, _ = x.shape
    stride = stride or max(tile // 2, 1)
    if tile >= h and tile >= w:
        return apply_fn(x)
    n_shards = int(mesh.size(mesh.mesh_dim_names.index(axis)))
    rank = int(mesh.get_local_rank(axis))
    ys = tile_positions(h, tile, stride)
    xs = tile_positions(w, tile, stride)
    pos = [(y0, x0) for y0 in ys for x0 in xs]
    win = tile_window(tile, tile - stride, x.device)
    n_live = len(pos)
    while len(pos) % (n_shards * chunk):
        pos.append(pos[-1])
    valid = [1.0] * n_live + [0.0] * (len(pos) - n_live)
    share = len(pos) // n_shards
    lo = rank * share
    acc, wsum = _fold_tiles(apply_fn, x, pos[lo:lo + share], valid[lo:lo + share], tile, win,
                            chunk)
    group = mesh.get_group(axis)
    dist.all_reduce(acc, group=group)
    dist.all_reduce(wsum, group=group)
    return (acc / wsum).to(x.dtype)


def make_tiled_unet(unet_apply_fn: Callable, tile: int, stride: Optional[int] = None,
                    chunk: int = 1, *, mesh=None, axis: str = "data"):
    """A (x, t, ctx) -> eps UNet call wrapped with spatial tiling: t and
    ctx repeated for the tiles of a chunk (tile-major, as the tiles are
    stacked). With ``mesh`` the tiles shard over its ``axis``
    (:func:`tiled_apply_sharded`)."""

    def tiled(x, t, ctx):
        b = x.shape[0]

        def fn(xt):
            reps = xt.shape[0] // b
            t_r = t.repeat(reps)
            ctx_r = ctx.repeat((reps,) + (1,) * (ctx.ndim - 1)) if ctx is not None else None
            return unet_apply_fn(xt, t_r, ctx_r)

        if mesh is not None:
            return tiled_apply_sharded(fn, x, tile, stride, mesh=mesh, axis=axis, chunk=chunk)
        return tiled_apply(fn, x, tile, stride, chunk=chunk)

    return tiled
