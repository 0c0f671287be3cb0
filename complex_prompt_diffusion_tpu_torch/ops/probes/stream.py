"""The streaming-copy probe, through the K9 CUDA kernel: the rate at which
this card streams a plane through a kernel. A probe no layer dispatches.

Counterpart of ``scripts/perf_gn7.py`` (an NHWC copy over (n, hw / ch)
blocks, plain or through f32) and ``scripts/perf_gn8.py`` (the same copy
with multi-buffered DMA). :func:`stream_copy` copies an [N, HW, C] bf16
tensor in tiles of ``rows`` whole rows; ``convert`` takes every value
through f32 and back; ``stages`` is the depth of the load pipeline (1, 3, 4
or 8).

On the card :func:`stream_copy` runs ``csrc/probe_copy_sm90.cu``: each tile
cut into the shares of :func:`copy_plan`, a persistent grid walking them,
each block streaming its shares through a ring of ``stages`` slots by bulk
copies (``cp.async.bulk``) in and out. :func:`stream_copy_prior` runs the
body it replaced (``csrc/probe_copy.cu``: one block a tile, 16 bytes a
thread; ``stages`` > 1 a cp.async ring of that depth).

CPU tensors run :func:`stream_copy_plain`; CUDA tensors launch or raise.
``stream_copy.launches`` and ``stream_copy_prior.launches`` count launches.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from complex_prompt_diffusion_tpu_torch import _build

__all__ = ["STAGES", "CopyPlan", "copy_plan", "stream_copy", "stream_copy_plain",
           "stream_copy_prior"]

STAGES = (1, 3, 4, 8)
SMS = 132  # H100 SXM
SLOT_MAX = 16384  # bytes of one ring slot at most
SLOTS_PER_SM = 8  # ring slots each SM keeps in flight (128 KB), at every depth
MIN_SHARE = 4096  # bytes of a share at least, where the tile holds that many


def _check(x, rows, stages):
    if x.ndim != 3:
        raise ValueError(f"stream_copy takes [N, HW, C], got {tuple(x.shape)}")
    n, hw, c = x.shape
    if rows <= 0 or hw % rows or (rows * c) % 8:
        raise ValueError(f"rows must divide HW and rows * C must be a multiple of 8; got "
                         f"rows={rows} for {tuple(x.shape)}")
    if stages not in STAGES:
        raise ValueError(f"stages must be one of {STAGES}, got {stages}")


class CopyPlan(NamedTuple):
    """How the Hopper body covers the tensor: ``tiles`` tiles of
    ``tile_bytes``, each cut into ``split`` shares (share k of a tile spans
    16-byte units k * units // split up to (k + 1) * units // split), each
    share streamed as ``chunks`` chunks of at most ``slot`` bytes (the last
    one shorter) by one of ``grid`` blocks (block g takes shares g, g +
    grid, ...), ``ctas_per_sm`` blocks an SM."""

    tiles: int
    tile_bytes: int
    split: int
    slot: int
    chunks: int
    grid: int
    ctas_per_sm: int

    @property
    def items(self) -> int:
        return self.tiles * self.split

    def share(self, item: int) -> tuple:
        """Byte range [lo, hi) of share ``item`` (tile item // split)."""
        tile, k = divmod(item, self.split)
        units = self.tile_bytes // 16
        return (tile * self.tile_bytes + k * units // self.split * 16,
                tile * self.tile_bytes + (k + 1) * units // self.split * 16)

    def block_chunks(self, block: int) -> list:
        """The (offset, bytes) chunks block ``block`` streams, in order (the
        kernel's ``chunk_at``)."""
        out = []
        for item in range(block, self.items, self.grid):
            lo, hi = self.share(item)
            for part in range(self.chunks):
                off = lo + part * self.slot
                out.append((off, min(self.slot, hi - off)))
        return out


def copy_plan(n: int, hw: int, c: int, rows: int, stages: int) -> CopyPlan:
    """The plan of :func:`stream_copy` for [n, hw, c] bf16 in ``rows``-row
    tiles through a ring of ``stages`` slots: ``SLOTS_PER_SM // stages``
    blocks an SM (at least 1), so every depth keeps about 128 KB in flight on
    each of the 132 SMs; each tile cut into the number of shares that
    spreads them most evenly over that grid (1 where the tiles alone fill
    it evenly); slots of at most 16 KB, evened out over a share's chunks."""
    if stages not in STAGES or rows <= 0 or hw % rows or (rows * c) % 8:
        raise ValueError(f"no plan for rows={rows}, stages={stages} on [{n}, {hw}, {c}]")
    tile_bytes = rows * c * 2
    units = tile_bytes // 16
    tiles = n * hw // rows
    ctas_per_sm = max(1, SLOTS_PER_SM // stages)
    want = SMS * ctas_per_sm
    # the split with the least time a tile: waves of shares over the grid,
    # over shares a tile; shares of at least MIN_SHARE bytes where the tile
    # allows, the smaller split on a tie
    s0 = -(-want // tiles)
    cap = max(1, min(units * 16 // MIN_SHARE, 4 * s0))
    split = min(range(1, cap + 1), key=lambda s: (-(-tiles * s // want) / s, s))
    big, small = -(-units // split) * 16, units // split * 16
    chunks = -(-big // SLOT_MAX)
    while True:
        slot = -(-big // (chunks * 16)) * 16
        if (chunks - 1) * slot < small:  # every chunk of every share holds bytes
            break
        chunks += 1
    return CopyPlan(tiles, tile_bytes, split, slot, chunks, min(tiles * split, want),
                    ctas_per_sm)


def stream_copy_plain(x, rows: int, convert: bool = False, stages: int = 1):
    """Plain twin of K9: a copy (through f32 with ``convert``)."""
    _check(x, rows, stages)
    return x.float().to(x.dtype) if convert else x.clone()


def _card_input(x, rows, stages):
    _check(x, rows, stages)
    if x.dtype != torch.bfloat16:
        raise TypeError(f"K9 copies bf16 tensors, got {x.dtype}")


def stream_copy(x, rows: int, convert: bool = False, stages: int = 1):
    """K9 wrapper: a fresh copy of x [N, HW, C] bf16, on the card by the
    Hopper body (``csrc/probe_copy_sm90.cu``) with the plan of
    :func:`copy_plan`."""
    if not x.is_cuda:
        return stream_copy_plain(x, rows, convert, stages)
    _card_input(x, rows, stages)
    _build.refuse_grad("streaming copy probe (K9)", x)
    x = x.contiguous()
    n, hw, c = x.shape
    plan = copy_plan(n, hw, c, int(rows), int(stages))
    y = torch.empty_like(x)
    launched = ctypes.c_int(0)
    err = _build.kernel_library().cpd_probe_copy_sm90_bf16(
        x.data_ptr(), y.data_ptr(), plan.tiles, plan.tile_bytes, plan.split, plan.slot,
        plan.chunks, plan.grid, int(stages), int(convert), ctypes.byref(launched),
        _build.stream_ptr(x.device))
    _build.check(err, "streaming copy probe (K9)")
    stream_copy.launches += launched.value
    return y


stream_copy.launches = 0


def stream_copy_prior(x, rows: int, convert: bool = False, stages: int = 1):
    """K9's replaced body (``csrc/probe_copy.cu``: one block a tile) on a
    CUDA bf16 tensor; CPU tensors run :func:`stream_copy_plain`."""
    if not x.is_cuda:
        return stream_copy_plain(x, rows, convert, stages)
    _card_input(x, rows, stages)
    _build.refuse_grad("streaming copy probe (K9, replaced body)", x)
    x = x.contiguous()
    y = torch.empty_like(x)
    n, hw, c = x.shape
    err = _build.kernel_library().cpd_probe_copy_bf16(
        x.data_ptr(), y.data_ptr(), n, hw, c, int(rows), int(convert), int(stages),
        _build.stream_ptr(x.device))
    _build.check(err, "streaming copy probe (K9, replaced body)")
    stream_copy_prior.launches += 1
    return y


stream_copy_prior.launches = 0

