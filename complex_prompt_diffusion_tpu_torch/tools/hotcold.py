"""Kernel times on the card with the L2 cache hot and cold.

``hot``: one input set, launched again and again, so whatever of it fits
the H100's 50 MB L2 is read from there. ``cold``: distinct input sets made
from seeds, launched in turn, with the outputs of the last launches kept
alive, so the sets and outputs in rotation exceed twice the L2 and each
launch finds its inputs in device memory.

The run of launches is captured once in a CUDA graph and replayed between
two CUDA events, so a time is the device's and not the host's: a wrapper
spends tens of microseconds of Python a launch, as long as the small
kernels themselves.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

__all__ = ["ITERS", "L2_BYTES", "METHOD", "HotCold", "graph_ms", "hot_cold_ms"]

L2_BYTES = 50e6  # H100 SXM
ITERS = 20  # launches a timing
METHOD = f"CUDA-graph replay of {ITERS} launches after 2 eager warm-ups"


class HotCold(NamedTuple):
    hot_ms: float
    cold_ms: float


def graph_ms(fn: Callable, iters: int = ITERS) -> float:
    """Mean ms of ``iters`` calls of ``fn`` captured in one CUDA graph (after
    two eager warm-up calls), replayed once untimed and once timed."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def hot_cold_ms(make_set: Callable, fn: Callable, set_bytes: float, sets=None) -> HotCold:
    """``make_set(i)``: the i-th input set (a tuple of arguments, made from
    seed i); ``fn(*args)``: one launch; ``set_bytes``: the bytes one launch
    reads and writes. ``sets``: input sets made ahead (extended here as
    needed) so that rows on the same inputs share them."""
    sets = [] if sets is None else sets
    if not sets:
        sets.append(make_set(0))
    hot = graph_ms(lambda: fn(*sets[0]))
    n = max(2, math.ceil(2 * L2_BYTES / max(set_bytes, 1.0)))
    while len(sets) < n:
        sets.append(make_set(len(sets)))
    outs = [None] * n
    turn = [0]

    def step():
        i = turn[0] % n
        outs[i] = fn(*sets[i])  # the launch before the last n is freed only now
        turn[0] += 1

    cold = graph_ms(step, n * math.ceil(ITERS / n))
    return HotCold(hot, cold)
