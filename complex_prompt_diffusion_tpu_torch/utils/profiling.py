"""Step timing, profiler traces and device memory figures.

Counterpart of ``complex_prompt_diffusion_tpu/utils/profiling.py``:

  * :class:`StepTimer` — step times with p50 / mean / rate summaries. On a
    CUDA device it times with ``torch.cuda.Event`` pairs (device time
    between the two records, read after a synchronize at ``stop``); on the
    CPU with the host clock.
  * :func:`trace` — a ``torch.profiler`` context writing a Chrome trace.
  * :func:`device_memory_stats` — ``torch.cuda.memory_stats`` of each GPU.
  * :func:`live_array_bytes` — ``torch.cuda.memory_allocated``: the bytes
    of live tensors on the GPUs.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

__all__ = ["StepTimer", "trace", "device_memory_stats", "live_array_bytes"]


class StepTimer:
    """Accumulate step timings; report p50 / mean and throughput.
    ``device``: time on this device's stream with CUDA events (the default
    when a GPU is present), or ``"cpu"`` for the host clock."""

    def __init__(self, unit: str = "step", device=None):
        self.unit = unit
        self.times: List[float] = []
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self._t0: Optional[object] = None

    def start(self):
        if self.device.type == "cuda":
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def stop(self, count: int = 1):
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop without start")
        if self.device.type == "cuda":
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._t0.elapsed_time(end) / 1e3 / count
        else:
            dt = (time.perf_counter() - self._t0) / count
        self.times.extend([dt] * count)
        self._t0 = None
        return dt

    @contextlib.contextmanager
    def __call__(self, count: int = 1):
        self.start()
        yield
        self.stop(count)

    def summary(self) -> Dict[str, float]:
        if not self.times:
            return {}
        ts = sorted(self.times)
        p50 = ts[len(ts) // 2]
        mean = sum(ts) / len(ts)
        return {
            f"p50_{self.unit}_ms": p50 * 1e3,
            f"mean_{self.unit}_ms": mean * 1e3,
            f"{self.unit}s_per_sec": 1.0 / mean,
            "count": float(len(ts)),
        }


@contextlib.contextmanager
def trace(logdir: str = "profile_trace"):
    """``torch.profiler`` over the block (CPU, and CUDA where present),
    written to ``logdir/trace.json`` (open it in Perfetto or
    chrome://tracing). Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    """Bytes in use, reserved and at peak, each GPU (empty without one)."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", -1),
            "bytes_reserved": stats.get("reserved_bytes.all.current", -1),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", -1),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


def live_array_bytes() -> int:
    """Bytes of live tensors on all GPUs (0 without one)."""
    if not torch.cuda.is_available():
        return 0
    return sum(torch.cuda.memory_allocated(i) for i in range(torch.cuda.device_count()))
