"""LR lambda schedules (multiplier curves, use with base_lr = 1.0).

A copy of ``complex_prompt_diffusion_tpu/train/schedulers.py`` (that package
imports jax): pure functions of the step count, usable directly as the
``learning_rate`` callable of :func:`train.optimizers.adan`.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "LambdaWarmUpCosineScheduler",
    "LambdaWarmUpCosineScheduler2",
    "LambdaLinearScheduler",
]


class LambdaWarmUpCosineScheduler:
    """Linear warmup then cosine decay."""

    def __init__(self, warm_up_steps, lr_min, lr_max, lr_start, max_decay_steps):
        self.warm_up_steps = warm_up_steps
        self.lr_start = lr_start
        self.lr_min = lr_min
        self.lr_max = lr_max
        self.max_decay_steps = max_decay_steps

    def __call__(self, n):
        if n < self.warm_up_steps:
            return (self.lr_max - self.lr_start) / self.warm_up_steps * n + self.lr_start
        t = (n - self.warm_up_steps) / (self.max_decay_steps - self.warm_up_steps)
        t = min(t, 1.0)
        return self.lr_min + 0.5 * (self.lr_max - self.lr_min) * (1 + np.cos(t * np.pi))


class LambdaWarmUpCosineScheduler2:
    """Cyclic warmup + cosine with per-cycle configs."""

    def __init__(self, warm_up_steps, f_min, f_max, f_start, cycle_lengths):
        assert len(warm_up_steps) == len(f_min) == len(f_max) == len(f_start) == len(
            cycle_lengths)
        self.warm_up_steps = warm_up_steps
        self.f_start = f_start
        self.f_min = f_min
        self.f_max = f_max
        self.cycle_lengths = cycle_lengths
        self.cum_cycles = np.cumsum([0] + list(cycle_lengths))

    def _interval(self, n):
        for i, cl in enumerate(self.cum_cycles[1:]):
            if n <= cl:
                return i
        return len(self.cycle_lengths) - 1

    def __call__(self, n):
        c = self._interval(n)
        n = n - self.cum_cycles[c]
        if n < self.warm_up_steps[c]:
            return (self.f_max[c] - self.f_start[c]) / self.warm_up_steps[c] * n + self.f_start[c]
        t = (n - self.warm_up_steps[c]) / (self.cycle_lengths[c] - self.warm_up_steps[c])
        t = min(t, 1.0)
        return self.f_min[c] + 0.5 * (self.f_max[c] - self.f_min[c]) * (1 + np.cos(t * np.pi))


class LambdaLinearScheduler(LambdaWarmUpCosineScheduler2):
    """Warmup then a linear ramp down per cycle (the schedule of the SD
    fine-tuning configs)."""

    def __call__(self, n):
        c = self._interval(n)
        n = n - self.cum_cycles[c]
        if n < self.warm_up_steps[c]:
            return (self.f_max[c] - self.f_start[c]) / self.warm_up_steps[c] * n + self.f_start[c]
        return self.f_min[c] + (self.f_max[c] - self.f_min[c]) * (
            self.cycle_lengths[c] - n) / (self.cycle_lengths[c])
