"""Learning-rate schedulers.

Counterpart of mxnet_tpu/lr_scheduler.py, arithmetic for arithmetic:
`LRScheduler` with linear or constant warmup, and the `Factor`,
`MultiFactor`, `Poly` and `Cosine` schedulers. `scheduler(num_update)`
is the rate at that update count.
"""
from __future__ import annotations

import math

from .base import MXNetError

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        if warmup_mode not in ("linear", "constant"):
            raise MXNetError(f"bad warmup_mode {warmup_mode}")
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        assert num_update < self.warmup_steps
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        return self.warmup_begin_lr

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """lr *= factor every `step` updates."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 **kwargs):
        super().__init__(base_lr, **kwargs)
        if step < 1:
            raise MXNetError("step must be >= 1")
        if factor > 1.0:
            raise MXNetError("factor must be <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        exp = (num_update - self.warmup_steps) // self.step
        return max(self.base_lr * (self.factor ** exp), self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """lr *= factor at each step boundary."""

    def __init__(self, step, factor=1, base_lr=0.01, **kwargs):
        super().__init__(base_lr, **kwargs)
        if not all(step[i] < step[i + 1] for i in range(len(step) - 1)):
            raise MXNetError("steps must be increasing")
        self.step = step
        self.factor = factor

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        passed = sum(1 for s in self.step if s <= num_update)
        return self.base_lr * (self.factor ** passed)


class PolyScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / self.max_steps
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1 - frac) ** self.power


class CosineScheduler(LRScheduler):
    def __init__(self, max_update, base_lr=0.01, final_lr=0, **kwargs):
        super().__init__(base_lr, **kwargs)
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - self.warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / self.max_steps
        return self.final_lr + (self.base_lr - self.final_lr) * \
            (1 + math.cos(math.pi * frac)) / 2
