"""Learning-rate schedulers (counterpart of ``mxnet_tpu/lr_scheduler.py``,
parity: python/mxnet/lr_scheduler.py).  Pure Python: a scheduler maps
the optimizer's update count to a learning rate."""
from __future__ import annotations

import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler:
    """Base scheduler with an optional linear or constant-power warmup
    from ``warmup_begin_lr`` to ``base_lr`` over ``warmup_steps``."""

    def __init__(self, base_lr=0.01, warmup_steps=0, warmup_begin_lr=0,
                 warmup_mode="linear"):
        self.base_lr = base_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.warmup_final_lr = base_lr
        self.warmup_mode = warmup_mode

    def get_warmup_lr(self, num_update):
        if self.warmup_mode == "linear":
            inc = (self.warmup_final_lr - self.warmup_begin_lr) \
                * num_update / self.warmup_steps
            return self.warmup_begin_lr + inc
        return self.warmup_final_lr * (num_update / self.warmup_steps) ** 2

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """``base_lr * factor ** ((n - warmup) // step)``, floored at
    ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8, base_lr=0.01,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr * (
            self.factor ** ((num_update - self.warmup_steps) // self.step))
        return max(lr, self.stop_factor_lr)


class MultiFactorScheduler(LRScheduler):
    """Multiply by ``factor`` at each update count in ``step``."""

    def __init__(self, step, factor=1, base_lr=0.01, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.step = sorted(step)
        self.factor = factor

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        lr = self.base_lr
        for s in self.step:
            if num_update >= s:
                lr *= self.factor
        return lr


class PolyScheduler(LRScheduler):
    """Polynomial decay of power ``pwr`` to ``final_lr`` at
    ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, pwr=2, final_lr=0,
                 warmup_steps=0, warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.max_update = max_update
        self.power = pwr
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / self.max_steps
        return self.final_lr + (self.base_lr - self.final_lr) \
            * (1 - frac) ** self.power


class CosineScheduler(LRScheduler):
    """Half-cosine decay to ``final_lr`` at ``max_update``."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0, warmup_steps=0,
                 warmup_begin_lr=0, warmup_mode="linear"):
        super().__init__(base_lr, warmup_steps, warmup_begin_lr, warmup_mode)
        self.max_update = max_update
        self.final_lr = final_lr
        self.max_steps = max_update - warmup_steps

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            return self.get_warmup_lr(num_update)
        if num_update >= self.max_update:
            return self.final_lr
        frac = (num_update - self.warmup_steps) / self.max_steps
        return self.final_lr + (self.base_lr - self.final_lr) \
            * (1 + math.cos(math.pi * frac)) / 2
