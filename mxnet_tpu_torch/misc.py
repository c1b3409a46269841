"""Deprecated iteration-based LR schedulers (reference
python/mxnet/misc.py — the pre-``lr_scheduler`` API: ``__call__`` takes
the raw iteration count and scales a stored ``base_lr``). Kept for
parity; new code should use ``mxnet_tpu_torch.lr_scheduler``.
Counterpart of ``mxnet_tpu/misc.py``."""
from __future__ import annotations

import logging
import math


class LearningRateScheduler:
    def __init__(self):
        self.base_lr = 0.01

    def __call__(self, iteration):
        raise NotImplementedError("must override this")


class FactorScheduler(LearningRateScheduler):
    """lr = base_lr * factor^(iteration // step)."""

    def __init__(self, step, factor=0.1):
        super().__init__()
        if step < 1:
            raise ValueError(
                "Schedule step must be greater or equal than 1 round")
        if factor >= 1.0:
            raise ValueError("Factor must be less than 1 to make lr reduce")
        self.step = step
        self.factor = factor
        self.old_lr = self.base_lr

    def __call__(self, iteration):
        lr = self.base_lr * math.pow(self.factor,
                                     int(iteration / self.step))
        if lr != self.old_lr:
            self.old_lr = lr
            logging.info("At Iteration [%d]: Switch to new learning rate "
                         "%.5f", iteration, lr)
        return lr
