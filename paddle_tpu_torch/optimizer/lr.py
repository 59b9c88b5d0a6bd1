"""Learning-rate schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``):
the ``LRScheduler`` base and the pretraining recipe's ``LinearWarmup``
and ``CosineAnnealingDecay``; the other schedulers come with a later
slice.

``get_lr()`` is the scheduler's float64 value at ``last_epoch``, as in
the JAX package. :meth:`LRScheduler.lr_of` is the value a step applies:
the JAX ``Trainer`` evaluates these schedulers' ``lr_of(step)`` in fp32
inside its compiled step, so here it is the same arithmetic in fp32
(numpy scalars), returned as a Python float.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

f32 = np.float32


class LRScheduler:
    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1):
        self.base_lr = learning_rate
        self.last_epoch = last_epoch
        self.last_lr = learning_rate
        self.step()  # paddle initializes by stepping to epoch 0

    def get_lr(self) -> float:
        raise NotImplementedError

    def step(self, epoch: Optional[int] = None) -> None:
        if epoch is None:
            self.last_epoch += 1
        else:
            self.last_epoch = epoch
        self.last_lr = self.get_lr()

    def get_last_lr(self) -> float:
        return self.last_lr

    def lr_of(self, step: int) -> float:
        """The learning rate applied at trainer step ``step`` (0-based),
        without changing the scheduler: ``get_lr()`` at that epoch,
        rounded to fp32 as the JAX trainer's device scalar is."""
        prev_epoch, prev_lr = self.last_epoch, self.last_lr
        try:
            self.last_epoch = int(step)
            return float(f32(self.get_lr()))
        finally:
            self.last_epoch, self.last_lr = prev_epoch, prev_lr

    def state_dict(self):
        return {"last_epoch": self.last_epoch, "last_lr": self.last_lr}

    def set_state_dict(self, state):
        self.last_epoch = state["last_epoch"]
        self.last_lr = state["last_lr"]

    def __call__(self) -> float:
        return self.last_lr


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps: int, start_lr: float,
                 end_lr: float, last_epoch: int = -1):
        self.lr_after = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        super().__init__(start_lr, last_epoch)

    def get_lr(self):
        if self.last_epoch < self.warmup_steps:
            return (self.end_lr - self.start_lr) * self.last_epoch / max(
                self.warmup_steps, 1) + self.start_lr
        if isinstance(self.lr_after, LRScheduler):
            self.lr_after.step(self.last_epoch - self.warmup_steps)
            return self.lr_after.get_last_lr()
        return self.lr_after

    def lr_of(self, step: int) -> float:
        """fp32 copy of ``paddle_tpu``'s ``LinearWarmup.lr_of``."""
        if step < self.warmup_steps:
            return float(f32(self.end_lr - self.start_lr) * f32(step)
                         / f32(max(self.warmup_steps, 1))
                         + f32(self.start_lr))
        if isinstance(self.lr_after, LRScheduler):
            return self.lr_after.lr_of(step - self.warmup_steps)
        return float(f32(self.lr_after))


class CosineAnnealingDecay(LRScheduler):
    def __init__(self, learning_rate: float, T_max: int, eta_min: float = 0.0,
                 last_epoch: int = -1):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)

    def lr_of(self, step: int) -> float:
        """fp32 copy of ``paddle_tpu``'s ``CosineAnnealingDecay.lr_of``."""
        s = f32(step)
        cos = np.cos(f32(math.pi) * s / f32(self.T_max))
        return float(f32(self.eta_min) + f32(self.base_lr - self.eta_min)
                     * (f32(1) + cos) / f32(2))


__all__ = ["LRScheduler", "LinearWarmup", "CosineAnnealingDecay"]
