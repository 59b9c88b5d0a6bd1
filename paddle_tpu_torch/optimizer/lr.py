"""Learning-rate schedulers (counterpart of ``paddle_tpu/optimizer/lr.py``):
the ``LRScheduler`` base, the sixteen schedulers and the fluid-era decay
functions.

``get_lr()`` is the scheduler's float64 value at ``last_epoch``, as in
the JAX package. :meth:`LRScheduler.lr_of` is the value a step applies.
The JAX ``Trainer`` evaluates a closed-form scheduler's ``lr_of(step)``
in fp32 inside its compiled step (``functional = True``); here each of
those is the same fp32 arithmetic in numpy scalars, rounded at every
operation as XLA rounds it (a Python constant meets an fp32 array as an
fp32 value). A stateful scheduler (``functional = False``) gives
``get_lr()`` at that step rounded once to fp32, the scalar the JAX
trainer transfers for it. ``lr_of`` returns a Python float.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

f32 = np.float32


class LRScheduler:
    #: True when :meth:`lr_of` is a closed form of ``step`` evaluated in
    #: fp32 (the JAX trainer computes it inside its compiled step)
    functional = False

    def __init__(self, learning_rate: float = 0.1, last_epoch: int = -1,
                 verbose=False):
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
        rounded to fp32 as the JAX trainer's device scalar is. Closed-form
        schedulers override it with their fp32 formula."""
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

    # paddle compat
    set_dict = set_state_dict
    state_keys = state_dict

    def __call__(self) -> float:
        return self.last_lr


class NoamDecay(LRScheduler):
    functional = True

    def __init__(self, d_model: int, warmup_steps: int,
                 learning_rate: float = 1.0, last_epoch: int = -1,
                 verbose=False):
        self.d_model = d_model
        self.warmup_steps = warmup_steps
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = max(self.last_epoch, 1)
        return (self.base_lr * self.d_model ** -0.5 *
                min(step ** -0.5, step * self.warmup_steps ** -1.5))

    def lr_of(self, step):
        s = np.maximum(f32(step), f32(1.0))
        return float(f32(self.base_lr * self.d_model ** -0.5) * np.minimum(
            s ** f32(-0.5), s * f32(self.warmup_steps ** -1.5)))


class PiecewiseDecay(LRScheduler):
    functional = True

    def __init__(self, boundaries: Sequence[int], values: Sequence[float],
                 last_epoch: int = -1, verbose=False):
        self.boundaries = list(boundaries)
        self.values = list(values)
        super().__init__(values[0], last_epoch, verbose)

    def get_lr(self):
        for b, v in zip(self.boundaries, self.values):
            if self.last_epoch < b:
                return v
        return self.values[len(self.boundaries)]

    def lr_of(self, step):
        idx = np.searchsorted(np.asarray(self.boundaries, np.int32),
                              np.int32(step), side="right")
        return float(np.asarray(self.values, f32)[idx])


class NaturalExpDecay(LRScheduler):
    functional = True

    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * math.exp(-self.gamma * self.last_epoch)

    def lr_of(self, step):
        s = f32(step)
        return float(f32(self.base_lr) * np.exp(f32(-self.gamma) * s))


class ExponentialDecay(LRScheduler):
    functional = True

    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** self.last_epoch

    def lr_of(self, step):
        s = f32(step)
        return float(f32(self.base_lr) * np.power(f32(self.gamma), s))


class InverseTimeDecay(LRScheduler):
    functional = True

    def __init__(self, learning_rate: float, gamma: float,
                 last_epoch: int = -1, verbose=False):
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr / (1 + self.gamma * self.last_epoch)

    def lr_of(self, step):
        s = f32(step)
        return float(f32(self.base_lr) / (f32(1) + f32(self.gamma) * s))


class PolynomialDecay(LRScheduler):
    functional = True

    def __init__(self, learning_rate: float, decay_steps: int,
                 end_lr: float = 0.0001, power: float = 1.0,
                 cycle: bool = False, last_epoch: int = -1, verbose=False):
        self.decay_steps = decay_steps
        self.end_lr = end_lr
        self.power = power
        self.cycle = cycle
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        step = self.last_epoch
        if self.cycle:
            div = math.ceil(step / self.decay_steps) if step > 0 else 1
            decay_steps = self.decay_steps * div
        else:
            decay_steps = self.decay_steps
            step = min(step, decay_steps)
        return ((self.base_lr - self.end_lr) *
                (1 - step / decay_steps) ** self.power + self.end_lr)

    def lr_of(self, step):
        s = f32(step)
        if self.cycle:
            div = np.maximum(np.ceil(s / f32(self.decay_steps)), f32(1.0))
            decay = f32(self.decay_steps) * div
        else:
            decay = f32(self.decay_steps)
            s = np.minimum(s, decay)
        return float(f32(self.base_lr - self.end_lr)
                     * np.power(f32(1) - s / decay, f32(self.power))
                     + f32(self.end_lr))


class LinearWarmup(LRScheduler):
    def __init__(self, learning_rate, warmup_steps: int, start_lr: float,
                 end_lr: float, last_epoch: int = -1, verbose=False):
        self.lr_after = learning_rate  # float or LRScheduler
        self.warmup_steps = warmup_steps
        self.start_lr = start_lr
        self.end_lr = end_lr
        # closed-form iff the post-warmup target is (the ramp itself is;
        # a wrapped stateful scheduler pins the evaluation to the host)
        self.functional = (not isinstance(learning_rate, LRScheduler)
                           or learning_rate.functional)
        super().__init__(start_lr, last_epoch, verbose)

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
        if not self.functional:
            # host evaluation; get_lr() advances the wrapped scheduler, so
            # its FULL state is restored around the probe (state_dict()
            # alone misses e.g. ReduceOnPlateau's best/num_bad counters)
            inner = {k: (list(v) if isinstance(v, list) else v)
                     for k, v in vars(self.lr_after).items()}
            try:
                return super().lr_of(step)
            finally:
                self.lr_after.__dict__.update(inner)
        if step < self.warmup_steps:
            return float(f32(self.end_lr - self.start_lr) * f32(step)
                         / f32(max(self.warmup_steps, 1))
                         + f32(self.start_lr))
        if isinstance(self.lr_after, LRScheduler):
            return self.lr_after.lr_of(step - self.warmup_steps)
        return float(f32(self.lr_after))


class CosineAnnealingDecay(LRScheduler):
    functional = True

    def __init__(self, learning_rate: float, T_max: int,
                 eta_min: float = 0.0, last_epoch: int = -1, verbose=False):
        self.T_max = T_max
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return (self.eta_min + (self.base_lr - self.eta_min) *
                (1 + math.cos(math.pi * self.last_epoch / self.T_max)) / 2)

    def lr_of(self, step: int) -> float:
        """fp32 copy of ``paddle_tpu``'s ``CosineAnnealingDecay.lr_of``."""
        s = f32(step)
        cos = np.cos(f32(math.pi) * s / f32(self.T_max))
        return float(f32(self.eta_min) + f32(self.base_lr - self.eta_min)
                     * (f32(1) + cos) / f32(2))


class StepDecay(LRScheduler):
    functional = True

    def __init__(self, learning_rate: float, step_size: int,
                 gamma: float = 0.1, last_epoch: int = -1, verbose=False):
        self.step_size = step_size
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.gamma ** (self.last_epoch // self.step_size)

    def lr_of(self, step):
        n = f32(int(step) // self.step_size)
        return float(f32(self.base_lr) * np.power(f32(self.gamma), n))


class MultiStepDecay(LRScheduler):
    functional = True

    def __init__(self, learning_rate: float, milestones: Sequence[int],
                 gamma: float = 0.1, last_epoch: int = -1, verbose=False):
        self.milestones = list(milestones)
        self.gamma = gamma
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        n = sum(1 for m in self.milestones if self.last_epoch >= m)
        return self.base_lr * self.gamma ** n

    def lr_of(self, step):
        n = f32(sum(1 for m in self.milestones if int(step) >= m))
        return float(f32(self.base_lr) * np.power(f32(self.gamma), n))


class LambdaDecay(LRScheduler):
    def __init__(self, learning_rate: float, lr_lambda, last_epoch: int = -1,
                 verbose=False):
        self.lr_lambda = lr_lambda
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        return self.base_lr * self.lr_lambda(self.last_epoch)


class ReduceOnPlateau(LRScheduler):
    """The learning rate as a stateful VALUE: ``step(metrics)`` decays it
    after ``patience`` epochs without improvement. It cannot be recomputed
    from ``last_epoch``, which is why the trainer's checkpoint stores
    ``last_lr`` itself."""

    def __init__(self, learning_rate: float, mode: str = "min",
                 factor: float = 0.1, patience: int = 10,
                 threshold: float = 1e-4, threshold_mode: str = "rel",
                 cooldown: int = 0, min_lr: float = 0, epsilon: float = 1e-8,
                 verbose=False):
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.epsilon = epsilon
        self.best = None
        self.num_bad = 0
        self.cooldown_counter = 0
        self.base_lr = learning_rate
        self.last_lr = learning_rate
        self.last_epoch = 0

    def _better(self, a, b):
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return a < b * (1 - self.threshold)
            return a < b - self.threshold
        if self.threshold_mode == "rel":
            return a > b * (1 + self.threshold)
        return a > b + self.threshold

    def step(self, metrics=None, epoch=None):
        if metrics is None:
            return
        m = float(metrics)
        self.last_epoch += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.best is None or self._better(m, self.best):
            self.best = m
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            new_lr = max(self.last_lr * self.factor, self.min_lr)
            if self.last_lr - new_lr > self.epsilon:
                self.last_lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad = 0

    def get_lr(self):
        return self.last_lr


class OneCycleLR(LRScheduler):
    def __init__(self, max_learning_rate: float, total_steps: int,
                 divide_factor: float = 25.0,
                 end_learning_rate: float = 0.0001, phase_pct: float = 0.3,
                 anneal_strategy: str = "cos", three_phase: bool = False,
                 last_epoch: int = -1, verbose=False):
        self.max_lr = max_learning_rate
        self.total_steps = total_steps
        self.initial_lr = max_learning_rate / divide_factor
        self.end_lr = end_learning_rate
        self.phase_pct = phase_pct
        self.anneal = anneal_strategy
        super().__init__(self.initial_lr, last_epoch, verbose)

    def _anneal(self, start, end, pct):
        if self.anneal == "cos":
            return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return (end - start) * pct + start

    def get_lr(self):
        step = min(self.last_epoch, self.total_steps)
        up_steps = int(self.phase_pct * self.total_steps)
        if step <= up_steps:
            return self._anneal(self.initial_lr, self.max_lr,
                                step / max(up_steps, 1))
        down = (step - up_steps) / max(self.total_steps - up_steps, 1)
        return self._anneal(self.max_lr, self.end_lr, down)


class CyclicLR(LRScheduler):
    def __init__(self, base_learning_rate: float, max_learning_rate: float,
                 step_size_up: int, step_size_down: Optional[int] = None,
                 mode: str = "triangular", exp_gamma: float = 1.0,
                 scale_fn=None, scale_mode: str = "cycle",
                 last_epoch: int = -1, verbose=False):
        self.base_lr_ = base_learning_rate
        self.max_lr = max_learning_rate
        self.up = step_size_up
        self.down = (step_size_down if step_size_down is not None
                     else step_size_up)
        self.mode = mode
        self.exp_gamma = exp_gamma
        super().__init__(base_learning_rate, last_epoch, verbose)

    def get_lr(self):
        total = self.up + self.down
        cycle = math.floor(1 + self.last_epoch / total)
        x = self.last_epoch - (cycle - 1) * total
        pct = x / self.up if x <= self.up else 1 - (x - self.up) / self.down
        scale = 1.0
        if self.mode == "triangular2":
            scale = 1 / (2 ** (cycle - 1))
        elif self.mode == "exp_range":
            scale = self.exp_gamma ** self.last_epoch
        return self.base_lr_ + (self.max_lr - self.base_lr_) * pct * scale


class CosineAnnealingWarmRestarts(LRScheduler):
    def __init__(self, learning_rate: float, T_0: int, T_mult: int = 1,
                 eta_min: float = 0.0, last_epoch: int = -1, verbose=False):
        self.T_0 = T_0
        self.T_mult = T_mult
        self.eta_min = eta_min
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = self.last_epoch
        T_i = self.T_0
        while t >= T_i:
            t -= T_i
            T_i *= self.T_mult
        return self.eta_min + (self.base_lr - self.eta_min) * (
            1 + math.cos(math.pi * t / T_i)) / 2


class LinearLR(LRScheduler):
    """Linear factor ramp start_factor -> end_factor over total_steps
    (reference: optimizer/lr.py LinearLR)."""

    functional = True

    def __init__(self, learning_rate, total_steps, start_factor=1. / 3,
                 end_factor=1.0, last_epoch=-1, verbose=False):
        self.total_steps = total_steps
        self.start_factor = start_factor
        self.end_factor = end_factor
        super().__init__(learning_rate, last_epoch, verbose)

    def get_lr(self):
        t = min(self.last_epoch, self.total_steps)
        frac = t / float(self.total_steps)
        factor = self.start_factor + (self.end_factor
                                      - self.start_factor) * frac
        return self.base_lr * factor

    def lr_of(self, step):
        t = np.minimum(f32(step), f32(self.total_steps))
        factor = (f32(self.start_factor)
                  + f32(self.end_factor - self.start_factor) * t
                  / f32(self.total_steps))
        return float(f32(self.base_lr) * factor)


# ---------------------------------------------------------------------------
# fluid-era decay FUNCTIONS (reference: optimizer/lr.py:2552-3100 keeps them
# importable; dygraph mode returns the scheduler object — the behavior kept
# here)
# ---------------------------------------------------------------------------

class _FluidDecay(LRScheduler):
    """Closed-form fluid decay: lr(step) given by ``fn``, evaluated on the
    host (``functional`` stays False, as in the JAX package)."""

    _auto_step = True

    def __init__(self, fn, learning_rate):
        self._fn = fn
        super().__init__(learning_rate)

    def get_lr(self):
        return self._fn(max(self.last_epoch, 0))


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    s = NoamDecay(d_model=d_model, warmup_steps=warmup_steps,
                  learning_rate=learning_rate)
    s._auto_step = True
    return s


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    def fn(step):
        t = step / float(decay_steps)
        if staircase:
            t = math.floor(t)
        return learning_rate * (decay_rate ** t)
    return _FluidDecay(fn, learning_rate)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    def fn(step):
        t = step / float(decay_steps)
        if staircase:
            t = math.floor(t)
        return learning_rate * math.exp(-decay_rate * t)
    return _FluidDecay(fn, learning_rate)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    def fn(step):
        t = step / float(decay_steps)
        if staircase:
            t = math.floor(t)
        return learning_rate / (1.0 + decay_rate * t)
    return _FluidDecay(fn, learning_rate)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    s = PolynomialDecay(learning_rate=learning_rate,
                        decay_steps=decay_steps,
                        end_lr=end_learning_rate, power=power,
                        cycle=cycle)
    s._auto_step = True   # fluid decays advance per executor step
    return s


def cosine_decay(learning_rate, step_each_epoch, epochs):
    def fn(step):
        epoch = step // step_each_epoch      # fluid: floor to epochs
        return 0.5 * learning_rate * (math.cos(epoch * math.pi / epochs) + 1)
    return _FluidDecay(fn, learning_rate)


def piecewise_decay(boundaries, values):
    s = PiecewiseDecay(boundaries=boundaries, values=values)
    s._auto_step = True
    return s


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    s = LinearWarmup(learning_rate=learning_rate,
                     warmup_steps=warmup_steps, start_lr=start_lr,
                     end_lr=end_lr)
    s._auto_step = True
    return s


def autoincreased_step_counter(counter_name=None, begin=1, step=1):
    """Legacy global step counter variable (reference lr.py:2500). Returns
    a host counter object; the schedulers above own real step state."""
    return np.asarray([begin], np.int64)


__all__ = ["LRScheduler", "NoamDecay", "PiecewiseDecay", "NaturalExpDecay",
           "ExponentialDecay", "InverseTimeDecay", "PolynomialDecay",
           "LinearWarmup", "CosineAnnealingDecay", "StepDecay",
           "MultiStepDecay", "LambdaDecay", "ReduceOnPlateau", "OneCycleLR",
           "CyclicLR", "CosineAnnealingWarmRestarts", "LinearLR",
           "noam_decay", "exponential_decay", "natural_exp_decay",
           "inverse_time_decay", "polynomial_decay", "cosine_decay",
           "piecewise_decay", "linear_lr_warmup",
           "autoincreased_step_counter"]
