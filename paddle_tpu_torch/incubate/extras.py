"""``LookAhead`` and ``ModelAverage`` (counterparts of the classes in
``paddle_tpu/incubate/extras.py``). Both keep copies of the parameters;
the parameters themselves are written in place."""

from __future__ import annotations

import contextlib
from typing import Dict, Optional

import torch


class LookAhead:
    """k fast steps of the inner optimizer, then the slow weights move
    ``alpha`` of the way to the fast ones and the fast weights take them.
    The slow weights start as the parameters after the first fast step,
    as in JAX."""

    def __init__(self, inner_optimizer, alpha: float = 0.5, k: int = 5,
                 name=None):
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self._step = 0
        self._slow: Optional[Dict[str, torch.Tensor]] = None

    @torch.no_grad()
    def step(self, grads=None):
        """One fast step: from ``grads`` (name → tensor) or, without them,
        the bound parameters' ``.grad``."""
        inner = self.inner_optimizer
        if grads is None:
            inner.step()
        else:
            inner.apply_gradients(inner._bound_params, grads)
        self._step += 1
        bound = inner._bound_params
        if self._slow is None:
            self._slow = {k: p.detach().clone() for k, p in bound.items()}
        if self._step % self.k == 0:
            for k, p in bound.items():
                s = self._slow[k]
                s.copy_(s + self.alpha * (p - s))
                p.copy_(s)

    def __getattr__(self, name):
        return getattr(self.inner_optimizer, name)


class ModelAverage:
    """A running sum of a model's state for evaluation with the averaged
    values: ``step`` adds the current state (restarting the window as JAX
    does), ``apply()`` is a context that loads the average and restores
    the live values after."""

    def __init__(self, average_window_rate: float, parameters=None,
                 min_average_window: int = 10000,
                 max_average_window: int = 10000, name=None):
        self.rate = average_window_rate
        self.min_w = min_average_window
        self.max_w = max_average_window
        self._layer = parameters if hasattr(parameters, "state_dict") \
            else None
        self._sum: Optional[Dict[str, torch.Tensor]] = None
        self._n = 0
        self._backup = None

    @staticmethod
    def _state(layer) -> Dict[str, torch.Tensor]:
        return {k: v.detach().clone() for k, v in layer.state_dict().items()}

    @torch.no_grad()
    def step(self, layer=None):
        layer = layer or self._layer
        state = self._state(layer)
        if self._sum is None:
            self._sum, self._n = state, 1
            return
        window = max(self.min_w, min(self.max_w, int(self._n * self.rate) + 1))
        if self._n >= window:          # restart the window
            self._sum, self._n = state, 1
        else:
            self._sum = {k: self._sum[k] + v for k, v in state.items()}
            self._n += 1

    def apply(self, executor=None, need_restore: bool = True, layer=None):
        @contextlib.contextmanager
        def guard():
            tgt = layer or self._layer
            self._backup = self._state(tgt)
            tgt.load_state_dict({k: v / self._n
                                 for k, v in self._sum.items()})
            try:
                yield
            finally:
                if need_restore:
                    tgt.load_state_dict(self._backup)

        return guard()

    def restore(self, executor=None, layer=None):
        tgt = layer or self._layer
        if self._backup is not None:
            tgt.load_state_dict(self._backup)


__all__ = ["LookAhead", "ModelAverage"]
