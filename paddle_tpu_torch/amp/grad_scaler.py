"""GradScaler: dynamic loss scaling (counterpart of
``paddle_tpu/amp/grad_scaler.py``).

``scale *= incr_ratio`` after ``incr_every_n_steps`` good steps; on a
non-finite gradient the update is skipped and, after
``decr_every_n_nan_or_inf`` such steps, ``scale *= decr_ratio`` (not
below 1). Gradients are a name → tensor dict, as the optimizers'
``apply_gradients`` takes them; ``step`` without one reads the bound
parameters' ``.grad``. ``unscale_`` reads one flag on the host.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

Grads = Dict[str, torch.Tensor]


def _bound_grads(optimizer) -> Grads:
    return {k: p.grad for k, p in optimizer._bound_params.items()
            if p.grad is not None}


class AmpScaler:
    def __init__(self, enable: bool = True,
                 init_loss_scaling: float = 2.0 ** 15,
                 incr_ratio: float = 2.0, decr_ratio: float = 0.5,
                 incr_every_n_steps: int = 1000,
                 decr_every_n_nan_or_inf: int = 2,
                 use_dynamic_loss_scaling: bool = True):
        self._enable = enable
        self._scale = float(init_loss_scaling)
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._incr_every_n_steps = incr_every_n_steps
        self._decr_every_n = decr_every_n_nan_or_inf
        self._dynamic = use_dynamic_loss_scaling
        self._good_steps = 0
        self._bad_steps = 0
        self._found_inf = False
        self._already_unscaled = False

    def is_enable(self) -> bool:
        return self._enable

    def is_use_dynamic_loss_scaling(self) -> bool:
        return self._dynamic

    def get_loss_scaling(self) -> float:
        return self._scale

    def set_init_loss_scaling(self, v: float) -> None:
        self._scale = float(v)

    def scale(self, loss):
        if not self._enable:
            return loss
        return loss * self._scale

    def unscale_(self, grads: Grads) -> Grads:
        """The gradients in fp32 times 1 / scale (new tensors), and
        whether any is non-finite (one host read)."""
        if not self._enable:
            return grads
        inv = 1.0 / self._scale
        out = {k: g.float() * inv for k, g in grads.items()}
        if out:
            finite = torch.stack([torch.isfinite(g).all()
                                  for g in out.values()]).all()
            self._found_inf = not bool(finite)
        else:
            self._found_inf = False
        self._already_unscaled = True
        return out

    def step(self, optimizer, grads: Optional[Grads] = None):
        """Unscale (unless the caller already did, e.g. to clip), then
        update through ``optimizer.apply_gradients`` on its bound
        parameters unless a gradient was non-finite."""
        if grads is None:
            grads = _bound_grads(optimizer)
        if self._enable and not self._already_unscaled:
            grads = self.unscale_(grads)
        if not (self._enable and self._found_inf):
            optimizer.apply_gradients(optimizer._bound_params, grads)

    def update(self) -> None:
        self._already_unscaled = False
        if not (self._enable and self._dynamic):
            return
        if self._found_inf:
            self._good_steps = 0
            self._bad_steps += 1
            if self._bad_steps >= self._decr_every_n:
                self._scale = max(self._scale * self._decr_ratio, 1.0)
                self._bad_steps = 0
        else:
            self._bad_steps = 0
            self._good_steps += 1
            if self._good_steps >= self._incr_every_n_steps:
                self._scale *= self._incr_ratio
                self._good_steps = 0

    def minimize(self, optimizer, loss, grads=None):
        self.step(optimizer, grads)
        self.update()

    def state_dict(self):
        return {"scale": self._scale, "good_steps": self._good_steps,
                "bad_steps": self._bad_steps, "enable": self._enable}

    def load_state_dict(self, sd):
        self._scale = sd["scale"]
        self._good_steps = sd["good_steps"]
        self._bad_steps = sd["bad_steps"]


class GradScaler(AmpScaler):
    """The public name."""


__all__ = ["AmpScaler", "GradScaler"]
