"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``): the
``Optimizer`` base and ``Adam`` / ``AdamW``; the other optimizers come
with a later slice.

The JAX package defines each optimizer by two pure functions over dicts
of arrays (``init_state``, ``apply_gradients``). The port keeps the same
state layout — ``{"step", "master", "slots"}``, fp32 masters for bf16
and fp16 parameters only, fp32 moments — but updates the parameters, the
masters and the moments IN PLACE under ``torch.no_grad()``, which saves a
copy of the optimizer state on the card. A bf16 parameter is then the
cast of its updated master, as there.

``step()`` reads each bound parameter's ``.grad``; ``apply_gradients``
takes an explicit name → gradient dict. Gradient clipping runs before
the update.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch
from torch import nn

from .clip import ClipGradBase
from .lr import LRScheduler

Params = Dict[str, torch.Tensor]


def _is_low_precision(t: torch.Tensor) -> bool:
    return t.dtype in (torch.bfloat16, torch.float16)


def _copy_state(tree):
    if isinstance(tree, dict):
        return {k: _copy_state(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


class Optimizer:
    def __init__(self, learning_rate: Union[float, LRScheduler] = 0.001,
                 parameters=None, weight_decay: float = 0.0,
                 grad_clip: Optional[ClipGradBase] = None,
                 multi_precision: bool = True,
                 apply_decay_param_fun: Optional[Callable[[str], bool]] = None
                 ):
        """``parameters``: an ``nn.Module`` (its trainable named
        parameters), a dict name → parameter, or None (then only
        ``apply_gradients`` with explicit dicts is usable)."""
        self._lr = learning_rate
        self._weight_decay = weight_decay if weight_decay is not None else 0.0
        self.grad_clip = grad_clip
        self.multi_precision = multi_precision
        self.apply_decay_param_fun = apply_decay_param_fun
        if isinstance(parameters, nn.Module):
            parameters = {n: p for n, p in parameters.named_parameters()
                          if p.requires_grad}
        self._bound_params: Params = dict(parameters or {})
        self._state: Optional[Dict] = None

    # -- lr ------------------------------------------------------------------

    def get_lr(self) -> float:
        if isinstance(self._lr, LRScheduler):
            return self._lr.get_last_lr()
        return self._lr

    def set_lr(self, lr: float) -> None:
        if isinstance(self._lr, LRScheduler):
            raise RuntimeError("cannot set_lr when using an LRScheduler")
        self._lr = lr

    @property
    def lr_scheduler(self) -> Optional[LRScheduler]:
        return self._lr if isinstance(self._lr, LRScheduler) else None

    # -- state ---------------------------------------------------------------

    def init_state(self, params: Params) -> Dict:
        state = {"step": 0, "master": {}, "slots": {}}
        with torch.no_grad():
            if self.multi_precision:
                state["master"] = {k: v.detach().float()
                                   for k, v in params.items()
                                   if _is_low_precision(v)}
            state["slots"] = {k: self._init_slots(v)
                              for k, v in params.items()}
        return state

    def _init_slots(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {}

    def _update_(self, name: str, p32: torch.Tensor, g32: torch.Tensor,
                 slots: Dict[str, torch.Tensor], lr: float,
                 step: int) -> None:
        """Update the fp32 parameter ``p32`` and the slots in place."""
        raise NotImplementedError

    def _decayed(self, name: str) -> bool:
        if self.apply_decay_param_fun is not None:
            return bool(self.apply_decay_param_fun(name))
        return True

    @torch.no_grad()
    def apply_gradients(self, params: Params, grads: Params,
                        lr: Optional[float] = None) -> None:
        """One update of ``params`` (name → tensor, changed in place) from
        ``grads``; a parameter without a gradient is left as it is. The
        state is created at the first call. ``lr`` defaults to
        :meth:`get_lr`."""
        if self._state is None:
            self._state = self.init_state(params)
        if lr is None:
            lr = self.get_lr()
        if self.grad_clip is not None:
            grads = self.grad_clip(grads)
        state = self._state
        state["step"] += 1
        for k, p in params.items():
            g = grads.get(k)
            if g is None:
                continue
            master = state["master"].get(k)
            p32 = master if master is not None else p
            if p32.dtype != torch.float32:
                raise TypeError(f"{k}: {p.dtype} parameter without an fp32 "
                                f"master (multi_precision=False)")
            self._update_(k, p32, g.float(), state["slots"][k], lr,
                          state["step"])
            if master is not None:
                p.copy_(master)

    def step(self) -> None:
        """Apply an update to the bound parameters from their ``.grad``."""
        if not self._bound_params:
            raise RuntimeError("optimizer has no trainable parameters bound")
        grads = {k: p.grad for k, p in self._bound_params.items()
                 if p.grad is not None}
        self.apply_gradients(self._bound_params, grads)

    def clear_grad(self) -> None:
        for p in self._bound_params.values():
            p.grad = None

    clear_gradients = clear_grad

    def state_dict(self) -> Dict:
        """The live state (tensors are not copied, as in torch's
        optimizers): the next update changes them in place."""
        out = {"state": self._state}
        if isinstance(self._lr, LRScheduler):
            out["lr_scheduler"] = self._lr.state_dict()
        return out

    def set_state_dict(self, sd: Dict) -> None:
        """Take a copy of ``sd``'s state, which the updates then own."""
        self._state = _copy_state(sd.get("state"))
        if "lr_scheduler" in sd and isinstance(self._lr, LRScheduler):
            self._lr.set_state_dict(sd["lr_scheduler"])


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay=0.0, grad_clip=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slots(self, p):
        return {"m": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device),
                "v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device)}

    def _decoupled(self) -> bool:
        return False

    def _update_(self, name, p32, g32, slots, lr, step):
        """The update of ``paddle_tpu``'s ``Adam._update`` in fp32, each
        operation rounded as there:
        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g^2;
        upd = (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + eps)
        (+ wd * p for decoupled decay);  p = p - lr * upd.
        Plain Adam folds the decay into the gradient instead."""
        decay = self._weight_decay and self._decayed(name)
        if decay and not self._decoupled():
            g32 = g32 + self._weight_decay * p32
        m, v = slots["m"], slots["v"]
        m.mul_(self.beta1).add_(g32 * (1 - self.beta1))
        v.mul_(self.beta2).add_(torch.square(g32).mul_(1 - self.beta2))
        # bias corrections in fp32 from the step counter, as
        # ``step.astype(float32)`` and ``beta ** t`` are in JAX
        t = torch.tensor(float(step), dtype=torch.float32)
        bc1 = float(1 - torch.pow(torch.tensor(self.beta1,
                                               dtype=torch.float32), t))
        bc2 = float(1 - torch.pow(torch.tensor(self.beta2,
                                               dtype=torch.float32), t))
        upd = (m / bc1).div_((v / bc2).sqrt_().add_(self.epsilon))
        if decay and self._decoupled():
            upd.add_(self._weight_decay * p32)
        p32.sub_(upd.mul_(lr))


class AdamW(Adam):
    """Decoupled weight decay: ``p -= lr * (update + wd * p)``, the decay
    outside the moments. ``apply_decay_param_fun(name)`` chooses the
    decayed parameters; by default every parameter is decayed, norm
    weights and embeddings included, as in ``paddle_tpu``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay: float = 0.01,
                 grad_clip=None, multi_precision=True,
                 apply_decay_param_fun=None):
        super().__init__(learning_rate, beta1, beta2, epsilon, parameters,
                         weight_decay, grad_clip, multi_precision)
        self.apply_decay_param_fun = apply_decay_param_fun

    def _decoupled(self) -> bool:
        return True


__all__ = ["Optimizer", "Adam", "AdamW"]
