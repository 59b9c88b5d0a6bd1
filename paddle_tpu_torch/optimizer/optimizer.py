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

Optimizer-state offload (:func:`place_opt_state`): masters and moments
may live in pinned host memory between steps. The JAX trainer moves the
whole state up and back in one batched transfer around its step; here
``apply_gradients`` sees host state beside card parameters and streams
it one parameter at a time — that parameter's master and moments copied
up, updated, copied back, all on the current stream — so the card holds
one parameter's state at a time (the largest: the embedding or head)
instead of the whole of it. The arithmetic is the same either way.
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


def _is_on_host(t: torch.Tensor, p: torch.Tensor) -> bool:
    return t.device.type == "cpu" and p.device.type != "cpu"


def _to_kind(t: torch.Tensor, kind: str, device) -> torch.Tensor:
    if kind == "pinned_host":
        if device.type == "cpu":
            return t
        return t.detach().to("cpu").pin_memory()
    if kind == "device":
        return t.to(device, non_blocking=True)
    raise ValueError(f"memory kind {kind!r}: 'pinned_host' or 'device'")


def place_opt_state(state: Dict, params: Params, kind: str) -> Dict:
    """An optimizer state (``{"step", "master", "slots"}``) with each
    master and slot in memory ``kind``: ``"pinned_host"`` (page-locked CPU
    memory, beside card parameters) or ``"device"`` (its parameter's
    device). Parameters on the CPU keep their state where it is. Returns a
    new dict; a tensor already in place is reused. Counterpart of
    ``paddle_tpu.optimizer.place_opt_state``; the port's updates then
    stream host state themselves (module docstring)."""
    def dev(name):
        return params[name].device
    out = dict(state)
    out["master"] = {k: _to_kind(v, kind, dev(k))
                     for k, v in state["master"].items()}
    out["slots"] = {k: {sk: _to_kind(sv, kind, dev(k))
                        for sk, sv in slots.items()}
                    for k, slots in state["slots"].items()}
    return out


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
        # set by a sharding helper in the JAX package; a Trainer built
        # without offload_opt_state= inherits it
        self._offload_opt_state = False

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

    def set_lr_scheduler(self, scheduler: LRScheduler) -> None:
        """Swap in an LRScheduler (reference: optimizer.py
        set_lr_scheduler — subsequent get_lr() reads the scheduler's
        current value)."""
        if not isinstance(scheduler, LRScheduler):
            raise TypeError(f"scheduler must be an LRScheduler, got "
                            f"{type(scheduler).__name__}")
        self._lr = scheduler

    # -- state ---------------------------------------------------------------

    def init_state(self, params: Params, kind: str = "device") -> Dict:
        """A fresh state: fp32 masters of the low-precision parameters and
        zero moments, on the parameters' device or, with ``kind=
        "pinned_host"``, in pinned host memory (built one tensor at a
        time, never whole on the card)."""
        state = {"step": 0, "master": {}, "slots": {}}
        with torch.no_grad():
            if self.multi_precision:
                state["master"] = {
                    k: _to_kind(v.detach().float(), kind, v.device)
                    for k, v in params.items() if _is_low_precision(v)}
            state["slots"] = {
                k: {sk: _to_kind(sv, kind, v.device)
                    for sk, sv in self._init_slots(
                        v, "cpu" if kind == "pinned_host" else None
                    ).items()}
                for k, v in params.items()}
        return state

    def ensure_state(self, params: Params, kind: str = "device") -> Dict:
        """The state, created by :meth:`init_state` if no update made it
        yet (a restore before the first step copies into it)."""
        if self._state is None:
            self._state = self.init_state(params, kind)
        return self._state

    def _init_slots(self, p: torch.Tensor,
                    device=None) -> Dict[str, torch.Tensor]:
        """Zero slots for ``p`` on ``device`` (default ``p``'s)."""
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
        :meth:`get_lr`. A parameter whose master and slots lie in host
        memory has them streamed up and back (module docstring)."""
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
            slots = state["slots"][k]
            p32 = master if master is not None else p
            if p32.dtype != torch.float32:
                raise TypeError(f"{k}: {p.dtype} parameter without an fp32 "
                                f"master (multi_precision=False)")
            host = [t for t in ([master] if master is not None else [])
                    + list(slots.values()) if _is_on_host(t, p)]
            if host:
                # offloaded: this parameter's state up, updated, and back
                # into the same pinned tensors; stream order keeps the
                # copies and the update in sequence
                up = {id(t): t.to(p.device, non_blocking=True)
                      for t in host}
                p32 = up.get(id(p32), p32)
                dslots = {sk: up.get(id(sv), sv) for sk, sv in slots.items()}
                self._update_(k, p32, g.float(), dslots, lr, state["step"])
                if master is not None:
                    p.copy_(p32)
                for t in host:
                    t.copy_(up[id(t)], non_blocking=True)
                continue
            self._update_(k, p32, g.float(), slots, lr, state["step"])
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

    def _init_slots(self, p, device=None):
        device = p.device if device is None else device
        return {"m": torch.zeros(p.shape, dtype=torch.float32,
                                 device=device),
                "v": torch.zeros(p.shape, dtype=torch.float32,
                                 device=device)}

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


__all__ = ["Optimizer", "Adam", "AdamW", "place_opt_state"]
