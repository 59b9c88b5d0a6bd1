"""Optimizers (counterpart of ``paddle_tpu/optimizer/optimizer.py``): the
``Optimizer`` base and SGD, Momentum, Adam, AdamW, Adamax, Adagrad,
RMSProp, Adadelta, Lamb and Rprop (LBFGS is in ``lbfgs.py``).

The JAX package defines each optimizer by two pure functions over dicts
of arrays (``init_state``, ``apply_gradients``). The port keeps the same
state layout — ``{"step", "master", "slots"}``, fp32 masters for bf16
and fp16 parameters only, fp32 slots under the JAX slot names — but
updates the parameters, the masters and the slots IN PLACE under
``torch.no_grad()``, which saves a copy of the optimizer state on the
card. A bf16 parameter is then the cast of its updated master, as there.
A bf16 or fp16 parameter without a master (``multi_precision=False``,
Rprop's default) is updated as JAX updates it: an fp32 copy goes through
the update and is rounded back into the parameter once.

Each ``_update_`` keeps the JAX expression's operations and their order
in fp32 (a Python scalar multiplies in fp32 on both sides).

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
            # offloaded state: this parameter's master and slots up,
            # updated, and back into the same pinned tensors; stream order
            # keeps the copies and the update in sequence
            host = [t for t in ([master] if master is not None else [])
                    + list(slots.values()) if _is_on_host(t, p)]
            up = {id(t): t.to(p.device, non_blocking=True) for t in host}
            # no master: an fp32 parameter is updated in place, a bf16 or
            # fp16 one through an fp32 copy rounded back once (as JAX's
            # ``p.astype(float32)`` ... ``.astype(p.dtype)``)
            p32 = up.get(id(master), master) if master is not None \
                else p.float()
            dslots = {sk: up.get(id(sv), sv) for sk, sv in slots.items()}
            self._update_(k, p32, g.float(), dslots, lr, state["step"])
            if p32 is not p:
                p.copy_(p32)
            for t in host:
                t.copy_(up[id(t)], non_blocking=True)

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


def _slot(p: torch.Tensor, device, fill: float = 0.0) -> torch.Tensor:
    """An fp32 slot shaped as ``p`` on ``device`` (default ``p``'s),
    filled with ``fill``."""
    return torch.full(p.shape, fill, dtype=torch.float32,
                      device=p.device if device is None else device)


def _bias_correction(beta: float, step: int) -> float:
    """``1 - beta ** t`` in fp32 from the step counter, as
    ``step.astype(float32)`` and ``beta ** t`` are in JAX (exact as a
    Python float)."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return float(1 - torch.pow(torch.tensor(beta, dtype=torch.float32), t))


class SGD(Optimizer):
    def _update_(self, name, p32, g32, slots, lr, step):
        """p = p - lr * g (the decay folded into g)."""
        if self._weight_decay and self._decayed(name):
            g32 = g32 + self._weight_decay * p32
        p32.sub_(g32 * lr)


class Momentum(Optimizer):
    def __init__(self, learning_rate=0.001, momentum: float = 0.9,
                 parameters=None, use_nesterov: bool = False,
                 weight_decay=0.0, grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.momentum = momentum
        self.use_nesterov = use_nesterov

    def _init_slots(self, p, device=None):
        return {"velocity": _slot(p, device)}

    def _update_(self, name, p32, g32, slots, lr, step):
        """v = mu v + g;  p = p - lr * v, or with Nesterov
        p = p - lr * (g + mu v)."""
        if self._weight_decay and self._decayed(name):
            g32 = g32 + self._weight_decay * p32
        v = slots["velocity"]
        v.mul_(self.momentum).add_(g32)
        if self.use_nesterov:
            p32.sub_((g32 + self.momentum * v).mul_(lr))
        else:
            p32.sub_(v * lr)


class Adam(Optimizer):
    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8,
                 parameters=None, weight_decay=0.0, grad_clip=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slots(self, p, device=None):
        return {"m": _slot(p, device), "v": _slot(p, device)}

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
        bc1 = _bias_correction(self.beta1, step)
        bc2 = _bias_correction(self.beta2, step)
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


class Adamax(Optimizer):
    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_slots(self, p, device=None):
        return {"m": _slot(p, device), "u": _slot(p, device)}

    def _update_(self, name, p32, g32, slots, lr, step):
        """m = b1 m + (1 - b1) g;  u = max(b2 u, |g|);
        p = p - lr / (1 - b1^t) * m / (u + eps)."""
        if self._weight_decay and self._decayed(name):
            g32 = g32 + self._weight_decay * p32
        m, u = slots["m"], slots["u"]
        m.mul_(self.beta1).add_(g32 * (1 - self.beta1))
        torch.maximum(u.mul_(self.beta2), g32.abs(), out=u)
        lr32 = float(torch.tensor(lr, dtype=torch.float32))
        coef = lr32 / _bias_correction(self.beta1, step)
        p32.sub_((m * coef).div_(u + self.epsilon))


class Adagrad(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon: float = 1e-6,
                 parameters=None, weight_decay=0.0, grad_clip=None,
                 multi_precision=True,
                 initial_accumulator_value: float = 0.0):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.epsilon = epsilon
        self.init_acc = initial_accumulator_value

    def _init_slots(self, p, device=None):
        return {"acc": _slot(p, device, self.init_acc)}

    def _update_(self, name, p32, g32, slots, lr, step):
        """acc = acc + g^2;  p = p - lr * g / (sqrt(acc) + eps)."""
        if self._weight_decay and self._decayed(name):
            g32 = g32 + self._weight_decay * p32
        acc = slots["acc"]
        acc.add_(torch.square(g32))
        p32.sub_((g32 * lr).div_(acc.sqrt().add_(self.epsilon)))


class RMSProp(Optimizer):
    def __init__(self, learning_rate=0.001, rho: float = 0.95,
                 epsilon: float = 1e-6, momentum: float = 0.0,
                 centered: bool = False, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.rho, self.epsilon = rho, epsilon
        self.momentum, self.centered = momentum, centered

    def _init_slots(self, p, device=None):
        s = {"ms": _slot(p, device), "mom": _slot(p, device)}
        if self.centered:
            s["mg"] = _slot(p, device)
        return s

    def _update_(self, name, p32, g32, slots, lr, step):
        """ms = rho ms + (1 - rho) g^2;  centered: mg = rho mg + (1 - rho)
        g, denom = sqrt(ms - mg^2 + eps), else sqrt(ms + eps);
        mom = mu mom + lr * g / denom;  p = p - mom."""
        if self._weight_decay and self._decayed(name):
            g32 = g32 + self._weight_decay * p32
        ms, mom = slots["ms"], slots["mom"]
        ms.mul_(self.rho).add_(torch.square(g32).mul_(1 - self.rho))
        if self.centered:
            mg = slots["mg"]
            mg.mul_(self.rho).add_(g32 * (1 - self.rho))
            denom = (ms - torch.square(mg)).add_(self.epsilon).sqrt_()
        else:
            denom = (ms + self.epsilon).sqrt_()
        mom.mul_(self.momentum).add_((g32 * lr).div_(denom))
        p32.sub_(mom)


class Adadelta(Optimizer):
    def __init__(self, learning_rate=0.001, epsilon: float = 1e-6,
                 rho: float = 0.95, parameters=None, weight_decay=0.0,
                 grad_clip=None, multi_precision=True):
        super().__init__(learning_rate, parameters, weight_decay, grad_clip,
                         multi_precision)
        self.epsilon, self.rho = epsilon, rho

    def _init_slots(self, p, device=None):
        return {"avg_sq_grad": _slot(p, device),
                "avg_sq_update": _slot(p, device)}

    def _update_(self, name, p32, g32, slots, lr, step):
        """asg = rho asg + (1 - rho) g^2;
        upd = sqrt(asu + eps) / sqrt(asg + eps) * g (the old asu);
        asu = rho asu + (1 - rho) upd^2;  p = p - lr * upd."""
        if self._weight_decay and self._decayed(name):
            g32 = g32 + self._weight_decay * p32
        asg, asu = slots["avg_sq_grad"], slots["avg_sq_update"]
        asg.mul_(self.rho).add_(torch.square(g32).mul_(1 - self.rho))
        upd = (asu + self.epsilon).sqrt_().div_(
            (asg + self.epsilon).sqrt_()).mul_(g32)
        asu.mul_(self.rho).add_(torch.square(upd).mul_(1 - self.rho))
        p32.sub_(upd.mul_(lr))


class Lamb(Optimizer):
    """Adam's update rescaled by the trust ratio ||p|| / ||update|| of
    whole-tensor norms; ``lamb_weight_decay`` is decoupled and taken off
    the parameters ``exclude_from_weight_decay_fn(name)`` names."""

    def __init__(self, learning_rate=0.001, lamb_weight_decay: float = 0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, parameters=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 multi_precision=True):
        super().__init__(learning_rate, parameters, lamb_weight_decay,
                         grad_clip, multi_precision)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon
        self.exclude_fn = exclude_from_weight_decay_fn

    def _init_slots(self, p, device=None):
        return {"m": _slot(p, device), "v": _slot(p, device)}

    def _update_(self, name, p32, g32, slots, lr, step):
        """m, v as Adam; r = mhat / (sqrt(vhat) + eps) + wd p;
        trust = ||p|| / ||r|| where both are > 0, else 1;
        p = p - lr * trust * r. The trust ratio stays on the device."""
        m, v = slots["m"], slots["v"]
        m.mul_(self.beta1).add_(g32 * (1 - self.beta1))
        v.mul_(self.beta2).add_(torch.square(g32).mul_(1 - self.beta2))
        bc1 = _bias_correction(self.beta1, step)
        bc2 = _bias_correction(self.beta2, step)
        r = (m / bc1).div_((v / bc2).sqrt_().add_(self.epsilon))
        wd = self._weight_decay
        if self.exclude_fn is not None and self.exclude_fn(name):
            wd = 0.0
        r.add_(wd * p32)
        p_norm = torch.square(p32).sum().sqrt()
        r_norm = torch.square(r).sum().sqrt()
        trust = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm,
                            torch.ones_like(p_norm))
        p32.sub_(r.mul_(trust.mul_(lr)))


class Rprop(Optimizer):
    """Resilient backprop: sign-based step sizes per element, grown by
    ``etas[1]`` where the gradient keeps its sign, shrunk by ``etas[0]``
    where it flips (and that element's update skipped), clipped to
    ``learning_rate_range``; the step sizes start at ``learning_rate``.
    A full-batch method. ``multi_precision=False`` by default, so a bf16
    parameter is updated through an fp32 copy (module docstring)."""

    def __init__(self, learning_rate: float = 0.001,
                 learning_rate_range=(1e-5, 50.0), parameters=None,
                 etas=(0.5, 1.2), grad_clip=None, multi_precision=False,
                 name=None):
        super().__init__(learning_rate=learning_rate, parameters=parameters,
                         grad_clip=grad_clip,
                         multi_precision=multi_precision)
        self._lr_min, self._lr_max = learning_rate_range
        self._eta_neg, self._eta_pos = etas
        self._init_lr = learning_rate

    def _init_slots(self, p, device=None):
        return {"step_size": _slot(p, device, self._init_lr),
                "prev_grad": _slot(p, device)}

    def _update_(self, name, p32, g32, slots, lr, step):
        """sign = sign(g * prev); size = clip(size * eta+ where sign > 0,
        size * eta- where < 0, else size); where the sign flipped the
        gradient counts as 0 (no step, and prev = 0);
        p = p - sign(g_eff) * size."""
        size, prev = slots["step_size"], slots["prev_grad"]
        sign = torch.sign(g32 * prev)
        grow, flip = sign > 0, sign < 0
        size.copy_(torch.where(grow, size * self._eta_pos,
                               torch.where(flip, size * self._eta_neg, size)
                               ).clamp_(self._lr_min, self._lr_max))
        g_eff = torch.where(flip, torch.zeros_like(g32), g32)
        prev.copy_(g_eff)
        p32.sub_(torch.sign(g_eff).mul_(size))


__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "RMSProp", "Adadelta", "Lamb", "Rprop",
           "place_opt_state"]
