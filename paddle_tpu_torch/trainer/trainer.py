"""Training loop with throughput and MFU accounting (counterpart of
``paddle_tpu/trainer/trainer.py``).

The JAX ``Trainer`` jits one functional step over donated parameter and
optimizer-state pytrees. Here the step is eager: the model's forward
with ``labels``, ``loss.backward()`` (the kernels' autograd Functions on
the card), then the optimizer's in-place update. The learning rate of
step n is the scheduler's ``lr_of(n)``, the fp32 value the JAX trainer
evaluates in its step; a constant rate is rounded to fp32 likewise.

MFU = tokens/s × ``model.flops_per_token(seq_len)`` (PaLM count) ÷ the
card's peak, from :data:`PEAK_FLOPS`. A device missing from the table
(the CPU among them) reports MFU as NaN rather than against a made-up
peak.

Not ported yet, and refused rather than ignored: checkpointing and
resume, the anomaly and preemption guards, ``steps_per_dispatch > 1``
(the superstep) and optimizer-state offload.
"""

from __future__ import annotations

import inspect
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch

from ..device import device_info
from ..optimizer.optimizer import Optimizer

# bf16 dense tensor-core peak per card, FLOP/s (NVIDIA H100 SXM data
# sheet; the rate assumes the card's full 700 W power limit)
PEAK_FLOPS = {"h100": 989e12}


def device_peak_flops(device: torch.device) -> Optional[float]:
    """The bf16 peak of ``device`` from :data:`PEAK_FLOPS`, or None."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).lower()
    return next((v for k, v in PEAK_FLOPS.items() if k in name), None)


@dataclass
class TrainMetrics:
    step: int
    loss: float
    step_time_s: float
    tokens_per_sec: float
    tokens_per_sec_per_chip: float
    mfu: float
    lr: float

    def as_dict(self):
        return self.__dict__.copy()


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: it comes with "
                               f"the trainer-runtime slice")


class Trainer:
    """One-card trainer over an ``nn.Module`` whose forward takes the
    batch's keys (``input_ids``, ``labels``, ...) and returns the loss,
    or ``(loss, ...)``; a forward that takes ``return_logits`` is called
    with ``return_logits=False``, for the loss alone.

    ``accumulate_steps`` > 1: each batch tensor carries a leading
    microbatch dimension [A, ...]; the gradients of the A microbatches
    are summed in the parameters' dtype and divided by A, the loss is the
    mean, as in the JAX trainer. ``seed`` keys the step's random streams
    in the JAX trainer; the port's steps draw none (attention dropout is
    0), so a seed other than 0 is refused until one does."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 accumulate_steps: int = 1, seed: int = 0,
                 offload_opt_state: Optional[bool] = None):
        if offload_opt_state:
            raise _later("offload_opt_state")
        if seed != 0:
            raise NotImplementedError(
                "Trainer(seed=...) keys random streams that no ported "
                "training step draws yet; leave seed=0")
        self.model = model
        self._loss_only = "return_logits" in inspect.signature(
            model.forward).parameters
        self.optimizer = optimizer
        self.params: Dict[str, torch.Tensor] = {
            n: p for n, p in model.named_parameters() if p.requires_grad}
        self.accumulate_steps = max(1, int(accumulate_steps))
        self._step = 0
        self.device = next(model.parameters()).device
        self.peak_flops = device_peak_flops(self.device)
        # the card's name and power limit: the peak assumes the full limit
        self.card = device_info() if self.device.type == "cuda" else None

    def _lr(self) -> float:
        sched = self.optimizer.lr_scheduler
        if sched is not None:
            return sched.lr_of(self._step)
        return float(np.float32(self.optimizer.get_lr()))

    def _loss(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        # the loss alone from a model that can return it so: what the JAX
        # trainer's jit gets by dropping the unread logits, which eager
        # PyTorch would otherwise compute (a [b, s, vocab] product)
        if self._loss_only:
            return self.model(**batch, return_logits=False)
        out = self.model(**batch)
        return out[0] if isinstance(out, tuple) else out

    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimization step. Returns the loss as a 0-d tensor on the
        device, without waiting for it: callers read ``float()`` only
        when they need the value."""
        lr = self._lr()
        for p in self.params.values():
            p.grad = None
        A = self.accumulate_steps
        if A == 1:
            loss = self._loss(batch)
            loss.backward()
            loss = loss.detach()
        else:
            loss = None
            for i in range(A):
                li = self._loss({k: v[i] for k, v in batch.items()})
                li.backward()
                loss = li.detach() if loss is None else loss + li.detach()
            loss = loss / A
            with torch.no_grad():
                for p in self.params.values():
                    if p.grad is not None:
                        p.grad.div_(A)
        grads = {k: p.grad for k, p in self.params.items()
                 if p.grad is not None}
        self.optimizer.apply_gradients(self.params, grads, lr=lr)
        self._step += 1
        sched = self.optimizer.lr_scheduler
        if sched is not None:
            sched.step()
        return loss

    def fit(self, data: Iterable[Dict[str, torch.Tensor]], steps: int,
            log_every: int = 10, on_metrics: Optional[Callable] = None,
            seq_len: Optional[int] = None, checkpoint_manager=None,
            resume=None, anomaly_guard=None, preemption_guard=None,
            steps_per_dispatch: int = 1) -> List[TrainMetrics]:
        """Train ``steps`` steps from ``data`` (stopping early when it
        runs out). Every ``log_every`` steps the loss is read (the only
        wait for the device) and a :class:`TrainMetrics` over the steps
        since the last one is recorded and passed to ``on_metrics``."""
        for name, val in (("checkpoint_manager", checkpoint_manager),
                          ("resume", resume),
                          ("anomaly_guard", anomaly_guard),
                          ("preemption_guard", preemption_guard)):
            if val:
                raise _later(name)
        if int(steps_per_dispatch) > 1:
            raise _later("steps_per_dispatch > 1")
        target = self._step + int(steps)
        it = iter(data)
        history: List[TrainMetrics] = []
        t_last = time.perf_counter()
        tokens_since = 0
        while self._step < target:
            try:
                batch = next(it)
            except StopIteration:
                break
            ids = batch.get("input_ids")
            loss = self.train_step(batch)
            tokens_since += ids.numel() if ids is not None else 0
            if self._step % log_every:
                continue
            loss_v = float(loss)   # waits for the device
            dt = time.perf_counter() - t_last
            tps = tokens_since / dt if dt > 0 else 0.0
            sl = seq_len or (ids.shape[-1] if ids is not None else 1)
            fpt = (self.model.flops_per_token(sl)
                   if hasattr(self.model, "flops_per_token") else 0.0)
            mfu = (tps * fpt / self.peak_flops
                   if fpt and self.peak_flops else math.nan)
            m = TrainMetrics(step=self._step, loss=loss_v,
                             step_time_s=dt / log_every,
                             tokens_per_sec=tps,
                             tokens_per_sec_per_chip=tps, mfu=mfu,
                             lr=self.optimizer.get_lr())
            history.append(m)
            if on_metrics:
                on_metrics(m)
            t_last = time.perf_counter()
            tokens_since = 0
        return history


__all__ = ["Trainer", "TrainMetrics", "PEAK_FLOPS", "device_peak_flops"]
