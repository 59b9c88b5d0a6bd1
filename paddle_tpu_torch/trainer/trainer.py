"""Training loop with throughput and MFU accounting, and the fault-tolerant
runtime around it (counterpart of ``paddle_tpu/trainer/trainer.py``).

The JAX ``Trainer`` jits one functional step over donated parameter and
optimizer-state pytrees. Here the step is eager: the model's forward
with ``labels``, ``loss.backward()`` (the kernels' autograd Functions on
the card), then the optimizer's in-place update. The learning rate of
step n is the scheduler's ``lr_of(n)``, the fp32 value the JAX trainer
evaluates in its step; a constant rate is rounded to fp32 likewise.

The runtime of ``fit`` is the JAX trainer's: checkpoints and resume
(``resilience.CheckpointManager``), the anomaly and preemption guards,
the superstep (``steps_per_dispatch=K``) and optimizer-state offload. The
port's state is updated IN PLACE (parameters, fp32 masters and moments
share storage with the model and the optimizer), which changes four
things:

* an async checkpoint's host snapshot is taken before ``save`` returns
  (``checkpoint.save_state_dict``); only the write runs in the background;
* ``AnomalyGuard(policy="skip")`` keeps a pre-step clone of the whole
  state on the card each step (``donate=False``; at Llama-3-8B widths and
  4 layers, 26.9 GB); ``donate=True`` with "skip" is refused, as in JAX;
* a restore copies into the live tensors (``copy_``), creating the
  optimizer state first when it comes before any step;
* the superstep is K eager steps enqueued back to back, one batch each
  from the iterator, their losses left on the device until the loop's
  next read; K = 1 is the same loop.

MFU = tokens/s × ``model.flops_per_token(seq_len)`` (PaLM count) ÷ the
card's peak, from :data:`PEAK_FLOPS`. A device missing from the table
(the CPU among them) reports MFU as NaN rather than against a made-up
peak.

Over a device mesh (a model through ``parallel.api.shard_layer``,
``group_sharded_parallel`` or ``fleet.distributed_model``; one process
per rank, each with its Trainer) the batches are GLOBAL, as the JAX
trainer's are: each rank takes its slice (``MeshPlan.local_batch``),
the model's loss is the global token mean, each gradient is summed over
the ranks that replicate its parameter, the global-norm clip counts
every element once, and the update runs on the local shards. Metrics
are global (tokens/s over every rank) and rank 0 publishes them. A
checkpoint manager on a mesh saves each rank's shards under the mesh's
``ShardingPlan`` and restores, resharded when the saved plan's axes
differ, each rank's slice (``resilience.CheckpointManager``;
:meth:`Trainer.apply_plan` adopts a planner's plan). A pipeline model
(``LlamaForCausalLMPipe``) trains through its fused ``loss_and_grads``
under the 1F1B schedule, as the JAX trainer does, and under any
schedule on a ``pp`` mesh; the loss it returns there is the last
stage's, broadcast, so every rank logs and judges the same value.

The cost gauges (``observability.costs.CostWatch``, component
"train"): with the registry on, the first dispatch of each step shape
runs under a census of its ops (rank 0 on a mesh), and each later log
boundary publishes the step-time breakdown, the census's MFU, its
bandwidth share and the predicted-over-measured drift that the planner's
``check_drift`` reads (the window that holds the census publishes
none: its time is the census's).

Not here: ``precompile`` (an eager step has nothing to compile ahead;
CUDA graphs are B.3.3) raises.
"""

from __future__ import annotations

import contextlib
import inspect
import itertools
import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

from .. import observability as _obs
from ..checkpoint import writer
from ..device import device_info
# the span around each microbatch's forward and backward, in which
# distributed.overlap's collectives_in_loop counts the sums started
from ..distributed.overlap import MICROBATCH_SPAN
from ..optimizer.optimizer import Optimizer, place_opt_state
from ..profiler import RecordEvent

# span names the trainer emits through RecordEvent (profiler traces and
# the flight recorder's span ring both see them)
TRAINER_EVENTS = ("trainer::dispatch", "trainer::checkpoint")

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


def _ntok(batch) -> int:
    ids = batch.get("input_ids")
    return int(ids.shape[0] * ids.shape[1]) if ids is not None else 0


class Trainer:
    """Trainer (one card, or one rank of a mesh) over an ``nn.Module``
    whose forward takes the
    batch's keys (``input_ids``, ``labels``, ...) and returns the loss,
    or ``(loss, ...)``; a forward that takes ``return_logits`` is called
    with ``return_logits=False``, for the loss alone.

    ``accumulate_steps`` > 1: each batch tensor carries a leading
    microbatch dimension [A, ...]; the gradients of the A microbatches
    are summed in the parameters' dtype and divided by A, the loss is the
    mean, as in the JAX trainer. ``seed`` keys the step's random streams
    in the JAX trainer; the port's steps draw none (attention dropout is
    0), so a seed other than 0 is refused until one does.

    ``donate``: the JAX trainer donates its state to the step; the port's
    step always updates in place. ``donate=False`` is what
    ``AnomalyGuard(policy="skip")`` needs: the pre-step clone that undoes
    a poisoned update. ``loss_key`` is accepted as in JAX and not read.

    ``offload_opt_state=True`` keeps the masters and moments in pinned
    host memory between steps; the optimizer streams each parameter's
    state to the card for its update and back. None inherits the
    optimizer's ``_offload_opt_state`` flag, also when it is set later."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer,
                 loss_key: Optional[str] = None, donate: bool = True,
                 accumulate_steps: int = 1,
                 offload_opt_state: Optional[bool] = None, seed: int = 0):
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
        from ..parallel.api import mesh_plan_of
        #: the model's parallel.api.MeshPlan when it is sharded over a
        #: device mesh: batches are then global and each rank takes its
        #: slice, gradients are summed over the ranks replicating them
        self._plan = mesh_plan_of(model)
        self._world = 1
        if self._plan is not None:
            optimizer._mesh_plan = self._plan
            self._world = self._plan.mesh.nproc
        #: the model's fused forward+backward (a pipeline's
        #: loss_and_grads): taken for the 1F1B schedule, as the JAX
        #: trainer does, and for any schedule on a pp mesh, where
        #: autograd cannot reach across the stages' ranks
        on_pp = self._plan is not None and self._plan.pp_size > 1
        self._fused = hasattr(model, "loss_and_grads") and (
            getattr(model, "pp_schedule", None) == "1f1b" or on_pp)
        self.accumulate_steps = max(1, int(accumulate_steps))
        self._donate = bool(donate)
        self._step = 0
        self.device = next(model.parameters()).device
        self.peak_flops = device_peak_flops(self.device)
        # the card's name and power limit: the peak assumes the full limit
        self.card = device_info() if self.device.type == "cuda" else None
        self._offload_explicit = offload_opt_state is not None
        if offload_opt_state is None:
            offload_opt_state = getattr(optimizer, "_offload_opt_state",
                                        False)
        self._offload = False
        if offload_opt_state:
            self._set_offload()
        self._watchdog = None
        #: host-side accounting: steps and dispatches (a superstep is one
        #: dispatch of K steps), the wall seconds spent ENQUEUEING steps,
        #: and the host's reads of a loss from the device
        self.dispatch_stats = {"steps": 0, "dispatches": 0,
                               "dispatch_host_s": 0.0, "loss_reads": 0}
        # cost observatory: the watch, the last dispatch's step shape and
        # steps, and the dispatch stats at the last publication
        self._cost_watch = None
        self._cost_key, self._cost_k = None, 1
        self._cost_disp_mark = None
        #: a census ran since the last log boundary: that window's time
        #: holds the census's dispatch mode, so it publishes no costs
        self._census_in_window = False

    # -- state ----------------------------------------------------------------

    def _set_offload(self) -> None:
        """Put the optimizer state in pinned host memory (creating it
        there when no step has made it yet)."""
        self._offload = True
        opt = self.optimizer
        if opt._state is None:
            # on a mesh the state is made for the local shards (or chunks)
            opt._state = opt.init_state(
                self.params if self._plan is None
                else self._plan.opt_views(self.params)[0], "pinned_host")
        else:
            opt._state = place_opt_state(opt._state, self.params,
                                         "pinned_host")

    def _opt_params(self) -> Dict[str, torch.Tensor]:
        """The tensors the optimizer's state is made for: the parameters,
        or on a mesh their local shards (chunks under os / os_g)."""
        if self._plan is None:
            return self.params
        return self._plan.opt_views(self.params)[0]

    def _adopt_offload_flag(self) -> None:
        """An optimizer flag set after this Trainer was built is honoured
        from here on, unless offload_opt_state was passed explicitly."""
        if (not self._offload and not self._offload_explicit
                and getattr(self.optimizer, "_offload_opt_state", False)):
            self._set_offload()

    @property
    def opt_state(self) -> Optional[Dict]:
        """The optimizer's live state ``{"step", "master", "slots"}`` (None
        before the first step)."""
        return self.optimizer._state

    def _sync_host_state(self) -> None:
        """Wait for the offloaded state's pending card→host copies before
        the host reads or writes it."""
        if self._offload and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _live_tensors(self):
        """(key, live tensor) of every parameter, master and slot."""
        out = [(("params", k), p) for k, p in self.params.items()]
        st = self.optimizer._state
        if st is not None:
            out += [(("master", k), t) for k, t in st["master"].items()]
            out += [(("slots", k, sk), t)
                    for k, slots in st["slots"].items()
                    for sk, t in slots.items()]
        return out

    def _snapshot_state(self):
        """A clone of the whole state (the undo of a skipped step)."""
        self._sync_host_state()
        sched = self.optimizer.lr_scheduler
        st = self.optimizer._state
        with torch.no_grad():
            return {"tensors": {key: t.clone()
                                for key, t in self._live_tensors()},
                    "opt_step": None if st is None else st["step"],
                    "sched": sched.state_dict() if sched else None}

    def _restore_snapshot(self, prev) -> None:
        if prev["opt_step"] is None:
            # the poisoned step created the optimizer state: drop it (the
            # next step creates it again from the restored parameters)
            self.optimizer._state = None
        self._sync_host_state()
        with torch.no_grad():
            for key, t in self._live_tensors():
                t.copy_(prev["tensors"][key])
        if prev["opt_step"] is not None:
            self.optimizer._state["step"] = prev["opt_step"]
        sched = self.optimizer.lr_scheduler
        if sched is not None and prev["sched"] is not None:
            sched.set_state_dict(prev["sched"])

    # -- the step -------------------------------------------------------------

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

    def _loss_backward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The batch's loss (detached) with its gradients accumulated
        into ``.grad``: the fused step, or the loss and its backward. On
        a pp mesh the fused step returns the last stage's loss on every
        rank, so that every rank logs and judges (the anomaly guard) the
        same value."""
        if self._fused:
            return self.model.loss_and_grads(**batch)[0]
        loss = self._loss(batch)
        loss.backward()
        return loss.detach()

    def _arm(self, A: int) -> None:
        """Before the step's last backward on a mesh: let the plan start
        each gradient's sums as soon as it is final (the comm overlap;
        not a pipeline's fused step)."""
        if self._plan is not None and not self._fused:
            self._plan.arm_grad_sync(self.params, divide=A)

    def _one_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        lr = self._lr()
        for p in self.params.values():
            p.grad = None
        A = self.accumulate_steps
        plan = self._plan
        if plan is not None and not getattr(batch, "is_local", False):
            # trace-lint: waive(host-sync) A is the Python accumulate count
            batch = plan.local_batch(batch, lead=int(A > 1))
        if A == 1:
            self._arm(A)
            with record_function(MICROBATCH_SPAN):
                loss = self._loss_backward(batch)
        else:
            loss = None
            for i in range(A):
                if i == A - 1:
                    self._arm(A)
                with record_function(MICROBATCH_SPAN):
                    li = self._loss_backward({k: v[i]
                                              for k, v in batch.items()})
                loss = li if loss is None else loss + li
            loss = loss / A
            with torch.no_grad():
                for n, p in self.params.items():
                    if p.grad is not None and not (
                            plan is not None and plan.sync_started(n)):
                        p.grad.div_(A)
        if plan is not None:
            plan.sync_grads(self.params)
            plan.apply(self.optimizer, self.params, lr=lr)
        else:
            grads = {k: p.grad for k, p in self.params.items()
                     if p.grad is not None}
            self.optimizer.apply_gradients(self.params, grads, lr=lr)
        self._step += 1
        self.dispatch_stats["steps"] += 1
        sched = self.optimizer.lr_scheduler
        if sched is not None:
            sched.step()
        return loss

    def train_step(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One optimization step. Returns the loss as a 0-d tensor on the
        device, without waiting for it: callers read ``float()`` only
        when they need the value."""
        return self._dispatch([batch])[0]

    def _dispatch(self, batches) -> List[torch.Tensor]:
        """One dispatch: a step over each batch in turn, enqueued back to
        back with no host read (a superstep when there are several).
        Returns the steps' losses on the device."""
        self._adopt_offload_flag()
        if self._watchdog is not None:
            self._watchdog.tick()
        # trace-lint: waive(host-time) dispatch_host_s is the enqueue's time
        t0 = time.perf_counter()
        with RecordEvent("trainer::dispatch"), self._step_census(batches):
            losses = [self._one_step(b) for b in batches]
        self.dispatch_stats["dispatches"] += 1
        # trace-lint: waive(host-time) dispatch_host_s is the enqueue's time
        self.dispatch_stats["dispatch_host_s"] += time.perf_counter() - t0
        return losses

    def _step_census(self, batches):
        """The census scope of a dispatch: the first of its step shape
        (the batch's shapes and dtypes, and the steps it holds) while the
        registry is on, on the rank that publishes; else a no-op."""
        K = len(batches)
        key = ("superstep" if K > 1 else "step", K, tuple(
            (k, tuple(v.shape), str(v.dtype)) for k, v in
            sorted(batches[0].items()) if isinstance(v, torch.Tensor)))
        self._cost_key, self._cost_k = key, K
        if not _obs.REGISTRY.enabled or (
                self._plan is not None and self._plan.mesh.rank != 0):
            return contextlib.nullcontext()
        if self._cost_watch is None:
            from ..observability.costs import CostWatch
            self._cost_watch = CostWatch("train")
        if self._cost_watch.observe(key):
            return contextlib.nullcontext()
        self._census_in_window = True
        return self._cost_watch.census(
            key, mesh=self._plan.mesh if self._plan is not None else None)

    def _publish_step_costs(self, m: TrainMetrics) -> None:
        """The cost gauges at a log boundary (the JAX trainer's): the
        measured step time split into compute / comm / host / stall,
        the census's MFU and bandwidth share, and the predicted-over-
        measured drift, for the step shape last dispatched. The host
        bucket is this window's enqueue seconds a step. A window that
        took a census publishes nothing: its wall and enqueue seconds
        hold the census's dispatch mode, not the step."""
        watch = self._cost_watch
        if watch is None or not watch.observe(self._cost_key):
            return
        # per-WINDOW host overhead: a lifetime average would carry the
        # first dispatch's allocations forever
        ds = self.dispatch_stats
        mark = self._cost_disp_mark or (0, 0.0)
        dsteps = ds["steps"] - mark[0]
        dhost = ds["dispatch_host_s"] - mark[1]
        self._cost_disp_mark = (ds["steps"], ds["dispatch_host_s"])
        if self._census_in_window:
            self._census_in_window = False
            return
        if dsteps <= 0 or dhost < 0:      # stats were reset externally
            dsteps, dhost = max(ds["steps"], 1), ds["dispatch_host_s"]
        watch.publish(m.step_time_s, host_s=dhost / max(dsteps, 1),
                      steps_per_exec=self._cost_k)

    def apply_plan(self, plan, devices=None):
        """Adopt a sharding-planner plan: shard the model (each rank
        holding the same full weights) as the ``ShardingPlan`` says
        (``plan.apply``: ``shard_layer``, FSDP2 over an fsdp axis), re-bind
        the optimizer to the sharded parameters, cut an optimizer state
        made before into this rank's shards, and return the mesh to train
        under. Collective over the live world, whose size must be the
        plan's. Usage (every rank)::

            report = auto_parallel.plan(cfg, n_devices=world)
            hm = trainer.apply_plan(report.chosen.plan)
            with hm:
                trainer.fit(loader, steps=...)
        """
        from ..distributed.sharding import bind_optimizer
        from ..parallel.api import mesh_plan_of, shard_optimizer_state
        self._sync_host_state()
        st = self.optimizer._state
        hm = plan.apply(self.model, devices=devices)
        bind_optimizer(self.optimizer, self.model)
        self._plan = mesh_plan_of(self.model)
        self.params = {n: p for n, p in self.model.named_parameters()
                       if p.requires_grad}
        self._world = self._plan.mesh.nproc
        on_pp = self._plan.pp_size > 1
        self._fused = hasattr(self.model, "loss_and_grads") and (
            getattr(self.model, "pp_schedule", None) == "1f1b" or on_pp)
        if st is not None:
            cut = shard_optimizer_state(
                {"step": st["step"], "master": st["master"],
                 "slots": st["slots"]}, self.model)
            self.optimizer._state = place_opt_state(
                cut, self.params, "pinned_host" if self._offload
                else "device")
        # remembered so fit() can hand the plan to the checkpoint manager
        # (saves record it as _PLAN.json; restores on a different mesh
        # reshard against it) without extra caller wiring
        self._active_plan = plan
        self._active_mesh = hm
        return hm

    def _mesh_sharding_plan(self):
        """The ShardingPlan of the mesh the model is sharded over: the one
        applied, else emitted from the mesh."""
        if getattr(self, "_active_plan", None) is not None:
            return self._active_plan
        from ..distributed.auto_parallel import ParallelConfig, emit_plan
        hm = self._plan.mesh
        cfg = ParallelConfig(
            dp=hm.axis_size("dp") * hm.axis_size("ep"),
            fsdp=hm.axis_size("fsdp"), tp=hm.axis_size("tp"),
            pp=hm.axis_size("pp"), sep=hm.axis_size("sep"),
            ep=hm.axis_size("ep"))
        return emit_plan(self.model, hm, cfg)

    def precompile(self, sample_batch, steps_per_dispatch: int = 1,
                   cache_dir: Optional[str] = None):
        raise NotImplementedError(
            "Trainer.precompile: an eager step has nothing to compile "
            "ahead; captured steps come with CUDA graphs (ROADMAP.md, "
            "B.3.3)")

    # -- full loop with metrics ---------------------------------------------

    def _metrics(self, step, loss_v, dt, log_every, tokens, sl, lr):
        # on a mesh the batch is global: tokens/s over every rank, the
        # loss the global mean, MFU against every card's peak
        tps = tokens / dt if dt > 0 else 0.0
        fpt = (self.model.flops_per_token(sl)
               if hasattr(self.model, "flops_per_token") else 0.0)
        mfu = (tps * fpt / (self.peak_flops * self._world)
               if fpt and self.peak_flops else math.nan)
        return TrainMetrics(step=step, loss=loss_v,
                            step_time_s=dt / log_every, tokens_per_sec=tps,
                            tokens_per_sec_per_chip=tps / self._world,
                            mfu=mfu, lr=lr)

    def _emit(self, m: TrainMetrics, history, on_metrics) -> None:
        history.append(m)
        if self._plan is not None and self._plan.mesh.rank != 0:
            return      # rank 0 publishes the (global) metrics
        _obs.observe_train_metrics(m)
        if _obs.REGISTRY.enabled:
            self._publish_step_costs(m)
        # SLO sentry: rules evaluate at the same log boundary the gauges
        # above were refreshed at (a load + branch when none is installed)
        _obs.sentry.maybe_tick()
        if on_metrics:
            on_metrics(m)

    def fit(self, data: Iterable[Dict[str, torch.Tensor]], steps: int,
            log_every: int = 10, on_metrics: Optional[Callable] = None,
            seq_len: Optional[int] = None, checkpoint_manager=None,
            resume=None, anomaly_guard=None, preemption_guard=None,
            steps_per_dispatch: int = 1) -> List[TrainMetrics]:
        """Train ``steps`` steps from ``data`` (stopping early when it
        runs out). Every ``log_every`` steps the loss is read (a wait for
        the device) and a :class:`TrainMetrics` over the steps since the
        last one is recorded and passed to ``on_metrics``. The runtime:

        * ``checkpoint_manager`` (resilience.CheckpointManager): periodic
          saves every ``save_interval_steps`` plus a final synchronous save;
        * ``resume="auto"``: restore the parameters, the optimizer state,
          the step and the LR scheduler from the newest COMMITTED
          checkpoint and fast-forward the data cursor (via
          ``data.set_state_dict`` when the loader supports it). With
          resume, ``steps`` is the TOTAL step budget of the run;
        * ``preemption_guard`` (resilience.PreemptionGuard): on SIGTERM the
          loop writes one final sync checkpoint at the next step boundary
          and raises TrainingPreempted (exit code = resumable);
        * ``anomaly_guard`` (resilience.AnomalyGuard): NaN/Inf or loss-spike
          steps are skipped (undo the update; needs donate=False) or rolled
          back to the last good checkpoint, within bounded budgets. With
          ``check_every > 1`` (and a non-skip policy) loss verdicts are
          consumed as a batched window — one device read per window;
        * ``steps_per_dispatch=K`` (superstep): K steps enqueued back to
          back, one batch each; losses are read at log/anomaly/
          checkpoint boundaries. Bit-identical to K=1 (the same step).
          Checkpoint/anomaly cadence aligns to dispatch boundaries (first
          boundary at-or-after the configured interval); resume may land
          mid-superstep — the next dispatch is sized
          ``min(K, target - step)``. Incompatible with ``policy="skip"``.
          The hung-step watchdog (``PT_STEP_TIMEOUT_S``) is ticked per
          dispatch and around the loss reads.
        """
        from ..distributed.watchdog import watchdog_from_env
        if self._watchdog is None:
            self._watchdog = watchdog_from_env()
        if resume and checkpoint_manager is None:
            raise ValueError("resume requires a checkpoint_manager")
        if checkpoint_manager is not None and self._plan is not None:
            # hand the mesh and its ShardingPlan to the manager: saves
            # write each rank's shards and record the plan as _PLAN.json,
            # and a restore whose saved plan has different axes reshards
            if checkpoint_manager.plan is None:
                checkpoint_manager.plan = self._mesh_sharding_plan()
            if checkpoint_manager._layout() is None:
                checkpoint_manager.mesh = self._plan
        if (anomaly_guard is not None and anomaly_guard.policy == "skip"
                and self._donate):
            raise ValueError(
                "AnomalyGuard(policy='skip') requires Trainer(donate=False): "
                "undoing a poisoned update needs a pre-step copy of the "
                "state, which an in-place (donated) update does not keep. "
                "Use policy='rollback' (with a checkpoint_manager) or "
                "donate=False.")
        K = max(1, int(steps_per_dispatch))
        if K > 1 and anomaly_guard is not None \
                and anomaly_guard.policy == "skip":
            raise ValueError(
                "steps_per_dispatch>1 cannot honor AnomalyGuard("
                "policy='skip'): a poisoned update inside a superstep "
                "cannot be undone from pre-step copies. Use "
                "policy='rollback' (checkpoint-backed) or "
                "steps_per_dispatch=1.")
        if (checkpoint_manager is not None
                and _obs.flight_recorder.recorder().active):
            # crash dumps land next to the quarantine dir so a post-mortem
            # ships with the checkpoint state it describes
            _obs.flight_recorder.set_dir(
                os.path.join(checkpoint_manager.root, "_flight"))
        # goodput ledger: the whole fit window is accounted wall-time;
        # everything not claimed by a span (save/restore/preempt) books as
        # productive_step
        led = _obs.ledger()
        led.run_start()
        try:
            if resume and checkpoint_manager is not None:
                self._resume_from(checkpoint_manager, data)
                target = int(steps)
            else:
                target = self._step + int(steps)
            return self._fit_loop(iter(data), target, K, log_every,
                                  on_metrics, seq_len,
                                  mgr=checkpoint_manager,
                                  anomaly=anomaly_guard,
                                  guard=preemption_guard, data=data)
        finally:
            if checkpoint_manager is not None:
                # the async saves' host buffers hold a copy of the whole
                # state; the next fit's first async save allocates them
                writer().release()
            led.run_end()
            if _obs.enabled():
                _obs.publish()       # goodput buckets + snapshot -> exporters
            if self._watchdog is not None:
                self._watchdog.stop()
                self._watchdog = None

    def _fit_loop(self, it, target, K, log_every, on_metrics, seq_len,
                  mgr=None, anomaly=None, guard=None, data=None):
        """The loop for every ``steps_per_dispatch`` K: a dispatch is
        ``min(K, target - step)`` eager steps enqueued back to back with no
        host read, their losses left on the device. At a dispatch boundary
        the pending losses are read with ONE host read when a log step, the
        anomaly window, a save or the end needs them; anomaly verdicts and
        metrics then run in step order. Saves come at the first boundary
        at or after each multiple of ``save_interval_steps`` (every
        multiple when K = 1), as in the JAX trainer."""
        pending = []       # (step, tokens, device loss) not read yet
        skip = anomaly is not None and anomaly.policy == "skip"
        if anomaly is None:
            window = None
        elif K > 1:
            # JAX's superstep reads its in-flight ring two dispatches deep
            window = 2 * K
        elif skip or getattr(anomaly, "check_every", 1) <= 1:
            # skip reads every step: the undo needs the pre-step copy
            # from BEFORE the next step runs
            window = 1
        else:
            window = anomaly.check_every
        acc = {"steps": 0, "tokens": 0, "t_last": time.perf_counter(),
               "sl": seq_len or 1}
        history = []
        last_saved = self._step
        exhausted = False

        def drain(it, prev=None):
            """Read the pending losses with one host read; run the
            verdicts and emit the metrics of the log steps among them.
            Returns ``(iterator, rolled_back)``: a verdict other than
            "ok" skips or rolls back and drops the rest of the window."""
            if not pending:
                return it, False
            entries = list(pending)
            pending.clear()
            if self._watchdog is not None:
                self._watchdog.tick()    # the read below waits for the card
            self.dispatch_stats["loss_reads"] += 1
            vals = torch.stack([l for _, _, l in entries]).float().cpu()
            if self._watchdog is not None:
                self._watchdog.tick()
            # every step since the last emission shares the wall span
            # [t_last, now] equally
            per_step_s = (max(time.perf_counter() - acc["t_last"], 1e-9)
                          / (acc["steps"] + len(entries)))
            sched = self.optimizer.lr_scheduler
            for (step, ntok, _), v in zip(entries, vals.tolist()):
                if anomaly is not None:
                    verdict = anomaly.check(v)
                    if verdict != "ok":
                        return self._handle_anomaly(verdict, anomaly, mgr,
                                                    prev, data, it, v), True
                acc["steps"] += 1
                acc["tokens"] += ntok
                if step % log_every == 0:
                    dt = per_step_s * acc["steps"]
                    # the scheduler has moved past these steps: the LR at
                    # the logged step
                    lr = (sched.lr_of(step) if sched is not None
                          else self.optimizer.get_lr())
                    m = self._metrics(step, v, dt, acc["steps"],
                                      acc["tokens"], acc["sl"], lr)
                    self._emit(m, history, on_metrics)
                    acc.update(t_last=acc["t_last"] + dt, steps=0, tokens=0)
            return it, False

        while True:
            if guard is not None and guard.preempted:
                it, _ = drain(it)
                self._preempt_exit(mgr, data)
            if self._step >= target or exhausted:
                it, rolled = drain(it)
                if rolled and self._step < target:
                    # a rollback rewinds a stateful loader to the
                    # checkpoint's cursor: train the remainder from there
                    exhausted = False
                    last_saved = self._step
                    continue
                break
            start = self._step
            batches = list(itertools.islice(it, min(K, target - start)))
            exhausted = len(batches) < min(K, target - start)
            if not batches:
                continue
            ids = batches[-1].get("input_ids")
            if seq_len is None and ids is not None:
                acc["sl"] = ids.shape[-1]
            prev = self._snapshot_state() if skip else None
            losses = self._dispatch(batches)
            pending.extend((start + i + 1, _ntok(b), l)
                           for i, (b, l) in enumerate(zip(batches, losses)))
            interval = mgr.save_interval_steps if mgr is not None else 0
            save = (interval > 0 and self._step < target
                    and self._step // interval > last_saved // interval)
            if (save or self._step // log_every > start // log_every
                    or (window is not None and len(pending) >= window)):
                it, rolled = drain(it, prev)
                if rolled:
                    if not skip:
                        exhausted = False
                        last_saved = self._step
                    continue
            del prev
            if save and not (guard is not None and guard.preempted):
                # the guard has cleared these steps (never checkpoint an
                # unchecked state); a preemption saves at the loop's head
                last_saved = self._step
                self._save_ckpt(mgr, data)
        if guard is not None and guard.preempted:
            self._preempt_exit(mgr, data)
        if mgr is not None:
            self._save_ckpt(mgr, data, async_save=False)
        return history

    # -- resilience runtime --------------------------------------------------

    def _save_ckpt(self, mgr, data, async_save=None):
        """One checkpoint save from the fit loop: traced as a
        trainer::checkpoint span, watermarked in the goodput ledger (the
        anchor a later rollback reclassifies against)."""
        with RecordEvent("trainer::checkpoint"):
            self._sync_host_state()
            mgr.save(self._step, self._ckpt_tree(data),
                     async_save=async_save, watchdog=self._watchdog)
        _obs.ledger().note_checkpoint(self._step)

    def _ckpt_tree(self, data=None):
        """Full training state as one checkpointable tree of the LIVE
        tensors (the storage layer snapshots them). The structure is FIXED
        (extra always present, same keys) so the restore target always
        matches the saved layout. The optimizer state is created first if
        no step has made it."""
        sched = self.optimizer.lr_scheduler
        if data is not None and hasattr(data, "state_dict"):
            # the loader's own count: batches actually handed out this pass.
            # NOT self._step — anomaly skips consume a batch without keeping
            # the step, so the two drift apart exactly when resume must not
            # replay the poisoned batch
            cursor = int(data.state_dict().get("batches_served", self._step))
        else:
            cursor = self._step    # 1 batch per step for stateless iterables
        st = self.optimizer.ensure_state(
            self._opt_params(), "pinned_host" if self._offload else "device")
        return {
            "step": np.asarray(self._step, np.int64),
            "params": dict(self.params),
            "opt_state": {"step": np.asarray(st["step"], np.int64),
                          "master": st["master"], "slots": st["slots"]},
            "extra": {
                "sched_last_epoch": np.asarray(
                    sched.last_epoch if sched is not None else -1, np.int64),
                # last_lr as VALUE, not formula: adaptive schedulers
                # (ReduceOnPlateau) cannot recompute it from last_epoch
                "sched_last_lr": np.asarray(
                    sched.last_lr if sched is not None else -1.0, np.float64),
                "data_cursor": np.asarray(cursor, np.int64),
            },
        }

    def _apply_restored(self, tree) -> int:
        """Copy a restored tree into the live tensors (the module's
        parameters, the optimizer's masters and slots share storage, so
        nothing is rebound); returns the data cursor."""
        st = self.optimizer.ensure_state(
            self._opt_params(), "pinned_host" if self._offload else "device")
        self._sync_host_state()
        from ..parallel.api import _local
        with torch.no_grad():
            for k, p in self.params.items():
                _local(p).copy_(tree["params"][k])
            for k, t in st["master"].items():
                t.copy_(tree["opt_state"]["master"][k])
            for k, slots in st["slots"].items():
                for sk, t in slots.items():
                    t.copy_(tree["opt_state"]["slots"][k][sk])
        st["step"] = int(np.asarray(tree["opt_state"]["step"]))
        self._step = int(np.asarray(tree["step"]))
        sched = self.optimizer.lr_scheduler
        le = int(np.asarray(tree["extra"]["sched_last_epoch"]))
        llr = float(np.asarray(tree["extra"]["sched_last_lr"]))
        if sched is not None and le >= 0:
            # set_state_dict, NOT step(epoch=le): ReduceOnPlateau.step is a
            # no-op without metrics, which would silently reset its decayed
            # LR to the constructor value
            sched.set_state_dict({"last_epoch": le, "last_lr": (
                llr if llr >= 0 else sched.last_lr)})
        return int(np.asarray(tree["extra"]["data_cursor"]))

    def _resume_from(self, mgr, data) -> Optional[int]:
        """resume="auto": restore the newest committed checkpoint (corrupt
        ones are quarantined by the manager and the previous step is used)
        and position the data cursor."""
        res = mgr.restore(self._ckpt_tree(), watchdog=self._watchdog)
        if res is None:
            return None          # nothing saved yet: cold start
        step, tree = res
        cursor = self._apply_restored(tree)
        if hasattr(data, "set_state_dict"):
            data.set_state_dict({"batches_served": cursor})
        return step

    def _preempt_exit(self, mgr, data=None):
        """Step-boundary preemption: one final SYNCHRONOUS checkpoint, then
        exit with the resumable status (a relauncher resumes instead of
        restarting)."""
        from ..resilience.preemption import TrainingPreempted
        # the wind-down books as preemption_lost (minus the nested
        # checkpoint_save span the manager opens for the final save)
        with _obs.ledger().span("preemption_lost"):
            if mgr is not None:
                self._save_ckpt(mgr, data, async_save=False)
            if _obs.REGISTRY.enabled:
                _obs.REGISTRY.counter(
                    "pt_preemptions_total",
                    "orderly SIGTERM checkpoint-and-exit events").inc()
            _obs.flight_recorder.maybe_dump(
                "preemption", extra={"step": self._step})
        raise TrainingPreempted(self._step)

    def _handle_anomaly(self, verdict, anomaly, mgr, prev, data, it, loss):
        """Apply the anomaly verdict; returns the (possibly replaced) data
        iterator."""
        from ..resilience.anomaly import SKIP
        if verdict == SKIP and prev is not None:
            # undo this step's (poisoned) update and move past the batch
            self._restore_snapshot(prev)
            self._step -= 1
            return it
        if verdict == "abort" or mgr is None:
            # no checkpoint to roll back to (or policy says die): fail loudly
            anomaly.raise_divergence(self._step, loss)
        res = mgr.restore(self._ckpt_tree(), watchdog=self._watchdog)
        if res is None:
            anomaly.raise_divergence(self._step, loss)
        _, tree = res
        cursor = self._apply_restored(tree)
        # productive time since the restored step's watermark is replayed
        # ground: reclassify it as rollback_wasted
        _obs.ledger().note_rollback(self._step)
        if data is not None and hasattr(data, "set_state_dict"):
            # replay from the checkpointed cursor; without a stateful
            # loader the current iterator continues forward (rollback then
            # sees new batches rather than a replay)
            close = getattr(it, "close", None)
            if close is not None:
                close()        # retire the old pass (and its prefetch thread)
            data.set_state_dict({"batches_served": cursor})
            return iter(data)
        return it

    def state_dict(self):
        """The live state: parameters, optimizer state and step."""
        return {"params": self.params, "opt_state": self.optimizer._state,
                "step": self._step}

    def set_state_dict(self, sd):
        """Copy ``sd`` (as :meth:`state_dict` gives it) into the live
        tensors."""
        tree = {"step": sd["step"], "params": sd["params"],
                "opt_state": sd["opt_state"],
                "extra": {"sched_last_epoch": -1, "sched_last_lr": -1.0,
                          "data_cursor": 0}}
        self._apply_restored(tree)


__all__ = ["Trainer", "TrainMetrics", "PEAK_FLOPS", "device_peak_flops",
           "TRAINER_EVENTS"]
