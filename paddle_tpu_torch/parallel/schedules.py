"""Pipeline schedules: GPipe, fused 1F1B and interleaved (counterpart of
``paddle_tpu/parallel/schedules.py`` and of ``pipeline_spmd`` in
``paddle_tpu/parallel/pipeline.py``).

The JAX package runs a schedule as one SPMD program over stage-stacked
weights (``vmap`` over stages, ``jnp.roll`` as the stage-to-stage
permute) and lets ``jax.grad`` or its own fused step differentiate it.
PyTorch has no such compiler, so the port runs the reference's design
(Paddle's ``pipeline_parallel.py:440``): a runtime that walks the
schedule tick by tick and runs each stage's forward (F) and backward
(B) cells itself.

* Where the stages run is a :class:`Runtime`. :data:`VIRTUAL` (the
  default) holds every stage in this process and runs them in tick
  order: what the JAX program computes when the stage axis is not
  sharded (one card, the CPU). :class:`MeshRuntime` holds one stage, this
  rank's on the mesh's ``pp`` axis; at the end of each tick every
  activation and cotangent that crosses a stage boundary goes to its
  neighbour in ONE ``batch_isend_irecv`` per rank, posted in the same
  order on every rank (the reference's fused send/recv pairs, which
  keep NCCL from deadlocking).
* A stage is ``stage_fn(vs, h) -> h`` for virtual stage ``vs``: its
  modules hold the parameters, and the B cells accumulate their
  gradients into ``.grad`` (JAX returns gradient trees instead).
* The loss head runs once per microbatch, on the last stage, in the
  tick of the last stage's forward; its backward gives that stage's
  cotangent at once.

Schedules (S stages, V chunks a stage, M microbatches):

* :func:`pipeline_1f1b`, fused forward and backward: F(m = t - s) and
  B(m = t - (2S - 2 - s)) at tick t on stage s, fill / steady / drain
  over M + 2(S - 1) ticks (:func:`schedule_ticks`). A stage keeps at
  most R = min(M, 2S - 1) microbatches between their F and B cells and
  frees each at its B cell: the stage INPUT with ``remat=True`` (the B
  cell replays the forward), the autograd graph with ``remat=False``.
* :func:`pipeline_fthenb`: the same cells with every F before every B
  (GPipe; interleaved when V > 1): all M microbatches live. The model's
  fused step takes it for the "gpipe" and "interleaved" schedules on a
  ``pp`` mesh, where autograd cannot reach across ranks.
* :func:`pipeline_gpipe` (JAX's ``pipeline_spmd``, M + S - 1 ticks) and
  :func:`pipeline_interleaved` (chunk v of stage s is virtual stage
  v·S + s; M a multiple of S; M·V + S - 1 ticks, :func:`interleaved_ticks`)
  are forwards: differentiable through autograd on :data:`VIRTUAL`
  stages (the backward is FThenB, as JAX's is through ``scan``), and
  forward-only (no gradient recorded) on a mesh, where the last stage
  returns the outputs.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

# an op of a tick: (physical stage, virtual stage, microbatch)
Op = Tuple[int, int, int]


class Runtime:
    """Every stage in this process, run in tick order."""

    def local(self, s: int) -> bool:
        return True

    def exchange(self, transfers, acts, like) -> None:
        """Move the tick's cross-stage tensors: a no-op here, where the
        consumer reads them from ``acts`` in a later tick."""


VIRTUAL = Runtime()


class MeshRuntime(Runtime):
    """Stage ``stage`` of ``num_stages`` on this rank: ``ranks[s]`` is
    the world rank holding stage s (this rank's ``pp`` group, in order)
    and ``group`` their process group."""

    def __init__(self, stage: int, ranks: Sequence[int], group):
        self.stage = stage
        self.ranks = list(ranks)
        self.group = group
        self._warm = False

    def local(self, s: int) -> bool:
        return s == self.stage

    def exchange(self, transfers, acts, like) -> None:
        """``transfers``: (key, src stage, dst stage) of every tensor that
        crosses a boundary this tick, in the same order on every rank.
        This rank sends its tensors and receives into new buffers of
        ``like``'s shape and dtype, in one batch_isend_irecv."""
        if not self._warm:
            # the group's first collective involves every member
            # (batch_isend_irecv's rule under NCCL)
            dist.barrier(group=self.group)
            self._warm = True
        ops = []
        got = []
        for key, src, dst in transfers:
            if src == self.stage:
                ops.append(dist.P2POp(dist.isend, acts.pop(key).contiguous(),
                                      self.ranks[dst], self.group))
            elif dst == self.stage:
                buf = torch.empty(like[0], dtype=like[1], device=like[2])
                ops.append(dist.P2POp(dist.irecv, buf, self.ranks[src],
                                      self.group))
                got.append((key, buf))
        if not ops:
            return
        for w in dist.batch_isend_irecv(ops):
            w.wait()
        acts.update(got)


def _check(S: int, V: int, M: int) -> None:
    if S < 1 or V < 1:
        raise ValueError(f"need num_stages >= 1 and num_chunks >= 1, got "
                         f"{S}, {V}")
    if M < 1:
        raise ValueError("need at least one microbatch")
    if V > 1 and M % S:
        raise ValueError(f"interleaved schedule needs microbatches ({M}) "
                         f"divisible by num_stages ({S})")


def _f_tick(S: int, V: int, vs: int, m: int) -> int:
    """The tick of F(vs, m): t = g·VS + v·S + i + s for microbatch
    m = g·S + i and virtual stage vs = v·S + s (t = m + s when V = 1)."""
    v, s = divmod(vs, S)
    if V == 1:
        return m + s
    g, i = divmod(m, S)
    return g * V * S + v * S + i + s


def _b_tick(S: int, V: int, vs: int, m: int) -> int:
    """The tick of B(vs, m) in an FThenB backward: the forward's
    timetable run on the reversed pipeline."""
    v, s = divmod(vs, S)
    if V == 1:
        return m + (S - 1 - s)
    g, i = divmod(m, S)
    return g * V * S + (V - 1 - v) * S + i + (S - 1 - s)


def _timetable(S: int, V: int, M: int, tick) -> List[List[Op]]:
    """Ops grouped by tick (stage order within a tick)."""
    T = M * V + S - 1
    out: List[List[Op]] = [[] for _ in range(T)]
    for vs in range(V * S):
        for m in range(M):
            out[tick(S, V, vs, m)].append((vs % S, vs, m))
    for ops in out:
        ops.sort()
    return out


def ticks_1f1b(S: int, M: int) -> List[Tuple[List[Op], List[Op]]]:
    """(F ops, B ops) of each 1F1B tick: F(t - s) and B(t - (2S-2-s))."""
    out = []
    for t in range(M + 2 * S - 2):
        f = [(s, s, t - s) for s in range(S) if 0 <= t - s < M]
        b = [(s, s, t - (2 * S - 2 - s)) for s in range(S)
             if 0 <= t - (2 * S - 2 - s) < M]
        out.append((f, b))
    return out


def ticks_fthenb(S: int, V: int, M: int
                 ) -> List[Tuple[List[Op], List[Op]]]:
    """Every F tick, then every B tick."""
    return ([(f, []) for f in _timetable(S, V, M, _f_tick)]
            + [([], b) for b in _timetable(S, V, M, _b_tick)])


def _transfers(ops_f, ops_b, S: int, VS: int):
    """(key, src stage, dst stage) of the tensors a tick's ops hand to
    another stage: F(vs) feeds F(vs + 1), B(vs) feeds B(vs - 1)."""
    out = []
    for s, vs, m in ops_f:
        if vs < VS - 1 and (vs + 1) % S != s:
            out.append((("f", vs + 1, m), s, (vs + 1) % S))
    for s, vs, m in ops_b:
        if vs > 0 and (vs - 1) % S != s:
            out.append((("b", vs - 1, m), s, (vs - 1) % S))
    return out


def _like(x_mb) -> Tuple:
    return (tuple(x_mb.shape[1:]), x_mb.dtype, x_mb.device)


def _run_fused(ticks, stage_fn: Callable, x_mb, targets_mb,
               loss_head_fn: Callable, S: int, V: int, remat: bool,
               return_dx: bool, weighted_loss: bool, total_weight,
               runtime: Runtime, stats: Optional[Dict]):
    """Run the F/B cells of ``ticks`` on the runtime's stages (module
    docstring). Returns (loss, dx): on a mesh the loss is the last
    stage's (0 elsewhere) and dx stage 0's (None elsewhere)."""
    M = x_mb.shape[0]
    VS = S * V
    like = _like(x_mb)
    dev = like[2]
    if weighted_loss:
        if total_weight is None:
            raise ValueError(
                "weighted_loss needs total_weight (the global weight, e.g. "
                "the count of counted labels over every microbatch and data "
                "rank): each microbatch's cotangent is scaled by it as the "
                "cells run, where JAX rescales the gradient trees after")
        head2 = loss_head_fn
        inv_w = 1.0 / torch.as_tensor(total_weight, dtype=torch.float32,
                                      device=dev).clamp_min(1e-9)
    else:
        def head2(h, tgt):
            return loss_head_fn(h, tgt), torch.ones((), device=dev)
        inv_w = torch.full((), 1.0 / M, dtype=torch.float32, device=dev)
    acts: Dict[Tuple, torch.Tensor] = {}
    saved: Dict[Tuple[int, int], object] = {}
    live = [0] * S
    peak = [0] * S
    loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
    dx: List[Optional[torch.Tensor]] = [None] * M

    def f_cell(s, vs, m):
        inp = x_mb[m] if vs == 0 else acts.pop(("f", vs, m))
        inp = inp.detach()
        if remat:
            with torch.no_grad():
                out = stage_fn(vs, inp)
            saved[(vs, m)] = inp
        else:
            h = inp.requires_grad_(True)
            with torch.enable_grad():
                out = stage_fn(vs, h)
            saved[(vs, m)] = (h, out)
        live[s] += 1
        peak[s] = max(peak[s], live[s])
        if vs < VS - 1:
            acts[("f", vs + 1, m)] = out.detach()
            return
        # the loss head, once, on the last stage: its cotangent is
        # B(vs, m)'s, scaled by the global weight
        nonlocal loss_sum
        h = out.detach().requires_grad_(True)
        with torch.enable_grad():
            lsum, _ = head2(h, targets_mb[m])
            torch.autograd.backward(lsum.float() * inv_w)
        loss_sum = loss_sum + lsum.detach().float()
        acts[("b", vs, m)] = h.grad

    def b_cell(s, vs, m):
        g = acts.pop(("b", vs, m))
        ent = saved.pop((vs, m))
        if remat:
            h = ent.requires_grad_(True)
            with torch.enable_grad():
                out = stage_fn(vs, h)
        else:
            h, out = ent
        torch.autograd.backward(out, g.to(out.dtype))
        live[s] -= 1
        del out, ent
        if vs > 0:
            acts[("b", vs - 1, m)] = h.grad
        elif return_dx:
            dx[m] = h.grad.float()

    for ops_f, ops_b in ticks:
        for s, vs, m in ops_f:
            if runtime.local(s):
                f_cell(s, vs, m)
        for s, vs, m in ops_b:
            if runtime.local(s):
                b_cell(s, vs, m)
        runtime.exchange(_transfers(ops_f, ops_b, S, VS), acts, like)
    if stats is not None:
        stats.update(peak_live=peak, ticks=len(ticks))
    loss = loss_sum * inv_w
    if not return_dx:
        return loss, None
    if any(d is None for d in dx):
        return loss, None
    return loss, torch.stack(dx)


def pipeline_1f1b(stage_fn: Callable, x_mb: torch.Tensor, targets_mb,
                  loss_head_fn: Callable, *, num_stages: int,
                  remat: bool = True, return_dx: bool = False,
                  weighted_loss: bool = False, total_weight=None,
                  runtime: Runtime = VIRTUAL, stats: Optional[Dict] = None):
    """Fused forward+backward 1F1B step (JAX's ``pipeline_1f1b``).

    stage_fn(s, h) -> h         stage s's compute (its modules' weights)
    x_mb:       [M, mb, ...] stage-0 inputs (on a mesh, any tensor of
                that shape and dtype on ranks other than stage 0's)
    targets_mb: [M, ...] the loss head's targets (read on stage S-1)
    loss_head_fn(h, target) -> the microbatch's mean loss, or with
        ``weighted_loss`` a (loss_sum, weight) pair; the result is then
        sum(loss_sum) / ``total_weight`` (the GLOBAL weight, e.g. the
        count of counted labels over every microbatch and data rank), so
        uneven padding gives the unpipelined token mean.

    The gradients of every stage's and the head's parameters accumulate
    into ``.grad``, already divided by the weight. Returns (loss, dx):
    dx is the [M, mb, ...] fp32 cotangent of ``x_mb`` with
    ``return_dx`` (stage 0's on a mesh), else None. ``stats`` (a dict)
    receives the peak count of microbatches held per stage, which never
    exceeds min(M, 2S - 1). This IS the backward: do not call
    ``backward`` on the loss."""
    S, M = num_stages, x_mb.shape[0]
    _check(S, 1, M)
    return _run_fused(ticks_1f1b(S, M), stage_fn, x_mb, targets_mb,
                      loss_head_fn, S, 1, remat, return_dx, weighted_loss,
                      total_weight, runtime, stats)


def pipeline_fthenb(stage_fn: Callable, x_mb: torch.Tensor, targets_mb,
                    loss_head_fn: Callable, *, num_stages: int,
                    num_chunks: int = 1, remat: bool = True,
                    return_dx: bool = False, weighted_loss: bool = False,
                    total_weight=None, runtime: Runtime = VIRTUAL,
                    stats: Optional[Dict] = None):
    """:func:`pipeline_1f1b`'s contract with every F cell before every
    B cell: GPipe (``num_chunks`` 1) or the interleaved schedule (V > 1:
    ``stage_fn(vs, h)`` for virtual stage vs = v·S + s, which runs on
    stage s)."""
    S, V, M = num_stages, num_chunks, x_mb.shape[0]
    _check(S, V, M)
    return _run_fused(ticks_fthenb(S, V, M), stage_fn, x_mb, targets_mb,
                      loss_head_fn, S, V, remat, return_dx, weighted_loss,
                      total_weight, runtime, stats)


def _forward(stage_fn: Callable, x_mb: torch.Tensor, S: int, V: int,
             remat: bool, runtime: Runtime):
    """The F timetable of :func:`ticks_fthenb` as a forward: [M, ...]
    outputs of the last virtual stage (differentiable on VIRTUAL stages;
    on a mesh computed without a gradient and returned on the last
    stage, None elsewhere)."""
    M = x_mb.shape[0]
    _check(S, V, M)
    VS = S * V
    on_mesh = runtime is not VIRTUAL
    if on_mesh and torch.is_grad_enabled():
        raise ValueError(
            "a pipeline forward on a pp mesh runs without a gradient; "
            "training takes the fused schedules (the model's "
            "loss_and_grads, which Trainer calls)")
    like = _like(x_mb)
    acts: Dict[Tuple, torch.Tensor] = {}
    outs: List[Optional[torch.Tensor]] = [None] * M

    def run(vs, h):
        if remat and torch.is_grad_enabled():
            return checkpoint(stage_fn, vs, h, use_reentrant=False)
        return stage_fn(vs, h)
    for ops in _timetable(S, V, M, _f_tick):
        for s, vs, m in ops:
            if not runtime.local(s):
                continue
            h = x_mb[m] if vs == 0 else acts.pop(("f", vs, m))
            out = run(vs, h)
            if vs < VS - 1:
                acts[("f", vs + 1, m)] = out
            else:
                outs[m] = out
        runtime.exchange(_transfers(ops, [], S, VS), acts, like)
    if any(o is None for o in outs):
        return None
    return torch.stack(outs)


def pipeline_gpipe(stage_fn: Callable, x_mb: torch.Tensor, *,
                   num_stages: int, remat: bool = True,
                   runtime: Runtime = VIRTUAL):
    """GPipe forward over M microbatches in M + S - 1 ticks (JAX's
    ``pipeline_spmd``): stage_fn(s, h) -> h; returns the [M, mb, ...]
    outputs of stage S - 1. ``remat`` checkpoints each stage call."""
    return _forward(stage_fn, x_mb, num_stages, 1, remat, runtime)


def pipeline_interleaved(stage_fn: Callable, x_mb: torch.Tensor, *,
                         num_stages: int, num_chunks: int,
                         remat: bool = True, runtime: Runtime = VIRTUAL):
    """Circular (interleaved / VPP) pipeline forward: ``stage_fn(vs, h)``
    is virtual stage vs = v·S + s, chunk v of stage s (Megatron's
    placement); M must be a multiple of S. Returns the [M, mb, ...]
    outputs of the last virtual stage."""
    if num_chunks < 1:
        raise ValueError("num_chunks must be >= 1")
    return _forward(stage_fn, x_mb, num_stages, num_chunks, remat, runtime)


def schedule_ticks(num_stages: int, num_microbatches: int) -> dict:
    """Per-phase tick counts of ``pipeline_1f1b``: fill and drain each
    cost one slot (tF or tB), so the bubble is (S-1)(tF+tB)."""
    S, M = num_stages, num_microbatches
    return {"fill": S - 1, "steady": M, "drain": S - 1,
            "total": M + 2 * (S - 1),
            "bubble_slot_pairs": S - 1}


def interleaved_ticks(num_stages: int, num_chunks: int,
                      num_microbatches: int) -> Tuple[int, int]:
    """(ticks, non_interleaved_chunk_ticks): the bubble-reduction math."""
    t = num_microbatches * num_chunks + num_stages - 1
    t_plain = (num_microbatches + num_stages - 1) * num_chunks
    return t, t_plain


__all__ = ["Runtime", "VIRTUAL", "MeshRuntime", "pipeline_1f1b",
           "pipeline_fthenb", "pipeline_gpipe", "pipeline_interleaved",
           "schedule_ticks", "interleaved_ticks", "ticks_1f1b",
           "ticks_fthenb"]
