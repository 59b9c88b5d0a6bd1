"""Comm/compute overlap in the eager step (counterpart of
``paddle_tpu/distributed/overlap.py``).

Reference analogues:

- ``mp_async_allreduce`` (fleet/layers/mpu/mp_layers.py:458-477): the
  tensor-parallel backward starts the input gradient's all-reduce and
  computes the weight gradient while it runs;
- sharding comm overlap (dygraph_sharding_optimizer.py:470): each
  gradient's reduction starts during the backward, as soon as the
  gradient is final.

The JAX package gets both from XLA's scheduler, given flags, and proves
the independence on the compiled HLO. Eager PyTorch has no scheduler, so
the port builds the overlap into its step, as the reference does, and
takes it on every mesh of more than one rank:

- ``mp_async_allreduce``: the tensor-parallel input projections (the
  Llama's qkv and gate/up, ``mp_layers``' column-parallel linear and the
  row-parallel one over a whole input) go through one autograd Function
  (:func:`copy_matmul`) whose backward computes dx, starts dx's
  all-reduce over tp (``async_op=True``), computes dW meanwhile and waits
  through the work handle: the compute stream waits on NCCL's, the host
  does not.
- ``sharding_comm_overlap``: ``MeshPlan`` starts each parameter's
  gradient all-reduce (or its ``os_g`` reduce-scatter) from a post-
  accumulate-grad hook on the step's last microbatch, and waits for all
  of them before the clip and the update. FSDP2's own prefetch and
  reduce-scatter overlap cover ``p_g_os``; a pipeline's fused step keeps
  the blocking sums.

Each collective keeps its tensor, size and group; only its start moves,
so the overlapped step equals the serial one bit for bit. Nothing
selects the serial schedule but :func:`serial_reference`, the plain
version that checks hold the overlap against (``tools/mesh_check.py``,
the tests). :func:`enable_overlap` and :func:`apply_strategy_overlap`
report this fixed policy in JAX's form.

:func:`backward_overlap_independent`, :func:`collectives_in_loop` and
:func:`exposed_comm` read a ``torch.profiler`` chrome trace of a step in
place of JAX's HLO. JAX's ``validate_xla_flags``, ``apply_overlap_flags``
and ``OVERLAP_XLA_FLAGS`` vet XLA flags and have no counterpart; nor has
its ``PT_NO_OVERLAP`` lever, which picks between two XLA schedules.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

KNOBS = ("mp_async_allreduce", "sharding_comm_overlap")
# set inside serial_reference(): the checks' plain schedule
_SERIAL = [False]
# the dx all-reduces' order of events while a test records them
_ORDER: List[Optional[list]] = [None]

DX_SPAN = "overlap::dx_allreduce"
SYNC_SPAN = "overlap::grad_sync"
# the span the Trainer puts around each microbatch
MICROBATCH_SPAN = "trainer::microbatch"


def overlapped() -> bool:
    """Whether a mesh step overlaps its collectives: always, except
    inside :func:`serial_reference`."""
    return not _SERIAL[0]


@contextlib.contextmanager
def serial_reference():
    """Run mesh steps in the serial schedule inside the scope: each dx
    all-reduce before dW's product (``copy_to_group`` then the product),
    each gradient's sums after the backward, blocking. The plain version
    of the overlap, for the checks that hold the overlapped step to it
    bit for bit and time the two; no entry point takes it."""
    _SERIAL[0] = True
    try:
        yield
    finally:
        _SERIAL[0] = False


def strategy_overlap_summary(strategy) -> Dict[str, bool]:
    """Which reference overlap knobs the strategy requests. Unknown knobs
    land in ``strategy.extras``; the three reference names are
    honoured."""
    tp_cfg = getattr(strategy, "tensor_parallel", None)
    sh_cfg = getattr(strategy, "sharding", None)
    extras = getattr(strategy, "extras", {}) or {}
    return {
        "mp_async_allreduce": bool(
            getattr(tp_cfg, "mp_async_allreduce", False)
            or extras.get("mp_async_allreduce")),
        "allreduce_matmul_grad_overlapping": bool(
            extras.get("allreduce_matmul_grad_overlapping")),
        "sharding_comm_overlap": bool(
            getattr(sh_cfg, "comm_overlap", False)
            or extras.get("comm_overlap")),
    }


def overlap_fingerprint() -> str:
    """The overlap in effect as a stable string: the mechanisms, or
    "serial" inside :func:`serial_reference`."""
    return " ".join(KNOBS) if overlapped() else "serial"


def enable_overlap(enable: bool = True) -> Dict[str, object]:
    """The overlap policy in JAX's dict: ``enabled``, ``applied`` (the
    mechanisms), ``reason`` and ``fingerprint``. The port's overlap is
    fixed, on every mesh of more than one rank (it changes no number), so
    this reports it; ``enable=False`` raises, as there is nothing to
    turn off."""
    if not enable:
        raise ValueError(
            "the comm/compute overlap is part of every mesh step and equals "
            "the serial schedule bit for bit; there is no switch to turn it "
            "off (distributed.overlap.serial_reference is the checks' plain "
            "version)")
    return {"enabled": True, "applied": list(KNOBS),
            "reason": "always on a mesh of more than one rank",
            "fingerprint": overlap_fingerprint()}


def apply_strategy_overlap(strategy) -> Dict[str, object]:
    """:func:`enable_overlap`'s report for a strategy: whichever overlap
    knobs it sets (``mp_async_allreduce``,
    ``allreduce_matmul_grad_overlapping``, ``sharding.comm_overlap``),
    or none, the step overlaps both."""
    return enable_overlap(True)


@contextlib.contextmanager
def record_order():
    """Record the overlapped tensor-parallel backward's events, in order:
    ("issue", i) when dx's all-reduce starts, ("dw", i) when the weight
    gradient is computed, ("wait", i) when the work handle is waited on
    (i counts the calls). Yields the list."""
    events: list = []
    _ORDER[0] = events
    try:
        yield events
    finally:
        _ORDER[0] = None


def _note(kind: str, i: int) -> None:
    if _ORDER[0] is not None:
        _ORDER[0].append((kind, i))


class _Work:
    """A collective's work handle that notes its wait."""

    def __init__(self, work, i: int):
        self.work, self.i = work, i

    def wait(self) -> None:
        if self.work is not None:
            self.work.wait()
        _note("wait", self.i)


class _CopyMatmul(torch.autograd.Function):
    """y = x' @ w, where x' is x (or its ``me``-th of ``n`` chunks along
    the last dimension) copied into a tensor-parallel region (Megatron's
    f fused with the product). The backward computes dx, starts its
    all-reduce over ``pg``, computes dW while it runs, then waits on the
    handle. dx and dW are the products autograd's matmul takes (the
    folded [rows, k] forms): the same numbers as ``copy_to_group``
    followed by ``torch.matmul``."""

    @staticmethod
    def forward(ctx, x, w, pg, n, me, chunk):
        xc = x.chunk(n, dim=-1)[me] if chunk else x
        ctx.save_for_backward(xc, w)
        ctx.args = (pg, n, me, chunk, x.shape)
        return torch.matmul(xc, w)

    @staticmethod
    def backward(ctx, g):
        xc, w = ctx.saved_tensors
        pg, n, me, chunk, xshape = ctx.args
        i = len(_ORDER[0]) if _ORDER[0] is not None else 0
        g2 = g.reshape(-1, g.shape[-1])
        dx = dw = None
        work = _Work(None, i)
        if ctx.needs_input_grad[0]:
            dxc = g2.mm(w.t()).view(xc.shape)
            if chunk:
                parts = [torch.zeros_like(dxc) for _ in range(n)]
                parts[me] = dxc
                dx = torch.cat(parts, dim=-1)
            else:
                dx = dxc
            if pg is not None:
                with torch.profiler.record_function(DX_SPAN):
                    work = _Work(dist.all_reduce(dx, group=pg,
                                                 async_op=True), i)
                _note("issue", i)
        if ctx.needs_input_grad[1]:
            dw = xc.reshape(-1, xc.shape[-1]).t().mm(g2)
            _note("dw", i)
        if dx is not None and pg is not None:
            work.wait()
        return dx, dw, None, None, None, None


def copy_matmul(x: torch.Tensor, w: torch.Tensor, group=None,
                chunk: bool = False) -> torch.Tensor:
    """``torch.matmul(copy_to_group(x, group), w)`` (with ``chunk``: of
    this rank's slice of x's last dimension, a row-parallel product over
    a whole input). In a group of more than one rank the backward
    overlaps dx's all-reduce with dW's product (:class:`_CopyMatmul`);
    in a group of one, or under :func:`serial_reference`, it is the
    plain composition.
    ``group`` None: no tensor-parallel region, the plain product."""
    from .communication import _pg, copy_to_group
    if group is None:
        return torch.matmul(x, w)
    pg, n, me, _ = _pg(group)
    if n > 1 and overlapped():
        return _CopyMatmul.apply(x, w, pg, n, me, chunk)
    x = copy_to_group(x, group)
    if chunk:
        x = x.chunk(n, dim=-1)[me]
    return torch.matmul(x, w)


# -- reading a torch.profiler trace -------------------------------------------

def _events(trace) -> List[dict]:
    """The events of a chrome trace: a path, the loaded dict, or a list
    of events."""
    if isinstance(trace, (str, os.PathLike)):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        trace = trace.get("traceEvents", [])
    return [e for e in trace if e.get("ph") == "X"]


def _is_nccl(e) -> bool:
    return "nccl" in e.get("name", "").lower()


def _is_gemm(e) -> bool:
    name = e.get("name", "").lower()
    return any(t in name for t in ("gemm", "xmma", "nvjet", "cutlass",
                                   "wgmma", "sm90_", "ampere_", "mma"))


def _kernels(evs) -> List[dict]:
    return [e for e in evs if e.get("cat") == "kernel"]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _covered(a: float, b: float, cover) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in cover)


def exposed_comm(trace) -> Dict[str, float]:
    """NCCL kernel time (ms) in a trace, and the part of it that overlaps
    no compute kernel ("exposed comm"): {"nccl_ms", "exposed_ms",
    "compute_ms", "nccl_kernels"}."""
    ks = _kernels(_events(trace))
    comm = [(e["ts"], e["ts"] + e["dur"]) for e in ks if _is_nccl(e)]
    comp = _union([(e["ts"], e["ts"] + e["dur"]) for e in ks
                   if not _is_nccl(e)])
    nccl = sum(b - a for a, b in comm)
    hidden = sum(_covered(a, b, comp) for a, b in comm)
    return {"nccl_ms": nccl / 1e3, "exposed_ms": (nccl - hidden) / 1e3,
            "compute_ms": sum(b - a for a, b in comp) / 1e3,
            "nccl_kernels": len(comm)}


def _launched_within(evs, spans) -> List[List[dict]]:
    """For each CPU span, the kernels whose launches (runtime or driver
    calls on the span's thread, inside it) it contains, matched by
    correlation id."""
    launches = [e for e in evs if e.get("cat") in ("cuda_runtime",
                                                    "cuda_driver")
                and "aunch" in e.get("name", "")]
    by_corr = {}
    for k in _kernels(evs):
        c = k.get("args", {}).get("correlation")
        if c is not None:
            by_corr.setdefault(c, []).append(k)
    out = []
    for s in spans:
        lo, hi = s["ts"], s["ts"] + s["dur"]
        mine = []
        for e in launches:
            if e.get("tid") == s.get("tid") and lo <= e["ts"] <= hi:
                mine += by_corr.get(e.get("args", {}).get("correlation"), [])
        out.append(mine)
    return out


def _spans(evs, name) -> List[dict]:
    return sorted((e for e in evs if e.get("name") == name
                   and e.get("cat") == "user_annotation"),
                  key=lambda e: e["ts"])


def backward_overlap_independent(trace) -> Dict[str, object]:
    """Whether each overlapped dx all-reduce's NCCL kernel (launched in a
    :data:`DX_SPAN` span) overlaps a GEMM on another stream in time:
    {"allreduces": n, "overlapping_gemm": k, "each": [bool, ...]}."""
    evs = _events(trace)
    gemms = [e for e in _kernels(evs) if _is_gemm(e) and not _is_nccl(e)]
    each = []
    for ks in _launched_within(evs, _spans(evs, DX_SPAN)):
        nccl = [k for k in ks if _is_nccl(k)]
        hit = False
        for k in nccl:
            a, b = k["ts"], k["ts"] + k["dur"]
            hit |= any(g.get("args", {}).get("stream")
                       != k.get("args", {}).get("stream")
                       and g["ts"] < b and a < g["ts"] + g["dur"]
                       for g in gemms)
        each.append(hit)
    return {"allreduces": len(each), "overlapping_gemm": sum(each),
            "each": each}


def collectives_in_loop(trace) -> Tuple[int, List[int]]:
    """(grad-sync collectives started, how many each microbatch started):
    the :data:`SYNC_SPAN` spans in the trace and their count inside each
    :data:`MICROBATCH_SPAN` span. Overlap issues them on the last
    microbatch only, once a parameter."""
    evs = _events(trace)
    syncs = _spans(evs, SYNC_SPAN)
    per = [sum(1 for s in syncs if m["ts"] <= s["ts"] <= m["ts"] + m["dur"])
           for m in _spans(evs, MICROBATCH_SPAN)]
    return len(syncs), per


__all__ = ["KNOBS", "overlapped", "serial_reference", "enable_overlap",
           "apply_strategy_overlap", "overlap_fingerprint",
           "strategy_overlap_summary", "copy_matmul", "record_order",
           "backward_overlap_independent", "collectives_in_loop",
           "exposed_comm"]
