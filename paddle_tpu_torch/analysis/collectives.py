"""Census of one training step: every aten op and every collective it
dispatches (counterpart of ``paddle_tpu/analysis/collectives.py``).

The JAX package reads the optimized HLO of a compiled step; the port has
no HLO, so it records the op stream the step dispatches, under a
``TorchDispatchMode`` (:class:`StepCensus`):

* each aten op with its flops (``torch.utils.flop_counter``'s formulas)
  and its bytes (inputs plus outputs; views and allocations move none);
* each c10d collective (``torch.ops.c10d.*``, ``_c10d_functional.*``) at
  the dispatcher, so that FSDP2's and DTensor's count as well as the
  port's own, with its payload bytes and the ranks of its group;
* each hand-written kernel's wrapper reports the kernel's own flops and
  bytes through :func:`kernel` (the counts ``PERF.md``'s bound column
  uses) and the census skips the ops beneath it, so the plain route on
  the CPU or the ``meta`` device prices the work the kernel does on the
  card;
* each matrix product's shape (``mm``, ``addmm``, ``bmm``: m, k, n and
  dtype, a batch folded into m), the JAX report's ``dots``, which the
  calibration probe times and the planner's measured-dot correction
  reads.

:func:`collective_census` classifies each collective by the mesh axis
whose group it ran over and summarises it in the JAX census's keys.
"""

from __future__ import annotations

import contextlib
import importlib
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveInstr", "OpCost", "StepCensus", "collective_census",
           "mesh_axis_groups", "kernel", "active"]

# c10d and functional-collective op names -> the HLO opcode vocabulary
_C10D = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "broadcast_": "collective-broadcast", "broadcast": "collective-broadcast",
    "send": "collective-permute", "recv_": "collective-permute",
    "reduce_": "all-reduce", "gather_": "all-gather",
    "scatter_": "collective-broadcast",
}
# matrix products -> the index of their left operand
_DOTS = {"mm": 0, "bmm": 0, "addmm": 1, "baddbmm": 1}
# aten ops that move no bytes of their own
_FREE = ("empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "lift_fresh", "_local_scalar_dense", "set_",
         "resize_", "record_stream", "_unsafe_view")


@dataclass
class OpCost:
    name: str
    flops: float
    bytes: float
    kernel: bool = False


@dataclass
class CollectiveInstr:
    opcode: str
    bytes: int
    ranks: Tuple[int, ...]
    axis: str = "?"            # mesh axis name, "?" when unclassified
    op_name: str = ""


_ACTIVE: List["StepCensus"] = []
_FLOPS: list = []


def _import_all(names):
    for name in names:
        importlib.import_module(name)


def _flop_registry():
    """``torch.utils.flop_counter``'s formulas, imported once together
    with ``torch._dynamo`` (which a dispatch mode's first op imports).
    Importing ``torch._dynamo`` leaves an exception's traceback in a
    reference cycle; through each frame's ``f_back`` that cycle pins the
    whole importing stack (a trainer or an engine with its model) until
    the next full collection. So the imports run on a thread of their
    own, whose frames pin nothing of the caller's."""
    if not _FLOPS:
        t = threading.Thread(target=_import_all, args=(
            ("torch._dynamo", "torch.utils.flop_counter"),))
        t.start()
        t.join()
        from torch.utils.flop_counter import flop_registry
        _FLOPS.append(flop_registry)
    return _FLOPS[0]


class _Kernel:
    """The census scope of one kernel (:func:`kernel`)."""

    def __init__(self, census: "StepCensus", name: str, flops: float,
                 nbytes: float):
        self.census, self.op = census, OpCost(name, float(flops),
                                              float(nbytes), True)

    def __enter__(self):
        self.census.ops.append(self.op)
        self.census._suppress += 1

    def __exit__(self, *exc):
        self.census._suppress -= 1


_OFF = contextlib.nullcontext()


def kernel(name: str, cost, *args):
    """Around one hand-written kernel's work (or its plain version's):
    under a census, record the kernel's flops and bytes, ``cost(*args)``,
    and skip the ops beneath. Without a census it returns a shared no-op
    context and never calls ``cost``."""
    if not _ACTIVE:
        return _OFF
    return _Kernel(_ACTIVE[-1], name, *cost(*args))


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _group_ranks(args) -> Tuple[int, ...]:
    import torch.distributed as dist
    pg_cls = torch._C._distributed_c10d.ProcessGroup
    for a in args:
        pg = None
        if isinstance(a, torch.ScriptObject):
            try:
                pg = pg_cls.unbox(a)
            except RuntimeError:
                continue
        elif isinstance(a, str):
            try:
                from torch.distributed.distributed_c10d import \
                    _resolve_process_group
                pg = _resolve_process_group(a)
            except (RuntimeError, ValueError, KeyError):
                continue
        if pg is not None:
            return tuple(dist.get_process_group_ranks(pg))
    return ()


class StepCensus(TorchDispatchMode):
    """Records every aten op (:class:`OpCost`) and collective
    (:class:`CollectiveInstr`) dispatched while entered; ``ops`` also
    holds the kernels reported through :func:`kernel`, ``dots`` the
    count of each matrix product's (m, k, n, dtype)."""

    def __init__(self):
        super().__init__()
        self._flops = _flop_registry()
        self.ops: List[OpCost] = []
        self.collectives: List[CollectiveInstr] = []
        self.dots: Dict[Tuple[int, int, int, str], int] = {}
        self._suppress = 0

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._suppress:
            return out
        ns, name = func.namespace, func._opname
        if ns in ("c10d", "_c10d_functional"):
            op = _C10D.get(name)
            if op is not None:
                b = max(_nbytes(args[0]) if args else 0,
                        _nbytes(args[1]) if len(args) > 1 else 0)
                if name.startswith("all_gather_into_tensor"):
                    b = _nbytes(out)
                self.collectives.append(CollectiveInstr(
                    op, int(b), _group_ranks(list(args) + list(
                        kwargs.values())), op_name=f"{ns}.{name}"))
            return out
        if ns != "aten" or func.is_view or name in _FREE:
            return out
        fl = 0.0
        f = self._flops.get(func._overloadpacket)
        if f is not None:
            fl = float(f(*args, **kwargs, out_val=out))
        self.ops.append(OpCost(f"aten.{name}", fl,
                               float(_nbytes(list(args)) + _nbytes(out))))
        if name in _DOTS:
            a, b = args[_DOTS[name]], args[_DOTS[name] + 1]
            m = a.shape[-2] * (a.shape[0] if a.dim() == 3 else 1)
            key = (int(m), int(a.shape[-1]), int(b.shape[-1]),
                   str(a.dtype).replace("torch.", ""))
            self.dots[key] = self.dots.get(key, 0) + 1
        return out


def mesh_axis_groups(mesh) -> Dict[str, frozenset]:
    """label -> the rank sets of this rank's groups over it, for a
    ``HybridMesh``: each axis (the tensor replica subgroups of a
    replicated KV head count as "tp"), each set of axes the port groups
    ("dp+fsdp", ...), and the whole world."""
    out: Dict[str, set] = {}
    for axes, (_g, ranks) in mesh._groups.items():
        if len(ranks) > 1:
            out.setdefault("+".join(axes), set()).add(frozenset(ranks))
    for a in mesh.axes:
        if mesh.axis_size(a) > 1:
            out.setdefault(a, set()).add(frozenset(mesh.group_ranks(a)))
    for key, g in mesh._subgroups.items():
        if g is not None:
            import torch.distributed as dist
            label = key[0] if isinstance(key, tuple) else "pp"
            out.setdefault(label, set()).add(frozenset(
                dist.get_process_group_ranks(g)))
    return {k: frozenset(v) for k, v in out.items()}


def collective_census(census: StepCensus, mesh=None) -> Dict:
    """Per-collective table and summary, in the JAX census's keys;
    ``mesh`` (a ``HybridMesh``) classifies each by its axis."""
    groups = mesh_axis_groups(mesh) if mesh is not None else {}
    single = {a for a in groups if "+" not in a}
    table: List[CollectiveInstr] = []
    for c in census.collectives:
        axis = "?"
        rs = frozenset(c.ranks)
        hits = [a for a, sets in groups.items() if rs in sets]
        if hits:
            # a single axis names it before a set of axes that equals it
            axis = sorted(hits, key=lambda a: (a not in single, a))[0]
        table.append(CollectiveInstr(c.opcode, c.bytes, c.ranks, axis,
                                     c.op_name))
    counts: Dict[str, int] = {}
    bytes_by_op: Dict[str, int] = {}
    for c in table:
        key = f"{c.opcode}[{c.axis}]" if c.axis != "?" else c.opcode
        counts[key] = counts.get(key, 0) + 1
        bytes_by_op[c.opcode] = bytes_by_op.get(c.opcode, 0) + c.bytes
    return {"table": table, "counts": dict(sorted(counts.items())),
            "bytes_by_op": dict(sorted(bytes_by_op.items())),
            "total_collectives": len(table),
            "total_collective_bytes": sum(c.bytes for c in table)}
