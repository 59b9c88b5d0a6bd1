"""Census of one call: every aten op and every collective it dispatches
(counterpart of ``paddle_tpu/analysis/collectives.py``, and the record
every analyzer of this package reads, as JAX's read ``hlo.parse_hlo``).

The JAX package reads the optimized HLO of a compiled step; the port has
no HLO, so it records the op stream the call dispatches, once, under a
``TorchDispatchMode`` (:class:`StepCensus`):

* each aten op with its flops (``torch.utils.flop_counter``'s formulas)
  and its bytes (inputs plus outputs; views and allocations move none),
  the leaves it allocates (shape, dtype, bytes: the buffers
  ``materialization`` reads) and the inputs it writes in place (the
  schema's ``Tensor(a!)``), with their storage;
* each c10d collective (``torch.ops.c10d.*``, ``_c10d_functional.*``) at
  the dispatcher, so that FSDP2's and DTensor's count as well as the
  port's own, with its payload bytes, the ranks of its group and its
  place in the op stream; an async collective's wait is reported by
  the port's async sites (:func:`async_issued`, :func:`async_waited`)
  or seen as ``wait_tensor``;
* each host sync (a scalar read, an op whose output shape depends on
  the data, a copy from the card to the CPU; on the CPU also
  ``Tensor.tolist`` / ``.numpy``, which read memory without an op)
  with the line of the port that asked for it;
* each hand-written kernel's wrapper reports the kernel's own flops and
  bytes through :func:`kernel` (the counts ``PERF.md``'s bound column
  uses) and the buffers it returns; the census skips the ops beneath
  it (host syncs excepted), so the plain route on the CPU or the
  ``meta`` device records what the kernel does on the card;
* each matrix product's shape (``mm``, ``addmm``, ``bmm``: m, k, n and
  dtype, a batch folded into m), the JAX report's ``dots``, which the
  calibration probe times and the planner's measured-dot correction
  reads;
* with ``inputs=`` (a name -> tensor map, or a callable giving one), the
  storage each named input held before and after the call: what
  ``donation`` compares.

:func:`collective_census` classifies each collective by the mesh axis
whose group it ran over and summarises it in the JAX census's keys.
:func:`to_json` / :func:`from_json` save and load a census, so the
tools run on a saved record as JAX's run on a saved ``.hlo``.
"""

from __future__ import annotations

import importlib
import os
import sys
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CollectiveInstr", "OpCost", "Leaf", "HostSync", "InputRecord",
           "CensusRecord", "StepCensus", "collective_census",
           "mesh_axis_groups", "kernel", "async_issued",
           "async_waited", "to_json", "from_json"]

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
         "resize_", "record_stream", "_unsafe_view", "item")
# the allocations among them: their outputs are buffers all the same
_ALLOC = ("empty", "empty_like", "empty_strided", "new_empty",
          "new_empty_strided")
# ops that wait for the device to hand the host a value or a shape
# (``item`` reaches the mode whole under inference mode)
_SYNC = ("_local_scalar_dense", "item", "nonzero", "masked_select", "unique",
         "_unique", "_unique2", "unique_consecutive", "unique_dim",
         "is_nonzero", "equal", "argwhere", "nonzero_numpy")
# out-of-place copies: a named input read whole by one of these before
# its first in-place write keeps its pre-call value (donation)
_COPIES = ("clone", "_to_copy", "copy")
# torch dtype -> the XLA element-type names the JAX reports use
_XLA_DTYPE = {torch.float32: "f32", torch.bfloat16: "bf16",
              torch.float16: "f16", torch.float64: "f64",
              torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
              torch.int32: "s32", torch.int64: "s64", torch.bool: "pred"}


def _xla(dtype) -> str:
    return _XLA_DTYPE.get(dtype, str(dtype).replace("torch.", ""))


@dataclass(frozen=True)
class Leaf:
    """One buffer: dims, XLA element-type name, bytes."""
    dims: Tuple[int, ...]
    dtype: str
    bytes: int

    def __str__(self) -> str:
        return f"{self.dtype}[{','.join(str(d) for d in self.dims)}]"


@dataclass
class OpCost:
    name: str
    flops: float
    bytes: float
    kernel: bool = False
    #: the buffers the op allocates (a kernel: those its wrapper returns)
    outputs: Tuple[Leaf, ...] = ()
    #: (storage key, leaf) of each input the op writes in place
    mutated: Tuple[Tuple[Tuple[str, int], Leaf], ...] = ()
    #: storage key of the input an out-of-place copy reads whole
    copied: Optional[Tuple[str, int]] = None


@dataclass
class CollectiveInstr:
    opcode: str
    bytes: int
    ranks: Tuple[int, ...]
    axis: str = "?"            # mesh axis name, "?" when unclassified
    op_name: str = ""
    #: the op stream's length when it was issued (ops before it)
    index: int = -1
    #: issued without waiting (its wait reported to the census)
    is_async: bool = False
    #: the op stream's length when its wait came
    done_index: Optional[int] = None


@dataclass
class HostSync:
    """One op that made the host wait for the device."""
    op: str
    where: str
    index: int

    def describe(self) -> str:
        return f"{self.op} at op {self.index} <- {self.where}"


@dataclass
class InputRecord:
    """A named input of the call: its leaf and its storage before and
    after (a storage that changed was replaced, not written in place)."""
    leaf: Leaf
    before: Optional[Tuple[str, int]]
    after: Optional[Tuple[str, int]] = None
    #: the leaf the name held after the call
    after_leaf: Optional[Leaf] = None


@dataclass
class CensusRecord:
    """What a census recorded (a finished :class:`StepCensus`, or one
    loaded by :func:`from_json`): the analyzers read these fields."""
    ops: List[OpCost] = field(default_factory=list)
    collectives: List[CollectiveInstr] = field(default_factory=list)
    host_syncs: List[HostSync] = field(default_factory=list)
    allocs: List[OpCost] = field(default_factory=list)
    dots: Dict[Tuple[int, int, int, str], int] = field(default_factory=dict)
    inputs: Dict[str, InputRecord] = field(default_factory=dict)


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


def _leaf(t: torch.Tensor) -> Leaf:
    return Leaf(tuple(int(d) for d in t.shape), _xla(t.dtype),
                int(t.numel() * t.element_size()))


def _leaves(x) -> List[Leaf]:
    if isinstance(x, torch.Tensor):
        return [_leaf(x)]
    if isinstance(x, (list, tuple)):
        return [l for v in x for l in _leaves(v)]
    return []


def _storage_key(t) -> Optional[Tuple[str, int]]:
    """(device, storage address) of a tensor, a DTensor's local shard's;
    None on the meta device (no storage) or for a non-tensor."""
    t = getattr(t, "_local_tensor", t)
    if not isinstance(t, torch.Tensor) or t.device.type == "meta":
        return None
    try:
        return (str(t.device), int(t.untyped_storage().data_ptr()))
    except (RuntimeError, NotImplementedError):
        return None


_HERE = os.path.abspath(__file__)
_PKG = os.path.dirname(os.path.dirname(_HERE))
_TORCH = os.path.dirname(os.path.abspath(torch.__file__))


def _where() -> str:
    """The innermost frame outside torch and this module: the line that
    asked for the op (the port's, or its caller's)."""
    f = sys._getframe(1)
    while f is not None:
        fn = os.path.abspath(f.f_code.co_filename)
        if fn != _HERE and not fn.startswith(_TORCH) \
                and "/torch/" not in fn:
            rel = os.path.relpath(fn, os.path.dirname(_PKG)) \
                if fn.startswith(_PKG) else os.path.basename(fn)
            return f"{rel}:{f.f_lineno} in {f.f_code.co_name}"
        f = f.f_back
    return "?"


class _Kernel:
    """The census scope of one kernel (:func:`kernel`)."""

    def __init__(self, census: "StepCensus", name: str, flops: float,
                 nbytes: float):
        self.census, self.op = census, OpCost(name, float(flops),
                                              float(nbytes), True)

    def __enter__(self):
        self.census.ops.append(self.op)
        self.census._suppress += 1
        return self

    def __exit__(self, *exc):
        self.census._suppress -= 1

    def out(self, *tensors):
        """Record the buffers the kernel returns (what it writes on the
        card, not what the plain route allocates); returns them."""
        self.op.outputs = self.op.outputs + tuple(_leaves(list(tensors)))
        return tensors[0] if len(tensors) == 1 else tensors


class _NoCensus:
    """:func:`kernel`'s scope without a census: a shared no-op."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def out(*tensors):
        return tensors[0] if len(tensors) == 1 else tensors


_OFF = _NoCensus()


def kernel(name: str, cost, *args):
    """Around one hand-written kernel's work (or its plain version's):
    under a census, record the kernel's flops and bytes, ``cost(*args)``,
    skip the ops beneath, and take the buffers it returns through the
    scope's ``out(*tensors)``. Without a census it returns a shared
    no-op scope and never calls ``cost``."""
    if not _ACTIVE:
        return _OFF
    return _Kernel(_ACTIVE[-1], name, *cost(*args))


def async_issued():
    """Called by a port site right after it issues a collective without
    waiting: marks the census's last collective async and returns the
    token :func:`async_waited` takes (None without a census)."""
    if not _ACTIVE or not _ACTIVE[-1].collectives:
        return None
    c = _ACTIVE[-1]
    c.collectives[-1].is_async = True
    return (c, len(c.collectives) - 1)


def async_waited(token) -> None:
    """Called where the site waits on the collective of ``token``: its
    window ends at the op stream's current length."""
    if token is not None:
        census, i = token
        census.collectives[i].done_index = len(census.ops)


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


def _is_d2h(name: str, args, kwargs, out) -> bool:
    """A copy from the card to the CPU: the host waits for it."""
    if name in ("_to_copy", "to") and args and isinstance(
            args[0], torch.Tensor):
        return (args[0].device.type == "cuda"
                and isinstance(out, torch.Tensor)
                and out.device.type == "cpu")
    if name == "copy_" and len(args) > 1:
        dst, src = args[0], args[1]
        return (isinstance(src, torch.Tensor) and src.device.type == "cuda"
                and isinstance(dst, torch.Tensor)
                and dst.device.type == "cpu")
    return False


def _syncs(func, name: str, args, kwargs, out) -> bool:
    if name in _SYNC or _is_d2h(name, args, kwargs, out):
        return True
    if name in ("index", "index_put_", "index_put") and len(args) > 1:
        # boolean-mask indexing: its shape is the mask's count
        return any(isinstance(i, torch.Tensor) and i.dtype in (
            torch.bool, torch.uint8) for i in (args[1] or ()))
    # repeats given as a tensor: the output's length is their sum
    return (name == "repeat_interleave" and not kwargs.get("output_size")
            and func._overloadname in ("Tensor", "self_Tensor"))


def _einsum_flops(args, out) -> float:
    """2 x the product of every index's size of a two-operand einsum."""
    eq, ops = args[0], args[1]
    if len(ops) != 2 or "..." in eq:
        return 0.0
    sizes = {}
    for spec, t in zip(eq.split("->")[0].split(","), ops):
        for ch, n in zip(spec.strip(), t.shape):
            sizes[ch] = int(n)
    prod = 1
    for n in sizes.values():
        prod *= n
    return 2.0 * prod


# products that reach the mode whole under inference mode (no autograd
# key decomposes them), which flop_counter has no formula for
_COMPOSITE_PRODUCTS = {
    "matmul": lambda a, out: 2.0 * out.numel() * a[0].shape[-1],
    "linear": lambda a, out: 2.0 * out.numel() * a[0].shape[-1],
    "einsum": _einsum_flops,
}


# Tensor methods that read a CPU tensor's memory without an aten op (on
# the card they dispatch a device-to-host copy, which the mode sees)
_HOST_READS = ("tolist", "numpy")
_PATCHED: Dict[str, Callable] = {}
_PATCH_LOCK = threading.Lock()


def _read_hook(name: str, orig: Callable) -> Callable:
    def read(self, *a, **kw):
        me = threading.get_ident()
        for c in _ACTIVE:
            if c._thread == me and self.device.type == "cpu" \
                    and not c._suppress:
                c.host_syncs.append(HostSync(f"Tensor.{name}", _where(),
                                             len(c.ops)))
        return orig(self, *a, **kw)
    read.__name__ = name
    return read


def _hook_reads() -> None:
    """Wrap the host-read methods while any census records, and only
    then."""
    with _PATCH_LOCK:
        if _ACTIVE and not _PATCHED:
            for name in _HOST_READS:
                _PATCHED[name] = getattr(torch.Tensor, name)
                setattr(torch.Tensor, name,
                        _read_hook(name, _PATCHED[name]))
        elif not _ACTIVE and _PATCHED:
            for name, orig in _PATCHED.items():
                setattr(torch.Tensor, name, orig)
            _PATCHED.clear()


def _on_card(args) -> bool:
    return any(isinstance(a, torch.Tensor) and a.device.type == "cuda"
               for a in args)


class StepCensus(TorchDispatchMode):
    """Records every aten op (:class:`OpCost`), collective
    (:class:`CollectiveInstr`) and host sync (:class:`HostSync`)
    dispatched while entered; ``ops`` also holds the kernels reported
    through :func:`kernel`, ``allocs`` the allocations, ``dots`` the
    count of each matrix product's (m, k, n, dtype) and ``inputs`` the
    storage of each named input before and after (``inputs=``)."""

    def __init__(self, inputs=None):
        super().__init__()
        self._flops = _flop_registry()
        self.ops: List[OpCost] = []
        self.collectives: List[CollectiveInstr] = []
        self.host_syncs: List[HostSync] = []
        self.allocs: List[OpCost] = []
        self.dots: Dict[Tuple[int, int, int, str], int] = {}
        self.inputs: Dict[str, InputRecord] = {}
        self._named: Optional[Callable] = (
            inputs if inputs is None or callable(inputs)
            else (lambda: inputs))
        self._functional: Dict[int, Tuple[torch.Tensor, int]] = {}
        self._suppress = 0
        self._thread = threading.get_ident()

    def __enter__(self):
        if self._named is not None:
            self.inputs = {k: InputRecord(_leaf(t), _storage_key(t))
                           for k, t in self._named().items()}
        self._thread = threading.get_ident()
        _ACTIVE.append(self)
        _hook_reads()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            _ACTIVE.remove(self)
            _hook_reads()
            self._functional.clear()
            if self._named is not None:
                now = self._named()
                for k, rec in self.inputs.items():
                    if k in now:
                        rec.after = _storage_key(now[k])
                        rec.after_leaf = _leaf(now[k])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ns, name = func.namespace, func._opname
        # beneath a kernel scope only the card's syncs count: a plain
        # route's reads of CPU tensors are not what the kernel does
        if ns == "aten" and _syncs(func, name, args, kwargs, out) and (
                not self._suppress or _on_card(args)):
            self.host_syncs.append(HostSync(f"aten.{name}", _where(),
                                            len(self.ops)))
        if self._suppress:
            return out
        if ns in ("c10d", "_c10d_functional"):
            op = _C10D.get(name)
            if op is not None:
                b = max(_nbytes(args[0]) if args else 0,
                        _nbytes(args[1]) if len(args) > 1 else 0)
                if name.startswith("all_gather_into_tensor"):
                    b = _nbytes(out)
                self.collectives.append(CollectiveInstr(
                    op, int(b), _group_ranks(list(args) + list(
                        kwargs.values())), op_name=f"{ns}.{name}",
                    index=len(self.ops)))
                if ns == "_c10d_functional" and isinstance(
                        out, torch.Tensor):
                    self._functional[id(out)] = (
                        out, len(self.collectives) - 1)
            elif name == "wait_tensor" and args:
                hit = self._functional.pop(id(args[0]), None)
                if hit is not None:
                    c = self.collectives[hit[1]]
                    c.is_async, c.done_index = True, len(self.ops)
            return out
        if ns != "aten" or func.is_view:
            return out
        if name in _FREE:
            if name in _ALLOC:
                self.allocs.append(OpCost(f"aten.{name}", 0.0, 0.0,
                                          outputs=tuple(_leaves(out))))
            return out
        fl = 0.0
        f = self._flops.get(func._overloadpacket)
        if f is not None:
            fl = float(f(*args, **kwargs, out_val=out))
        elif name in _COMPOSITE_PRODUCTS:
            fl = _COMPOSITE_PRODUCTS[name](args, out)
        schema = func._schema
        mutated = []
        for i, a in enumerate(schema.arguments):
            if a.alias_info is None or not a.alias_info.is_write:
                continue
            v = args[i] if i < len(args) else kwargs.get(a.name)
            for t in (v if isinstance(v, (list, tuple)) else [v]):
                if isinstance(t, torch.Tensor):
                    mutated.append((_storage_key(t), _leaf(t)))
        fresh = [o for o, r in zip(
            out if isinstance(out, (list, tuple)) else [out],
            schema.returns) if r.alias_info is None]
        copied = (_storage_key(args[0]) if name in _COPIES and args
                  and isinstance(args[0], torch.Tensor) else None)
        self.ops.append(OpCost(f"aten.{name}", fl,
                               float(_nbytes(list(args)) + _nbytes(out)),
                               outputs=tuple(_leaves(fresh)),
                               mutated=tuple(mutated), copied=copied))
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


def collective_census(census, mesh=None) -> Dict:
    """Per-collective table and summary, in the JAX census's keys;
    ``mesh`` (a ``HybridMesh``) classifies each by its axis. A census
    whose collectives already carry their axes (one loaded by
    :func:`from_json`) keeps them."""
    groups = mesh_axis_groups(mesh) if mesh is not None else {}
    single = {a for a in groups if "+" not in a}
    table: List[CollectiveInstr] = []
    for c in census.collectives:
        axis = c.axis
        rs = frozenset(c.ranks)
        hits = [a for a, sets in groups.items() if rs in sets]
        if hits:
            # a single axis names it before a set of axes that equals it
            axis = sorted(hits, key=lambda a: (a not in single, a))[0]
        table.append(CollectiveInstr(c.opcode, c.bytes, c.ranks, axis,
                                     c.op_name, c.index, c.is_async,
                                     c.done_index))
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


# -- saved records -------------------------------------------------------------

def _leaf_json(l: Leaf):
    return [list(l.dims), l.dtype, l.bytes]


def _leaf_of(j) -> Leaf:
    return Leaf(tuple(j[0]), j[1], int(j[2]))


def _key_json(k):
    return None if k is None else [k[0], k[1]]


def _key_of(j):
    return None if j is None else (j[0], int(j[1]))


def _op_json(o: OpCost):
    return {"name": o.name, "flops": o.flops, "bytes": o.bytes,
            "kernel": o.kernel,
            "outputs": [_leaf_json(l) for l in o.outputs],
            "mutated": [[_key_json(k), _leaf_json(l)]
                        for k, l in o.mutated],
            "copied": _key_json(o.copied)}


def _op_of(j) -> OpCost:
    return OpCost(j["name"], float(j["flops"]), float(j["bytes"]),
                  bool(j["kernel"]),
                  tuple(_leaf_of(l) for l in j.get("outputs", ())),
                  tuple((_key_of(k), _leaf_of(l))
                        for k, l in j.get("mutated", ())),
                  _key_of(j.get("copied")))


def to_json(census, mesh=None) -> Dict:
    """A census as JSON-able data (collectives with their mesh axes when
    ``mesh`` is given): what :func:`from_json` loads."""
    coll = collective_census(census, mesh)["table"]
    return {
        "ops": [_op_json(o) for o in census.ops],
        "allocs": [_op_json(o) for o in census.allocs],
        "collectives": [{"opcode": c.opcode, "bytes": c.bytes,
                         "ranks": list(c.ranks), "axis": c.axis,
                         "op_name": c.op_name, "index": c.index,
                         "is_async": c.is_async,
                         "done_index": c.done_index} for c in coll],
        "host_syncs": [{"op": h.op, "where": h.where, "index": h.index}
                       for h in census.host_syncs],
        "dots": [[*k, n] for k, n in census.dots.items()],
        "inputs": {k: {"leaf": _leaf_json(r.leaf),
                       "before": _key_json(r.before),
                       "after": _key_json(r.after),
                       "after_leaf": (None if r.after_leaf is None
                                      else _leaf_json(r.after_leaf))}
                   for k, r in census.inputs.items()},
    }


def from_json(d: Dict) -> CensusRecord:
    """The record :func:`to_json` saved."""
    return CensusRecord(
        ops=[_op_of(o) for o in d.get("ops", ())],
        collectives=[CollectiveInstr(
            c["opcode"], int(c["bytes"]), tuple(c["ranks"]), c["axis"],
            c["op_name"], int(c["index"]), bool(c["is_async"]),
            c["done_index"]) for c in d.get("collectives", ())],
        host_syncs=[HostSync(h["op"], h["where"], int(h["index"]))
                    for h in d.get("host_syncs", ())],
        allocs=[_op_of(o) for o in d.get("allocs", ())],
        dots={(int(m), int(k), int(n), str(dt)): int(c)
              for m, k, n, dt, c in d.get("dots", ())},
        inputs={k: InputRecord(_leaf_of(r["leaf"]), _key_of(r["before"]),
                               _key_of(r["after"]),
                               None if r.get("after_leaf") is None
                               else _leaf_of(r["after_leaf"]))
                for k, r in d.get("inputs", {}).items()})

