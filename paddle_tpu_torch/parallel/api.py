"""Semi-auto parallel API over ``torch.distributed`` (counterpart of
``paddle_tpu/parallel/api.py``): placements, ``shard_tensor`` /
``reshard`` over DTensor, ``param_spec_tree``, ``shard_layer`` and
``shard_optimizer_state``.

In the JAX package a parameter carries its ``sharding=`` annotation and
GSPMD partitions the program around it. Here :func:`shard_layer` reads
the same annotations (the model's table, :func:`param_spec_tree` equal
to JAX's) and turns each rank's full weights into its LOCAL shards:
plain tensors for the kernels' autograd Functions. Tensor parallelism is
explicit (Megatron-style, ``parallel.mp_layers``); the ``fsdp`` axis is
FSDP2's (``distributed.sharding.group_sharded_parallel``).

A fused projection is split per part, not by columns: rank ``r`` of
``tp`` gets its q heads, its KV heads and its v heads of ``qkv_proj``
and its slice of gate and of up of ``gate_up_proj`` (JAX's GSPMD
reshards after the split). When ``tp`` exceeds the KV heads, each KV
head is held by ``tp / n_kv`` consecutive ranks, whose gradients for it
are summed. :func:`full_state_dict` gathers the shards back into JAX's
layout.

:class:`MeshPlan` (``shard_layer``'s record on the model) holds what the
step needs beyond the forward: each parameter's shard, the gradient sums
over the axes a parameter is replicated on (:meth:`MeshPlan.sync_grads`),
the optimizer's view of the local shards (chunks of them under the
``os`` / ``os_g`` sharding levels), the global norm counting every
element once (:meth:`MeshPlan.global_sq`) and each rank's slice of a
global batch (:meth:`MeshPlan.local_batch`).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.tensor import (DTensor, Partial, Placement,
                                      Replicate, Shard, distribute_tensor)

from ..distributed import communication as comm
from .mesh import BATCH_AXES, HybridMesh, current_mesh

def _resolve_mesh(mesh) -> HybridMesh:
    if mesh is None:
        mesh = current_mesh()
        if mesh is None:
            raise RuntimeError("no active mesh: enter `with HybridMesh.build"
                               "(...)` (or fleet.init) or pass mesh=")
    return mesh


def _clean_spec(entries, mesh: HybridMesh) -> Tuple:
    """Drop axis names the mesh lacks or holds at size 1 (JAX's
    ``_clean_spec``); () for a replicated parameter."""
    if not entries:
        return ()
    out = []
    for e in entries:
        if isinstance(e, (tuple, list)):
            kept = tuple(a for a in e if mesh.axis_size(a) > 1)
            out.append(kept if kept else None)
        else:
            out.append(e if e is not None and mesh.axis_size(e) > 1
                       else None)
    return tuple(out)


def shard_tensor(x: torch.Tensor, mesh=None,
                 placements: Sequence[Placement] = ()) -> DTensor:
    """A DTensor of ``x`` (each rank's full copy) with ``placements`` per
    mesh axis, in ``mesh.axes`` order (missing ones Replicate)."""
    hm = _resolve_mesh(mesh)
    pl = list(placements) + [Replicate()] * (len(hm.axes) - len(placements))
    return distribute_tensor(x, hm.device_mesh, pl)


def reshard(x, mesh=None, placements: Sequence[Placement] = ()) -> DTensor:
    """``x`` (a DTensor, or a full tensor) with new placements: DTensor's
    redistribution runs the collectives."""
    hm = _resolve_mesh(mesh)
    if not isinstance(x, DTensor):
        return shard_tensor(x, hm, placements)
    pl = list(placements) + [Replicate()] * (len(hm.axes) - len(placements))
    return x.redistribute(hm.device_mesh, pl)


def annotations(layer: nn.Module) -> Dict[str, Tuple]:
    """{parameter name: (spec, blocks)} of ``layer``: its own table, the
    ``_sharding_annotations`` it carries; a parameter outside it is
    replicated."""
    return dict(getattr(layer, "_sharding_annotations", {}))


def param_spec_tree(layer: nn.Module, mesh=None) -> Dict[str, Tuple]:
    """name → the cleaned sharding spec of every trainable parameter, as
    JAX's ``param_spec_tree`` gives it (a tuple per dimension: an axis,
    a tuple of axes or None; () when replicated)."""
    hm = _resolve_mesh(mesh)
    ann = annotations(layer)
    return {n: _clean_spec(ann.get(n, (None, None))[0], hm)
            for n, p in layer.named_parameters() if p.requires_grad}


# -- tensor-parallel slicing ----------------------------------------------------

def _runs(size: int, blocks) -> List[Tuple[int, int]]:
    return blocks if blocks else [(size, 1)]


def tp_slice(full: torch.Tensor, dim: int, blocks, tp: int,
             r: int) -> torch.Tensor:
    """Rank ``r``'s shard of ``full`` along ``dim``: the runs of
    :func:`tp_runs`, concatenated."""
    return torch.cat([full.narrow(dim, start, n) for start, n in
                      tp_runs(full.shape[dim], blocks, tp, r)],
                     dim=dim).contiguous()


def tp_unslice(shards: List[torch.Tensor], dim: int, blocks,
               full_size: int) -> torch.Tensor:
    """The inverse of :func:`tp_slice` over every rank's shard."""
    tp = len(shards)
    out, off = [], 0
    for units, width in _runs(full_size, blocks):
        if units >= tp:
            size = units // tp * width
            out += [s.narrow(dim, off, size) for s in shards]
        else:
            size = width
            out += [shards[u * (tp // units)].narrow(dim, off, size)
                    for u in range(units)]
        off += size
    return torch.cat(out, dim=dim)


def tp_runs(size: int, blocks, tp: int, r: int) -> List[Tuple[int, int]]:
    """The (start, length) runs of the full dimension that rank ``r``'s
    :func:`tp_slice` holds, in order, one a fused part: each (units,
    width) run split into ``tp`` parts, or, with fewer units than ranks,
    unit ``r // (tp / units)`` (a replicated head)."""
    out, off = [], 0
    for units, width in _runs(size, blocks):
        if units >= tp:
            if units % tp:
                raise ValueError(f"{units} units do not split over tp={tp}")
            per = units // tp
            out.append((off + r * per * width, per * width))
        else:
            if tp % units:
                raise ValueError(f"{units} units cannot be replicated "
                                 f"evenly over tp={tp}")
            out.append((off + (r // (tp // units)) * width, width))
        off += units * width
    return out


def sub_runs(runs: List[Tuple[int, int]], lo: int,
             hi: int) -> List[Tuple[int, int]]:
    """The runs of positions ``[lo, hi)`` of the concatenation of
    ``runs``."""
    out, pos = [], 0
    for start, n in runs:
        a, b = max(lo, pos), min(hi, pos + n)
        if a < b:
            out.append((start + a - pos, b - a))
        pos += n
    return out


def flat_chunk(n: int, f: int, i: int) -> Tuple[int, int]:
    """Rank ``i`` of ``f``'s flat chunk ``[lo, hi)`` of ``n`` elements
    (the ``os`` / ``os_g`` optimizer view)."""
    c = -(-n // f)
    lo = min(i * c, n)
    return lo, min(lo + c, n)


def shard_layout(full_shape, spec, blocks, axes: Dict[str, int],
                 coords: Dict[str, int], level: str = "none",
                 view: bool = False) -> Dict:
    """Where one rank's local tensor of a parameter sits in the full
    (JAX-layout) tensor, without being that rank: ``{"runs": per
    dimension the (start, length) runs whose concatenation the local
    tensor holds, "flat": [lo, hi] or None}``. The maps are
    :func:`shard_layer`'s: the expert dimension over ep, the tensor
    dimension's fused runs over tp (:func:`tp_runs`), then FSDP2's row
    chunk of the tensor shard (``level`` "fsdp2"); ``view`` asks for the
    optimizer's view, a flat chunk of the local tensor under "os" /
    "os_g". ``axes`` are the mesh's sizes and ``coords`` the rank's
    coordinates (absent axes: 1 and 0)."""
    runs = [[(0, int(n))] for n in full_shape]
    spec = tuple(spec or ())

    def dim_of(axis):
        return next((d for d, e in enumerate(spec)
                     if e == axis or (isinstance(e, tuple) and axis in e)),
                    None)
    ep, tp = int(axes.get("ep", 1)), int(axes.get("tp", 1))
    ep_dim, tp_dim = dim_of("ep"), dim_of("tp")
    if ep_dim is not None and ep > 1:
        n = full_shape[ep_dim]
        if n % ep:
            raise ValueError(f"{n} experts do not split over ep={ep}")
        runs[ep_dim] = [(int(coords.get("ep", 0)) * (n // ep), n // ep)]
    if tp_dim is not None and tp > 1:
        runs[tp_dim] = tp_runs(full_shape[tp_dim], blocks, tp,
                               int(coords.get("tp", 0)))
    f, i = int(axes.get("fsdp", 1)), int(coords.get("fsdp", 0))
    if level == "fsdp2" and f > 1 and runs:
        lo, hi = flat_chunk(sum(n for _, n in runs[0]), f, i)
        runs[0] = sub_runs(runs[0], lo, hi)
    flat = None
    if view and level in ("os", "os_g") and f > 1:
        numel = int(np.prod([sum(n for _, n in r) for r in runs]))
        flat = list(flat_chunk(numel, f, i))
    return {"runs": [[list(x) for x in r] for r in runs], "flat": flat}


def plan_layout(plan: "MeshPlan", name: str, view: bool = False,
                coords: Optional[Dict[str, int]] = None) -> Dict:
    """:func:`shard_layout` of parameter ``name`` under ``plan`` at this
    rank's coordinates, or at ``coords``."""
    sh = plan.shards[name]
    hm = plan.mesh
    return shard_layout(sh.full_shape, sh.spec, sh.blocks, hm.shape,
                        hm._coord if coords is None else coords,
                        plan.level, view)


def _rep_ranges(size: int, blocks, tp: int) -> List[Tuple[int, int, int]]:
    """(start, end, replicas) of the local shard's columns held by more
    than one rank."""
    out, off = [], 0
    for units, width in _runs(size, blocks):
        if units >= tp:
            off += units // tp * width
        else:
            out.append((off, off + width, tp // units))
            off += width
    return out


def _local(t: torch.Tensor) -> torch.Tensor:
    return t._local_tensor if isinstance(t, DTensor) else t


class ParamShard:
    """One parameter's place on the mesh: its cleaned spec, the
    dimension split over ``tp`` (None: replicated there) and its fused
    runs, the local columns held by several ranks (each range with its
    rank group and whether this rank leads it), the full shape, the
    dimension split over ``ep`` (an expert weight's expert dimension;
    None for a dense parameter) and whether this rank counts it toward
    a norm at all (not the copy of a tied embedding on the last pipeline
    stage)."""

    def __init__(self, name, spec, blocks, full_shape, tp_dim, reps,
                 ep_dim=None, counted=True):
        self.name, self.spec, self.blocks = name, spec, blocks
        self.full_shape, self.tp_dim, self.reps = full_shape, tp_dim, reps
        self.ep_dim, self.counted = ep_dim, counted
        self._mask = None

    def owned_mask(self, shape, device) -> Optional[torch.Tensor]:
        """1.0 where this rank counts the element toward a norm, 0.0 on
        the replicated columns a lower rank of its group counts; None
        when it counts all of them. Broadcasts over the local shard."""
        if not self.reps or all(lead for *_, lead in self.reps):
            return None
        if self._mask is None:
            m = torch.ones(shape[self.tp_dim], device=device)
            for lo, hi, _, lead in self.reps:
                if not lead:
                    m[lo:hi] = 0.0
            view = [1] * len(shape)
            view[self.tp_dim] = -1
            self._mask = m.view(view)
        return self._mask


class MeshPlan:
    """What :func:`shard_layer` recorded about a model on a mesh (module
    docstring). ``level`` is how the ``fsdp`` axis holds the state:
    "none" (replicated; gradients summed over it as over dp), "fsdp2"
    (FSDP2 shards parameters, gradients and state), "os" (the optimizer
    state in flat chunks, gradients all-reduced) or "os_g" (gradients
    reduce-scattered into the chunks too)."""

    def __init__(self, mesh: HybridMesh, shards: Dict[str, ParamShard],
                 seq: bool):
        self.mesh = mesh
        self.shards = shards
        self.level = "none"
        self.seq = seq
        self.tp = comm.Group("tp", mesh)
        self.sep = comm.Group("sep", mesh)
        self.pp = comm.Group("pp", mesh)
        self.ep = comm.Group("ep", mesh)
        self.data = comm.Group(mesh.data_axes, mesh)
        self.tp_size, self.tp_rank = mesh.axis_size("tp"), \
            mesh.coordinate("tp")
        self.sep_size, self.sep_rank = mesh.axis_size("sep"), \
            mesh.coordinate("sep")
        self.pp_size, self.pp_rank = mesh.axis_size("pp"), \
            mesh.coordinate("pp")
        self.ep_size, self.ep_rank = mesh.axis_size("ep"), \
            mesh.coordinate("ep")
        self.data_size = mesh.group_size(mesh.data_axes)
        #: the first and last pipeline stages' group (a tied embedding's
        #: gradient is summed over it), None without a pp axis
        self.tied = mesh.stage_ends_group()
        self._grad_chunks: Dict[str, torch.Tensor] = {}
        # name -> the model's parameter (FSDP2 replaces them: refreshed)
        self.params: Dict[str, torch.Tensor] = {}
        # comm overlap (distributed.overlap "sharding_comm_overlap"):
        # whether the hooks start the gradient sums in this backward, the
        # division they apply first, the groups, the sums started (name
        # -> task), the parameters hooked, and the count of sums started
        # (for the tests)
        self._armed = False
        self._divide = 1
        self._groups = None
        self._pending: Dict[str, comm.Task] = {}
        self._hooked: set = set()
        self.sync_issues = 0

    # -- the batch -------------------------------------------------------------

    def local_batch(self, batch: Dict[str, torch.Tensor],
                    lead: int = 0) -> Dict[str, torch.Tensor]:
        """This rank's slice of a global batch: rows over dp, ep and
        fsdp (JAX's ``("dp", "fsdp")`` batch sharding), and with sequence
        parallelism the sequence over sep. ``lead`` leading dimensions
        (a microbatch axis) are kept whole."""
        hm = self.mesh
        nb, ib = hm.group_size(BATCH_AXES), hm.group_rank(BATCH_AXES)
        out = {}
        for k, v in batch.items():
            if nb > 1:
                if v.shape[lead] % nb:
                    raise ValueError(f"batch {k} of {v.shape[lead]} rows "
                                     f"does not split over {nb} data ranks")
                v = v.chunk(nb, dim=lead)[ib]
            if self.seq and v.dim() > lead + 1:
                if v.shape[lead + 1] % self.sep_size:
                    raise ValueError(f"sequence of {v.shape[lead + 1]} does "
                                     f"not split over sep={self.sep_size}")
                v = v.chunk(self.sep_size, dim=lead + 1)[self.sep_rank]
            out[k] = v
        return out

    # -- gradients -------------------------------------------------------------

    def _chunk(self, n: int) -> Tuple[int, int, int]:
        f = self.mesh.axis_size("fsdp")
        c = -(-n // f)
        lo = min(self.mesh.coordinate("fsdp") * c, n)
        return lo, min(lo + c, n), c

    def _sync_groups(self):
        """(dense, expert, fsdp): the groups a gradient is summed over."""
        hm = self.mesh
        rest = (("dp", "ep", "sep") if self.level in ("fsdp2", "os_g")
                else hm.data_axes)
        return (comm.Group(rest, hm),
                comm.Group(tuple(a for a in rest if a != "ep"), hm),
                comm.Group("fsdp", hm))

    def _sync_one(self, name: str, g: torch.Tensor, groups,
                  sync_op: bool = True):
        """Parameter ``name``'s sums of its local gradient ``g``
        (:meth:`sync_grads`); with ``sync_op=False`` the last one's
        :class:`~paddle_tpu_torch.distributed.communication.Task` (an os_g
        reduce-scatter behind a dense sum waits for that sum first: on
        the card a stream wait, not a host sync)."""
        dense, expert, fsdp = groups
        sh = self.shards.get(name)
        for lo, hi, grp, _ in (sh.reps if sh else ()):
            cols = g.narrow(sh.tp_dim, lo, hi - lo)
            if grp is not None:
                buf = cols.contiguous()
                comm.all_reduce(buf, group=grp)
                cols.copy_(buf)
        task = comm.all_reduce(g, group=expert if sh is not None
                               and sh.ep_dim is not None else dense,
                               sync_op=sync_op)
        if self.level != "os_g":
            return task
        if not sync_op:
            task.wait()
        n = g.numel()
        lo, hi, c = self._chunk(n)
        flat = torch.zeros(c * self.mesh.axis_size("fsdp"), dtype=g.dtype,
                           device=g.device)
        flat[:n] = g.reshape(-1)
        out = torch.empty(c, dtype=g.dtype, device=g.device)
        # this rank's chunk: read after the sum (sync_grads waits first)
        self._grad_chunks[name] = out[:hi - lo]
        return comm.reduce_scatter(out, flat, group=fsdp, sync_op=sync_op)

    # -- overlap --------------------------------------------------------------

    def arm_grad_sync(self, params: Dict[str, torch.Tensor],
                      divide: int = 1) -> bool:
        """Before the step's last backward: each gradient's sums start
        from a post-accumulate-grad hook as soon as it is final
        (``distributed.overlap``, "sharding_comm_overlap"), ``divide``
        (the microbatches) applied first as the step would;
        :meth:`sync_grads` then waits for them. Not for FSDP2 ("fsdp2",
        whose own hooks reduce-scatter and overlap), nor under
        ``overlap.serial_reference``. Returns whether armed."""
        from ..distributed.overlap import overlapped
        if not overlapped() or self.level == "fsdp2":
            return False
        for name, p in params.items():
            if name not in self._hooked:
                p.register_post_accumulate_grad_hook(
                    lambda p, name=name: self._on_grad(name, p))
                self._hooked.add(name)
        self._armed, self._divide, self._pending = True, int(divide), {}
        self._grad_chunks = {}
        self._groups = self._sync_groups()
        return True

    def sync_started(self, name: str) -> bool:
        """Whether parameter ``name``'s sums started in the backward."""
        return name in self._pending

    @torch.no_grad()
    def _on_grad(self, name: str, p: torch.Tensor) -> None:
        if not self._armed:
            return
        if name in self._pending:
            raise RuntimeError(
                f"{name}: its gradient was accumulated again after its sum "
                f"started (a parameter used in two backward passes of one "
                f"step is not supported on a mesh; take one backward a "
                f"microbatch)")
        g = _local(p.grad)
        if self._divide > 1:
            g.div_(self._divide)
        with torch.profiler.record_function("overlap::grad_sync"):
            self._pending[name] = self._sync_one(name, g, self._groups,
                                                 sync_op=False)
        self.sync_issues += 1

    @torch.no_grad()
    def sync_grads(self, params: Dict[str, torch.Tensor]) -> None:
        """Sum each local gradient over the ranks that hold the same
        values of its parameter: the replicated columns' tensor groups,
        then dp, ep and sep, and fsdp unless FSDP2 has reduce-scattered
        over it ("os_g": reduce-scatter into this rank's chunk). An
        expert weight is split over ep, so its gradient (the all-to-all's
        backward has brought it every ep rank's tokens) is summed over
        the other axes only. The sums the backward started
        (:meth:`arm_grad_sync`) are waited for here, in order."""
        pending, self._pending, self._armed = self._pending, {}, False
        if not pending:
            self._grad_chunks = {}
        groups = self._sync_groups()
        for name, p in params.items():
            if name in pending:
                pending[name].wait()
            elif p.grad is not None:
                self._sync_one(name, _local(p.grad), groups)

    def opt_views(self, params: Dict[str, torch.Tensor]):
        """(params, grads): the tensors the optimizer updates in place,
        name → local shard (FSDP2's local tensor) or, under "os" /
        "os_g", this rank's flat chunk of it."""
        pv, gv = {}, {}
        for name, p in params.items():
            t = _local(p)
            if self.level in ("os", "os_g"):
                lo, hi, _ = self._chunk(t.numel())
                pv[name] = t.view(-1)[lo:hi]
                if self.level == "os_g":
                    if name in self._grad_chunks:
                        gv[name] = self._grad_chunks[name]
                elif p.grad is not None:
                    gv[name] = _local(p.grad).reshape(-1)[lo:hi]
            else:
                pv[name] = t
                if p.grad is not None:
                    gv[name] = _local(p.grad)
        return pv, gv

    @torch.no_grad()
    def after_update(self, params: Dict[str, torch.Tensor]) -> None:
        """Under "os" / "os_g", all-gather the updated chunks over fsdp
        into every rank's whole parameter."""
        if self.level not in ("os", "os_g"):
            return
        fsdp = comm.Group("fsdp", self.mesh)
        f = self.mesh.axis_size("fsdp")
        for p in params.values():
            t = _local(p)
            n = t.numel()
            lo, hi, c = self._chunk(n)
            mine = torch.zeros(c, dtype=t.dtype, device=t.device)
            mine[:hi - lo] = t.view(-1)[lo:hi]
            parts = comm.all_gather(None, mine, group=fsdp)
            t.view(-1).copy_(torch.cat(parts)[:n] if f > 1 else mine[:n])

    def apply(self, optimizer, params: Dict[str, torch.Tensor],
              lr=None) -> None:
        """One optimizer update of the local shards from their synced
        gradients, then the chunks' all-gather."""
        pv, gv = self.opt_views(params)
        optimizer._mesh_plan = self
        optimizer.apply_gradients(pv, gv, lr=lr)
        self.after_update(params)

    # -- norms -----------------------------------------------------------------

    def _owned_sq(self, name: str, g: torch.Tensor) -> Optional[torch.Tensor]:
        """fp32 sum of squares of the elements of optimizer view ``g``
        that this rank counts (each element of the global tensor counted
        on one rank), or None when it counts none of them."""
        hm = self.mesh
        sh = self.shards.get(name)
        if sh is not None and not sh.counted:
            return None
        if (sh is None or sh.tp_dim is None) and hm.coordinate("tp") != 0:
            return None
        if (sh is None or sh.ep_dim is None) and hm.coordinate("ep") != 0:
            return None
        if self.level == "none" and hm.coordinate("fsdp") != 0:
            return None
        sq = torch.square(g.float())
        p = self.params.get(name)
        mask = (sh.owned_mask(tuple(_local(p).shape), g.device)
                if sh is not None and p is not None else None)
        if mask is not None:
            # the columns' mask over the local shard (FSDP2's row shard
            # included), flattened into the chunk under os / os_g
            full = mask.expand(tuple(_local(p).shape))
            if self.level in ("os", "os_g"):
                lo, hi, _ = self._chunk(full.numel())
                full = full.reshape(-1)[lo:hi]
            sq = sq * full
        return torch.sum(sq)

    def _norm_sum(self, local: torch.Tensor) -> torch.Tensor:
        comm.all_reduce(local, group=comm.Group(("pp", "ep", "fsdp", "tp"),
                                                self.mesh))
        return local

    def global_sq(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The fp32 sum of squares of the global gradients: each rank's
        owned elements summed in order, then over the pipeline stages,
        the expert shards, fsdp and tp."""
        parts = [s for s in (self._owned_sq(n, g) for n, g in grads.items())
                 if s is not None]
        local = (sum(parts) if parts else torch.zeros(
            (), dtype=torch.float32, device=next(iter(grads.values())).device))
        return self._norm_sum(local.clone())

    def tensor_sq(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """The fp32 sum of squares of one global gradient."""
        s = self._owned_sq(name, g)
        local = (s.clone() if s is not None else
                 torch.zeros((), dtype=torch.float32, device=g.device))
        return self._norm_sum(local)


def mesh_plan_of(model) -> Optional[MeshPlan]:
    """The :class:`MeshPlan` of a model (or of the model a meta-parallel
    wrapper holds), or None."""
    while model is not None:
        plan = getattr(model, "_mesh_plan", None)
        if plan is not None:
            return plan
        model = getattr(model, "_layers", None)
    return None


def shard_layer(layer: nn.Module, mesh=None, shard_fn=None, input_fn=None,
                output_fn=None) -> nn.Module:
    """Turn every annotated parameter of ``layer`` (each rank holding the
    same full weights) into this rank's tensor-parallel shard, in place
    (the Parameter objects stay, so an optimizer bound before keeps
    them), record a :class:`MeshPlan` on the layer and on each of its
    modules, and install ``input_fn(inputs, mesh)`` / ``output_fn(
    outputs, mesh)`` as forward pre/post hooks (JAX's contract).
    ``shard_fn(name, param, mesh)`` runs first for each parameter.
    The ``fsdp`` axis is not split here: ``group_sharded_parallel``
    hands it to FSDP2; without it a parameter stays whole over fsdp and
    its gradient is summed there as over dp. A ``sep`` axis over 1 asks
    for ``cfg.sequence_parallel``. A ``pp`` axis over 1 needs a pipeline
    model (one with ``_keep_stage``, e.g. ``LlamaForCausalLMPipe``):
    each rank keeps its stage's parameters. An ``ep`` axis splits the
    expert dimension of the parameters annotated with it (the MoE
    layers' experts): rank r of ep keeps experts [r e/ep, (r+1) e/ep).
    The layer carries its sharding table (``_sharding_annotations``) and
    declares ``_global_mean_loss``: its loss on a mesh is the global
    token mean, which the gradient sums over the data axes assume; any
    other layer raises."""
    if not (hasattr(layer, "_sharding_annotations")
            and getattr(layer, "_global_mean_loss", False)):
        raise NotImplementedError(
            f"shard_layer: {type(layer).__name__} lacks a sharding table "
            f"(`_sharding_annotations`) or a loss that takes the global "
            f"token mean over the mesh (`_global_mean_loss`), which the "
            f"gradient sums over the data axes assume")
    hm = _resolve_mesh(mesh)
    if mesh_plan_of(layer) is not None:
        raise RuntimeError("shard_layer: the layer is already sharded")
    cfg = getattr(layer, "cfg", None)
    if getattr(cfg, "weight_dtype", "native") != "native":
        raise ValueError("shard_layer: an int8 model serves only, and "
                         "serving or generating on a mesh with int8 weights "
                         "is ROADMAP.md A.10c; shard the float model")
    if hm.axis_size("pp") > 1:
        keep = getattr(layer, "_keep_stage", None)
        if keep is None:
            raise ValueError(
                f"shard_layer: a pp axis of {hm.axis_size('pp')} needs a "
                f"pipeline model (LlamaForCausalLMPipe); "
                f"{type(layer).__name__} is not one")
        keep(hm)
    seq = bool(getattr(cfg, "sequence_parallel", False))
    if hm.axis_size("sep") > 1 and not seq:
        raise ValueError("a sep axis > 1 shards the sequence: set "
                         "cfg.sequence_parallel=True (fleet.distributed_"
                         "model does)")
    ann = annotations(layer)
    tp, r = hm.axis_size("tp"), hm.coordinate("tp")
    ep, r_ep = hm.axis_size("ep"), hm.coordinate("ep")
    stage_of = getattr(layer, "param_stage", None)
    shards = {}
    with torch.no_grad():
        for name, p in layer.named_parameters():
            if shard_fn is not None:
                shard_fn(name, p, hm)
            spec_raw, blocks = ann.get(name, (None, None))
            spec = _clean_spec(spec_raw, hm)
            tp_dim = next((d for d, e in enumerate(spec)
                           if e == "tp" or (isinstance(e, tuple)
                                            and "tp" in e)), None)
            ep_dim = next((d for d, e in enumerate(spec)
                           if e == "ep" or (isinstance(e, tuple)
                                            and "ep" in e)), None)
            full_shape = tuple(p.shape)
            if ep_dim is not None:
                n = full_shape[ep_dim]
                if n % ep:
                    raise ValueError(f"{name}: {n} experts do not split "
                                     f"over ep={ep}")
                p.data = p.data.narrow(ep_dim, r_ep * (n // ep),
                                       n // ep).contiguous()
            reps = []
            if tp_dim is not None:
                p.data = tp_slice(p.data, tp_dim, blocks, tp, r)
                for lo, hi, n in _rep_ranges(full_shape[tp_dim], blocks, tp):
                    if tp_dim != len(full_shape) - 1:
                        raise NotImplementedError(
                            f"{name}: replicated heads on a row dimension")
                    grp = hm.subgroup("tp", n)
                    reps.append((lo, hi, grp, r % n == 0))
            counted = (stage_of is None or hm.axis_size("pp") == 1
                       or stage_of(name) == hm.coordinate("pp"))
            shards[name] = ParamShard(name, spec, blocks, full_shape, tp_dim,
                                      reps, ep_dim, counted)
    plan = MeshPlan(hm, shards, seq and hm.axis_size("sep") > 1)
    plan.params = dict(layer.named_parameters())
    for mod in layer.modules():
        mod._mesh_plan = plan
    if input_fn is not None:
        layer.register_forward_pre_hook(
            lambda lyr, inputs: input_fn(inputs, hm))
    if output_fn is not None:
        layer.register_forward_hook(
            lambda lyr, inputs, outputs: output_fn(outputs, hm))
    return layer


def _param_local(plan: MeshPlan, name: str, full: torch.Tensor):
    """``full`` (shaped as parameter ``name``) cut as the plan cuts the
    parameter: its tensor shard, then its FSDP2 rows or its os chunk."""
    sh = plan.shards[name]
    hm = plan.mesh
    if sh.ep_dim is not None:
        n = full.shape[sh.ep_dim] // hm.axis_size("ep")
        full = full.narrow(sh.ep_dim, hm.coordinate("ep") * n, n)
    t = (tp_slice(full, sh.tp_dim, sh.blocks, hm.axis_size("tp"),
                  hm.coordinate("tp")) if sh.tp_dim is not None else full)
    if plan.level == "fsdp2" and hm.axis_size("fsdp") > 1:
        parts = t.chunk(hm.axis_size("fsdp"))
        i = hm.coordinate("fsdp")
        t = parts[i] if i < len(parts) else t[:0]
    elif plan.level in ("os", "os_g"):
        lo, hi, _ = plan._chunk(t.numel())
        t = t.reshape(-1)[lo:hi]
    return t.contiguous()


def shard_optimizer_state(state: Dict, layer, mesh=None) -> Dict:
    """A full optimizer state (``{"step", "master", "slots"}``, each
    tensor shaped as its parameter, e.g. from
    ``convert.opt_state_from_jax``) cut into this rank's shards as the
    layer's plan (``layer``: the sharded model or its :class:`MeshPlan`)
    cuts the parameters. Counterpart of JAX's ``shard_optimizer_state``,
    which places the slots like their parameters."""
    plan = layer if isinstance(layer, MeshPlan) else mesh_plan_of(layer)
    if plan is None:
        raise RuntimeError("shard_optimizer_state: shard_layer the model "
                           "first")
    out = dict(state)
    out["master"] = {k: _param_local(plan, k, v)
                     for k, v in state.get("master", {}).items()}
    out["slots"] = {k: {sk: _param_local(plan, k, sv)
                        for sk, sv in slots.items()}
                    for k, slots in state.get("slots", {}).items()}
    return out


@torch.no_grad()
def full_state_dict(layer: nn.Module,
                    grads: bool = False) -> Dict[str, torch.Tensor]:
    """Every parameter (or, with ``grads``, every parameter's gradient)
    whole, in the JAX layout, on every rank: FSDP2's shards gathered over
    fsdp, then the tensor shards over tp (fused projections put back
    part by part), the expert shards over ep, and on a pp mesh each
    stage's parameters broadcast from it (in the order of the model's
    sharding table). Collective over the mesh."""
    plan = mesh_plan_of(layer)
    out = {}
    for name, p in layer.named_parameters():
        if grads:
            p = p.grad
        t = p.full_tensor() if isinstance(p, DTensor) else p.detach()
        sh = plan.shards.get(name) if plan is not None else None
        if sh is not None and sh.tp_dim is not None:
            parts = comm.all_gather(None, t.contiguous(), group=plan.tp)
            t = tp_unslice(parts, sh.tp_dim, sh.blocks,
                           sh.full_shape[sh.tp_dim])
        if sh is not None and sh.ep_dim is not None:
            t = torch.cat(comm.all_gather(None, t.contiguous(),
                                          group=plan.ep), dim=sh.ep_dim)
        out[name] = t.clone()
    if plan is None or plan.pp_size == 1:
        return out
    # the other stages' parameters: each from the stage that counts it
    dev = next(iter(out.values())).device
    ranks = plan.mesh.group_ranks("pp")
    full = {}
    for name, (shape, dtype) in layer.full_shapes().items():
        src = layer.param_stage(name)
        t = (out[name].contiguous() if src == plan.pp_rank
             else torch.empty(shape, dtype=dtype, device=dev))
        dist.broadcast(t, src=ranks[src], group=plan.pp.process_group)
        full[name] = t
    return full


__all__ = ["Placement", "Replicate", "Shard", "Partial", "shard_tensor",
           "reshard", "param_spec_tree", "annotations", "shard_layer",
           "shard_optimizer_state", "full_state_dict", "mesh_plan_of",
           "MeshPlan", "ParamShard", "tp_slice", "tp_unslice", "tp_runs",
           "sub_runs", "flat_chunk", "shard_layout", "plan_layout"]
