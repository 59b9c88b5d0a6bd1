"""Collective communication over ``torch.distributed`` (counterpart of
``paddle_tpu/distributed/communication.py``).

Per-rank semantics, as Paddle's API has them: each process passes its
own tensor and gets its own result. The JAX package's eager collectives
work instead on a rank-major global array (slice ``r`` is rank ``r``'s
tensor); rank ``r``'s result here is slice ``r`` of JAX's result.

A :class:`Group` names axes of the :class:`~paddle_tpu_torch.parallel.
mesh.HybridMesh` (its members are the ranks that differ from this one
only along them); ``None`` is every rank. Ranks given to ``broadcast``,
``reduce``, ``scatter``, ``gather``, ``send_to`` and the pairs of
:func:`ppermute` are indices WITHIN the group, as JAX's axis indices
are. A group of one rank makes every collective the identity, and none
is called.

The differentiable forms that the tensor- and sequence-parallel layers,
the ring and Ulysses share are ``torch.autograd.Function``s with their
stated transposes: :func:`copy_to_group` (copy forward, all-reduce
backward), :func:`reduce_from_group` (all-reduce forward, copy
backward), :func:`gather_from_group` (all-gather forward, reduce-scatter
backward), :func:`scatter_to_group` (own chunk forward, all-gather
backward), :func:`reduce_scatter_to_group` (reduce-scatter forward,
all-gather backward), :func:`all_to_all` (all-to-all forward, the
inverse all-to-all backward) and :func:`ring_shift` (send to the next
rank forward, to the previous one backward).

Gloo has no reduce-scatter and no AVG: there they are an all-reduce
then a slice, and a sum then a division.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ..analysis.collectives import async_issued, async_waited
from ..parallel.mesh import HybridMesh, current_mesh


class ReduceOp:
    """SUM / MAX / MIN / PROD / AVG (``paddle.distributed.ReduceOp``)."""
    SUM = "sum"
    MAX = "max"
    MIN = "min"
    PROD = "prod"
    AVG = "avg"


_TORCH_OP = {ReduceOp.SUM: dist.ReduceOp.SUM, ReduceOp.MAX: dist.ReduceOp.MAX,
             ReduceOp.MIN: dist.ReduceOp.MIN,
             ReduceOp.PROD: dist.ReduceOp.PRODUCT}


class Group:
    """The ranks of one or more mesh axes at this rank's coordinate (the
    world when the mesh is absent). ``process_group`` is None for a group
    of one rank."""

    def __init__(self, axes: Union[str, Sequence[str], None] = None,
                 mesh: Optional[HybridMesh] = None):
        self._mesh = mesh
        self.axes: Optional[Tuple[str, ...]] = (
            None if axes is None else
            (axes,) if isinstance(axes, str) else tuple(axes))

    @property
    def mesh(self) -> Optional[HybridMesh]:
        return self._mesh if self._mesh is not None else current_mesh()

    def _resolved(self):
        hm = self.mesh
        if hm is None:
            if self.axes is not None:
                raise RuntimeError(f"group over {self.axes} needs an active "
                                   f"mesh (fleet.init or `with mesh:`)")
            n = dist.get_world_size()
            return (dist.group.WORLD if n > 1 else None, list(range(n)),
                    dist.get_rank())
        axes = self.axes if self.axes is not None else hm.axes
        return hm.group(axes), hm.group_ranks(axes), hm.group_rank(axes)

    @property
    def process_group(self):
        return self._resolved()[0]

    @property
    def ranks(self) -> List[int]:
        """The members' world ranks, in group order."""
        return self._resolved()[1]

    @property
    def rank(self) -> int:
        """This process's index in the group."""
        return self._resolved()[2]

    @property
    def nranks(self) -> int:
        return len(self.ranks)

    world_size = nranks

    def __repr__(self):
        return f"Group(axes={self.axes}, nranks={self.nranks})"


def _resolve_group(group) -> Group:
    if isinstance(group, Group):
        return group
    return Group(group)


def _pg(group):
    """(process group or None, group size, my index, world ranks) of a
    Group, mesh axes, None, or a torch ProcessGroup."""
    if isinstance(group, dist.ProcessGroup):
        ranks = dist.get_process_group_ranks(group)
        return group, len(ranks), dist.get_rank(group), ranks
    pg, ranks, me = _resolve_group(group)._resolved()
    return pg, len(ranks), me, ranks


def new_group(axes=None, ranks=None, backend=None) -> Group:
    """A Group over mesh axes. ``ranks`` (Paddle's rank-list signature)
    is refused, as in JAX: an arbitrary rank set is not a mesh slice."""
    if ranks is not None:
        raise NotImplementedError(
            "rank-list groups are not mesh slices; name mesh axes instead "
            "(e.g. new_group('tp') or new_group(('dp', 'fsdp')))")
    return _resolve_group(axes)


def get_rank(group=None) -> int:
    """This process's rank: in the world, or its index in ``group``."""
    if group is None:
        return dist.get_rank() if dist.is_initialized() else 0
    return _resolve_group(group).rank


def get_world_size(group=None) -> int:
    if group is None:
        return dist.get_world_size() if dist.is_initialized() else 1
    return _resolve_group(group).nranks


def barrier(group=None) -> None:
    pg, n, _, _ = _pg(group)
    if n > 1:
        dist.barrier(group=pg)


def _is_gloo(pg) -> bool:
    return dist.get_backend(pg) == "gloo"


# -- per-rank collectives -----------------------------------------------------

class Task:
    """The handle of a collective started with ``sync_op=False``
    (Paddle's task): :meth:`wait` waits for it (on the card the current
    stream waits for NCCL's; the host does not) and completes its result
    in place."""

    def __init__(self, work=None, finish=None):
        self._work, self._finish = work, finish
        # the step census pairs the collective just issued with its wait
        self._census = async_issued() if work is not None else None

    def wait(self) -> bool:
        if self._work is not None:
            self._work.wait()
            self._work = None
            async_waited(self._census)
        if self._finish is not None:
            self._finish()
            self._finish = None
        return True

    def is_completed(self) -> bool:
        return self._work is None and self._finish is None


def all_reduce(tensor: torch.Tensor, op: str = ReduceOp.SUM, group=None,
               sync_op: bool = True):
    """Reduce ``tensor`` over the group IN PLACE (SUM, MAX, MIN, PROD or
    AVG) and return it; with ``sync_op=False`` start it and return its
    :class:`Task`."""
    pg, n, _, _ = _pg(group)
    if op not in _TORCH_OP and op != ReduceOp.AVG:
        raise NotImplementedError(f"all_reduce op {op!r}")
    if n == 1:
        return tensor if sync_op else Task()
    finish = (lambda: tensor.div_(n)) if op == ReduceOp.AVG else None
    work = dist.all_reduce(tensor, _TORCH_OP.get(op, dist.ReduceOp.SUM),
                           group=pg, async_op=not sync_op)
    if not sync_op:
        return Task(work, finish)
    if finish is not None:
        finish()
    return tensor


def all_gather(tensor_list: Optional[List[torch.Tensor]],
               tensor: torch.Tensor, group=None,
               sync_op: bool = True) -> List[torch.Tensor]:
    """Every rank's ``tensor``, in group order, into ``tensor_list``
    (filled in place when given) and returned."""
    pg, n, _, _ = _pg(group)
    out = [torch.empty_like(tensor) for _ in range(n)]
    if n == 1:
        out[0].copy_(tensor)
    else:
        dist.all_gather(out, tensor.contiguous(), group=pg)
    if tensor_list is None:
        return out
    tensor_list.clear()
    tensor_list.extend(out)
    return tensor_list


def _chunks(x: Union[torch.Tensor, Sequence[torch.Tensor]], n: int):
    if isinstance(x, torch.Tensor):
        if x.shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(x.shape)} does not split "
                             f"into {n}")
        return list(x.chunk(n))
    if len(x) != n:
        raise ValueError(f"{len(x)} tensors for a group of {n}")
    return list(x)


def reduce_scatter(tensor: Optional[torch.Tensor], tensor_list,
                   op: str = ReduceOp.SUM, group=None,
                   sync_op: bool = True):
    """``tensor_list`` (n tensors, or one tensor split along dim 0) is
    summed elementwise over the group; rank ``i`` receives chunk ``i``,
    into ``tensor`` when given, and it is returned; with
    ``sync_op=False`` the :class:`Task` is (``tensor`` holds the chunk
    after its ``wait()``)."""
    if op != ReduceOp.SUM:
        raise NotImplementedError("reduce_scatter supports SUM")
    pg, n, me, _ = _pg(group)
    parts = _chunks(tensor_list, n)
    out = tensor if tensor is not None else torch.empty_like(parts[me])
    work = finish = None
    if n == 1:
        out.copy_(parts[0])
    elif _is_gloo(pg):
        full = torch.cat([p.reshape(-1) for p in parts])
        work = dist.all_reduce(full, group=pg, async_op=not sync_op)
        size = parts[me].numel()
        off = sum(p.numel() for p in parts[:me])

        def finish():
            out.copy_(full[off:off + size].view(parts[me].shape))
    else:
        work = dist.reduce_scatter(out, [p.contiguous() for p in parts],
                                   group=pg, async_op=not sync_op)
    if not sync_op:
        return Task(work, finish)
    if finish is not None:
        finish()
    return out


def alltoall(in_tensor_list, out_tensor_list: Optional[List] = None,
             group=None, sync_op: bool = True) -> List[torch.Tensor]:
    """Piece ``j`` of this rank's input (n tensors of one shape, or one
    tensor split along dim 0) goes to rank ``j``; returns (and fills
    ``out_tensor_list`` with) the pieces received, piece ``j`` from rank
    ``j``. JAX's rank-major form is the transpose of the pieces."""
    pg, n, _, _ = _pg(group)
    parts = _chunks(in_tensor_list, n)
    src = torch.stack([p.contiguous() for p in parts])
    dst = torch.empty_like(src)
    if n == 1:
        dst.copy_(src)
    else:
        dist.all_to_all_single(dst, src, group=pg)
    out = list(dst.unbind(0))
    if out_tensor_list is None:
        return out
    out_tensor_list.clear()
    out_tensor_list.extend(out)
    return out_tensor_list


def broadcast(tensor: torch.Tensor, src: int = 0, group=None,
              sync_op: bool = True) -> torch.Tensor:
    """Group rank ``src``'s tensor into every rank's ``tensor`` (in
    place)."""
    pg, n, _, ranks = _pg(group)
    if n > 1:
        dist.broadcast(tensor, src=ranks[src], group=pg)
    return tensor


def reduce(tensor: torch.Tensor, dst: int = 0, op: str = ReduceOp.SUM,
           group=None, sync_op: bool = True) -> torch.Tensor:
    """Rank ``dst`` receives the reduction (in place); the other ranks
    keep their input, as JAX's eager reduce leaves it."""
    pg, n, me, _ = _pg(group)
    if n == 1:
        return tensor
    total = tensor.clone()
    all_reduce(total, op, group)
    if me == dst:
        tensor.copy_(total)
    return tensor


def scatter(tensor: torch.Tensor, tensor_list=None, src: int = 0,
            group=None, sync_op: bool = True) -> torch.Tensor:
    """Group rank ``src``'s ``tensor_list`` (n tensors, or one tensor
    split along dim 0): piece ``i`` into rank ``i``'s ``tensor``. The
    other ranks' lists are not read."""
    pg, n, me, ranks = _pg(group)
    if n == 1:
        return tensor.copy_(_chunks(tensor_list, 1)[0].reshape(tensor.shape))
    parts = ([p.reshape(tensor.shape).contiguous()
              for p in _chunks(tensor_list, n)] if me == src else None)
    dist.scatter(tensor, parts, src=ranks[src], group=pg)
    return tensor


def gather(tensor: torch.Tensor, gather_list: Optional[List] = None,
           dst: int = 0, group=None,
           sync_op: bool = True) -> Optional[List[torch.Tensor]]:
    """Rank ``dst`` receives every rank's tensor in group order (into
    ``gather_list`` when given, returned); the others get None. JAX's
    eager gather materialises the result on every rank: rank ``dst``'s
    list here is its result."""
    pg, n, me, ranks = _pg(group)
    if n == 1:
        out = [tensor.clone()]
    else:
        out = ([torch.empty_like(tensor) for _ in range(n)]
               if me == dst else None)
        dist.gather(tensor.contiguous(), out, dst=ranks[dst], group=pg)
    if me != dst:
        return None
    if gather_list is None:
        return out
    gather_list.clear()
    gather_list.extend(out)
    return gather_list


P2POp = dist.P2POp


def isend(tensor: torch.Tensor, dst: int, group=None):
    """Send to group rank ``dst``; returns the work handle."""
    pg, _, _, ranks = _pg(group)
    return dist.isend(tensor, ranks[dst], group=pg)


def irecv(tensor: torch.Tensor, src: int, group=None):
    """Receive from group rank ``src`` into ``tensor``."""
    pg, _, _, ranks = _pg(group)
    return dist.irecv(tensor, ranks[src], group=pg)


def batch_isend_irecv(p2p_op_list: Sequence[dist.P2POp]):
    """Issue the ``P2POp``s (``dist.isend`` / ``dist.irecv`` with WORLD
    peers) as one batch; returns the work handles to ``wait()`` on."""
    return dist.batch_isend_irecv(list(p2p_op_list))


def ppermute(tensor: torch.Tensor, pairs: Sequence[Tuple[int, int]],
             group=None) -> torch.Tensor:
    """JAX's ``ppermute`` / eager ``batch_isend_irecv``: for each (src,
    dst) pair of group ranks, dst receives src's tensor; a rank that is
    no destination gets zeros. One batch of sends and receives."""
    pg, n, me, ranks = _pg(group)
    out = torch.zeros_like(tensor)
    if n == 1:
        for s, d in pairs:
            if s == d == 0:
                out.copy_(tensor)
        return out
    send = tensor.contiguous()
    ops = [dist.P2POp(dist.isend, send, ranks[d], pg)
           for s, d in pairs if s == me and d != me]
    ops += [dist.P2POp(dist.irecv, out, ranks[s], pg)
            for s, d in pairs if d == me and s != me]
    if any(s == d == me for s, d in pairs):
        out.copy_(tensor)
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    return out


def send_recv(tensor: torch.Tensor, shift: int = 1,
              group=None) -> torch.Tensor:
    """Ring exchange: every rank sends to rank + ``shift`` (mod n) and
    returns what rank - ``shift`` sent."""
    n = _pg(group)[1]
    return ppermute(tensor, [(i, (i + shift) % n) for i in range(n)], group)


def send_to(tensor: torch.Tensor, dst: int, src: int,
            group=None) -> torch.Tensor:
    """Group rank ``src``'s tensor moves to rank ``dst``, in place there;
    every other rank keeps its own (JAX's ``send_to``)."""
    pg, n, me, ranks = _pg(group)
    if n == 1 or src == dst:
        return tensor
    if me == src:
        dist.send(tensor.contiguous(), ranks[dst], group=pg)
    elif me == dst:
        dist.recv(tensor, ranks[src], group=pg)
    return tensor


class stream:
    """``paddle.distributed.stream.*``: the same collectives (torch
    schedules them on its communication streams)."""
    all_reduce = staticmethod(all_reduce)
    all_gather = staticmethod(all_gather)
    reduce_scatter = staticmethod(reduce_scatter)
    alltoall = staticmethod(alltoall)
    broadcast = staticmethod(broadcast)
    reduce = staticmethod(reduce)
    scatter = staticmethod(scatter)
    gather = staticmethod(gather)
    send_to = staticmethod(send_to)


# -- differentiable forms -------------------------------------------------------

def _sum(x: torch.Tensor, pg) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=pg)
    return y


def _gather_cat(x: torch.Tensor, pg, n: int, dim: int) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=pg)
    return torch.cat(parts, dim=dim)


def _reduce_chunk(x: torch.Tensor, pg, n: int, me: int,
                  dim: int) -> torch.Tensor:
    parts = [p.contiguous() for p in x.chunk(n, dim=dim)]
    if _is_gloo(pg):
        return _sum(x, pg).chunk(n, dim=dim)[me].contiguous()
    out = torch.empty_like(parts[me])
    dist.reduce_scatter(out, parts, group=pg)
    return out


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.pg), None


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        return _sum(x, pg)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, me, dim):
        ctx.args = (pg, n, me, dim)
        return _gather_cat(x, pg, n, dim)

    @staticmethod
    def backward(ctx, g):
        pg, n, me, dim = ctx.args
        return _reduce_chunk(g, pg, n, me, dim), None, None, None, None


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, me, dim):
        ctx.args = (pg, n, me, dim)
        return x.chunk(n, dim=dim)[me].contiguous()

    @staticmethod
    def backward(ctx, g):
        pg, n, me, dim = ctx.args
        return _gather_cat(g, pg, n, dim), None, None, None, None


class _ReduceScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, me, dim):
        ctx.args = (pg, n, me, dim)
        return _reduce_chunk(x, pg, n, me, dim)

    @staticmethod
    def backward(ctx, g):
        pg, n, me, dim = ctx.args
        return _gather_cat(g, pg, n, dim), None, None, None, None


def _a2a(x: torch.Tensor, pg, n: int, split_dim: int,
         concat_dim: int) -> torch.Tensor:
    """Split ``x`` into n pieces along ``split_dim``, piece j to rank j;
    the pieces received (from ranks 0..n-1) concatenated along
    ``concat_dim``."""
    src = torch.stack([p.contiguous() for p in x.chunk(n, dim=split_dim)])
    dst = torch.empty_like(src)
    dist.all_to_all_single(dst, src, group=pg)
    return torch.cat(dst.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, n, split_dim, concat_dim):
        ctx.args = (pg, n, split_dim, concat_dim)
        return _a2a(x, pg, n, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        pg, n, split_dim, concat_dim = ctx.args
        return _a2a(g, pg, n, concat_dim, split_dim), None, None, None, None


def _shift(x: torch.Tensor, pg, ranks: List[int], me: int,
           shift: int) -> torch.Tensor:
    n = len(ranks)
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    ops = [dist.P2POp(dist.isend, x.contiguous(), ranks[(me + shift) % n],
                      pg),
           dist.P2POp(dist.irecv, out, ranks[(me - shift) % n], pg)]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg, ranks, me, shift):
        ctx.args = (pg, ranks, me, shift)
        return _shift(x, pg, ranks, me, shift)

    @staticmethod
    def backward(ctx, g):
        pg, ranks, me, shift = ctx.args
        return _shift(g, pg, ranks, me, -shift), None, None, None, None


def copy_to_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity forward; the gradient is all-reduced over the group
    (Megatron's f, where a tensor-parallel region begins)."""
    pg, n, _, _ = _pg(group)
    return x if n == 1 else _CopyToGroup.apply(x, pg)


def reduce_from_group(x: torch.Tensor, group=None) -> torch.Tensor:
    """All-reduce (sum) forward; the gradient passes unchanged
    (Megatron's g, where a tensor-parallel region ends)."""
    pg, n, _, _ = _pg(group)
    return x if n == 1 else _ReduceFromGroup.apply(x, pg)


def gather_from_group(x: torch.Tensor, group=None,
                      dim: int = -1) -> torch.Tensor:
    """All-gather along ``dim`` forward, reduce-scatter backward."""
    pg, n, me, _ = _pg(group)
    return x if n == 1 else _GatherFromGroup.apply(x, pg, n, me,
                                                   dim % x.dim())


def scatter_to_group(x: torch.Tensor, group=None,
                     dim: int = -1) -> torch.Tensor:
    """This rank's chunk along ``dim`` forward, all-gather backward."""
    pg, n, me, _ = _pg(group)
    return x if n == 1 else _ScatterToGroup.apply(x, pg, n, me,
                                                  dim % x.dim())


def reduce_scatter_to_group(x: torch.Tensor, group=None,
                            dim: int = 0) -> torch.Tensor:
    """Sum over the group and keep this rank's chunk along ``dim``
    forward, all-gather backward."""
    pg, n, me, _ = _pg(group)
    return x if n == 1 else _ReduceScatterToGroup.apply(x, pg, n, me,
                                                        dim % x.dim())


def all_to_all(x: torch.Tensor, group=None, split_dim: int = 2,
               concat_dim: int = 1) -> torch.Tensor:
    """Piece j of ``x`` along ``split_dim`` goes to rank j; the pieces
    received join along ``concat_dim``. The backward is the inverse
    all-to-all."""
    pg, n, _, _ = _pg(group)
    if n == 1:
        return x
    return _AllToAll.apply(x, pg, n, split_dim % x.dim(),
                           concat_dim % x.dim())


def ring_shift(x: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """Send ``x`` to rank + ``shift`` and return what rank - ``shift``
    sent; the gradient travels the other way."""
    pg, n, me, ranks = _pg(group)
    return x if n == 1 else _RingShift.apply(x, pg, ranks, me, shift)


def all_reduce_max_(x: torch.Tensor, group=None) -> torch.Tensor:
    """In-place MAX all-reduce outside autograd (a stability shift that
    is not differentiated, as JAX's stop_gradient of pmax)."""
    pg, n, _, _ = _pg(group)
    if n > 1:
        dist.all_reduce(x, dist.ReduceOp.MAX, group=pg)
    return x


__all__ = ["ReduceOp", "Group", "Task", "new_group", "get_rank",
           "get_world_size", "barrier", "all_reduce", "all_gather",
           "reduce_scatter", "alltoall", "broadcast", "reduce", "scatter",
           "gather", "P2POp",
           "isend", "irecv", "batch_isend_irecv", "ppermute", "send_recv",
           "send_to", "stream", "copy_to_group", "reduce_from_group",
           "gather_from_group", "scatter_to_group",
           "reduce_scatter_to_group", "all_to_all", "ring_shift",
           "all_reduce_max_"]
