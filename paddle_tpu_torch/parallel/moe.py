"""Mixture-of-Experts layer (counterpart of ``paddle_tpu/parallel/moe.py``).

Sort-based top-k routing as in the JAX package: token assignments are
sorted by expert id, each assignment's slot is its rank within its
expert's run, and dispatch and combine are gathers.

- Capacity routing (``capacity_factor`` a number): the dense
  ``[experts, capacity, d]`` layout, the experts as two batched products
  (:class:`MoEMLP`), assignments past an expert's capacity dropped
  (priority choice-major, token-ascending).
- Dropless routing (``capacity_factor=None``): the sorted assignments
  feed the grouped matmul (``ops.grouped_matmul``, the CUDA kernel on the
  card) over the exact per-expert counts; nothing is dropped.

Gates are renormalised over the top-k whenever k > 1, in both paths, as
the JAX package does.

On a data mesh without ep (dp x fsdp over more than one rank) the
capacity path routes the global batch as JAX's GSPMD step does: the
capacity counts every rank's tokens and each entry keeps its global
priority (:func:`_capacity_routing`, one all-gather of [k, e]
counts).

On the card nothing on the dropless path makes the host wait for the
device: counts are ``scatter_add_`` into fixed-size tensors
(``bincount`` sizes its output on the host), and gathers and the unsort
are ``index_select``/``index_copy``.

Expert parallelism (an ``ep`` mesh axis; JAX's shard_map'd paths). Rank
r of ep holds experts [r e/ep, (r+1) e/ep) (``parallel.api.shard_layer``
cuts them) and routes its own tokens; an exchange carries each token
row to the rank of its expert and the results back:

- dropless (:meth:`MoELayer._forward_dropless_ep`): JAX scatters into a
  static ``[e, t_local, d]`` buffer because its jax has no ragged
  all-to-all; the port sends EXACT splits. The per-expert counts go
  first (an all-to-all of [e] vectors), the host reads the split sizes
  once a layer (:data:`EP_HOST_READS` counts these reads: the one sync
  of the path), the rows go by ``all_to_all_single`` with those splits,
  each rank runs the grouped matmul over the exact counts of its local
  experts, and the reverse exchange and the unsort restore token order;
- capacity (:meth:`MoELayer._forward_capacity_ep`): each rank routes
  its local tokens into the full ``[e, c_local, d]`` slot layout with
  c_local = ceil(t_local k / e cf) (JAX :398: not the unsharded
  capacity), equal splits carry each expert block to its rank, the
  local experts run one batched SwiGLU over [e/ep, ep c_local, d], and
  the reverse exchange feeds the local combine.

The exchange is handed to the layer: on a mesh :class:`MeshExchange`
(NCCL or gloo all-to-all over the ep group, differentiable), for
virtual ranks in one process :class:`VirtualExchange` (a permutation of
tensors, :meth:`MoELayer.forward_virtual_ep`). The aux loss takes the
two token means over every data rank before their product (JAX's
``_aux_loss_ep`` pmeans them), so it is the global estimator. On a
tensor-parallel mesh the experts' FFN width is split over tp: the
expert input is copied into the group and the output summed.

:func:`publish_moe_metrics` publishes a logged step's routing health
(:func:`routing_stats`) through the metrics registry under the JAX
package's ``pt_moe_*`` names.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

import torch.distributed as dist

from ..device import dtype_of, resolve_device
from ..nn.initializer import Normal
from ..ops.grouped_matmul import grouped_matmul_act

#: host reads of the exchange split sizes on the dropless ep path (one a
#: layer forward); the card tests and chip_smoke read it
EP_HOST_READS = [0]


def _counts(ids: torch.Tensor, e: int) -> torch.Tensor:
    """int64 [e]: how often each expert id in ``ids`` occurs."""
    flat = ids.reshape(-1)
    return torch.zeros(e, dtype=torch.int64, device=ids.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def _aux_loss(probs: torch.Tensor, e: int) -> torch.Tensor:
    """GShard eq. 4 load-balance loss: e * sum_e(mean_t(gate) *
    mean_t(top-1 fraction))."""
    top1 = torch.argmax(probs, dim=-1)
    me = probs.mean(dim=0)
    ce = _counts(top1, e).float() / probs.shape[0]
    return (me * ce).sum() * e


def _aux_of(probs: torch.Tensor, e: int, plan=None) -> torch.Tensor:
    """The aux loss of one rank's tokens: GShard's (:func:`_aux_loss`)
    alone, on a data mesh with both token means taken over every data
    rank before the product (the value is global on every rank, the
    gradient each rank's share)."""
    if plan is None or plan.data_size == 1:
        return _aux_loss(probs, e)
    from ..distributed.communication import all_reduce, reduce_from_group
    n = plan.data_size
    me = reduce_from_group(probs.mean(dim=0) / n, plan.data)
    ce = all_reduce(_counts(torch.argmax(probs, dim=-1), e).float()
                    / (probs.shape[0] * n), group=plan.data)
    return (me * ce).sum() * e


def _aux_lanes(probs: list, e: int) -> torch.Tensor:
    """The aux loss over virtual ranks of equal token counts: the means
    of their token means, then the product."""
    me = sum(p.mean(dim=0) for p in probs) / len(probs)
    ce = sum(_counts(torch.argmax(p, dim=-1), e).float() / p.shape[0]
             for p in probs) / len(probs)
    return (me * ce).sum() * e


class VirtualExchange:
    """The ep exchange between ``ep`` virtual ranks held in one process:
    every lane's tensors are at hand, so an all-to-all is a permutation
    of them (autograd sees cats and splits)."""

    def __init__(self, ep: int):
        self.ep = ep

    def counts(self, counts):
        """[e] per lane -> [ep, e/ep] per lane: row j holds lane j's
        counts of this lane's experts."""
        el = counts[0].shape[0] // self.ep
        return [torch.stack([c[r * el:(r + 1) * el] for c in counts])
                for r in range(self.ep)]

    def rows(self, xs, send, recv):
        """Lane r's rows split by ``send[r]`` (one block a destination);
        returns each lane's received blocks concatenated in source
        order."""
        parts = [x.split(s) for x, s in zip(xs, send)]
        return [torch.cat([parts[j][r] for j in range(self.ep)])
                for r in range(self.ep)]


class _AllToAllV(torch.autograd.Function):
    """all_to_all_single with split sizes; the backward runs the reverse
    exchange."""

    @staticmethod
    def forward(ctx, x, send, recv, pg):
        ctx.args = (send, recv, pg)
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        dist.all_to_all_single(out, x.contiguous(), recv, send, group=pg)
        return out

    @staticmethod
    def backward(ctx, g):
        send, recv, pg = ctx.args
        gx = g.new_empty((sum(send),) + tuple(g.shape[1:]))
        dist.all_to_all_single(gx, g.contiguous(), send, recv, group=pg)
        return gx, None, None, None


class MeshExchange:
    """The ep exchange of this rank over the mesh's ep group (one lane:
    this rank's)."""

    def __init__(self, plan):
        self.ep = plan.ep_size
        self.pg = plan.ep.process_group

    def counts(self, counts):
        c = counts[0].contiguous()
        out = torch.empty_like(c)
        dist.all_to_all_single(out, c, group=self.pg)
        return [out.reshape(self.ep, -1)]

    def rows(self, xs, send, recv):
        return [_AllToAllV.apply(xs[0], send[0], recv[0], self.pg)]


def _tp_group(plan):
    return plan.tp if plan is not None and plan.tp_size > 1 else None


def routing_stats(gate_logits: torch.Tensor, k: int):
    """(aux_loss, router_z, per-expert token counts int32) for one routing
    batch; router_z is the ST-MoE z-loss ``mean(logsumexp(logits)^2)``."""
    e = gate_logits.shape[1]
    logits = gate_logits.float()
    probs = torch.softmax(logits, dim=-1)
    _, ids = torch.topk(probs, k, dim=-1)
    counts = _counts(ids, e).to(torch.int32)
    z = (torch.logsumexp(logits, dim=-1) ** 2).mean()
    return _aux_loss(probs, e), z, counts


def _host(v):
    """A 0-d or 1-d tensor or array-like as a float numpy array (one
    host read for a tensor on the card)."""
    import numpy as np
    if isinstance(v, torch.Tensor):
        v = v.detach().float().cpu().numpy()
    return np.asarray(v, dtype=float)


def publish_moe_metrics(aux_loss=None, router_z=None, expert_counts=None):
    """Publish MoE routing health through the metrics registry (the JAX
    package's vocabulary): ``pt_moe_*`` counters for routed token
    assignments per expert plus gauges for the aux loss, router z-loss
    and the load-balance factor (``e × max expert share``; 1.0 =
    balanced — the statistic the planner's ep pricing uses,
    ``planner.ep_imbalance``).

    Host-side: each given value is read to the host (a wait for the
    card), so call it at a log step with that step's
    :func:`routing_stats`, never inside the step. Nothing happens while
    the registry is off."""
    from ..observability.metrics import REGISTRY
    if not REGISTRY.enabled:
        return
    if aux_loss is not None:
        REGISTRY.gauge("pt_moe_aux_loss",
                       "GShard load-balance aux loss").set(
            float(_host(aux_loss)))
    if router_z is not None:
        REGISTRY.gauge("pt_moe_router_z",
                       "router z-loss mean(logsumexp^2)").set(
            float(_host(router_z)))
    if expert_counts is not None:
        c = _host(expert_counts).ravel()
        tot = float(c.sum())
        ctr = REGISTRY.counter("pt_moe_expert_tokens_total",
                               "routed token assignments per expert")
        for i, v in enumerate(c):
            ctr.inc(float(v), expert=str(i))
        REGISTRY.counter("pt_moe_dispatch_total",
                         "MoE routing batches published").inc()
        if tot > 0:
            REGISTRY.gauge(
                "pt_moe_load_imbalance",
                "e * max expert share (1.0 = perfectly balanced)").set(
                float(c.max() * c.size / tot))


def _jitter(gate_logits: torch.Tensor, jitter_eps: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """fp32 logits, multiplied by uniform noise in [1 - eps, 1 + eps) drawn
    from ``generator`` when eps > 0 and a generator is given (the JAX
    functions' ``key``)."""
    gate_logits = gate_logits.float()
    if jitter_eps > 0.0 and generator is not None:
        noise = torch.empty_like(gate_logits).uniform_(
            1.0 - jitter_eps, 1.0 + jitter_eps, generator=generator)
        gate_logits = gate_logits * noise
    return gate_logits


def _sort_assignments(ids: torch.Tensor):
    """The choice-major assignment stream of ``ids`` [t, k] (every first
    choice, token-ascending, then every second, ...), and the stable
    order that sorts it by expert: (order, sorted expert ids), [k t]."""
    flat_e = ids.t().reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    return order, flat_e.index_select(0, order)


def _capacity_slots(ids: torch.Tensor, e: int, capacity: int,
                    c: Optional[int] = None,
                    lead: Optional[torch.Tensor] = None) -> torch.Tensor:
    """slot [t, k] int64 of the assignments ``ids`` [t, k] in an [e * c]
    slot space (c defaults to ``capacity``): each assignment's rank at
    its expert in the choice-major, token-ascending order is its slot
    there; it is dropped (slot e * c) where its priority position, that
    rank plus ``lead`` [k, e] at its (choice, expert) when given (the
    entries of other ranks ahead of it), reaches ``capacity``."""
    t, k = ids.shape
    c = capacity if c is None else c
    order, sorted_e = _sort_assignments(ids)
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=ids.device))
    pos = torch.arange(k * t, device=ids.device) - starts.index_select(
        0, sorted_e)
    prio = pos if lead is None else pos + lead.reshape(-1).index_select(
        0, (order // t) * e + sorted_e)
    slot_sorted = torch.where(prio < capacity, sorted_e * c + pos, e * c)
    slot_cm = torch.zeros_like(slot_sorted).index_copy_(0, order,
                                                        slot_sorted)
    return slot_cm.reshape(k, t).t()


def top_k_routing(gate_logits: torch.Tensor, k: int, capacity: int,
                  jitter_eps: float = 0.0,
                  generator: Optional[torch.Generator] = None):
    """Sort-based top-k routing with capacity. Returns (slot [t, k]
    int64, gates [t, k] fp32, aux_loss): ``slot[i, j]`` is the flat
    position of token i's j-th assignment in the [e * capacity] slot
    space, or e * capacity when it was dropped (its expert full).
    Priority is choice-major, token-ascending."""
    e = gate_logits.shape[1]
    probs = torch.softmax(_jitter(gate_logits, jitter_eps, generator), -1)
    gates, ids = torch.topk(probs, k, dim=-1)
    return _capacity_slots(ids, e, capacity), gates, _aux_loss(probs, e)


def _batch_group(plan):
    """(group, ranks, rank) of the batch axes (dp x fsdp) of a mesh
    plan when they hold more than one rank, else None."""
    if plan is None:
        return None
    from ..distributed.communication import Group
    axes = ("dp", "fsdp")
    n = plan.mesh.group_size(axes)
    if n == 1:
        return None
    return Group(axes, plan.mesh), n, plan.mesh.group_rank(axes)


def _capacity_routing(gate_logits: torch.Tensor, k: int, cf: float,
                      data=None):
    """:func:`top_k_routing` of this rank's tokens against the GLOBAL
    batch's capacity, as the unsharded layer routes (JAX's GSPMD step):
    ``data`` is (group, n, rank) of the batch axes, which split the
    global batch rank-major, or None for one rank. The capacity counts
    all n t tokens; an entry's priority position at its expert is the
    count of global entries before it, choice-major and token-ascending:
    every lower choice on every rank, the same choice on lower ranks,
    then its local position. Those come from an all-gather of each
    rank's [k, e] choice counts (no host read). Returns (slot [t, k],
    gates [t, k], c): slots in this rank's [e, c] layout, c =
    min(capacity, t), enough for every kept entry (a rank's kept entries
    at one expert are a prefix of its local order, at most t of them)."""
    group, n, rank = data if data is not None else (None, 1, 0)
    t, e = gate_logits.shape
    capacity = int(math.ceil(n * t * k / e * cf))
    probs = torch.softmax(gate_logits, -1)
    gates, ids = torch.topk(probs, k, dim=-1)
    lead = None
    if data is not None:
        from ..distributed.communication import all_gather
        local = torch.zeros((k, e), dtype=torch.int64, device=ids.device)
        local.scatter_add_(1, ids.t(), torch.ones_like(ids.t()))
        counts = torch.stack(all_gather(None, local, group))   # [n, k, e]
        total = counts.sum(0)
        # lower choices on every rank beyond this rank's own (its local
        # rank counts those), then the same choice on lower ranks
        lead = (total.cumsum(0) - total - (local.cumsum(0) - local)
                + counts[:rank].sum(0))
    c = min(capacity, t)
    return _capacity_slots(ids, e, capacity, c, lead), gates, c


def dispatch_tokens(flat: torch.Tensor, slot: torch.Tensor,
                    num_experts: int, capacity: int) -> torch.Tensor:
    """Gather tokens into the dense [e, c, d] expert layout (empty slots
    zero). flat [t, d]; slot [t, k] from :func:`top_k_routing`."""
    t, d = flat.shape
    k = slot.shape[1]
    ec = num_experts * capacity
    # slot -> token (choice-major, as top_k_routing); dropped assignments
    # all land on the trash entry ec, which is cut off
    slot_token = torch.full((ec + 1,), t, dtype=torch.int64,
                            device=flat.device)
    slot_token[slot.t().reshape(-1)] = torch.arange(
        t, device=flat.device).repeat(k)
    padded = torch.cat([flat, flat.new_zeros((1, d))])
    return padded.index_select(0, slot_token[:ec]).reshape(
        num_experts, capacity, d)


def _combine_weights(gates: torch.Tensor, renormalize: bool) -> torch.Tensor:
    if renormalize:
        gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates


def combine_tokens(ye: torch.Tensor, slot: torch.Tensor, gates: torch.Tensor,
                   renormalize: bool) -> torch.Tensor:
    """Weighted gather back to tokens. ye [e, c, d]; slot, gates [t, k].
    Dropped assignments (slot == e * c) contribute zero."""
    e, c, d = ye.shape
    padded = torch.cat([ye.reshape(e * c, d), ye.new_zeros((1, d))])
    y = padded.index_select(0, slot.reshape(-1)).reshape(*slot.shape, d)
    g = _combine_weights(gates * (slot < e * c).to(gates.dtype), renormalize)
    return (g[..., None].to(y.dtype) * y).sum(dim=1)


def top_k_gating(gate_logits: torch.Tensor, k: int, capacity: int,
                 jitter_eps: float = 0.0,
                 generator: Optional[torch.Generator] = None):
    """GShard one-hot gating (dispatch [t, e, c] bool, combine [t, e, c]
    fp32, aux_loss): O(t e c), kept as the oracle of the sort-based
    routing, as in the JAX package."""
    t, e = gate_logits.shape
    probs = torch.softmax(_jitter(gate_logits, jitter_eps, generator), -1)
    aux_loss = _aux_loss(probs, e)
    dev = gate_logits.device
    combine = torch.zeros((t, e, capacity), device=dev)
    dispatch = torch.zeros((t, e, capacity), dtype=torch.bool, device=dev)
    remaining = probs
    fill = torch.zeros(e, dtype=torch.int64, device=dev)
    for _ in range(k):
        idx = torch.argmax(remaining, dim=-1)                      # [t]
        onehot = F.one_hot(idx, e)                                 # [t, e]
        pos = ((onehot.cumsum(0) - 1 + fill) * onehot).sum(-1)     # [t]
        fits = pos < capacity
        gate_val = probs.gather(-1, idx[:, None])[:, 0]
        pos_oh = F.one_hot(torch.where(fits, pos, capacity),
                           capacity + 1)[:, :capacity].float()     # [t, c]
        contrib = onehot.float()[:, :, None] * pos_oh[:, None, :]
        combine = combine + (gate_val[:, None, None] * contrib
                             * fits[:, None, None])
        dispatch = dispatch | ((contrib > 0) & fits[:, None, None])
        fill = fill + (onehot * fits[:, None]).sum(0)
        remaining = remaining * (1.0 - onehot.float())
    if k > 1:
        denom = combine.sum(dim=(1, 2), keepdim=True)
        combine = combine / denom.clamp_min(1e-9)
    return dispatch, combine, aux_loss


class MoEMLP(nn.Module):
    """The experts as batched weights: ``w_gate_up`` [e, d, 2f] and
    ``w_down`` [e, f, d]; forward maps [e, c, d] → [e, c, d] with two
    batched products (SwiGLU between)."""

    def __init__(self, num_experts: int, hidden_size: int, ffn_size: int,
                 dtype="float32", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dev, dt = resolve_device(device), dtype_of(dtype)
        normal = Normal(0.0, 0.02)
        self.w_gate_up = nn.Parameter(normal(
            (num_experts, hidden_size, 2 * ffn_size), dt, dev, generator))
        self.w_down = nn.Parameter(normal(
            (num_experts, ffn_size, hidden_size), dt, dev, generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _expert_ffn(x, self.w_gate_up, self.w_down)


def _expert_ffn(x: torch.Tensor, w_gu: torch.Tensor,
                w_dn: torch.Tensor) -> torch.Tensor:
    """The per-expert SwiGLU on a dense [e, c, d] layout (MoEMLP's math on
    given weights: a rank's expert shard)."""
    gu = torch.bmm(x, w_gu.to(x.dtype))
    g, u = gu.chunk(2, dim=-1)
    return torch.bmm(F.silu(g) * u, w_dn.to(x.dtype))


class MoELayer(nn.Module):
    """Top-k routed MoE block: forward(x [b, s, d]) → (out [b, s, d],
    aux_loss). ``capacity_factor=None`` selects dropless routing through
    the grouped matmul. The router ``gate_weight`` [d, e] is fp32 and
    routes in fp32, whatever the activations' dtype."""

    def __init__(self, hidden_size: int, ffn_size: int, num_experts: int,
                 top_k: int = 2, capacity_factor: Optional[float] = 1.25,
                 dtype="float32", gate: str = "gshard", device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if top_k > num_experts:
            raise ValueError(f"top_k={top_k} > num_experts={num_experts}")
        self.num_experts = num_experts
        self.top_k = 1 if gate == "switch" else top_k
        self.capacity_factor = capacity_factor
        dev = resolve_device(device)
        self.gate_weight = nn.Parameter(Normal(0.0, 0.02)(
            (hidden_size, num_experts), torch.float32, dev, generator))
        self.experts = MoEMLP(num_experts, hidden_size, ffn_size, dtype, dev,
                              generator)

    def _logits(self, flat: torch.Tensor) -> torch.Tensor:
        return torch.matmul(flat.float(), self.gate_weight)

    def routing_histogram(self, x: torch.Tensor) -> torch.Tensor:
        """Measured per-expert token counts for ``x`` (int32 [e])."""
        flat = x.reshape(-1, x.shape[-1])
        return routing_stats(self._logits(flat), self.top_k)[2]

    _mesh_plan = None

    def forward(self, x: torch.Tensor):
        b, s, d = x.shape
        t = b * s
        e = self.num_experts
        flat = x.reshape(t, d)
        plan = self._mesh_plan
        if plan is not None and plan.ep_size > 1:
            run = (self._forward_dropless_ep if self.capacity_factor is None
                   else self._forward_capacity_ep)
            outs, aux = run([flat], MeshExchange(plan))
            return outs[0].reshape(b, s, d), aux
        logits = self._logits(flat)
        if self.capacity_factor is None:
            out, aux = self._forward_dropless(flat, logits)
            return out.reshape(b, s, d), aux
        slot, gates, c = _capacity_routing(
            logits, self.top_k, self.capacity_factor, _batch_group(plan))
        xe = dispatch_tokens(flat, slot, e, c)
        ye = self._experts_tp(self.experts, xe)
        out = combine_tokens(ye, slot, gates, renormalize=self.top_k > 1)
        return out.reshape(b, s, d), _aux_of(torch.softmax(logits, -1), e,
                                             plan)

    def _experts_tp(self, fn, x):
        """``fn(x)``, the experts' FFN; on a tensor-parallel mesh over this
        rank's FFN columns, the input copied into tp and the output
        summed over it."""
        from ..distributed.communication import (copy_to_group,
                                                 reduce_from_group)
        tp = _tp_group(self._mesh_plan)
        if tp is None:
            return fn(x)
        return reduce_from_group(fn(copy_to_group(x, tp)), tp)

    def _grouped_ffn(self, xs, w_gu, w_dn, group_sizes):
        """Two grouped products (SwiGLU between) over runs of
        ``group_sizes`` rows, in xs's dtype."""
        def fn(z):
            g, u = grouped_matmul_act(z, w_gu.to(z.dtype),
                                      group_sizes).chunk(2, dim=-1)
            return grouped_matmul_act(F.silu(g) * u, w_dn.to(z.dtype),
                                      group_sizes)
        return self._experts_tp(fn, xs)

    def forward_virtual_ep(self, xs: list, ep: int):
        """The expert-parallel layer over ``ep`` virtual ranks in this
        process: ``xs`` holds each rank's tokens ([b, s, d], equal
        counts), rank r computes with experts [r e/ep, (r+1) e/ep) of
        this layer's weights, and the exchange is a permutation
        (:class:`VirtualExchange`). Returns (each rank's output, the
        aux loss over every rank's tokens); the gradients reach the
        whole weights."""
        if self.num_experts % ep:
            raise ValueError(f"{self.num_experts} experts do not split over "
                             f"ep={ep}")
        shape = xs[0].shape
        flats = [x.reshape(-1, shape[-1]) for x in xs]
        run = (self._forward_dropless_ep if self.capacity_factor is None
               else self._forward_capacity_ep)
        outs, aux = run(flats, VirtualExchange(ep),
                        list(self.experts.w_gate_up.chunk(ep)),
                        list(self.experts.w_down.chunk(ep)))
        return [o.reshape(x.shape) for o, x in zip(outs, xs)], aux

    def _route_lanes(self, flats):
        """Each lane's (probs, top-k gates, expert ids)."""
        out = []
        for flat in flats:
            probs = torch.softmax(self._logits(flat), dim=-1)
            out.append((probs,) + tuple(torch.topk(probs, self.top_k,
                                                   dim=-1)))
        return out

    def _ep_aux(self, probs, exchange):
        if isinstance(exchange, VirtualExchange):
            return _aux_lanes(probs, self.num_experts)
        return _aux_of(probs[0], self.num_experts, self._mesh_plan)

    def _lanes_weights(self, exchange, w_gu, w_dn):
        """The lanes' expert weights (default: this layer's, one lane);
        an exchange is required: the ep paths run on a mesh's ep group or
        over virtual ranks, never alone."""
        if exchange is None:
            raise ValueError(
                "the expert-parallel paths need an exchange: a mesh with an "
                "ep axis (MeshExchange) or virtual ranks (VirtualExchange, "
                "MoELayer.forward_virtual_ep)")
        if w_gu is None:
            w_gu, w_dn = [self.experts.w_gate_up], [self.experts.w_down]
        return w_gu, w_dn

    def _forward_dropless_ep(self, flats, exchange, w_gu=None, w_dn=None):
        """Dropless expert parallelism over lanes (this rank, or every
        virtual rank) with EXACT split sizes (module docstring): the
        per-expert counts exchanged, one host read of the splits, the
        rows exchanged, the grouped matmul over the local experts'
        exact counts (expert-major: each expert's rows from rank 0, 1,
        ...), the reverse exchange and the unsort."""
        w_gu, w_dn = self._lanes_weights(exchange, w_gu, w_dn)
        e, k, ep = self.num_experts, self.top_k, exchange.ep
        el = e // ep
        routed = self._route_lanes(flats)
        sorts = [_sort_assignments(ids) for _, _, ids in routed]
        counts = [_counts(se, e) for _, se in sorts]               # [e]
        recv_c = exchange.counts(counts)                     # [ep, el]
        send_c = [c.reshape(ep, el).sum(1) for c in counts]
        # the one host read: every lane's send and receive split sizes
        sizes = torch.cat(send_c + [c.sum(1) for c in recv_c]).tolist()
        EP_HOST_READS[0] += 1
        n = len(flats)
        send = [sizes[i * ep:(i + 1) * ep] for i in range(n)]
        recv = [sizes[(n + i) * ep:(n + i + 1) * ep] for i in range(n)]
        xs = [f.index_select(0, order % f.shape[0])
              for f, (order, _) in zip(flats, sorts)]
        got = exchange.rows(xs, send, recv)
        ys = []
        for r, (x, c) in enumerate(zip(got, recv_c)):
            # source-major [ep, el] blocks -> expert-major rows
            keys = (torch.arange(el, device=x.device) * ep
                    + torch.arange(ep, device=x.device)[:, None])
            key = torch.repeat_interleave(keys.reshape(-1), c.reshape(-1),
                                          output_size=x.shape[0])
            perm = torch.argsort(key, stable=True)
            y = self._grouped_ffn(x.index_select(0, perm), w_gu[r],
                                  w_dn[r], c.sum(0).to(torch.int32))
            ys.append(torch.zeros_like(y).index_copy(0, perm, y))
        back = exchange.rows(ys, recv, send)
        outs = []
        for f, (_, gates, _), (order, _), y in zip(flats, routed, sorts,
                                                    back):
            t, d = f.shape
            y_cm = torch.zeros_like(y).index_copy(0, order, y).reshape(
                k, t, d)
            g_km = _combine_weights(gates, k > 1).t()
            outs.append((g_km[..., None].to(y.dtype) * y_cm).sum(dim=0))
        return outs, self._ep_aux([p for p, _, _ in routed], exchange)

    def _forward_capacity_ep(self, flats, exchange, w_gu=None, w_dn=None):
        """Capacity routing with expert parallelism over lanes: each lane
        routes its tokens into [e, c, d] with c = ceil(t_local k / e cf)
        (JAX :398), equal splits carry expert block j to lane j, which
        runs its experts over [e/ep, ep c, d] (slots source-major, JAX's
        tiled all-to-all), and the reverse exchange feeds the local
        combine."""
        w_gu, w_dn = self._lanes_weights(exchange, w_gu, w_dn)
        e, k, ep = self.num_experts, self.top_k, exchange.ep
        el = e // ep
        d = flats[0].shape[1]
        cap = int(math.ceil(flats[0].shape[0] * k / e
                            * self.capacity_factor))
        logits = [self._logits(f) for f in flats]
        routed = [top_k_routing(lg, k, cap) for lg in logits]
        xe = [dispatch_tokens(f, slot, e, cap).reshape(e * cap, d)
              for f, (slot, _, _) in zip(flats, routed)]
        split = [[el * cap] * ep for _ in flats]
        got = exchange.rows(xe, split, split)
        ys = []
        for r, x in enumerate(got):
            blocks = x.reshape(ep, el, cap, d).transpose(0, 1).reshape(
                el, ep * cap, d)
            y = self._experts_tp(lambda z, r=r: _expert_ffn(z, w_gu[r],
                                                           w_dn[r]), blocks)
            ys.append(y.reshape(el, ep, cap, d).transpose(0, 1).reshape(
                e * cap, d))
        back = exchange.rows(ys, split, split)
        outs = [combine_tokens(y.reshape(e, cap, d), slot, gates,
                               renormalize=k > 1)
                for y, (slot, gates, _) in zip(back, routed)]
        probs = [torch.softmax(lg, dim=-1) for lg in logits]
        return outs, self._ep_aux(probs, exchange)

    def _forward_dropless(self, flat: torch.Tensor, logits: torch.Tensor):
        """The experts as two grouped products over the exact per-expert
        counts of the sorted assignments."""
        t, d = flat.shape
        e, k = self.num_experts, self.top_k
        probs = torch.softmax(logits, dim=-1)
        gates, ids = torch.topk(probs, k, dim=-1)                 # [t, k]
        order, sorted_e = _sort_assignments(ids)
        group_sizes = _counts(sorted_e, e).to(torch.int32)
        xs = flat.index_select(0, order % t)                      # [k t, d]
        ys = self._grouped_ffn(xs, self.experts.w_gate_up,
                               self.experts.w_down, group_sizes)
        # unsort to choice-major, weight, reduce over k
        y_cm = torch.zeros_like(ys).index_copy(0, order, ys).reshape(k, t, d)
        g_km = _combine_weights(gates, k > 1).t()                 # [k, t]
        out = (g_km[..., None].to(ys.dtype) * y_cm).sum(dim=0)
        return out, _aux_of(probs, e, self._mesh_plan)


__all__ = ["MoELayer", "MoEMLP", "top_k_routing", "dispatch_tokens",
           "combine_tokens", "top_k_gating", "routing_stats",
           "publish_moe_metrics",
           "VirtualExchange", "MeshExchange", "EP_HOST_READS"]
