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

On the card nothing on the dropless path makes the host wait for the
device: counts are ``scatter_add_`` into fixed-size tensors
(``bincount`` sizes its output on the host), and gathers and the unsort
are ``index_select``/``index_copy``.

Not ported: the expert-parallel paths (an ``ep`` mesh axis with
all-to-all dispatch, and the sharding constraint on the expert layout),
which come with ROADMAP.md A.4b (the mesh itself is A.4a's; ``ep`` > 1
is refused there), so :class:`MoELayer` never reaches them, as the JAX
layer does not without an ``ep`` axis; and ``publish_moe_metrics``, which waits for the observability
plane (A.6).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..device import dtype_of, resolve_device
from ..nn.initializer import Normal
from ..ops.grouped_matmul import grouped_matmul_act


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


def top_k_routing(gate_logits: torch.Tensor, k: int, capacity: int,
                  jitter_eps: float = 0.0,
                  generator: Optional[torch.Generator] = None):
    """Sort-based top-k routing with capacity. Returns (slot [t, k]
    int64, gates [t, k] fp32, aux_loss): ``slot[i, j]`` is the flat
    position of token i's j-th assignment in the [e * capacity] slot
    space, or e * capacity when it was dropped (its expert full).
    Priority is choice-major, token-ascending."""
    t, e = gate_logits.shape
    probs = torch.softmax(_jitter(gate_logits, jitter_eps, generator), -1)
    gates, ids = torch.topk(probs, k, dim=-1)
    order, sorted_e = _sort_assignments(ids)
    starts = torch.searchsorted(
        sorted_e, torch.arange(e, device=ids.device))
    pos = torch.arange(k * t, device=ids.device) - starts.index_select(
        0, sorted_e)
    slot_sorted = torch.where(pos < capacity, sorted_e * capacity + pos,
                              e * capacity)
    slot_cm = torch.zeros_like(slot_sorted).index_copy_(0, order,
                                                        slot_sorted)
    return slot_cm.reshape(k, t).t(), gates, _aux_loss(probs, e)


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
        gu = torch.bmm(x, self.w_gate_up.to(x.dtype))
        g, u = gu.chunk(2, dim=-1)
        return torch.bmm(F.silu(g) * u, self.w_down.to(x.dtype))


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

    def forward(self, x: torch.Tensor):
        b, s, d = x.shape
        t = b * s
        e = self.num_experts
        flat = x.reshape(t, d)
        logits = self._logits(flat)
        if self.capacity_factor is None:
            out, aux = self._forward_dropless(flat, logits)
            return out.reshape(b, s, d), aux
        capacity = int(math.ceil(t * self.top_k / e * self.capacity_factor))
        slot, gates, aux = top_k_routing(logits, self.top_k, capacity)
        ye = self.experts(dispatch_tokens(flat, slot, e, capacity))
        out = combine_tokens(ye, slot, gates, renormalize=self.top_k > 1)
        return out.reshape(b, s, d), aux

    def _forward_capacity_ep(self, flat, mesh, ep: int):
        raise NotImplementedError(
            "expert-parallel capacity routing (ep > 1) comes with "
            "ROADMAP.md A.4b")

    def _forward_dropless_ep(self, flat, mesh, ep: int):
        raise NotImplementedError(
            "expert-parallel dropless routing (ep > 1) comes with "
            "ROADMAP.md A.4b")

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
        w_gu = self.experts.w_gate_up.to(flat.dtype)              # [e, d, 2f]
        w_dn = self.experts.w_down.to(flat.dtype)                 # [e, f, d]
        g, u = grouped_matmul_act(xs, w_gu, group_sizes).chunk(2, dim=-1)
        ys = grouped_matmul_act(F.silu(g) * u, w_dn, group_sizes)
        # unsort to choice-major, weight, reduce over k
        y_cm = torch.zeros_like(ys).index_copy(0, order, ys).reshape(k, t, d)
        g_km = _combine_weights(gates, k > 1).t()                 # [k, t]
        out = (g_km[..., None].to(ys.dtype) * y_cm).sum(dim=0)
        return out, _aux_loss(probs, e)


__all__ = ["MoELayer", "MoEMLP", "top_k_routing", "dispatch_tokens",
           "combine_tokens", "top_k_gating", "routing_stats"]
