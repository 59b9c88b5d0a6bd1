"""Tensor-parallel (Megatron-style) layers and the vocab-parallel cross
entropy (counterpart of ``paddle_tpu/parallel/mp_layers.py``).

In the JAX package these layers annotate their weights and GSPMD
derives the collectives. Here each rank holds its LOCAL shard and the
collectives are explicit (``distributed.communication``): a column-
parallel linear copies its input into the tensor region (the gradient
all-reduced over ``tp``) and leaves its output sharded; a row-parallel
linear all-reduces its partial output (the gradient passed as it is).
A layer is built at its FULL sizes and keeps this rank's part: pass the
full weight to :meth:`load_full` to cut it. Without a tp axis over 1 a
layer is the plain one and calls no collective.

The vocab-parallel cross entropies merge per-shard statistics: a MAX
all-reduce that is not differentiated (JAX's ``stop_gradient`` of the
``pmax``), a SUM all-reduce of the exp-sums and one of the target
logits. :func:`parallel_fused_linear_cross_entropy` runs the fused
vocab-CE head (``ops.vocab_ce.lse_and_target``: on the card its
kernels) over each rank's [H, V/tp] shard, so the logits never exist.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.communication import (Group, all_reduce_max_,
                                         copy_to_group, gather_from_group,
                                         reduce_from_group,
                                         reduce_scatter_to_group)
from ..distributed.overlap import copy_matmul
from ..nn.initializer import Normal
from .mesh import current_mesh


def _tp(mesh=None, axis: str = "tp"):
    """(Group, size, rank) of the tensor axis, or (None, 1, 0)."""
    hm = current_mesh() if mesh is None else mesh
    if hm is None or hm.axis_size(axis) <= 1:
        return None, 1, 0
    return Group(axis, hm), hm.axis_size(axis), hm.coordinate(axis)


def _xavier(shape, device, dtype, g):
    bound = (6.0 / (shape[0] + shape[1])) ** 0.5
    return (torch.rand(shape, generator=g, device=device) * 2 - 1).mul_(
        bound).to(dtype)


class _TPLayer(nn.Module):
    def __init__(self, mesh, axis):
        super().__init__()
        self._group, self.tp, self.tp_rank = _tp(mesh, axis)

    def _part(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        return full.chunk(self.tp, dim=dim)[self.tp_rank].contiguous()


class VocabParallelEmbedding(_TPLayer):
    """Embedding whose rows (the vocabulary) split over ``tp``: ids
    outside this rank's range give 0, then a SUM all-reduce."""

    def __init__(self, num_embeddings: int, embedding_dim: int,
                 weight_attr=None, dtype=torch.float32, device="cpu",
                 mesh=None, axis: str = "tp", generator=None):
        super().__init__(mesh, axis)
        if num_embeddings % self.tp:
            raise ValueError(f"vocabulary {num_embeddings} does not split "
                             f"over tp={self.tp}")
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.per = num_embeddings // self.tp
        init = weight_attr or Normal(0.0, 0.02)
        self.weight = nn.Parameter(self._part(init(
            (num_embeddings, embedding_dim), dtype, device, generator), 0))

    def load_full(self, w: torch.Tensor) -> None:
        with torch.no_grad():
            self.weight.copy_(self._part(w, 0))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        lo = self.tp_rank * self.per
        inside = (ids >= lo) & (ids < lo + self.per)
        local = torch.where(inside, ids - lo, 0)
        out = F.embedding(local, self.weight) * inside[..., None].to(
            self.weight.dtype)
        return (out if self._group is None
                else reduce_from_group(out, self._group))


class ColumnParallelLinear(_TPLayer):
    """y = x W (+ b) with W [in, out] split by output columns over
    ``tp``; the output stays split unless ``gather_output``."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 gather_output: bool = False, dtype=torch.float32,
                 device="cpu", mesh=None, axis: str = "tp", generator=None):
        super().__init__(mesh, axis)
        self.in_features, self.out_features = in_features, out_features
        self.gather_output = gather_output
        w = (weight_attr((in_features, out_features), dtype, device,
                         generator) if weight_attr is not None else
             _xavier((in_features, out_features), device, dtype, generator))
        self.weight = nn.Parameter(self._part(w, 1))
        self.bias = (nn.Parameter(torch.zeros(out_features // self.tp,
                                              dtype=dtype, device=device))
                     if has_bias else None)

    def load_full(self, w: torch.Tensor, b=None) -> None:
        with torch.no_grad():
            self.weight.copy_(self._part(w, 1))
            if b is not None:
                self.bias.copy_(self._part(b, 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = copy_matmul(x, self.weight.to(x.dtype), self._group)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return (gather_from_group(y, self._group, dim=-1)
                if self.gather_output and self._group is not None else y)


class RowParallelLinear(_TPLayer):
    """y = x W (+ b) with W [in, out] split by input rows over ``tp``:
    the input arrives split (``input_is_parallel``) and the partial
    products are all-reduced; the bias is added after, replicated."""

    def __init__(self, in_features: int, out_features: int,
                 weight_attr=None, has_bias: bool = True,
                 input_is_parallel: bool = True, dtype=torch.float32,
                 device="cpu", mesh=None, axis: str = "tp", generator=None):
        super().__init__(mesh, axis)
        self.in_features, self.out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        w = (weight_attr((in_features, out_features), dtype, device,
                         generator) if weight_attr is not None else
             _xavier((in_features, out_features), device, dtype, generator))
        self.weight = nn.Parameter(self._part(w, 0))
        self.bias = (nn.Parameter(torch.zeros(out_features, dtype=dtype,
                                              device=device))
                     if has_bias else None)

    def load_full(self, w: torch.Tensor, b=None) -> None:
        with torch.no_grad():
            self.weight.copy_(self._part(w, 0))
            if b is not None:
                self.bias.copy_(b)

    def _partial(self, x: torch.Tensor) -> torch.Tensor:
        if not self.input_is_parallel:
            return copy_matmul(x, self.weight.to(x.dtype), self._group,
                               chunk=True)
        return torch.matmul(x, self.weight.to(x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self._partial(x)
        if self._group is not None:
            y = reduce_from_group(y, self._group)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


# -- vocab-parallel cross entropy ---------------------------------------------

def parallel_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                           mesh=None, axis: str = "tp",
                           ignore_index: int = -100) -> torch.Tensor:
    """Per-token CE [...] over THIS rank's vocabulary shard of the
    logits [..., V/tp] (rank r holding columns r V/tp ..), without
    gathering them: the fp32 max all-reduced without gradient, the sum
    of exp(logits - max) and the target logit all-reduced. Ignored rows
    give 0. One shard (no mesh, or the axis at 1) is the plain CE."""
    g, tp, r = _tp(mesh, axis)
    logits32 = logits.float()
    if g is None:
        logp = torch.log_softmax(logits32, dim=-1)
        safe = torch.where(labels == ignore_index, 0, labels)
        nll = -torch.gather(logp, -1, safe[..., None].long())[..., 0]
        return torch.where(labels == ignore_index, 0.0, nll)
    per = logits.shape[-1]
    lo = r * per
    gmax = all_reduce_max_(logits32.detach().amax(dim=-1), g)
    shifted = logits32 - gmax[..., None]
    gsum = reduce_from_group(torch.exp(shifted).sum(-1), g)
    safe = torch.where(labels == ignore_index, 0, labels)
    local = safe - lo
    inside = (local >= 0) & (local < per)
    picked = torch.gather(shifted, -1, local.clamp(0, per - 1)[..., None]
                          .long())[..., 0]
    target = reduce_from_group(torch.where(inside, picked, 0.0), g)
    nll = torch.log(gsum) - target
    return torch.where(labels == ignore_index, 0.0, nll)


def parallel_fused_linear_cross_entropy(hidden: torch.Tensor,
                                        w: torch.Tensor,
                                        labels: torch.Tensor, mesh=None,
                                        axis: str = "tp",
                                        ignore_index: int = -100,
                                        block_n=None, block_v=None,
                                        impl=None,
                                        interpret: bool = False
                                        ) -> torch.Tensor:
    """Per-token CE(hidden @ W, labels) [...] fp32 with ``w`` THIS rank's
    [H, V/tp] vocabulary shard (rank r holding columns r V/tp ..) and
    ``hidden`` [..., H] the same on every rank of ``axis``. Each rank
    runs ``lse_and_target`` over its shard with its labels shifted by
    the shard's offset (an ignored row maps to -1 - lo, below every
    shard; a label outside a shard contributes 0), and the shards'
    (lse, tgt) merge by the max-shifted sum of exp(lse). The gradient of
    ``hidden`` is summed over the axis. One shard is the fused head."""
    from ..ops.vocab_ce import fused_linear_cross_entropy, lse_and_target
    g, tp, r = _tp(mesh, axis)
    if g is None:
        return fused_linear_cross_entropy(
            hidden, w, labels, ignore_index=ignore_index, reduction="none",
            block_n=block_n, block_v=block_v, impl=impl, interpret=interpret)
    lo = r * w.shape[-1]
    lab = labels.reshape(-1)
    valid = lab != ignore_index
    local = (torch.where(valid, lab, -1) - lo).to(torch.int32)
    h2 = copy_to_group(hidden, g).reshape(-1, hidden.shape[-1])
    lse_l, tgt_l = lse_and_target(h2, w, local, block_v)
    return merge_shards(lse_l, tgt_l, valid, g).reshape(labels.shape)


def merge_shards(lse_l: torch.Tensor, tgt_l: torch.Tensor,
                 valid: torch.Tensor, group) -> torch.Tensor:
    """nll [N] from each shard's (lse, tgt) [N]: lse = gmax + log(sum
    exp(lse_l - gmax)) with gmax all-reduced without gradient, tgt
    summed; 0 on ignored rows."""
    gmax = all_reduce_max_(lse_l.detach().clone(), group)
    gse = reduce_from_group(torch.exp(lse_l - gmax), group)
    lse = gmax + torch.log(gse)
    tgt = reduce_from_group(tgt_l, group)
    return torch.where(valid, lse - tgt, 0.0)


def merge_shard_stats(lses, tgts, valid: torch.Tensor) -> torch.Tensor:
    """:func:`merge_shards` over every shard's (lse, tgt) held by one
    process (virtual ranks): the same arithmetic, the sums in shard
    order."""
    gmax = torch.stack([x.detach() for x in lses]).amax(0)
    gse = sum(torch.exp(x - gmax) for x in lses)
    return torch.where(valid, gmax + torch.log(gse) - sum(tgts), 0.0)


class ParallelCrossEntropy(nn.Module):
    """Layer form of :func:`parallel_cross_entropy`."""

    def __init__(self, mp_group=None, ignore_index: int = -100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, logits, labels):
        return parallel_cross_entropy(logits, labels,
                                      ignore_index=self.ignore_index)


# -- sequence-parallel utilities ----------------------------------------------

def scatter_seq(x: torch.Tensor, axis_name: str = "sep", dim: int = 1,
                mesh=None) -> torch.Tensor:
    """This rank's block of the sequence dimension (Paddle's ScatterOp;
    the backward all-gathers)."""
    from ..distributed.communication import scatter_to_group
    g, n, _ = _tp(mesh, axis_name)
    return x if g is None else scatter_to_group(x, g, dim)


def gather_seq(x: torch.Tensor, dim: int = 1, axis_name: str = "sep",
               mesh=None) -> torch.Tensor:
    """The whole sequence from every rank's block (Paddle's
    GatherOp/AllGatherOp; the backward reduce-scatters)."""
    g, n, _ = _tp(mesh, axis_name)
    return x if g is None else gather_from_group(x, g, dim)


class ColumnSequenceParallelLinear(ColumnParallelLinear):
    """Column-parallel linear whose input is sequence-sharded over the
    same ``tp`` ranks (Megatron sequence parallelism): the sequence is
    all-gathered before the product (reduce-scattered back in the
    backward)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = gather_from_group(x, self._group, dim=1)
        y = torch.matmul(x, self.weight.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return (gather_from_group(y, self._group, dim=-1)
                if self.gather_output else y)


class RowSequenceParallelLinear(RowParallelLinear):
    """Row-parallel linear whose output is reduce-scattered along the
    sequence over ``tp`` (all-gathered in the backward); the bias is
    added to each rank's block."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = reduce_scatter_to_group(self._partial(x), self._group, dim=1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y


__all__ = ["VocabParallelEmbedding", "ColumnParallelLinear",
           "RowParallelLinear", "parallel_cross_entropy",
           "parallel_fused_linear_cross_entropy", "merge_shards",
           "ParallelCrossEntropy", "scatter_seq", "gather_seq",
           "ColumnSequenceParallelLinear", "RowSequenceParallelLinear"]
