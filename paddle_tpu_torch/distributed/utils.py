"""paddle.distributed.utils: the MoE all-to-alls ``global_scatter`` and
``global_gather`` (counterpart of ``paddle_tpu/distributed/utils.py``;
reference: python/paddle/distributed/utils/moe_utils.py:20, :153).

The reference moves ragged per-(rank, expert) token buckets over NCCL.
The port's MoE layer (``parallel.moe.MoELayer``) dispatches by sorting
and exchanges its buckets itself over the ep group (``MeshExchange``),
so these functions keep JAX's semantics for recipes: exact in a group of
one process (every expert is local and the data does not move), and a
raise pointing at the MoE layer on a group of several ranks.
"""

from __future__ import annotations

import torch

__all__ = ["global_scatter", "global_gather"]


def _world(group) -> int:
    if group is not None and getattr(group, "nranks", 1) > 1:
        return int(group.nranks)
    return 1


def _check_counts(local_count, global_count) -> None:
    lc, gc = torch.as_tensor(local_count), torch.as_tensor(global_count)
    if lc.shape != gc.shape:
        raise ValueError(f"local_count {tuple(lc.shape)} != global_count "
                         f"{tuple(gc.shape)}")


def _multi_rank(name: str):
    return NotImplementedError(
        f"multi-rank {name}: use parallel.moe.MoELayer, whose sort-based "
        f"dispatch exchanges the expert buckets over the ep group itself")


def global_scatter(x, local_count, global_count, group=None):
    """Send per-expert token buckets to their owner ranks (reference:
    moe_utils.py:20). In one process every expert is local and
    local_count equals global_count: the buckets stay, the identity."""
    _check_counts(local_count, global_count)
    if _world(group) > 1:
        raise _multi_rank("global_scatter")
    return torch.as_tensor(x)


def global_gather(x, local_count, global_count, group=None):
    """The inverse of :func:`global_scatter` (reference: moe_utils.py:153)."""
    _check_counts(local_count, global_count)
    if _world(group) > 1:
        raise _multi_rank("global_gather")
    return torch.as_tensor(x)
