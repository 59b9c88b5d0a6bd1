"""Ulysses (all-to-all head-scatter) sequence parallelism (counterpart of
``paddle_tpu/parallel/ulysses.py``).

Activations are sequence-sharded over the ``sep`` axis. Around the
attention core one all-to-all per tensor trades the sequence sharding
for a head sharding::

    [b, s/n, h, d]  --all_to_all-->  [b, s, h/n, d]
    full-sequence flash attention on h/n local heads
    [b, s, h/n, d]  --all_to_all-->  [b, s/n, h, d]

The all-to-all is ``distributed.communication.all_to_all``, whose
backward is the inverse all-to-all; the attention core is the flash
kernels' autograd Function.

GQA: with ``h_kv % n == 0`` K/V split like q; with ``n % h_kv == 0``
each KV head is repeated ``n / h_kv`` times first (each rank's q slice
sits inside one KV group); otherwise KV expands to h
(:func:`gqa_expand_factor`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..distributed.communication import Group, all_to_all
from ..ops.attention import flash_attention
from .mesh import current_mesh


def gqa_expand_factor(h: int, h_kv: int, n: int) -> int:
    """KV head repeat factor before the all-to-all: 1 when h_kv splits
    over the axis, n / h_kv when h_kv divides n, else h / h_kv."""
    if h_kv % n == 0:
        return 1
    if n % h_kv == 0:
        return n // h_kv
    return h // h_kv


def ulysses_supported(h: int, h_kv: int, n: int) -> bool:
    """Query heads split evenly over the axis, and KV heads split too or
    expand to h exactly."""
    return n > 1 and h % n == 0 and (h_kv % n == 0 or h % h_kv == 0)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      causal: bool = True, axis: str = "sep",
                      scale: Optional[float] = None,
                      mesh=None) -> torch.Tensor:
    """Exact attention over sequence-sharded q, k, v (THIS rank's shards
    [b, s/n, h(_kv), d], rank r holding block r) through head
    all-to-alls; returns this rank's [b, s/n, h, d]. Without a mesh or
    with the axis at 1 it is the local flash attention."""
    hm = current_mesh() if mesh is None else mesh
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if hm is None or hm.axis_size(axis) <= 1:
        return flash_attention(q, k, v, causal=causal, scale=scale)
    n = hm.axis_size(axis)
    h, h_kv = q.shape[2], k.shape[2]
    if not ulysses_supported(h, h_kv, n):
        raise ValueError(
            f"ulysses_attention: need h % n == 0 and (h_kv % n == 0 or "
            f"h % h_kv == 0); got h={h}, h_kv={h_kv}, {axis}={n}: use "
            f"ring_attention instead")
    r = gqa_expand_factor(h, h_kv, n)
    if r > 1:
        k = torch.repeat_interleave(k, r, dim=2)
        v = torch.repeat_interleave(v, r, dim=2)
    g = Group(axis, hm)
    # [b, s/n, h, d] -> [b, s, h/n, d]: split heads, join the sequence
    qh, kh, vh = (all_to_all(t, g, split_dim=2, concat_dim=1)
                  for t in (q, k, v))
    out = flash_attention(qh, kh, vh, causal=causal, scale=scale)
    # [b, s, h/n, d] -> [b, s/n, h, d]: split the sequence, join heads
    return all_to_all(out, g, split_dim=1, concat_dim=2)


__all__ = ["ulysses_attention", "ulysses_supported", "gqa_expand_factor"]
