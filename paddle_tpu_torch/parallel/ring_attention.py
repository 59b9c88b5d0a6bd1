"""Ring attention: exact attention over sequence-sharded K/V (counterpart
of ``paddle_tpu/parallel/ring_attention.py``).

Each rank of the ``sep`` axis holds q, k and v shards [b, s/n, h(_kv),
d] of consecutive sequence blocks (rank ``r`` block ``r``). K/V (and the
KV segment ids) rotate to the right around the ring; at step ``t`` rank
``my`` holds the block that started on rank ``(my - t) mod n`` and runs
the flash kernel on it through the block entries
(``ops.attention.flash_fwd_block`` / ``flash_bwd_block``). Causal steps
dispatch on the block's origin: ``src < my`` is a full block (causal
off), ``src == my`` the diagonal (causal on), and ``src > my`` is
skipped: nothing is launched for it.

The forward merges NORMALISED partials in fp32, the block outputs cast
to fp32 first (:func:`merge_norm`, JAX's ``_merge_norm``). The backward
is the hand-written ring: dq accumulates locally in fp32, dk and dv ride
with their block in fp32 and reach home after n rotations, each summed
in step order and cast once, so two runs give the same bits where the
kernels do. The per-rank step and the merge are module-level functions
of (rank, step, block), which ``chip_smoke.py`` drives over virtual
ranks in one process.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ..distributed.communication import _pg
from ..ops.attention import (NEG_INF, flash_attention, flash_bwd_block,
                             flash_fwd_block)
from .mesh import current_mesh

# the port's flash kernels take these head dims; JAX's also take 256
HEAD_DIMS = (32, 64, 128)


def check_blocks(sl: int, h: int, h_kv: int, d: int) -> None:
    """Refuse what JAX's ``_flash_blocks_ok`` refuses (a local length
    with no block of 8 to 512 dividing it, query heads not a multiple of
    the KV heads, a head dim outside 32, 64, 128, 256), and d = 256,
    which the port's kernel does not take yet."""
    if h % h_kv:
        raise ValueError(f"{h} query heads are not a multiple of {h_kv} KV "
                         f"heads")
    if not any(sl % c == 0 for c in (512, 256, 128, 64, 32, 16, 8)):
        raise ValueError(f"ring attention: the local sequence {sl} is not a "
                         f"multiple of 8")
    if d == 256:
        raise NotImplementedError("ring attention at head_dim 256 waits for "
                                  "the flash kernel's d = 256 (ROADMAP.md "
                                  "B.1.1)")
    if d not in HEAD_DIMS:
        raise ValueError(f"ring attention takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")


def ring_case(rank: int, step: int, n: int, causal: bool) -> str:
    """"full", "diag" or "skip": what rank ``rank`` does at ``step`` with
    the block from rank ``(rank - step) mod n``."""
    if not causal:
        return "full"
    src = (rank - step) % n
    return "diag" if src == rank else ("full" if src < rank else "skip")


def ring_fwd_step(rank: int, step: int, n: int, causal: bool, scale: float,
                  q, k_blk, v_blk, q_seg=None, kv_seg=None):
    """(out_i, lse_i) of rank ``rank``'s queries against the block it
    holds at ``step``, or None for a skipped block."""
    case = ring_case(rank, step, n, causal)
    if case == "skip":
        return None
    return flash_fwd_block(q, k_blk, v_blk, scale, case == "diag", q_seg,
                           kv_seg)


def merge_norm(out: torch.Tensor, lse: torch.Tensor, o_i: torch.Tensor,
               lse_i: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge a normalised partial (o_i cast to fp32) into the running
    (out [b, sl, h, d] fp32, lse [b, h, sl] fp32): lse' = logaddexp,
    out' = out exp(lse - lse') + o_i exp(lse_i - lse'). A state or a
    block at NEG_INF gets weight 0."""
    new = torch.logaddexp(lse, lse_i)
    w0 = torch.exp(lse - new).transpose(1, 2)[..., None]
    w1 = torch.exp(lse_i - new).transpose(1, 2)[..., None]
    return out * w0 + o_i.float() * w1, new


def ring_bwd_step(rank: int, step: int, n: int, causal: bool, scale: float,
                  q, k_blk, v_blk, out, lse, dout, q_seg=None, kv_seg=None,
                  delta=None):
    """(dq_i, dk_i, dv_i) of the block rank ``rank`` holds at ``step``
    from the GLOBAL out and lse, or None for a skipped block."""
    case = ring_case(rank, step, n, causal)
    if case == "skip":
        return None
    return flash_bwd_block(q, k_blk, v_blk, out, lse, dout, scale,
                           case == "diag", q_seg, kv_seg, delta)


def _exchange(tensors: List[Optional[torch.Tensor]], pg, ranks: List[int],
              me: int):
    """Start sending each tensor to the next rank and receiving the
    previous rank's; returns (works, received). None entries pass."""
    n = len(ranks)
    ops, outs = [], []
    for t in tensors:
        if t is None:
            outs.append(None)
            continue
        t = t.contiguous()
        r = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, ranks[(me + 1) % n], pg))
        ops.append(dist.P2POp(dist.irecv, r, ranks[(me - 1) % n], pg))
        outs.append(r)
    return (dist.batch_isend_irecv(ops) if ops else []), outs


def _wait(works) -> None:
    for w in works:
        w.wait()


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, pg, ranks, me, causal, scale):
        n = len(ranks)
        b, sl, h, d = q.shape
        out = torch.zeros((b, sl, h, d), dtype=torch.float32,
                          device=q.device)
        lse = torch.full((b, h, sl), NEG_INF, dtype=torch.float32,
                         device=q.device)
        blk = [k, v, kv_seg]
        for t in range(n):
            works, nxt = (_exchange(blk, pg, ranks, me) if t < n - 1
                          else ([], None))
            r = ring_fwd_step(me, t, n, causal, scale, q, blk[0], blk[1],
                              q_seg, blk[2])
            if r is not None:
                out, lse = merge_norm(out, lse, r[0], r[1])
            _wait(works)
            blk = nxt
        out_c = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out_c, lse, q_seg, kv_seg)
        ctx.args = (pg, ranks, me, causal, scale)
        return out_c

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        pg, ranks, me, causal, scale = ctx.args
        n = len(ranks)
        dout = dout.contiguous()
        delta = (out.float() * dout.float()).sum(-1).transpose(
            1, 2).contiguous()
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        blk = [k, v, kv_seg]
        for t in range(n):
            works, nxt = (_exchange(blk, pg, ranks, me) if t < n - 1
                          else ([], None))
            r = ring_bwd_step(me, t, n, causal, scale, q, blk[0], blk[1],
                              out, lse, dout, q_seg, blk[2], delta)
            if r is not None:
                dq += r[0].float()
                dk += r[1].float()
                dv += r[2].float()
            # dk and dv ride with their block: after n rotations they are
            # home holding every rank's contribution
            gw, (dk, dv) = _exchange([dk, dv], pg, ranks, me)
            _wait(works)
            _wait(gw)
            blk = nxt
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   causal: bool = True, axis: str = "sep",
                   scale: Optional[float] = None, mesh=None,
                   segment_ids=None) -> torch.Tensor:
    """Exact attention with K/V rotating over the ``axis`` ring. q, k, v
    are THIS rank's shards [b, s/n, h(_kv), d] (rank r of the axis holds
    sequence block r); returns this rank's [b, s/n, h, d].
    ``segment_ids`` [b, s/n] (this rank's block) packs sequences: the
    query side stays, the key side rotates with its K/V. Without a mesh
    or with the axis at 1 it is the local flash attention."""
    hm = current_mesh() if mesh is None else mesh
    d = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if hm is None or hm.axis_size(axis) <= 1:
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               segment_ids=segment_ids)
    from ..distributed.communication import Group
    pg, n, me, ranks = _pg(Group(axis, hm))
    check_blocks(q.shape[1], q.shape[2], k.shape[2], d)
    seg = None
    if segment_ids is not None:
        seg = segment_ids.to(torch.int32).contiguous()
    return _Ring.apply(q, k, v, seg, seg, pg, ranks, me, bool(causal),
                       float(scale))


__all__ = ["ring_attention", "ring_case", "ring_fwd_step", "ring_bwd_step",
           "merge_norm", "check_blocks"]
