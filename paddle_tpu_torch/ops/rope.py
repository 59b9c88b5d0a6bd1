"""Rotary position embedding (counterpart of ``paddle_tpu/ops/rope.py``).

The neox/Llama rotate-half form on [b, s, heads, d] tensors. Both the
contiguous-position form (prefill) and the ``position_ids`` form (decode)
go through the hand-written CUDA kernel on a CUDA tensor; a CPU tensor
takes the plain version, which is also the kernel's oracle. Under
autograd the backward is the same rotation with the sine negated.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..analysis.collectives import kernel as _census
from ..device import plain_route as _plain
from .kernels.fused_rope import fused_rope


def rope_freqs(head_dim: int, max_seq: int, base: float = 10000.0,
               scaling_factor: float = 1.0, device=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) fp32 tables [max_seq, head_dim]. Computed on the CPU and
    then moved, so every device holds the same bits."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2,
                                            dtype=torch.float32) / head_dim))
    t = torch.arange(max_seq, dtype=torch.float32) / scaling_factor
    freqs = torch.outer(t, inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(device), emb.sin().to(device)


def _rope_plain(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, position_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in plain PyTorch: half-split rotation in
    fp32 (``o1 = x1*c1 - x2*s1``, ``o2 = x2*c2 + x1*s2``), positions
    clamped into the table as a JAX gather clamps."""
    s = q.shape[1]
    if position_ids is None:
        c, sn = cos[:s][None, :, None, :], sin[:s][None, :, None, :]
    else:
        idx = position_ids.long().clamp(0, cos.shape[0] - 1)
        c, sn = cos[idx][:, :, None, :], sin[idx][:, :, None, :]
    c, sn = c.float(), sn.float()
    half = q.shape[-1] // 2
    c1, c2, s1, s2 = c[..., :half], c[..., half:], sn[..., :half], \
        sn[..., half:]

    def rot(x):
        x1, x2 = x[..., :half].float(), x[..., half:].float()
        return torch.cat([x1 * c1 - x2 * s1, x2 * c2 + x1 * s2],
                         dim=-1).to(x.dtype)
    return rot(q), rot(k)


def _cost(q, k):
    b, s, h, d = q.shape
    hk = k.shape[2]
    return 3 * b * s * (h + hk) * d, (2 * b * s * (h + hk) * d
                                      * q.element_size() + 2 * b * s * d * 4)


def _rope(q, k, cos, sin, position_ids):
    """The forward rotation: the kernel on CUDA, the plain version on the
    CPU (and on the meta device). ``position_ids`` is int64 [b, s] or
    None."""
    with _census("fused_rope", _cost, q, k) as kern:
        if _plain(q):
            return kern.out(*_rope_plain(q, k, cos, sin, position_ids))
        return kern.out(*fused_rope(q, k, cos, sin, position_ids))


class _Rope(torch.autograd.Function):
    """RoPE of (q, k) with the transposed rotation as its backward: the
    same kernel with the sine table negated, R(theta)^T = R(-theta), as
    ``paddle_tpu.ops.rope._rope_bwd`` does. The tables are constants and
    get no gradient."""

    @staticmethod
    def forward(ctx, q, k, cos, sin, neg_sin, position_ids):
        ctx.save_for_backward(cos, neg_sin, position_ids)
        return _rope(q, k, cos, sin, position_ids)

    @staticmethod
    def backward(ctx, gq, gk):
        cos, neg_sin, position_ids = ctx.saved_tensors
        dq, dk = _rope(gq.contiguous(), gk.contiguous(), cos, neg_sin,
                       position_ids)
        return dq, dk, None, None, None, None


def apply_rotary_pos_emb(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                         sin: torch.Tensor,
                         position_ids: Optional[torch.Tensor] = None,
                         neg_sin: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q [b, s, h, d], k [b, s, hk, d]; cos/sin the fp32 [max_seq, d]
    tables; ``position_ids`` [b, s] or None for 0..s-1. ``neg_sin`` is
    ``-sin``, the backward's table: a model keeps it as a buffer, and it
    is made here (one allocation a call) when None and a gradient is
    recorded."""
    if position_ids is not None:
        position_ids = position_ids.to(torch.int64).contiguous()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return _Rope.apply(q, k, cos, sin,
                           -sin if neg_sin is None else neg_sin,
                           position_ids)
    return _rope(q, k, cos, sin, position_ids)


__all__ = ["rope_freqs", "apply_rotary_pos_emb"]
