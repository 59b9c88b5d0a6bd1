"""Attention ops (counterpart of ``paddle_tpu/ops/attention.py`` and the
plain half of ``paddle_tpu/ops/pallas/paged_attention.py``).

Layouts follow the JAX package: q [batch, q_seq, heads, d], k/v
[batch, kv_seq, kv_heads, d] (GQA when kv_heads < heads); paged pools
are head-major [kv_heads, num_pages, page_size, d].
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .kernels.paged_attention import paged_decode


def _expand_kv(k: torch.Tensor, heads: int) -> torch.Tensor:
    """[b, s, kvh, d] -> [b, s, heads, d] by repeating each kv head."""
    kvh = k.shape[2]
    return k if kvh == heads else torch.repeat_interleave(
        k, heads // kvh, dim=2)


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True,
               scale: Optional[float] = None) -> torch.Tensor:
    """Copy of ``paddle_tpu.ops.attention._sdpa_xla`` (no mask, segments
    or dropout): fp32 scores, bottom-right causal mask, fp32 softmax,
    probabilities cast to v's dtype before the weighted sum, output in
    q's dtype. The serving prefill runs this on the card as well: in the
    JAX package it is outside every Pallas kernel."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        qi = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=q.device)[None, :]
        logits = logits.masked_fill(~(ki <= qi)[None, None], float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def paged_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       seq_lens: torch.Tensor,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Copy of ``paddle_tpu.ops.pallas.paged_attention.paged_decode_xla``
    (native pools): gather the whole table, attend positions
    0..seq_lens[b] inclusive with an fp32 softmax. Table entries are
    clamped into the pool, as a JAX gather clamps."""
    B, H, D = q.shape
    H_kv, num_pages, page_size, _ = k_pages.shape
    T = block_tables.shape[1] * page_size
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    safe = block_tables.long().clamp(0, num_pages - 1)

    def gather(pages):
        g = pages[:, safe]                       # [H_kv, B, mp, page, D]
        g = g.reshape(H_kv, B, T, D).movedim(0, 2)
        return torch.repeat_interleave(g, H // H_kv, dim=2)
    ks, vs = gather(k_pages), gather(v_pages)
    lg = torch.einsum("bhd,bthd->bht", q.float(), ks.float()) * scale
    valid = (torch.arange(T, device=q.device)[None, None, :]
             <= seq_lens.to(q.device).long()[:, None, None])
    p = torch.softmax(lg.masked_fill(~valid, float("-inf")), dim=-1)
    out = torch.einsum("bht,bthd->bhd", p, vs.float())
    return out.to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens,
                           scale: Optional[float] = None) -> torch.Tensor:
    """One-token decode attention over paged pools: the CUDA kernel on a
    CUDA tensor, the plain version on a CPU tensor."""
    if q.device.type == "cpu":
        return paged_decode_plain(q, k_pages, v_pages, block_tables,
                                  seq_lens, scale)
    return paged_decode(q, k_pages, v_pages, block_tables, seq_lens, scale)


__all__ = ["sdpa_plain", "paged_decode_plain", "paged_decode_attention"]
