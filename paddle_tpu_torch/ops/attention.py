"""Attention ops (counterpart of ``paddle_tpu/ops/attention.py``, the
plain halves of ``paddle_tpu/ops/pallas/flash_attention.py`` and
``paddle_tpu/ops/pallas/paged_attention.py``).

Layouts follow the JAX package: q [batch, q_seq, heads, d], k/v
[batch, kv_seq, kv_heads, d] (GQA when kv_heads < heads); paged pools
are head-major [kv_heads, num_pages, page_size, d].
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..analysis.collectives import kernel as _census
from ..device import plain_route as _plain

from .kernels.flash_attention import dropout_threshold, flash_bwd, flash_fwd
from .hash32 import M32, mul32
from .kernels.paged_attention import paged_decode

NEG_INF = -1e30   # the flash kernels' mask value (no inf - inf = nan)


def _expand_kv(k: torch.Tensor, heads: int) -> torch.Tensor:
    """[b, s, kvh, d] -> [b, s, heads, d] by repeating each kv head."""
    kvh = k.shape[2]
    return k if kvh == heads else torch.repeat_interleave(
        k, heads // kvh, dim=2)


def _allowed(b: int, sq: int, sk: int, causal: bool,
             q_seg: Optional[torch.Tensor], kv_seg: Optional[torch.Tensor],
             device) -> Optional[torch.Tensor]:
    """Boolean [b or 1, 1, sq, sk] of the (query, key) pairs that may
    attend: the bottom-right causal mask and equal segment ids; None when
    every pair may."""
    mask = None
    if causal:
        qi = torch.arange(sq, device=device)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=device)[None, :]
        mask = (ki <= qi)[None, None]
    if q_seg is not None:
        seg = (q_seg[:, :, None] == kv_seg[:, None, :])[:, None]
        mask = seg if mask is None else mask & seg
    return mask


def sdpa_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               causal: bool = True, scale: Optional[float] = None,
               segment_ids=None, attn_mask: Optional[torch.Tensor] = None,
               dropout_p: float = 0.0, dropout_seed: int = 0
               ) -> torch.Tensor:
    """Copy of ``paddle_tpu.ops.attention._sdpa_xla``: fp32 scores,
    bottom-right causal mask, segment ids ([b, s] or a (q_seg, kv_seg)
    pair), a dense ``attn_mask`` broadcast to [b, h, sq, sk] (boolean:
    keep where True; otherwise added to the fp32 scores), fp32 softmax,
    probabilities cast to v's dtype before the weighted sum, output in
    q's dtype. ``dropout_p`` > 0 drops probabilities with the flash
    kernels' keep mask of ``dropout_seed`` (the port has no global random
    stream). The serving prefill runs this on the card as well: in the
    JAX package it is outside every Pallas kernel."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    k = _expand_kv(k, h)
    v = _expand_kv(v, h)
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_seg, kv_seg = _segments(segment_ids)
    mask = _allowed(b, sq, sk, causal, q_seg, kv_seg, q.device)
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    if attn_mask is not None:
        if attn_mask.dtype == torch.bool:
            logits = logits.masked_fill(~attn_mask, float("-inf"))
        else:
            logits = logits + attn_mask.to(logits.dtype)
    probs = torch.softmax(logits, dim=-1)
    if dropout_p > 0.0:
        keep = dropout_keep_plain(dropout_seed, b, h, sq, sk, dropout_p,
                                  q.device)
        probs = torch.where(keep, probs / (1.0 - dropout_p), 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def paged_decode_plain(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       seq_lens: torch.Tensor,
                       scale: Optional[float] = None,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Copy of ``paddle_tpu.ops.pallas.paged_attention.paged_decode_xla``:
    gather the whole table, attend positions 0..seq_lens[b] inclusive with
    an fp32 softmax. Int8 pools come with ``k_scales``/``v_scales``
    [num_pages] fp32 (both or neither) and are dequantized in the gather:
    widened to fp32 and multiplied by their page's scale. Table entries
    are clamped into the pool, as a JAX gather clamps."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    B, H, D = q.shape
    H_kv, num_pages, page_size, _ = k_pages.shape
    T = block_tables.shape[1] * page_size
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    safe = block_tables.long().clamp(0, num_pages - 1)

    def gather(pages, pscales):
        g = pages[:, safe]                       # [H_kv, B, mp, page, D]
        if pscales is not None:
            g = g.float() * pscales.float()[safe][None, :, :, None, None]
        g = g.reshape(H_kv, B, T, D).movedim(0, 2)
        return torch.repeat_interleave(g, H // H_kv, dim=2)
    ks, vs = gather(k_pages, k_scales), gather(v_pages, v_scales)
    lg = torch.einsum("bhd,bthd->bht", q.float(), ks.float()) * scale
    valid = (torch.arange(T, device=q.device)[None, None, :]
             <= seq_lens.to(q.device).long()[:, None, None])
    p = torch.softmax(lg.masked_fill(~valid, float("-inf")), dim=-1)
    out = torch.einsum("bht,bthd->bhd", p, vs.float())
    return out.to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, block_tables, seq_lens,
                           scale: Optional[float] = None,
                           k_scales: Optional[torch.Tensor] = None,
                           v_scales: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """One-token decode attention over paged pools, native or int8 with
    per-page scales: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if _plain(q):
        return paged_decode_plain(q, k_pages, v_pages, block_tables,
                                  seq_lens, scale, k_scales, v_scales)
    return paged_decode(q, k_pages, v_pages, block_tables, seq_lens, scale,
                        k_scales, v_scales)


# -- the dense decode route and the dense/paged crossover --------------------

def paged_decode_dense(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, block_tables: torch.Tensor,
                       seq_lens: torch.Tensor,
                       scale: Optional[float] = None,
                       k_scales: Optional[torch.Tensor] = None,
                       v_scales: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """The dense decode route (counterpart of JAX's ``paged_decode_xla``
    where the engine picks it below the crossover): gather every page of
    each row's table into contiguous fp32 K/V [B, H_kv, T, D], int8 pages
    dequantized with their page's scale, then fp32 attention over
    positions 0..seq_lens[b] through ``F.scaled_dot_product_attention``,
    the query heads of one KV head taken as its rows (K/V never
    expanded). The same function on every device; the output is in q's
    dtype."""
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    B, H, D = q.shape
    H_kv, num_pages, page_size, _ = k_pages.shape
    T = block_tables.shape[1] * page_size
    flat = block_tables.long().clamp(0, num_pages - 1).reshape(-1)

    def gather(pages, pscales):
        g = pages[:, flat].float()               # [H_kv, B * mp, page, D]
        if pscales is not None:
            g.mul_(pscales.float()[flat][None, :, None, None])
        return g.view(H_kv, B, T, D).transpose(0, 1)
    k, v = gather(k_pages, k_scales), gather(v_pages, v_scales)
    valid = (torch.arange(T, device=q.device)[None, :]
             <= seq_lens.to(q.device).long()[:, None])          # [B, T]
    out = F.scaled_dot_product_attention(
        q.float().view(B, H_kv, H // H_kv, D), k, v,
        attn_mask=valid[:, None, None, :],
        scale=scale if scale is not None else 1.0 / math.sqrt(D))
    return out.reshape(B, H, D).to(q.dtype)


_FORCED_IMPL = [None]     # None: the paged kernel; "dense" | "paged"


class force_decode_impl:
    """Scope that picks the decode attention route of
    ``LlamaAttention.decode_paged`` (counterpart of JAX's
    ``force_decode_impl``): ``"dense"`` takes :func:`paged_decode_dense`,
    ``"paged"`` or None :func:`paged_decode_attention`. The serving
    engine enters it around each decode block with the route its
    crossover chose."""

    def __init__(self, impl):
        if impl not in (None, "dense", "paged"):
            raise ValueError(f"impl must be None|'dense'|'paged', "
                             f"got {impl!r}")
        self.impl = impl

    def __enter__(self):
        _FORCED_IMPL.append(self.impl)
        return self

    def __exit__(self, *exc):
        _FORCED_IMPL.pop()
        return False


def forced_decode_impl():
    return _FORCED_IMPL[-1]


def paged_decode_crossover() -> int:
    """Context length (tokens) at or below which the serving engine
    decodes through the dense route, the paged kernel above it. 0: the
    paged kernel at every context. Measured by ``chip_smoke.py``'s phase
    3c on an NVIDIA H100 80GB HBM3 at a 700.00 W limit, at Llama-3-8B
    widths, B = 8, contexts 128 to 8192, native and int8 pools: the two
    routes differ only in the attention, and one layer's attention on
    the device was faster through the paged kernel at every context
    (native 13.1 against 79.0 µs at 128, 123.4 against 1889.7 µs at
    8192; int8 13.7 against 95.4 and 93.3 against 2300.7 µs). The whole
    decode step is host-bound there, so its times do not decide it. The
    dense route runs only where a caller asks for it
    (``attn_crossover=``). The JAX package's TuneDB lookup is not
    ported."""
    return 0


# -- flash attention ---------------------------------------------------------

def dropout_keep_plain(seed: int, b: int, h: int, sq: int, sk: int,
                       dropout_p: float, device) -> torch.Tensor:
    """Boolean keep mask [b, h, sq, sk] of ``paddle_tpu``'s
    ``flash_attention._dropout_keep``, bit for bit: the murmur3
    finalizer of (q_pos * sk + k_pos) ^ (seed * 0x9E3779B1 + batch *
    0x85EBCA77 + head * 0xC2B2AE3D), all in uint32 arithmetic (here int64
    tensors masked to 32 bits), kept where >= the threshold of p."""
    qi = torch.arange(sq, dtype=torch.int64, device=device)[:, None]
    ki = torch.arange(sk, dtype=torch.int64, device=device)[None, :]
    cell = (mul32(qi, sk) + ki) & M32                        # [sq, sk]
    bi = torch.arange(b, dtype=torch.int64, device=device)
    hi = torch.arange(h, dtype=torch.int64, device=device)
    key = (mul32(torch.full((), int(seed) & M32, dtype=torch.int64,
                             device=device), 0x9E3779B1)
           + mul32(bi, 0x85EBCA77)[:, None]
           + mul32(hi, 0xC2B2AE3D)[None, :]) & M32          # [b, h]
    x = cell[None, None] ^ key[:, :, None, None]
    x = x ^ (x >> 16)
    x = mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= dropout_threshold(dropout_p)


def _masked_scores(q, k, causal, scale, q_seg, kv_seg):
    """fp32 scores [b, h, sq, sk] with forbidden pairs at NEG_INF."""
    b, sq, h, _ = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _expand_kv(k, h).float()) * scale
    mask = _allowed(b, sq, k.shape[1], causal, q_seg, kv_seg, q.device)
    return s if mask is None else s.masked_fill(~mask, NEG_INF)


def _flash_fwd_plain(q, k, v, causal: bool, scale: float, q_seg=None,
                     kv_seg=None, dropout_p: float = 0.0, seed: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out, lse)`` from the formula of ``flash_attention._fwd_kernel``
    over the whole row at once: m = row max of the masked scores, p =
    exp(s - m) with masked entries exactly 0, l = sum p (before dropout),
    kept p scaled by 1/(1 - dropout_p), P cast to v's dtype for P.V in
    fp32, out = (P.V) / l with l = 0 -> 1 (a fully masked row gives out
    = 0 and lse = m), lse = m + log(l) [b, h, sq] fp32."""
    b, sq, h, _ = q.shape
    s = _masked_scores(q, k, causal, scale, q_seg, kv_seg)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    safe_l = torch.where(l == 0.0, 1.0, l)
    if dropout_p > 0.0:
        keep = dropout_keep_plain(seed, b, h, sq, k.shape[1], dropout_p,
                                  q.device)
        p = torch.where(keep, p / (1.0 - dropout_p), 0.0)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                       _expand_kv(v, h).float())
    out = (acc / safe_l).to(q.dtype).transpose(1, 2).contiguous()
    return out, (m + torch.log(safe_l)).squeeze(-1)


def _flash_bwd_plain(q, k, v, dout, lse, delta, causal: bool, scale: float,
                     q_seg=None, kv_seg=None, dropout_p: float = 0.0,
                     seed: int = 0):
    """``(dq, dk, dv)`` from the formulas of ``_bwd_dq_kernel`` and
    ``_bwd_dkv_kernel``: p = exp(s - lse) (masked entries 0), dp = dO.V,
    with dropout p_drop / dp kept and scaled by 1/(1 - dropout_p),
    ds = p * (dp - delta) * scale; dq = ds (cast to k's dtype) . K,
    dv = p_drop^T (cast to dO's dtype) . dO and dk = ds^T (cast to q's
    dtype) . Q, summed in fp32 over each KV head's query-head group."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    s = _masked_scores(q, k, causal, scale, q_seg, kv_seg)
    p = torch.where(s <= NEG_INF * 0.5, 0.0, torch.exp(s - lse[..., None]))
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(),
                      _expand_kv(v, h).float())
    pd = p
    if dropout_p > 0.0:
        keep = dropout_keep_plain(seed, b, h, sq, sk, dropout_p, q.device)
        inv = 1.0 / (1.0 - dropout_p)
        pd = torch.where(keep, p * inv, 0.0)
        dp = torch.where(keep, dp * inv, 0.0)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      _expand_kv(k, h).float()).to(q.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", pd.to(dout.dtype).float(),
                      dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dk = dk.reshape(b, sk, hk, h // hk, d).sum(3).to(k.dtype)
    dv = dv.reshape(b, sk, hk, h // hk, d).sum(3).to(v.dtype)
    return dq, dk, dv


def _flash_cost(q, k, causal: bool, backward: bool):
    """(flops, bytes) of one flash launch on q [b, sq, h, d] and
    k [b, sk, hk, d]: 2 products forward and 5 backward, 2d each a
    (query, key) pair attended; q, k, v, out (and dout, dq, dk, dv) and
    the fp32 lse (and delta) rows once each."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    pairs = (b * h * sq * (sq + 1) // 2 if causal and sq == sk
             else b * h * sq * sk)
    qb, kvb = b * sq * h * d * q.element_size(), b * sk * hk * d * \
        k.element_size()
    rowb = b * h * sq * 4
    if backward:
        return 10 * d * pairs, 3 * qb + 4 * kvb + 2 * rowb
    return 4 * d * pairs, 2 * qb + 2 * kvb + rowb


class _FlashAttention(torch.autograd.Function):
    """Flash attention with its kernel backward: the forward saves
    (q, k, v, out, lse); the backward takes delta = rowsum(out * dout) in
    fp32 as a torch expression (XLA computes it outside the kernels in
    the JAX package too), then the backward kernel. CPU tensors take the
    plain versions through the same wiring."""

    @staticmethod
    def forward(ctx, q, k, v, q_seg, kv_seg, causal, scale, dropout_p,
                seed):
        with _census("flash_fwd", _flash_cost, q, k, causal, False):
            if _plain(q):
                out, lse = _flash_fwd_plain(q, k, v, causal, scale, q_seg,
                                            kv_seg, dropout_p, seed)
            else:
                out, lse = flash_fwd(q, k, v, causal, scale, q_seg, kv_seg,
                                     dropout_p, seed)
        ctx.save_for_backward(q, k, v, out, lse, q_seg, kv_seg)
        ctx.args = (causal, scale, dropout_p, seed)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_seg, kv_seg = ctx.saved_tensors
        causal, scale, dropout_p, seed = ctx.args
        dout = dout.contiguous()
        delta = (out.float() * dout.float()).sum(-1).transpose(
            1, 2).contiguous()                                  # [b, h, sq]
        args = (causal, scale, q_seg, kv_seg, dropout_p, seed)
        with _census("flash_bwd", _flash_cost, q, k, causal, True):
            if _plain(q):
                dq, dk, dv = _flash_bwd_plain(q, k, v, dout, lse, delta,
                                              *args)
            else:
                dq, dk, dv = flash_bwd(q, k, v, dout, lse, delta, *args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_fwd_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, causal: bool,
                    q_seg: Optional[torch.Tensor] = None,
                    kv_seg: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One (query block, key block) pair of flash attention: ``(out [b,
    sq, h, d] in q's dtype, lse [b, h, sq] fp32)`` (counterpart of
    ``flash_fwd_block`` in ``paddle_tpu/ops/pallas/flash_attention.py``,
    the ring's building block). ``q_seg`` [b, sq] / ``kv_seg`` [b, sk]
    restrict attention to equal ids; a row with no allowed key in this
    block comes back with out = 0 and lse = -1e30 (NEG_INF), which the
    ring's merge weighs as zero. The kernel on CUDA tensors, the plain
    version on CPU tensors; no gradient is recorded."""
    q_seg, kv_seg = _segments((q_seg, kv_seg) if q_seg is not None
                              else None)
    with _census("flash_fwd", _flash_cost, q, k, causal, False):
        if _plain(q):
            return _flash_fwd_plain(q, k, v, causal, scale, q_seg, kv_seg)
        return flash_fwd(q, k, v, causal, scale, q_seg, kv_seg)


def flash_bwd_block(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    out: torch.Tensor, lse: torch.Tensor,
                    dout: torch.Tensor, scale: float, causal: bool,
                    q_seg: Optional[torch.Tensor] = None,
                    kv_seg: Optional[torch.Tensor] = None,
                    delta: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq, dk, dv)`` of one block pair given the GLOBAL ``out`` and
    ``lse`` of the whole attention (counterpart of JAX's
    ``flash_bwd_block``): ``delta = rowsum(out * dout)`` [b, h, sq] is
    taken in fp32 here, as there (a caller that has it passes
    ``delta``), then the backward kernel, or its plain version on CPU
    tensors."""
    q_seg, kv_seg = _segments((q_seg, kv_seg) if q_seg is not None
                              else None)
    dout = dout.contiguous()
    if delta is None:
        delta = (out.float() * dout.float()).sum(-1).transpose(
            1, 2).contiguous()
    lse = lse.contiguous()
    with _census("flash_bwd", _flash_cost, q, k, causal, True):
        if _plain(q):
            return _flash_bwd_plain(q, k, v, dout, lse, delta, causal,
                                    scale, q_seg, kv_seg)
        return flash_bwd(q, k, v, dout, lse, delta, causal, scale, q_seg,
                         kv_seg)


def _segments(segment_ids):
    """[b, s] ids or a (q_seg, kv_seg) pair → two int32 tensors or
    (None, None)."""
    if segment_ids is None:
        return None, None
    if isinstance(segment_ids, (tuple, list)):
        q_seg, kv_seg = segment_ids
    else:
        q_seg = kv_seg = segment_ids
    return (q_seg.to(torch.int32).contiguous(),
            kv_seg.to(torch.int32).contiguous())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    attn_mask=None, dropout_p: float = 0.0,
                    causal: bool = False, scale: Optional[float] = None,
                    segment_ids=None,
                    dropout_seed: Optional[int] = None) -> torch.Tensor:
    """Counterpart of ``paddle_tpu.ops.attention.flash_attention`` (and
    ``flash_attention_pallas``): q [b, sq, h, d], k/v [b, sk, hk, d] →
    [b, sq, h, d] in q's dtype. The CUDA kernels on CUDA tensors,
    their plain versions on CPU tensors, through one autograd.Function.

    ``segment_ids`` ([b, s] ints, or a (q_seg, kv_seg) pair) restricts
    attention to equal ids. ``dropout_p`` > 0 drops inside the kernels
    with the keep mask of ``dropout_seed``, which is required: the port
    has no global random stream. A dense ``attn_mask`` (boolean, or
    added to the scores) goes to :func:`sdpa_plain` on every device, as
    the JAX dispatch sends it to ``_sdpa_xla``: no kernel of the JAX
    package takes one. ``causal`` with sq > sk raises
    NotImplementedError (``_sdpa_xla`` gives rows of NaN there)."""
    if causal and q.shape[1] > k.shape[1]:
        raise NotImplementedError("causal attention with sq > sk leaves "
                                  "query rows with no key")
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    if dropout_p > 0.0 and dropout_seed is None:
        raise ValueError("dropout_p > 0 needs an explicit dropout_seed")
    q_seg, kv_seg = _segments(segment_ids)
    if q_seg is not None and (q_seg.shape != q.shape[:2]
                              or kv_seg.shape != k.shape[:2]):
        raise ValueError(f"segment_ids shapes {tuple(q_seg.shape)}/"
                         f"{tuple(kv_seg.shape)} do not match q "
                         f"{tuple(q.shape)} and k {tuple(k.shape)}")
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if attn_mask is not None:
        return sdpa_plain(q, k, v, causal, scale, segment_ids, attn_mask,
                          dropout_p, int(dropout_seed or 0))
    return _FlashAttention.apply(q, k, v, q_seg, kv_seg, bool(causal),
                                 float(scale), float(dropout_p),
                                 int(dropout_seed or 0))


__all__ = ["sdpa_plain", "paged_decode_plain", "paged_decode_attention",
           "paged_decode_dense", "force_decode_impl", "forced_decode_impl",
           "paged_decode_crossover", "flash_attention", "dropout_keep_plain",
           "flash_fwd_block", "flash_bwd_block"]
