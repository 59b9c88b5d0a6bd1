"""Launch wrapper of the paged decode attention kernel
(``csrc/paged_attention.cu``).

Replaces ``paddle_tpu/ops/pallas/paged_attention.py`` ``_decode_kernel``,
for native (float) pools and for int8 pools with per-page fp32 scales
(its ``quant`` branch). The plain version is
``ops.attention.paged_decode_plain``; ``ops.attention.
paged_decode_attention`` chooses between the two by the tensor's device.

The kernel splits each sequence's context over blocks (:func:`split_plan`,
a function of shapes alone) and merges the splits' fp32 partials on the
device in split order (:func:`merge_splits` is that merge in plain
PyTorch).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:47"
# head dims the kernel takes (the JAX gate ``paged_decode_supported``'s);
# every group H % H_kv == 0 is taken
HEAD_DIMS = (32, 64, 128, 256)
# query rows a block holds at most: a larger group is cut into slices
MAX_SLICE = 8
# blocks an SM that the plan aims at for full tables (it gets at least
# half as many; four blocks of 48 KB fit an SM at once)
BLOCKS_PER_SM = 8
# most tokens one split walks, so that long tables still give short,
# many splits (each block's time stays small beside the merge)
SPLIT_TOKENS = 512
# most splits a (row, KV head, slice): the kernel's merge keeps each
# split's (m, l) in shared memory
MAX_SPLITS = 512

_PLANS: Dict[tuple, Tuple[int, int, int, int]] = {}


def group_slice(group: int) -> Tuple[int, int]:
    """``(gs, slices)``: a group of query rows over one KV head is held
    ``gs`` rows a block (1, 2, 4 or 8), in ``slices`` blocks."""
    if group < 1:
        raise ValueError(f"group must be positive, got {group}")
    gs = 1 << (min(group, MAX_SLICE) - 1).bit_length()
    return gs, -(-group // gs)


def split_plan(b: int, h_kv: int, slices: int, max_pages: int,
               page_size: int, sms: int) -> Tuple[int, int]:
    """``(pps, splits)``: each (row, KV head, group slice) is cut into
    ``splits`` splits of ``pps`` consecutive table pages (the last may
    hold fewer), from shapes alone, never from the sequence lengths (a
    device tensor): at least half of :data:`BLOCKS_PER_SM` blocks an SM
    when the tables are full (or every page its own split), at most
    :data:`SPLIT_TOKENS` tokens a split unless a page holds more or the
    table would need more than :data:`MAX_SPLITS` splits."""
    pairs = max(1, b * h_kv * slices)
    want = max(1, -(-BLOCKS_PER_SM * sms // pairs))
    pps = -(-max_pages // want)
    pps = max(1, min(pps, SPLIT_TOKENS // page_size),
              -(-max_pages // MAX_SPLITS))
    return pps, -(-max_pages // pps)


def merge_splits(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor
                 ) -> torch.Tensor:
    """The kernel's merge in plain PyTorch: splits' running maxima m
    [..., S], sums l [..., S] and unnormalised outputs acc [..., S, D]
    (S in split order) into softmax(.) V [..., D], fp32, as one pass over
    all the splits' tokens gives it. A split whose m is -1e30 (no token)
    weighs 0."""
    top = m.max(-1, keepdim=True).values
    f = torch.exp(m - top)
    total = (l * f).sum(-1)
    out = (acc * f[..., None]).sum(-2)
    return out / torch.where(total == 0.0, 1.0, total)[..., None]


def _plan(device: torch.device, b: int, h_kv: int, group: int,
          max_pages: int, page_size: int) -> Tuple[int, int, int, int]:
    """``(gs, slices, pps, splits)`` of a launch, kept by shape (the
    decode step asks the same 32 times)."""
    key = (device.index, b, h_kv, group, max_pages, page_size,
           BLOCKS_PER_SM, SPLIT_TOKENS)
    plan = _PLANS.get(key)
    if plan is None:
        gs, slices = group_slice(group)
        plan = (gs, slices) + split_plan(b, h_kv, slices, max_pages,
                                         page_size,
                                         _build.sm_count(device))
        _PLANS[key] = plan
    return plan


def paged_decode(q: torch.Tensor, k_pages: torch.Tensor,
                 v_pages: torch.Tensor, block_tables: torch.Tensor,
                 seq_lens: torch.Tensor,
                 scale: Optional[float] = None,
                 k_scales: Optional[torch.Tensor] = None,
                 v_scales: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step of attention over head-major page pools.

    q [B, H, D]; k/v_pages [H_kv, num_pages, page_size, D] of q's dtype,
    or int8 with ``k_scales``/``v_scales`` [num_pages] float32 (both or
    neither; a page reads as its codes times its scale);
    block_tables [B, max_pages] int32 (entries < 0 read page 0);
    seq_lens [B] int64 — row b attends positions 0..seq_lens[b]
    inclusive. All on one CUDA device and contiguous. Returns [B, H, D].
    Counts its launches under ``paged_decode`` (native pools) or
    ``paged_decode_int8``."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode kernel needs CUDA tensors, got "
                         f"{q.device}")
    if (k_scales is None) != (v_scales is None):
        raise ValueError("k_scales and v_scales must be given together")
    quant = k_scales is not None
    if q.dim() != 3 or k_pages.dim() != 4 or v_pages.shape != k_pages.shape:
        raise ValueError("q must be [B, H, D] and the pools "
                         "[H_kv, num_pages, page_size, D], both alike")
    B, H, D = q.shape
    H_kv, num_pages, page_size, Dk = k_pages.shape
    if Dk != D or H_kv < 1 or H % H_kv or D not in HEAD_DIMS:
        raise ValueError(f"unsupported shapes: H={H}, H_kv={H_kv}, D={D} "
                         f"(H a multiple of H_kv, D in {HEAD_DIMS})")
    scales = (k_scales, v_scales) if quant else ()
    for t in (k_pages, v_pages, block_tables, seq_lens) + scales:
        if t.device != q.device:
            raise ValueError("all inputs must be on one device")
    pool_dtype = torch.int8 if quant else q.dtype
    if k_pages.dtype != pool_dtype or v_pages.dtype != pool_dtype:
        raise ValueError(f"pools must be {pool_dtype} (q's dtype, or int8 "
                         f"with k_scales and v_scales), got "
                         f"{k_pages.dtype} and {v_pages.dtype}")
    for t in scales:
        if t.dtype != torch.float32 or t.shape != (num_pages,):
            raise ValueError(f"page scales must be float32 [{num_pages}]")
    if block_tables.dtype != torch.int32 or block_tables.dim() != 2 \
            or block_tables.shape[0] != B:
        raise ValueError(f"block_tables must be int32 [{B}, max_pages]")
    if seq_lens.dtype != torch.int64 or seq_lens.shape != (B,):
        raise ValueError(f"seq_lens must be int64 [{B}]")
    if not all(t.is_contiguous() for t in (q, k_pages, v_pages,
                                            block_tables, seq_lens)
               + scales):
        raise ValueError("paged_decode kernel needs contiguous inputs")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged_decode kernel needs 16-byte aligned pools")
    code = _build.dtype_code(q.dtype)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(D)
    out = torch.empty_like(q)
    if B == 0:
        return out
    ks, vs = (k_scales.data_ptr(), v_scales.data_ptr()) if quant \
        else (None, None)
    max_pages = block_tables.shape[1]
    gs, slices, pps, splits = _plan(q.device, B, H_kv, H // H_kv,
                                    max_pages, page_size)
    pairs = B * H_kv * slices
    part = (torch.empty((pairs * splits * gs * (D + 2),),
                        dtype=torch.float32, device=q.device)
            if splits > 1 else None)
    stream = _build.stream_ptr(q.device)
    tickets = _build.tickets(q.device, stream, pairs)
    err = _build.lib().pt_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, tickets.data_ptr(),
        B, H, H_kv, D, num_pages, page_size, max_pages, gs, pps, scale, code,
        stream)
    name = "paged_decode_int8" if quant else "paged_decode"
    _build.check(err, name)
    _build.count_launch(name)
    return out


__all__ = ["paged_decode", "split_plan", "group_slice", "merge_splits",
           "SOURCE", "REPLACES", "HEAD_DIMS"]
