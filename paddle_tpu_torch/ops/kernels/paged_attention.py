"""Launch wrapper of the paged decode attention kernel
(``csrc/paged_attention.cu``).

Replaces ``paddle_tpu/ops/pallas/paged_attention.py`` ``_decode_kernel``,
for native (float) pools and for int8 pools with per-page fp32 scales
(its ``quant`` branch). The plain version is
``ops.attention.paged_decode_plain``; ``ops.attention.
paged_decode_attention`` chooses between the two by the tensor's device.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/paged_attention.cu"
REPLACES = "paddle_tpu/ops/pallas/paged_attention.py:47"
GROUPS = (1, 2, 4, 8)
HEAD_DIMS = (64, 128, 256)


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
    if Dk != D or H % H_kv or H // H_kv not in GROUPS or D not in HEAD_DIMS:
        raise ValueError(f"unsupported shapes: H={H}, H_kv={H_kv}, D={D} "
                         f"(group in {GROUPS}, D in {HEAD_DIMS})")
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
    err = _build.lib().pt_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), ks, vs,
        block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(), B, H,
        H_kv, D, num_pages, page_size, block_tables.shape[1], scale, code,
        _build.stream_ptr(q.device))
    name = "paged_decode_int8" if quant else "paged_decode"
    _build.check(err, name)
    _build.count_launch(name)
    return out


__all__ = ["paged_decode", "SOURCE", "REPLACES"]
