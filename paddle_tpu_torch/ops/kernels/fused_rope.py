"""Launch wrapper of the fused RoPE kernel (``csrc/fused_rope.cu``).

Replaces ``paddle_tpu/ops/pallas/fused_rope.py`` ``_rope_kernel``. The
plain version is ``ops.rope._rope_plain``; ``ops.rope.
apply_rotary_pos_emb`` chooses between the two by the tensor's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/fused_rope.cu"
REPLACES = "paddle_tpu/ops/pallas/fused_rope.py:37"


def fused_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q [b, s, h, d] and k [b, s, hk, d] (neox half-split form)
    by the rows of the fp32 tables cos/sin [max_pos, d] at ``positions``
    [b, s] int64 (0..s-1 when None). Returns new contiguous (q, k).

    q and k may be strided views (the split of a fused qkv projection):
    only their last dimension must be contiguous; they are read in place."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_rope kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q and k must be [b, s, heads, d]")
    b, s, h, d = q.shape
    hk = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or d % 2:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"share b, s and an even d")
    if k.dtype != q.dtype or k.device != q.device:
        raise ValueError("q and k must share dtype and device")
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError("q and k need a contiguous last dimension")
    for name, t in (("cos", cos), ("sin", sin)):
        if (t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous() or t.dim() != 2
                or t.shape[1] != d):
            raise ValueError(f"{name} must be a contiguous fp32 [max_pos, "
                             f"{d}] table on {q.device}")
    if cos.shape != sin.shape:
        raise ValueError("cos and sin tables differ in shape")
    if positions is not None and (
            positions.dtype != torch.int64 or positions.shape != (b, s)
            or not positions.is_contiguous()
            or positions.device != q.device):
        raise ValueError(f"positions must be contiguous int64 [{b}, {s}] "
                         f"on {q.device}")
    code = _build.dtype_code(q.dtype)
    qo = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    ko = torch.empty((b, s, hk, d), dtype=k.dtype, device=k.device)
    if b * s == 0:
        return qo, ko
    err = _build.lib().pt_fused_rope(
        q.data_ptr(), k.data_ptr(), qo.data_ptr(), ko.data_ptr(),
        cos.data_ptr(), sin.data_ptr(),
        positions.data_ptr() if positions is not None else None,
        b, s, h, hk, d, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2), cos.shape[0], code,
        _build.stream_ptr(q.device))
    _build.check(err, "fused_rope")
    _build.count_launch("fused_rope")
    return qo, ko


__all__ = ["fused_rope", "SOURCE", "REPLACES"]
