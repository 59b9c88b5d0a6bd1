"""Launch wrappers of the RMSNorm kernels (``csrc/fused_norm.cu``).

Replace ``paddle_tpu/ops/pallas/fused_norm.py`` ``_fwd_kernel`` and
``_bwd_kernel``. The plain versions are ``ops.norm._rms_norm_fwd_plain``
and ``ops.norm._rms_norm_bwd_plain``; ``ops.norm.rms_norm`` chooses
between kernel and plain version by the tensor's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/fused_norm.cu"
REPLACES = "paddle_tpu/ops/pallas/fused_norm.py:43"
REPLACES_BWD = "paddle_tpu/ops/pallas/fused_norm.py:51"
# rows per block of the backward: at R = 8192 (2 x 4096 tokens) that is
# 256 blocks for 132 SMs and a 4 MB partial buffer at D = 4096
ROWS_PER_BLOCK = 32


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, epsilon: float,
                 return_rstd: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(y, rstd)``: y = x * rsqrt(mean(x^2) + eps) * weight over the last
    dimension, in x's dtype; rstd [R] fp32 when asked for, else None.

    x: CUDA, float32 or bfloat16, contiguous, any number of rows.
    weight: [D] float32 or bfloat16 on the same device, contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm kernel needs a CUDA tensor, got "
                         f"{x.device}")
    D = x.shape[-1]
    if weight.shape != (D,) or weight.device != x.device:
        raise ValueError(f"weight must be [{D}] on {x.device}, got "
                         f"{tuple(weight.shape)} on {weight.device}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel needs contiguous x and weight")
    xc, wc = _build.dtype_code(x.dtype), _build.dtype_code(weight.dtype)
    R = x.numel() // D if D else 0
    y = torch.empty_like(x)
    rstd = (torch.empty((R,), dtype=torch.float32, device=x.device)
            if return_rstd else None)
    if R == 0:
        return y, rstd
    vec8 = D % 8 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (x, weight, y))
    err = _build.lib().pt_rms_norm_fwd(
        x.data_ptr(), weight.data_ptr(), y.data_ptr(),
        rstd.data_ptr() if rstd is not None else None, R, D,
        float(epsilon), xc, wc, int(vec8), _build.stream_ptr(x.device))
    _build.check(err, "rms_norm")
    _build.count_launch("rms_norm")
    return y, rstd


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor,
                 dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of the RMSNorm forward, from the rstd [R] fp32 that it
    saved. dx has x's dtype; dw is the sum over rows of the kernel's
    per-block fp32 partials, taken outside the kernel and cast to the
    weight's dtype (as ``paddle_tpu``'s ``_rms_bwd_rule`` does).

    x, dy: CUDA, the same dtype (float32 or bfloat16) and shape,
    contiguous; weight [D]; rstd contiguous fp32 [R]."""
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_bwd kernel needs a CUDA tensor, got "
                         f"{x.device}")
    D = x.shape[-1]
    R = x.numel() // D if D else 0
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("dy must match x in shape, dtype and device")
    if weight.shape != (D,) or weight.device != x.device:
        raise ValueError(f"weight must be [{D}] on {x.device}")
    if (rstd.dtype != torch.float32 or rstd.shape != (R,)
            or rstd.device != x.device):
        raise ValueError(f"rstd must be fp32 [{R}] on {x.device}")
    if not all(t.is_contiguous() for t in (x, weight, rstd, dy)):
        raise ValueError("rms_norm_bwd kernel needs contiguous tensors")
    xc, wc = _build.dtype_code(x.dtype), _build.dtype_code(weight.dtype)
    dx = torch.empty_like(x)
    if R == 0:
        return dx, torch.zeros_like(weight)
    rows = ROWS_PER_BLOCK
    part = torch.empty((-(-R // rows), D), dtype=torch.float32,
                       device=x.device)
    vec8 = D % 8 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (x, weight, dy, dx))
    err = _build.lib().pt_rms_norm_bwd(
        x.data_ptr(), weight.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), part.data_ptr(), R, D, rows, xc, wc, int(vec8),
        _build.stream_ptr(x.device))
    _build.check(err, "rms_norm_bwd")
    _build.count_launch("rms_norm_bwd")
    return dx, part.sum(0).to(weight.dtype)


__all__ = ["rms_norm_fwd", "rms_norm_bwd", "SOURCE", "REPLACES",
           "REPLACES_BWD"]
