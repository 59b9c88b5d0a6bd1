"""Launch wrapper of the RMSNorm forward kernel (``csrc/fused_norm.cu``).

Replaces ``paddle_tpu/ops/pallas/fused_norm.py`` ``_fwd_kernel``. The
plain version is ``ops.norm._rms_norm_plain``; ``ops.norm.rms_norm``
chooses between the two by the tensor's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/fused_norm.cu"
REPLACES = "paddle_tpu/ops/pallas/fused_norm.py:43"


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


__all__ = ["rms_norm_fwd", "SOURCE", "REPLACES"]
