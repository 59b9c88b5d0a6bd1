"""Normalization ops (counterpart of ``paddle_tpu/ops/norm.py``).

``rms_norm`` runs the hand-written CUDA kernel on a CUDA tensor and the
plain PyTorch version on a CPU tensor; the plain version is also the
kernel's oracle.
"""

from __future__ import annotations

import torch

from .kernels.fused_norm import rms_norm_fwd


def _rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                    epsilon: float) -> torch.Tensor:
    """Copy of ``paddle_tpu.ops.norm._rms_norm_xla``: fp32 statistics,
    ``(x * rstd) * w`` in fp32, output cast to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + epsilon)
    return (out * weight.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dimension with a [D] weight."""
    if x.device.type == "cpu":
        return _rms_norm_plain(x, weight, epsilon)
    return rms_norm_fwd(x, weight, epsilon)[0]


__all__ = ["rms_norm"]
