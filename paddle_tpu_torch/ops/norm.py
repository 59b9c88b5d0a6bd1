"""Normalization ops (counterpart of ``paddle_tpu/ops/norm.py``).

``rms_norm`` runs the hand-written CUDA kernels on a CUDA tensor and the
plain PyTorch versions on a CPU tensor; the plain versions are also the
kernels' oracles. Under autograd it is a ``torch.autograd.Function``
whose forward saves the per-row rstd and whose backward is the backward
kernel (the plain backward on the CPU), as ``paddle_tpu``'s
``_rms_norm_p`` custom_vjp is on the TPU.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..analysis.collectives import kernel as _census
from ..device import plain_route as _plain
from .kernels.fused_norm import rms_norm_bwd, rms_norm_fwd


def _fwd_cost(x, weight):
    D = x.shape[-1]
    R = x.numel() // max(D, 1)
    return (4 * R * D, 2 * R * D * x.element_size()
            + D * weight.element_size() + R * 4)


def _bwd_cost(x, weight):
    D = x.shape[-1]
    R = x.numel() // max(D, 1)
    return (9 * R * D, 3 * R * D * x.element_size() + R * 4
            + 2 * D * weight.element_size())


def _rms_norm_plain(x: torch.Tensor, weight: torch.Tensor,
                    epsilon: float) -> torch.Tensor:
    """Copy of ``paddle_tpu.ops.norm._rms_norm_xla``: fp32 statistics,
    ``(x * rstd) * w`` in fp32, output cast to x's dtype."""
    return _rms_norm_fwd_plain(x, weight, epsilon)[0]


def _rms_norm_fwd_plain(x: torch.Tensor, weight: torch.Tensor,
                        epsilon: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(y, rstd)``: the forward kernel's arithmetic, rstd [R] fp32 over
    the rows of x flattened to [R, D]."""
    xf = x.float()
    rstd = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + epsilon)
    y = ((xf * rstd) * weight.float()).to(x.dtype)
    return y, rstd.reshape(-1)


def _rms_norm_bwd_plain(x: torch.Tensor, weight: torch.Tensor,
                        rstd: torch.Tensor, dy: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` from the formula of ``fused_norm._bwd_kernel``:
    xhat = x * rstd, wdy = dy * w, c = mean(wdy * xhat),
    dx = (wdy - xhat * c) * rstd in x's dtype, dw = sum over rows of
    dy * xhat in fp32, cast to the weight's dtype."""
    D = x.shape[-1]
    x2 = x.reshape(-1, D).float()
    dy2 = dy.reshape(-1, D).float()
    xhat = x2 * rstd.reshape(-1, 1)
    wdy = dy2 * weight.float()
    c = torch.mean(wdy * xhat, dim=-1, keepdim=True)
    dx = ((wdy - xhat * c) * rstd.reshape(-1, 1)).to(x.dtype)
    dw = torch.sum(dy2 * xhat, dim=0).to(weight.dtype)
    return dx.reshape(x.shape), dw


class _RMSNorm(torch.autograd.Function):
    """RMSNorm with its kernel backward; x [..., D], weight [D]."""

    @staticmethod
    def forward(ctx, x, weight, epsilon):
        with _census("rms_norm", _fwd_cost, x, weight):
            if _plain(x):
                y, rstd = _rms_norm_fwd_plain(x, weight, epsilon)
            else:
                x = x.contiguous()
                y, rstd = rms_norm_fwd(x, weight, epsilon, return_rstd=True)
        ctx.save_for_backward(x, weight, rstd)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, rstd = ctx.saved_tensors
        with _census("rms_norm_bwd", _bwd_cost, x, weight):
            if _plain(x):
                dx, dw = _rms_norm_bwd_plain(x, weight, rstd, dy)
            else:
                dx, dw = rms_norm_bwd(x, weight, rstd, dy.contiguous())
        return dx, dw, None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             epsilon: float = 1e-6) -> torch.Tensor:
    """RMS norm over the last dimension with a [D] weight. Where autograd
    records (grad mode on and an input that needs a gradient) it goes
    through :class:`_RMSNorm`; otherwise straight to the forward."""
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        return _RMSNorm.apply(x, weight, epsilon)
    with _census("rms_norm", _fwd_cost, x, weight):
        if _plain(x):
            return _rms_norm_plain(x, weight, epsilon)
        return rms_norm_fwd(x.contiguous(), weight, epsilon)[0]


__all__ = ["rms_norm"]
