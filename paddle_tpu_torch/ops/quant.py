"""Weight-only int8 matrix product (counterpart of the registry op
``int8_matmul`` of ``paddle_tpu/ops/pallas/int8_matmul.py``).

``quantized_matmul`` is the one entry every int8 linear of the port goes
through: the CUDA kernel on a CUDA tensor, the plain version on a CPU
tensor. There is no other route: a CUDA tensor the kernel does not take
raises.
"""

from __future__ import annotations

import torch

from .kernels.int8_matmul import int8_matmul


def weight_only_plain(x: torch.Tensor, wq: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """Copy of ``paddle_tpu``'s ``xla_weight_only``: widen the int8
    weight (exact in bf16 and fp32), sum in fp32, multiply the fp32 SUM by
    the per-channel ``scale`` [n] (not the [n, k] weight), cast to x's
    dtype. x float [..., k]; wq int8 [n, k] → [..., n]. bf16 products of
    a bf16 value and an int8 value are exact in fp32, so widening both
    operands to fp32 gives the fp32-accumulated product."""
    acc = torch.matmul(x.float(), wq.float().t())
    return (acc * scale.float()).to(x.dtype)


def quantized_matmul(x: torch.Tensor, wq: torch.Tensor,
                     scale: torch.Tensor) -> torch.Tensor:
    """x float [..., k] · int8 wq [n, k] with per-channel fp32 ``scale``
    [n] → [..., n] in x's dtype. Leading dimensions are flattened to the
    kernel's m (any m, ragged included)."""
    if x.device.type == "cpu":
        return weight_only_plain(x, wq, scale)
    lead, k = x.shape[:-1], x.shape[-1]
    y = int8_matmul(x.reshape(-1, k).contiguous(), wq, scale)
    return y.reshape(*lead, wq.shape[0])


__all__ = ["weight_only_plain", "quantized_matmul"]
