"""Layers (counterpart of ``paddle_tpu/nn/common.py``)."""

from __future__ import annotations

import torch
from torch import nn

from ..device import dtype_of, resolve_device
from ..ops.norm import rms_norm
from .initializer import Constant


class RMSNorm(nn.Module):
    """RMS norm over the last dimension with a learned [hidden] weight
    (ones at construction). The weight keeps its own dtype (Llama keeps
    it fp32 under bf16 activations); the output has the input's dtype."""

    def __init__(self, hidden_size: int, epsilon: float = 1e-6,
                 device=None, dtype="float32"):
        super().__init__()
        self.hidden_size = hidden_size
        self.epsilon = epsilon
        self.weight = nn.Parameter(Constant(1.0)(
            [hidden_size], dtype_of(dtype), resolve_device(device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.epsilon)


__all__ = ["RMSNorm"]
