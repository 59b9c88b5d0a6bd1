"""Parameter initializers drawing from an explicit ``torch.Generator``
(counterpart of ``paddle_tpu/nn/initializer.py`` ``Normal``/``Constant``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


class Normal:
    """Values drawn from N(mean, std) with the given generator."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = float(mean), float(std)

    def __call__(self, shape: Sequence[int], dtype: torch.dtype, device,
                 generator: Optional[torch.Generator]) -> torch.Tensor:
        t = torch.empty(tuple(shape), dtype=dtype, device=device)
        return t.normal_(self.mean, self.std, generator=generator)


class Constant:
    """Every value equal to ``value``."""

    def __init__(self, value: float = 0.0):
        self.value = float(value)

    def __call__(self, shape: Sequence[int], dtype: torch.dtype, device,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        return torch.full(tuple(shape), self.value, dtype=dtype,
                          device=device)


__all__ = ["Normal", "Constant"]
