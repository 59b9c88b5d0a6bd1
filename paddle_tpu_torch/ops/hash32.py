"""32-bit unsigned hash arithmetic on int64 tensors, shared by the flash
dropout keep mask (``ops.attention``) and the sampler's random streams
(``inference.generation``). Values live in [0, 2**32) and every product
wraps around modulo 2**32, as uint32 arithmetic does."""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF


def mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32), in int64 steps that
    never overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


__all__ = ["M32", "mul32"]
