"""Gradient clipping (counterpart of ``paddle_tpu/optimizer/clip.py``).

Each clip takes a dict name → gradient and returns the clipped dict.
Norms are taken in fp32. The tensors are clipped IN PLACE (the JAX
package returns new arrays) so that a step holds one copy of the
gradients; a bf16 gradient is scaled in fp32 and rounded once, as there.

On a device mesh each rank holds local shards: a clip called with the
model's ``plan`` (``parallel.api.MeshPlan``, the optimizer passes its
own) takes the norms of the GLOBAL gradients, each element counted once
(the plan sums squares over the shards and counts a replicated
parameter on one rank).
"""

from __future__ import annotations

from typing import Dict

import torch

Grads = Dict[str, torch.Tensor]


class ClipGradBase:
    def __call__(self, grads: Grads, plan=None) -> Grads:
        raise NotImplementedError


def _scale_(g: torch.Tensor, factor: torch.Tensor) -> None:
    """g = (g in fp32 * factor) cast back to g's dtype, in place."""
    g.copy_(g.float() * factor)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max: float, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def __call__(self, grads: Grads, plan=None) -> Grads:
        for g in grads.values():
            g.clamp_(self.min, self.max)
        return grads


class ClipGradByNorm(ClipGradBase):
    """Per-tensor norm clip."""

    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def __call__(self, grads: Grads, plan=None) -> Grads:
        for name, g in grads.items():
            norm = torch.sqrt(plan.tensor_sq(name, g) if plan is not None
                              else torch.sum(torch.square(g.float())))
            factor = torch.clamp_max(
                self.clip_norm / torch.clamp_min(norm, 1e-12), 1.0)
            _scale_(g, factor)
        return grads


class ClipGradByGlobalNorm(ClipGradBase):
    def __init__(self, clip_norm: float):
        self.clip_norm = float(clip_norm)

    def global_norm(self, grads: Grads, plan=None) -> torch.Tensor:
        """sqrt of the fp32 sum of squares of every gradient: a 0-d
        tensor on the gradients' device (no host sync)."""
        if plan is not None:
            return torch.sqrt(plan.global_sq(grads))
        sq = sum(torch.sum(torch.square(g.float())) for g in grads.values())
        return torch.sqrt(sq)

    def __call__(self, grads: Grads, plan=None) -> Grads:
        if not grads:
            return grads
        gnorm = self.global_norm(grads, plan)
        factor = self.clip_norm / torch.clamp_min(gnorm, self.clip_norm)
        for g in grads.values():
            _scale_(g, factor)
        return grads


__all__ = ["ClipGradBase", "ClipGradByValue", "ClipGradByNorm",
           "ClipGradByGlobalNorm"]
