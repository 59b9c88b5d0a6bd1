"""``L1Decay`` / ``L2Decay`` (counterpart of ``paddle_tpu/regularizer.py``):
a regularizer is a penalty (``__call__``) and its gradient (``grad``),
which a caller adds to a parameter's gradient before the update. An
optimizer's ``weight_decay`` float is L2Decay's coefficient."""

from __future__ import annotations

import torch

__all__ = ["L1Decay", "L2Decay"]


class WeightDecayRegularizer:
    def __call__(self, param: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def grad(self, param: torch.Tensor) -> torch.Tensor:
        """Penalty gradient to add to the parameter's gradient."""
        raise NotImplementedError


class L1Decay(WeightDecayRegularizer):
    """loss += coeff * sum(|p|); gradient coeff * sign(p)."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return self.coeff * torch.sum(torch.abs(param))

    def grad(self, param):
        return self.coeff * torch.sign(param)

    def __repr__(self):
        return f"L1Decay(coeff={self.coeff})"


class L2Decay(WeightDecayRegularizer):
    """loss += 0.5 * coeff * sum(p^2); gradient coeff * p."""

    def __init__(self, coeff: float = 0.0):
        self.coeff = float(coeff)

    def __call__(self, param):
        return 0.5 * self.coeff * torch.sum(param * param)

    def grad(self, param):
        return self.coeff * param

    def __repr__(self):
        return f"L2Decay(coeff={self.coeff})"
