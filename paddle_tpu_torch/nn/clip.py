"""The ``nn.clip`` module path (counterpart of ``paddle_tpu/nn/clip.py``):
the gradient-clip classes live in ``optimizer/clip.py``, and
``clip_by_norm`` scales one tensor. ``set_gradient_clip`` stores a clip
on the static program, which comes with ``static`` (A.7): it raises until
then."""

from __future__ import annotations

import torch

from ..optimizer.clip import (ClipGradBase, ClipGradByGlobalNorm,  # noqa: F401
                              ClipGradByNorm, ClipGradByValue)

__all__ = ["ClipGradByGlobalNorm", "ClipGradByNorm", "ClipGradByValue",
           "clip_by_norm"]


def clip_by_norm(x, max_norm, name=None) -> torch.Tensor:
    """``x`` scaled so that its l2 norm is at most ``max_norm``."""
    arr = torch.as_tensor(x)
    norm = torch.sqrt(torch.sum(arr * arr))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return arr * scale


def set_gradient_clip(clip, param_list=None, program=None):
    """Deprecated in the reference in favour of ``grad_clip=`` on the
    optimizer; it sets the static program's clip, and ``static`` is not
    ported yet (A.7)."""
    raise NotImplementedError("set_gradient_clip needs the static program "
                              "(A.7): pass grad_clip=... to the optimizer")
