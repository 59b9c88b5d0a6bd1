"""Carry weights from the JAX package's models into the port's.

The JAX model's ``state_dict()``, converted to numpy, has the same names
and ``[in, out]`` layouts as the port's modules, so the bridge is a
checked copy.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .device import dtype_of, resolve_device
from .models.llama import LlamaConfig, parameter_shapes


def state_dict_from_jax(np_params: Dict[str, np.ndarray], cfg: LlamaConfig,
                        device=None, dtype=None) -> Dict[str, torch.Tensor]:
    """``np_params`` (name → numpy array, as the JAX ``LlamaForCausalLM``'s
    ``state_dict()`` gives them) → a state_dict for the port's
    ``LlamaForCausalLM(cfg)`` on ``device``. Projections and embeddings
    take ``dtype`` (default ``cfg.dtype``); norm weights stay fp32.
    Raises ValueError naming every missing, extra or mis-shaped key."""
    want = parameter_shapes(cfg)
    missing = sorted(set(want) - set(np_params))
    extra = sorted(set(np_params) - set(want))
    shaped = sorted(n for n in set(want) & set(np_params)
                    if tuple(np.shape(np_params[n])) != want[n][0])
    if missing or extra or shaped:
        raise ValueError(
            f"JAX params do not match LlamaConfig: missing={missing} "
            f"extra={extra} wrong_shape="
            f"{[(n, tuple(np.shape(np_params[n])), want[n][0]) for n in shaped]}")
    dev = resolve_device(device)
    dt = dtype_of(dtype if dtype is not None else cfg.dtype)
    out = {}
    for name, (_, is_norm) in want.items():
        arr = np.array(np_params[name], dtype=np.float32, order="C")
        out[name] = torch.from_numpy(arr).to(
            device=dev, dtype=torch.float32 if is_norm else dt)
    return out


__all__ = ["state_dict_from_jax"]
