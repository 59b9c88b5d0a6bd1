"""Carry weights from the JAX package's models into the port's.

The JAX model's ``state_dict()``, converted to numpy, has the same names
and layouts as the port's modules (``[in, out]`` float projections, or
``[out, in]`` int8 ones with their fp32 scales; the MoE models' expert
weights ``[e, in, out]``), so the bridge is a checked copy.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from .device import dtype_of, resolve_device
from .models import llama, moe_lm


def state_dict_from_jax(np_params: Dict[str, np.ndarray],
                        cfg: Union[llama.LlamaConfig, moe_lm.MoEConfig],
                        device=None, dtype=None) -> Dict[str, torch.Tensor]:
    """``np_params`` (name → numpy array, as the JAX ``LlamaForCausalLM``'s
    or ``MoEForCausalLM``'s ``state_dict()`` gives them) → a state_dict
    for the port's model of ``cfg`` on ``device``. Float projections,
    experts and embeddings take ``dtype`` (default ``cfg.dtype``); norm
    weights, routers and int8 scales stay fp32; the int8 projections of
    a ``weight_dtype="int8"`` config stay int8 (they must be int8).
    Raises ValueError naming every missing, extra, mis-shaped or
    mis-typed key."""
    family = moe_lm if isinstance(cfg, moe_lm.MoEConfig) else llama
    want = family.parameter_shapes(cfg)
    missing = sorted(set(want) - set(np_params))
    extra = sorted(set(np_params) - set(want))
    shaped = sorted(n for n in set(want) & set(np_params)
                    if tuple(np.shape(np_params[n])) != want[n][0])
    typed = sorted(n for n in set(want) & set(np_params)
                   if (want[n][1] == "int8")
                   != (np.asarray(np_params[n]).dtype == np.int8))
    if missing or extra or shaped or typed:
        raise ValueError(
            f"JAX params do not match {type(cfg).__name__}: missing={missing} "
            f"extra={extra} wrong_shape="
            f"{[(n, tuple(np.shape(np_params[n])), want[n][0]) for n in shaped]}"
            f" int8_mismatch={typed}")
    dev = resolve_device(device)
    dt = dtype_of(dtype if dtype is not None else cfg.dtype)
    out = {}
    for name, (_, kind) in want.items():
        if kind == "int8":
            arr = np.array(np_params[name], dtype=np.int8, order="C")
            out[name] = torch.from_numpy(arr).to(device=dev)
            continue
        arr = np.array(np_params[name], dtype=np.float32, order="C")
        out[name] = torch.from_numpy(arr).to(
            device=dev, dtype=dt if kind == "float" else torch.float32)
    return out


__all__ = ["state_dict_from_jax"]
