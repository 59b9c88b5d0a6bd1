"""Carry weights and optimizer state from the JAX package into the port.

The JAX model's ``state_dict()``, converted to numpy, has the same names
and layouts as the port's modules (``[in, out]`` float projections, or
``[out, in]`` int8 ones with their fp32 scales; the MoE models' expert
weights ``[e, in, out]``), so the bridge is a checked copy. The JAX
optimizer's state ``{"step", "master", "slots"}`` has the port's layout
too (fp32 masters of the low-precision parameters, fp32 slots), so
:func:`opt_state_from_jax` is a checked copy as well.
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


def opt_state_from_jax(np_state: Dict, params: Dict[str, torch.Tensor]
                       ) -> Dict:
    """The JAX optimizer state (``{"step", "master", "slots"}`` with numpy
    leaves, as ``paddle_tpu.optimizer.Optimizer.init_state`` /
    ``apply_gradients`` keep it) → the port's optimizer state for
    ``params`` (name → the port's parameter), each master and slot an
    fp32 tensor on its parameter's device; ``step`` a Python int. Install
    it with ``optimizer._state = ...`` or through
    ``Trainer.set_state_dict``. Raises ValueError naming every missing,
    extra or mis-shaped entry."""
    masters = np_state.get("master", {}) or {}
    slots = np_state["slots"]
    bad = []
    for k in sorted(set(masters) - set(params)):
        bad.append(f"master {k}: no such parameter")
    for k in sorted(set(params) ^ set(slots)):
        bad.append(f"slots {k}: " + ("missing" if k in params
                                     else "no such parameter"))
    for k, v in masters.items():
        if k in params and tuple(np.shape(v)) != tuple(params[k].shape):
            bad.append(f"master {k}: shape {np.shape(v)} != "
                       f"{tuple(params[k].shape)}")
    for k, entry in slots.items():
        for sk, v in entry.items():
            if k in params and tuple(np.shape(v)) != tuple(params[k].shape):
                bad.append(f"slots {k}/{sk}: shape {np.shape(v)} != "
                           f"{tuple(params[k].shape)}")
    if bad:
        raise ValueError(f"JAX optimizer state does not match the "
                         f"parameters: {bad}")

    def t(k, v):
        arr = np.array(v, dtype=np.float32, order="C")
        return torch.from_numpy(arr).to(params[k].device)
    return {"step": int(np.asarray(np_state["step"])),
            "master": {k: t(k, v) for k, v in masters.items()},
            "slots": {k: {sk: t(k, v) for sk, v in entry.items()}
                      for k, entry in slots.items()}}


__all__ = ["state_dict_from_jax", "opt_state_from_jax"]
