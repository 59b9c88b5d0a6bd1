"""Weight-only int8 conversion for serving (counterpart of
``paddle_tpu/quantization/serving.py``).

Takes a float Llama state dict and produces the layout
``LlamaConfig(weight_dtype="int8")`` expects: every dense projection
(``qkv_proj`` / ``o_proj`` / ``gate_up_proj`` / ``down_proj`` /
``lm_head``) becomes a transposed int8 ``[n, k]`` weight plus a
per-output-channel fp32 ``<name>_scale`` ``[n]``, with
``nn.quantized_linear.weight_quantize``'s rounding. Embeddings, RMSNorm
weights and the rope tables stay float; a tied model keeps its float
table as the vocabulary head.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import replace
from typing import Dict, Optional

import torch

from ..nn.quantized_linear import weight_quantize

# the last component of a state_dict name → quantize; the rest copies
PROJ_SUFFIXES = ("qkv_proj", "o_proj", "gate_up_proj", "down_proj",
                 "lm_head")


def int8_config(cfg, kv_dtype: Optional[str] = None):
    """The serving twin of a config: the same architecture with
    ``weight_dtype="int8"`` (and, when given, ``kv_dtype``)."""
    kw = {"weight_dtype": "int8"}
    if kv_dtype is not None:
        kw["kv_dtype"] = kv_dtype
    return replace(cfg, **kw)


def quantize_state_dict(state_dict: Dict[str, torch.Tensor]
                        ) -> Dict[str, torch.Tensor]:
    """Float Llama state dict → int8 serving state dict: each projection
    ``[k, n]`` becomes int8 ``[n, k]`` + ``<name>_scale`` fp32 ``[n]``;
    every other entry passes through as it is. Refuses an already-int8
    projection (quantizing twice would scale twice)."""
    out: Dict[str, torch.Tensor] = OrderedDict()
    for name, w in state_dict.items():
        if name.rsplit(".", 1)[-1] in PROJ_SUFFIXES and w.dim() == 2:
            if w.dtype == torch.int8:
                raise ValueError(f"{name} is already int8 — refusing to "
                                 f"quantize a quantized checkpoint")
            out[name], out[name + "_scale"] = weight_quantize(w)
        else:
            out[name] = w
    return out


def quantize_model(model, kv_dtype: Optional[str] = None):
    """A float ``LlamaForCausalLM`` → its int8 serving twin on the same
    device, with the same float dtype for what stays float. The twin is
    built without drawing random weights and loads the quantized state
    dict; it serves only (``forward(labels=...)`` raises)."""
    from ..models.llama import LlamaForCausalLM
    emb = model.model.embed_tokens
    qmodel = LlamaForCausalLM(int8_config(model.cfg, kv_dtype),
                              device=emb.device, dtype=emb.dtype,
                              init_weights=False)
    qmodel.load_state_dict(quantize_state_dict(model.state_dict()))
    return qmodel


__all__ = ["PROJ_SUFFIXES", "int8_config", "quantize_state_dict",
           "quantize_model"]
