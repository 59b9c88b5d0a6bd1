"""Weight-only int8 linear (counterpart of
``paddle_tpu/nn/quantized_linear.py``).

The layout contract is the JAX package's: ``weight_quantize`` turns a
float ``[k, n]`` weight into a TRANSPOSED int8 ``[n, k]`` weight and an
fp32 per-output-channel scale ``[n]``; ``weight_only_linear`` computes
``x @ dequant(weight).T`` through ``ops.quant.quantized_matmul`` (the
int8 matrix product kernel on the card), the weight never dequantized in
memory.

Only per-channel ``weight_only_int8`` is ported: ``weight_only_int4``,
group-wise scales and ``llm.int8`` raise NotImplementedError (ROADMAP.md,
queue A.7).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.quant import quantized_matmul

_ALGOS = ("weight_only_int8", "weight_only_int4", "llm.int8")
_NOT_PORTED = ("{what} is not ported to paddle_tpu_torch (only per-channel "
               "weight_only_int8 is); see ROADMAP.md, queue A.7")


def _check(algo: str, group_size: int) -> None:
    """The JAX package's argument checks, then refuse what is not ported."""
    if algo not in _ALGOS:
        raise ValueError(f"algo must be one of {_ALGOS}, got {algo!r}")
    if group_size not in (-1, 64, 128):
        raise ValueError(f"group_size must be -1/64/128, got {group_size}")
    if algo != "weight_only_int8":
        raise NotImplementedError(_NOT_PORTED.format(what=algo))
    if group_size != -1:
        raise NotImplementedError(_NOT_PORTED.format(
            what="group-wise scales"))


def weight_quantize(x: torch.Tensor, algo: str = "weight_only_int8",
                    arch=None, group_size: int = -1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize a float ``[k, n]`` weight to (int8 ``[n, k]``, fp32 scale
    ``[n]``) with the JAX package's rounding: scale = max|w[:, j]| / 127
    (fp32), code = round-half-to-even(w / max(scale, 1e-10)) clipped to
    ±127. ``arch`` is accepted and ignored, as in the JAX package. Works
    on a fresh fp32 ``[n, k]`` copy, so the transient memory is one fp32
    copy of the weight."""
    _check(algo, group_size)
    if x.dim() != 2:
        raise ValueError(f"weight must be rank-2, got {tuple(x.shape)}")
    k, n = x.shape
    wt = torch.empty((n, k), dtype=torch.float32, device=x.device)
    wt.copy_(x.t())
    amax = torch.maximum(wt.amax(dim=1), -wt.amin(dim=1))       # [n]
    scale = amax / 127.0
    wt.div_(scale.clamp_min(1e-10)[:, None]).round_().clamp_(-127, 127)
    return wt.to(torch.int8), scale


def weight_dequantize(x: torch.Tensor, scale: torch.Tensor,
                      algo: str = "weight_only_int8",
                      out_dtype="float16", group_size: int = -1
                      ) -> torch.Tensor:
    """Inverse of :func:`weight_quantize`: int8 ``[n, k]`` and scale
    ``[n]`` → the float ``[k, n]`` weight in ``out_dtype``."""
    _check(algo, group_size)
    if scale.dim() != 1:
        raise ValueError("rank-2 group scale given: group-wise scales are "
                         "not ported")
    dt = out_dtype if isinstance(out_dtype, torch.dtype) else getattr(
        torch, str(out_dtype))
    return (x.float() * scale.float()[:, None]).to(dt).t()


def weight_only_linear(x: torch.Tensor, weight: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       weight_scale: Optional[torch.Tensor] = None,
                       weight_dtype: str = "int8", arch=None,
                       group_size: int = -1) -> torch.Tensor:
    """y = x @ dequant(weight).T + bias with the int8 ``[n, k]`` weight and
    its per-channel ``weight_scale`` [n], through
    ``ops.quant.quantized_matmul``; output in x's dtype."""
    if weight_dtype not in ("int8", "int4"):
        raise ValueError(f"weight_dtype must be 'int8'|'int4', "
                         f"got {weight_dtype!r}")
    _check("weight_only_int8" if weight_dtype == "int8"
           else "weight_only_int4", group_size)
    if weight_scale is None or weight_scale.dim() != 1:
        raise NotImplementedError(_NOT_PORTED.format(
            what="weight_only_linear without a per-channel [n] scale"))
    out = quantized_matmul(x, weight, weight_scale.float())
    if bias is not None:
        out = out + bias.to(x.dtype)
    return out


__all__ = ["weight_quantize", "weight_dequantize", "weight_only_linear"]
