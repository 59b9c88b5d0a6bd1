"""Launch wrapper of the weight-only int8 matrix product
(``csrc/int8_matmul.cu``).

Replaces ``paddle_tpu/ops/pallas/int8_matmul.py`` ``_kernel``. The plain
version is ``ops.quant.weight_only_plain``; ``ops.quant.quantized_matmul``
chooses between the two by the tensor's device.

The kernel has three routes, which :func:`route` chooses from m and x's
type before the launch: ``"wgmma"`` (bf16 x, m > 16: TMA + register-A
``wgmma``, the prefill products), ``"decode"`` (bf16 x, m <= 16:
``mma.sync`` decode tiling) and ``"fp32"`` (fp32 x: FMAs). A launch
counts under ``int8_matmul`` and under ``int8_matmul_<route>``.
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/int8_matmul.cu"
REPLACES = "paddle_tpu/ops/pallas/int8_matmul.py:40"
# the C side's route codes
ROUTES = {"fp32": 0, "decode": 1, "wgmma": 2}
DECODE_MAX_M = 16


def route(m: int, dtype: torch.dtype) -> str:
    """The kernel route for m rows of x of ``dtype``."""
    if dtype == torch.float32:
        return "fp32"
    return "decode" if m <= DECODE_MAX_M else "wgmma"


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """y[m, n] = (x[m, k] @ wq[n, k]^T) * scale[n] with an fp32 sum, in
    x's dtype (float32 or bfloat16). wq int8 [n, k], scale float32 [n];
    any m >= 1, n and k multiples of 16; all on one CUDA device,
    contiguous and 16-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 2 or wq.dim() != 2 or scale.dim() != 1:
        raise ValueError("x must be [m, k], wq [n, k] and scale [n]")
    m, k = x.shape
    n = wq.shape[0]
    if wq.shape[1] != k or scale.shape[0] != n:
        raise ValueError(f"shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"scale {tuple(scale.shape)} do not match")
    if n % 16 or k % 16 or n == 0 or k == 0:
        raise ValueError(f"int8_matmul kernel needs n and k multiples of 16, "
                         f"got n={n}, k={k}")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"wq must be int8 and scale float32, got "
                         f"{wq.dtype} and {scale.dtype}")
    for t in (wq, scale):
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in (x, wq, scale)):
        raise ValueError("int8_matmul kernel needs contiguous inputs")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_matmul kernel needs 16-byte aligned x and wq")
    _build.dtype_code(x.dtype)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    way = route(m, x.dtype)
    err = _build.lib().pt_int8_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(), m, n, k,
        ROUTES[way], _build.stream_ptr(x.device))
    _build.check(err, "int8_matmul")
    _build.count_launch("int8_matmul")
    _build.count_launch(f"int8_matmul_{way}")
    return y


__all__ = ["int8_matmul", "route", "ROUTES", "SOURCE", "REPLACES"]
