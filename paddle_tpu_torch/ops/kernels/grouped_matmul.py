"""Launch wrappers of the grouped (ragged) matrix product
(``csrc/grouped_matmul.cu``).

``grouped_matmul`` replaces ``paddle_tpu/ops/pallas/grouped_matmul.py``
``_kernel`` and, reading the weight transposed, computes the dx half of
the backward; ``grouped_matmul_dw`` computes the dw half. The JAX
package's backward (``_gmm_bwd``, the vjp of ``ragged_dot``) is XLA's, so
that kernel is this port's own design. The plain versions are
``ops.grouped_matmul.grouped_matmul_plain`` / ``grouped_matmul_dw_plain``;
``ops.grouped_matmul.grouped_matmul`` chooses by the tensors' device.

Runs are given by their device offsets ``ends`` (:func:`group_ends`, the
int32 cumulative sum of the group sizes): no wrapper reads a group size
on the host.

Each kernel has three routes, which :func:`route` chooses from dtype,
widths, group count and alignment before the launch: ``"wgmma"`` (bf16,
both widths multiples of 8, 16-byte aligned bases, at most
``MAX_GROUPS`` groups: TMA + ``wgmma`` under a grouped tile scheduler),
``"tile"`` (other bf16: the ``mma.sync`` tile loop) and ``"fma"``
(fp32). A launch counts under the kernel's name and under
``<name>_<route>``.
"""

from __future__ import annotations

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/grouped_matmul.cu"
REPLACES = "paddle_tpu/ops/pallas/grouped_matmul.py:73"
REPLACES_DW = "paddle_tpu/ops/pallas/grouped_matmul.py:304"
# the largest group count of the wgmma route's shared-memory tables
MAX_GROUPS = 512


def group_ends(group_sizes: torch.Tensor) -> torch.Tensor:
    """The int32 cumulative sum of ``group_sizes`` [g]: run i is rows
    [ends[i - 1], ends[i])."""
    return torch.cumsum(group_sizes, 0, dtype=torch.int32)


def _check(name: str, a: torch.Tensor, b: torch.Tensor, ends: torch.Tensor,
           out_dtype: torch.dtype) -> int:
    """Device, types and layout of the two operands and ``ends``; returns
    the element type code."""
    for t in (a, b, ends):
        if t.device.type != "cuda":
            raise ValueError(f"{name} kernel needs CUDA tensors, got "
                             f"{t.device}")
        if t.device != a.device:
            raise ValueError("all inputs must be on one device")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel needs contiguous inputs")
    if a.dtype != b.dtype:
        raise ValueError(f"{name} operands must share a dtype, got "
                         f"{a.dtype} and {b.dtype}")
    code = _build.dtype_code(a.dtype)
    if code == 0 and out_dtype != torch.float32:
        raise ValueError(f"{name}: float32 operands give a float32 result, "
                         f"not {out_dtype}")
    if ends.dtype != torch.int32 or ends.dim() != 1 or ends.numel() == 0:
        raise ValueError("ends must be a non-empty int32 [g] tensor")
    return code


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def route(dtype: torch.dtype, k: int, n: int, g: int,
          aligned: bool = True) -> str:
    """The kernel route for operands of ``dtype``, contraction or input
    width k, output width n, g groups; ``aligned``: every base 16-byte
    aligned."""
    if dtype == torch.float32:
        return "fma"
    if k % 8 == 0 and n % 8 == 0 and aligned and g <= MAX_GROUPS:
        return "wgmma"
    return "tile"


def _code(way: str, k: int, n: int, aligned: bool) -> int:
    """The C side's route code: 2 wgmma; the tile loop with 16-byte loads
    (1) where both widths are multiples of 8 and the bases aligned, else
    element loads (0)."""
    if way == "wgmma":
        return 2
    return int(way == "tile" and k % 8 == 0 and n % 8 == 0 and aligned)


def grouped_matmul(xs: torch.Tensor, w: torch.Tensor, ends: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32,
                   transpose_w: bool = False) -> torch.Tensor:
    """y[m, n] = run-wise ``xs[run] @ w[run]`` (``w`` [g, k, n]) or, with
    ``transpose_w``, ``xs[run] @ w[run]^T`` (``w`` [g, n, k]), with an fp32
    sum, in ``out_dtype`` (float32, or bfloat16 for bf16 operands). Rows
    past ``ends[-1]`` are 0. xs and w of one type, float32 or bfloat16."""
    code = _check("grouped_matmul", xs, w, ends, out_dtype)
    if xs.dim() != 2 or w.dim() != 3 or w.shape[0] != ends.shape[0]:
        raise ValueError(f"xs must be [m, k], w [g, ., .] and ends [g], got "
                         f"{tuple(xs.shape)}, {tuple(w.shape)}, "
                         f"{tuple(ends.shape)}")
    m, k = xs.shape
    g = w.shape[0]
    n, kw = (w.shape[1], w.shape[2]) if transpose_w else (w.shape[2],
                                                          w.shape[1])
    if kw != k:
        raise ValueError(f"xs [{m}, {k}] does not match w {tuple(w.shape)}"
                         f"{' read transposed' if transpose_w else ''}")
    y = torch.empty((m, n), dtype=out_dtype, device=xs.device)
    if m == 0 or n == 0:
        return y
    aligned = _aligned(xs, w)
    way = route(xs.dtype, k, n, g, aligned)
    err = _build.lib().pt_grouped_matmul(
        xs.data_ptr(), w.data_ptr(), ends.data_ptr(), y.data_ptr(), m, k, n,
        g, int(transpose_w), code, _build.dtype_code(out_dtype),
        _code(way, k, n, aligned), _build.stream_ptr(xs.device))
    _build.check(err, "grouped_matmul")
    _build.count_launch("grouped_matmul")
    _build.count_launch(f"grouped_matmul_{way}")
    return y


def grouped_matmul_dw(xs: torch.Tensor, gy: torch.Tensor, ends: torch.Tensor,
                      out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """dw[g, k, n] = run-wise ``xs[run]^T @ gy[run]`` with an fp32 sum in
    ``out_dtype``; zeros for an empty run. xs [m, k] and gy [m, n] of one
    type, float32 or bfloat16."""
    code = _check("grouped_matmul_dw", xs, gy, ends, out_dtype)
    if xs.dim() != 2 or gy.dim() != 2 or gy.shape[0] != xs.shape[0]:
        raise ValueError(f"xs must be [m, k] and gy [m, n], got "
                         f"{tuple(xs.shape)} and {tuple(gy.shape)}")
    m, k = xs.shape
    n = gy.shape[1]
    g = ends.shape[0]
    dw = torch.empty((g, k, n), dtype=out_dtype, device=xs.device)
    if k == 0 or n == 0:
        return dw
    aligned = _aligned(xs, gy)
    way = route(xs.dtype, k, n, g, aligned)
    err = _build.lib().pt_grouped_matmul_dw(
        xs.data_ptr(), gy.data_ptr(), ends.data_ptr(), dw.data_ptr(), m, k, n,
        g, code, _build.dtype_code(out_dtype), _code(way, k, n, aligned),
        _build.stream_ptr(xs.device))
    _build.check(err, "grouped_matmul_dw")
    _build.count_launch("grouped_matmul_dw")
    _build.count_launch(f"grouped_matmul_dw_{way}")
    return dw


__all__ = ["grouped_matmul", "grouped_matmul_dw", "group_ends", "route",
           "MAX_GROUPS", "SOURCE", "REPLACES", "REPLACES_DW"]
