"""Launch wrappers of the RMSNorm kernels (``csrc/fused_norm.cu``).

Replace ``paddle_tpu/ops/pallas/fused_norm.py`` ``_fwd_kernel`` and
``_bwd_kernel``. The plain versions are ``ops.norm._rms_norm_fwd_plain``
and ``ops.norm._rms_norm_bwd_plain``; ``ops.norm.rms_norm`` chooses
between kernel and plain version by the tensor's device.

The forward's launch is planned from shapes alone (:func:`plan`): the
route ("row" at the widths the models launch, "vec" at other widths
that are multiples of 8, "scalar" for the rest and for unaligned
views), the 16-byte vectors a thread holds, the rows a block and the
blocks. :func:`row_map` is the kernels' index map in plain Python, for
the tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/fused_norm.cu"
REPLACES = "paddle_tpu/ops/pallas/fused_norm.py:43"
REPLACES_BWD = "paddle_tpu/ops/pallas/fused_norm.py:51"
# rows per block of the backward: at R = 8192 (2 x 4096 tokens) that is
# 256 blocks for 132 SMs and a 4 MB partial buffer at D = 4096
ROWS_PER_BLOCK = 32

ROUTES = {"scalar": 0, "vec": 1, "row": 2}
# the widths the row route fixes at compile time (Llama, DeepSeekMoE)
ROW_WIDTHS = (2048, 4096)
# 16-byte vectors a thread holds at prefill and in training, and that
# route's threads a block (several rows a block)
WIDE_VPT = 4
WIDE_THREADS = 256
# blocks an SM that the walking grid holds at most: the wide row route
# takes 100-108 registers a thread (ptxas), so two 256-thread blocks fit
# an SM; a grid larger than that runs in a second wave
BLOCKS_PER_SM = 2


class NormPlan(NamedTuple):
    route: str
    vpt: int        # 16-byte vectors a thread (0 on the scalar route)
    rows: int       # rows a block holds at once
    blocks: int
    threads: int


def plan(R: int, D: int, aligned: bool, sms: int) -> NormPlan:
    """The forward's launch for R rows of width D (``aligned``: x, the
    weight and y start at 16-byte boundaries) on a card of ``sms`` SMs.
    The row route at :data:`ROW_WIDTHS`: up to one row an SM latency
    decides, so one row a block and one vector a thread, every load in
    flight at once; above that :data:`WIDE_VPT` vectors a thread,
    several rows a block and at most :data:`BLOCKS_PER_SM` blocks an SM,
    walking the rows. Other widths: one row a block."""
    if R < 1 or D < 1:
        raise ValueError(f"no rows to normalise: R={R}, D={D}")
    if D % 8 or not aligned:
        return NormPlan("scalar", 0, 1, R, _row_threads(D))
    if D not in ROW_WIDTHS:
        return NormPlan("vec", 1, 1, R, _row_threads(D // 8))
    if R <= sms:
        return NormPlan("row", 1, 1, R, D // 8)
    tpr = D // (8 * WIDE_VPT)
    rows = WIDE_THREADS // tpr
    return NormPlan("row", WIDE_VPT, rows,
                    _build.walking_grid(-(-R // rows), sms * BLOCKS_PER_SM),
                    WIDE_THREADS)


def _row_threads(work: int) -> int:
    return min(256, max(32, -(-work // 32) * 32))


def row_map(p: NormPlan, R: int, D: int) -> Tuple[np.ndarray, np.ndarray]:
    """How often the launch ``p`` normalises each (row, element), from
    the kernels' index map, as two factors: every visit of a row covers
    the same columns, so the count is visits [R] times columns [D] (the
    times a column is covered in one visit). One-row-a-block routes:
    block i takes row i, thread i elements i, i + threads, ... (scalar)
    or their 8-wide vectors (vec). The row route: thread t of a block's
    row slot r takes vectors t, t + TPR, ... of rows blockIdx * rows + r,
    walking blocks * rows apart."""
    rows = np.zeros(R, np.int64)
    cols = np.zeros(D, np.int64)
    if p.route in ("scalar", "vec"):
        width = 1 if p.route == "scalar" else 8
        np.add.at(rows, np.arange(p.blocks), 1)
        for i in range(p.threads):
            starts = np.arange(i * width, D, p.threads * width)
            for w in range(width):
                np.add.at(cols, starts + w, 1)
        return rows, cols
    tpr = D // (8 * p.vpt)
    assert tpr * p.rows == p.threads
    first = (np.arange(p.blocks)[:, None] * p.rows
             + np.arange(p.rows)[None, :]).ravel()
    for row in first:
        np.add.at(rows, np.arange(row, R, p.blocks * p.rows), 1)
    vec = (np.arange(p.vpt)[:, None] * tpr + np.arange(tpr)[None, :])
    for w in range(8):
        np.add.at(cols, vec.ravel() * 8 + w, 1)
    return rows, cols


def rms_norm_fwd(x: torch.Tensor, weight: torch.Tensor, epsilon: float,
                 return_rstd: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(y, rstd)``: y = x * rsqrt(mean(x^2) + eps) * weight over the last
    dimension, in x's dtype; rstd [R] fp32 when asked for, else None.

    x: CUDA, float32 or bfloat16, contiguous, any number of rows.
    weight: [D] float32 or bfloat16 on the same device, contiguous."""
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm kernel needs a CUDA tensor, got "
                         f"{x.device}")
    D = x.shape[-1]
    if weight.shape != (D,) or weight.device != x.device:
        raise ValueError(f"weight must be [{D}] on {x.device}, got "
                         f"{tuple(weight.shape)} on {weight.device}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("rms_norm kernel needs contiguous x and weight")
    xc, wc = _build.dtype_code(x.dtype), _build.dtype_code(weight.dtype)
    R = x.numel() // D if D else 0
    y = torch.empty_like(x)
    rstd = (torch.empty((R,), dtype=torch.float32, device=x.device)
            if return_rstd else None)
    if R == 0:
        return y, rstd
    p = plan(R, D, all(t.data_ptr() % 16 == 0 for t in (x, weight, y)),
             _build.sm_count(x.device))
    err = _build.lib().pt_rms_norm_fwd(
        x.data_ptr(), weight.data_ptr(), y.data_ptr(),
        rstd.data_ptr() if rstd is not None else None, R, D,
        float(epsilon), xc, wc, ROUTES[p.route], p.vpt, p.rows, p.blocks,
        p.threads, _build.stream_ptr(x.device))
    _build.check(err, "rms_norm")
    _build.count_launch("rms_norm")
    _build.count_launch(f"rms_norm_{p.route}")
    return y, rstd


def rms_norm_bwd(x: torch.Tensor, weight: torch.Tensor, rstd: torch.Tensor,
                 dy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dx, dw)`` of the RMSNorm forward, from the rstd [R] fp32 that it
    saved. dx has x's dtype; dw is the sum over rows of the kernel's
    per-block fp32 partials, taken outside the kernel and cast to the
    weight's dtype (as ``paddle_tpu``'s ``_rms_bwd_rule`` does).

    x, dy: CUDA, the same dtype (float32 or bfloat16) and shape,
    contiguous; weight [D]; rstd contiguous fp32 [R]."""
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm_bwd kernel needs a CUDA tensor, got "
                         f"{x.device}")
    D = x.shape[-1]
    R = x.numel() // D if D else 0
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError("dy must match x in shape, dtype and device")
    if weight.shape != (D,) or weight.device != x.device:
        raise ValueError(f"weight must be [{D}] on {x.device}")
    if (rstd.dtype != torch.float32 or rstd.shape != (R,)
            or rstd.device != x.device):
        raise ValueError(f"rstd must be fp32 [{R}] on {x.device}")
    if not all(t.is_contiguous() for t in (x, weight, rstd, dy)):
        raise ValueError("rms_norm_bwd kernel needs contiguous tensors")
    xc, wc = _build.dtype_code(x.dtype), _build.dtype_code(weight.dtype)
    dx = torch.empty_like(x)
    if R == 0:
        return dx, torch.zeros_like(weight)
    rows = ROWS_PER_BLOCK
    part = torch.empty((-(-R // rows), D), dtype=torch.float32,
                       device=x.device)
    vec8 = D % 8 == 0 and all(t.data_ptr() % 16 == 0
                              for t in (x, weight, dy, dx))
    err = _build.lib().pt_rms_norm_bwd(
        x.data_ptr(), weight.data_ptr(), rstd.data_ptr(), dy.data_ptr(),
        dx.data_ptr(), part.data_ptr(), R, D, rows, xc, wc, int(vec8),
        _build.stream_ptr(x.device))
    _build.check(err, "rms_norm_bwd")
    _build.count_launch("rms_norm_bwd")
    return dx, part.sum(0).to(weight.dtype)


__all__ = ["rms_norm_fwd", "rms_norm_bwd", "plan", "row_map", "NormPlan",
           "SOURCE", "REPLACES", "REPLACES_BWD"]
