"""Grouped (ragged) matrix product (counterpart of
``paddle_tpu/ops/pallas/grouped_matmul.py``).

The rows of ``xs [m, k]`` split into ``g`` contiguous runs by
``group_sizes [g]``; run i multiplies ``w[i] [k, n]``; the result is fp32
``[m, n]``, as ``xla_grouped_matmul`` returns it. :func:`grouped_matmul`
is the public op: an autograd Function whose forward is the CUDA kernel
on CUDA tensors and :func:`grouped_matmul_plain` on CPU (and meta) tensors, and
whose backward is exact (the vjp of ``ragged_dot``, as the JAX package's
``_gmm_bwd``): the fp32 cotangent stays fp32, so dx and dw are fp32
products over operands widened to fp32, each cast to its operand's
dtype. :func:`grouped_matmul_act` is the MoE layer's entry: the same
product already cast to the operands' dtype (as both call sites cast it
at once), so its cotangent has that dtype and the backward runs both
products on the operands' type: dx through the forward kernel reading
the weight transposed, dw through the dw kernel.
"""

from __future__ import annotations

import torch

from ..analysis.collectives import kernel as _census
from ..device import plain_route as _plain
from .kernels import grouped_matmul as kgm


def _runs(group_sizes: torch.Tensor, m: int):
    """(i, start, end) of every non-empty run, clamped to m rows (the
    host reads the sizes: the plain version's loop)."""
    start = 0
    for i, c in enumerate(group_sizes.tolist()):
        end = min(start + max(int(c), 0), m)
        if end > start:
            yield i, start, end
        start = end


def grouped_matmul_plain(xs: torch.Tensor, w: torch.Tensor,
                         group_sizes: torch.Tensor) -> torch.Tensor:
    """fp32 y[m, n]: a loop over the runs, each ``xs[run] @ w[i]`` with
    both operands widened to fp32 (bf16 products are exact there, so the
    sum is fp32). Rows past the last run are 0. ``w`` may be a strided
    view (the backward passes ``w.transpose(1, 2)``). On the meta device
    (the planner's census: no counts to read) the result is its shape."""
    y = torch.zeros((xs.shape[0], w.shape[2]), dtype=torch.float32,
                    device=xs.device)
    if not y.is_meta:
        for i, s, e in _runs(group_sizes, xs.shape[0]):
            y[s:e] = xs[s:e].float() @ w[i].float()
    return y


def grouped_matmul_dw_plain(xs: torch.Tensor, gy: torch.Tensor,
                            group_sizes: torch.Tensor) -> torch.Tensor:
    """fp32 dw[g, k, n] = ``xs[run i]^T @ gy[run i]`` per run, 0 for an
    empty run; on the meta device its shape, as above."""
    dw = torch.zeros((group_sizes.shape[0], xs.shape[1], gy.shape[1]),
                     dtype=torch.float32, device=xs.device)
    if not dw.is_meta:
        for i, s, e in _runs(group_sizes, xs.shape[0]):
            dw[i] = xs[s:e].float().t() @ gy[s:e].float()
    return dw


def _backward(xs, w, group_sizes, ends, gy, needs):
    """(dx, dw) of y = grouped xs @ w for the cotangent ``gy``, each in its
    operand's dtype. The products run on gy's dtype: an fp32 gy widens
    the operands (the kernels' fp32 route on the card), a gy of the
    operands' dtype keeps them as they are."""
    gy = gy.contiguous()
    a, b = (xs, w) if gy.dtype == xs.dtype else (xs.float(), w.float())
    dx = dw = None
    if ends is None:
        if needs[0]:
            dx = grouped_matmul_plain(gy, b.transpose(1, 2),
                                      group_sizes).to(xs.dtype)
        if needs[1]:
            dw = grouped_matmul_dw_plain(a, gy, group_sizes).to(w.dtype)
    else:
        if needs[0]:
            dx = kgm.grouped_matmul(gy, b, ends, out_dtype=gy.dtype,
                                    transpose_w=True).to(xs.dtype)
        if needs[1]:
            dw = kgm.grouped_matmul_dw(a, gy, ends,
                                       out_dtype=gy.dtype).to(w.dtype)
    return dx, dw


def _fwd_cost(xs, w, out_dtype):
    m, k = xs.shape
    g, _, n = w.shape
    return 2 * m * k * n, (m * k * xs.element_size()
                           + g * k * n * w.element_size()
                           + m * n * out_dtype.itemsize)


def _bwd_cost(xs, w, gy):
    m, k = xs.shape
    g, _, n = w.shape
    e = gy.element_size()
    return 4 * m * k * n, (m * n * e + g * k * n * e + m * k * e    # dx
                           + m * (k + n) * e + g * k * n * e)       # dw


class _GroupedMatmul(torch.autograd.Function):
    """``cast`` False: the fp32 product, whose fp32 cotangent the
    backward keeps; True: the product cast to the operands' dtype."""

    @staticmethod
    def forward(ctx, xs, w, group_sizes, cast):
        out_dtype = xs.dtype if cast else torch.float32
        with _census("grouped_matmul", _fwd_cost, xs, w, out_dtype) as k:
            if _plain(xs):
                ends = None
                y = grouped_matmul_plain(xs, w, group_sizes).to(out_dtype)
            else:
                ends = kgm.group_ends(group_sizes)
                y = kgm.grouped_matmul(xs, w, ends, out_dtype=out_dtype)
            k.out(y)
        ctx.save_for_backward(xs, w, group_sizes, ends)
        return y

    @staticmethod
    def backward(ctx, gy):
        xs, w, group_sizes, ends = ctx.saved_tensors
        with _census("grouped_matmul_bwd", _bwd_cost, xs, w, gy) as k:
            dx, dw = _backward(xs, w, group_sizes, ends, gy,
                               ctx.needs_input_grad)
            k.out(*(t for t in (dx, dw) if t is not None))
        return dx, dw, None, None


def grouped_matmul(xs: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """fp32 y[m, n] = run-wise ``xs[run] @ w[run]``; xs float [m, k], w
    [g, k, n] of xs's dtype, group_sizes int [g] summing to m.
    Differentiable in xs and w; the backward keeps an fp32 cotangent
    exact, as the JAX package's ``_gmm_bwd`` does."""
    return _GroupedMatmul.apply(xs, w, group_sizes, False)


def grouped_matmul_act(xs: torch.Tensor, w: torch.Tensor,
                       group_sizes: torch.Tensor) -> torch.Tensor:
    """:func:`grouped_matmul` cast to xs's dtype (the value of
    ``grouped_matmul(xs, w, group_sizes).to(xs.dtype)``), whose cotangent
    has xs's dtype: the MoE layer's expert products."""
    return _GroupedMatmul.apply(xs, w, group_sizes, True)


__all__ = ["grouped_matmul", "grouped_matmul_act", "grouped_matmul_plain",
           "grouped_matmul_dw_plain"]
