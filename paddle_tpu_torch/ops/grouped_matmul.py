"""Grouped (ragged) matrix product (counterpart of
``paddle_tpu/ops/pallas/grouped_matmul.py``).

The rows of ``xs [m, k]`` split into ``g`` contiguous runs by
``group_sizes [g]``; run i multiplies ``w[i] [k, n]``; the result is fp32
``[m, n]``, as ``xla_grouped_matmul`` returns it. :func:`grouped_matmul`
is the one entry the MoE layer calls: an autograd Function whose forward
is the CUDA kernel on CUDA tensors and :func:`grouped_matmul_plain` on
CPU tensors, and whose backward is exact (the vjp of ``ragged_dot``, as
the JAX package's ``_gmm_bwd``): dx through the same kernel with the
weight read transposed, dw through the dw kernel, each cast to its
operand's dtype.
"""

from __future__ import annotations

import torch

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
    view (the backward passes ``w.transpose(1, 2)``)."""
    y = torch.zeros((xs.shape[0], w.shape[2]), dtype=torch.float32,
                    device=xs.device)
    for i, s, e in _runs(group_sizes, xs.shape[0]):
        y[s:e] = xs[s:e].float() @ w[i].float()
    return y


def grouped_matmul_dw_plain(xs: torch.Tensor, gy: torch.Tensor,
                            group_sizes: torch.Tensor) -> torch.Tensor:
    """fp32 dw[g, k, n] = ``xs[run i]^T @ gy[run i]`` per run, 0 for an
    empty run."""
    dw = torch.zeros((group_sizes.shape[0], xs.shape[1], gy.shape[1]),
                     dtype=torch.float32, device=xs.device)
    for i, s, e in _runs(group_sizes, xs.shape[0]):
        dw[i] = xs[s:e].float().t() @ gy[s:e].float()
    return dw


class _GroupedMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, w, group_sizes):
        if xs.device.type == "cpu":
            ends = None
            y = grouped_matmul_plain(xs, w, group_sizes)
        else:
            ends = kgm.group_ends(group_sizes)
            y = kgm.grouped_matmul(xs, w, ends)
        ctx.save_for_backward(xs, w, group_sizes, ends)
        return y

    @staticmethod
    def backward(ctx, gy):
        xs, w, group_sizes, ends = ctx.saved_tensors
        # Both MoE call sites cast the fp32 product to the activation
        # dtype at once, so the cotangent arriving here is a value of
        # that dtype held in fp32: casting it to the operands' dtype
        # loses nothing in a bf16 model (and is no cast in an fp32 one),
        # and lets both products run on the operands' type.
        gy = gy.to(xs.dtype).contiguous()
        dx = dw = None
        if ends is None:
            if ctx.needs_input_grad[0]:
                dx = grouped_matmul_plain(gy, w.transpose(1, 2),
                                          group_sizes).to(xs.dtype)
            if ctx.needs_input_grad[1]:
                dw = grouped_matmul_dw_plain(xs, gy, group_sizes).to(w.dtype)
        else:
            if ctx.needs_input_grad[0]:
                dx = kgm.grouped_matmul(gy, w, ends, out_dtype=xs.dtype,
                                        transpose_w=True)
            if ctx.needs_input_grad[1]:
                dw = kgm.grouped_matmul_dw(xs, gy, ends, out_dtype=w.dtype)
        return dx, dw, None


def grouped_matmul(xs: torch.Tensor, w: torch.Tensor,
                   group_sizes: torch.Tensor) -> torch.Tensor:
    """fp32 y[m, n] = run-wise ``xs[run] @ w[run]``; xs float [m, k], w
    [g, k, n] of xs's dtype, group_sizes int [g] summing to m.
    Differentiable in xs and w."""
    return _GroupedMatmul.apply(xs, w, group_sizes)


__all__ = ["grouped_matmul", "grouped_matmul_plain",
           "grouped_matmul_dw_plain"]
