"""Fused vocabulary projection + cross-entropy loss head (counterpart of
the public half of ``paddle_tpu/ops/pallas/fused_vocab_ce.py``).

``loss = CE(hidden @ W, labels)`` without the [N, V] logits: the
primitive :func:`lse_and_target` gives each row's log-sum-exp of the
logits and the logit at its label (0 for a label outside [0, V)), and
``nll = lse - tgt``. It is a ``torch.autograd.Function``: on CUDA
tensors its forward is the ``vocab_ce_fwd`` kernel and its backward the
dlog, dh and dW kernels (``ops/kernels/fused_vocab_ce.py``), which
recompute the logits chunk by chunk from the saved lse; on CPU tensors
both are the plain versions below, blockwise over the vocabulary as
``_fwd_xla`` / ``_bwd_xla`` are, with the Pallas kernels' casts of dlog.
The result does not depend on the blocks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..analysis.collectives import kernel as _census
from ..device import plain_route as _plain
from .kernels.fused_vocab_ce import vocab_ce_bwd, vocab_ce_fwd

NEG_INF = -1e30
# vocabulary columns per block of the plain versions ([N, block] fp32
# logits at a time)
PLAIN_BLOCK_V = 2048
_IMPLS = (None, "pallas", "xla", "xla_unroll")


def _block_logits(hf: torch.Tensor, w: torch.Tensor, j0: int, bv: int):
    """fp32 logits of vocabulary columns j0 .. j0 + bv and their ids:
    products of the inputs' values summed in fp32, as the TPU kernels'
    ``preferred_element_type=float32`` dot."""
    wj = w[:, j0:j0 + bv].float()
    cols = torch.arange(j0, j0 + wj.shape[1], device=hf.device)
    return hf @ wj, wj, cols


def _fwd_plain(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
               block_v: int = PLAIN_BLOCK_V
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lse, tgt)`` fp32 [N] by the online log-sum-exp over vocabulary
    blocks of ``_fwd_xla``."""
    n, v = h.shape[0], w.shape[1]
    hf = h.float()
    lab = labels.long()[:, None]
    m = torch.full((n,), NEG_INF, dtype=torch.float32, device=h.device)
    s = torch.zeros((n,), dtype=torch.float32, device=h.device)
    t = torch.zeros((n,), dtype=torch.float32, device=h.device)
    for j0 in range(0, v, block_v):
        logits, _, cols = _block_logits(hf, w, j0, block_v)
        t = t + torch.where(cols[None, :] == lab, logits, 0.0).sum(-1)
        m_new = torch.maximum(m, logits.max(-1).values)
        p = torch.where(logits <= NEG_INF * 0.5, 0.0,
                        torch.exp(logits - m_new[:, None]))
        s = s * torch.exp(m - m_new) + p.sum(-1)
        m = m_new
    return m + torch.log(torch.where(s == 0.0, 1.0, s)), t


def _dlog_plain(hf: torch.Tensor, w: torch.Tensor, lab: torch.Tensor,
                lse: torch.Tensor, g_lse: torch.Tensor, g_tgt: torch.Tensor,
                j0: int, bv: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """fp32 dlog = g_lse * exp(logits - lse) + g_tgt * onehot(label) of
    vocabulary columns j0 .. j0 + bv (``_dlog_block``) from hf = h in
    fp32 and lab = labels [N, 1] int64, and the block of W in fp32."""
    logits, wj, cols = _block_logits(hf, w, j0, bv)
    p = torch.where(logits <= NEG_INF * 0.5, 0.0,
                    torch.exp(logits - lse[:, None]))
    return g_lse[:, None] * p + torch.where(cols[None, :] == lab,
                                            g_tgt[:, None], 0.0), wj


def _bwd_plain(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
               lse: torch.Tensor, g_lse: torch.Tensor, g_tgt: torch.Tensor,
               block_v: int = PLAIN_BLOCK_V
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(dh, dW)``: per vocabulary block, the logits recomputed from h,
    dlog = g_lse * exp(logits - lse) + g_tgt * onehot(label) cast to W's
    dtype for dh += dlog . W_j^T (fp32 sums) and to h's dtype for
    dW_j = h^T . dlog, as the Pallas backward kernels cast it. dh in h's
    dtype, dW in W's."""
    v = w.shape[1]
    hf = h.float()
    lab = labels.long()[:, None]
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    dws = []
    for j0 in range(0, v, block_v):
        dlog, wj = _dlog_plain(hf, w, lab, lse, g_lse, g_tgt, j0, block_v)
        dh += dlog.to(w.dtype).float() @ wj.t()
        dws.append((hf.t() @ dlog.to(h.dtype).float()).to(w.dtype))
    return dh.to(h.dtype), torch.cat(dws, dim=1)


def _fwd_cost(h, w):
    N, H = h.shape
    V, e = w.shape[1], h.element_size()
    return 2 * N * H * V, N * H * e + H * V * e + 3 * N * 4


def _bwd_cost(h, w):
    N, H = h.shape
    V, e = w.shape[1], h.element_size()
    return 6 * N * H * V, 2 * N * H * e + 2 * H * V * e + 4 * N * 4


class _LseAndTarget(torch.autograd.Function):
    """(lse, tgt) with the recompute backward. On CUDA the forward takes
    contiguous h and W (a tied head's transposed embedding is copied once
    here and the copy saved for the backward)."""

    @staticmethod
    def forward(ctx, h, w, labels, block_v):
        with _census("vocab_ce_fwd", _fwd_cost, h, w) as k:
            if _plain(h):
                lse, tgt = _fwd_plain(h, w, labels, block_v)
            else:
                h, w = h.contiguous(), w.contiguous()
                labels = labels.to(torch.int32).contiguous()
                lse, tgt = vocab_ce_fwd(h, w, labels)
            k.out(lse, tgt)
        ctx.save_for_backward(h, w, labels, lse)
        ctx.block_v = block_v
        return lse, tgt

    @staticmethod
    def backward(ctx, g_lse, g_tgt):
        h, w, labels, lse = ctx.saved_tensors
        g_lse, g_tgt = g_lse.float().contiguous(), g_tgt.float().contiguous()
        with _census("vocab_ce_bwd", _bwd_cost, h, w) as k:
            if _plain(h):
                dh, dw = _bwd_plain(h, w, labels, lse, g_lse, g_tgt,
                                    ctx.block_v)
            else:
                dh, dw = vocab_ce_bwd(h, w, labels, lse, g_lse, g_tgt,
                                      *ctx.needs_input_grad[:2])
            # what the kernels write: the gradients autograd asked for
            k.out(*(t for t, need in zip((dh, dw), ctx.needs_input_grad)
                    if need))
        return dh, dw, None, None


def lse_and_target(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                   block_v: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``(logsumexp(h @ w), logit at label)``, both fp32 [N],
    without the logits tensor in the forward or the backward. h [N, H],
    w [H, V] of one dtype; labels [N] ints, a label outside [0, V)
    contributing 0 to tgt. ``block_v`` is the plain versions' vocabulary
    block (default :data:`PLAIN_BLOCK_V`); the CUDA kernels choose their
    own tiles."""
    # trace-lint: waive(host-sync) block_v is a Python int (or None)
    return _LseAndTarget.apply(h, w, labels, int(block_v or PLAIN_BLOCK_V))


def fused_linear_cross_entropy(hidden: torch.Tensor, w: torch.Tensor,
                               labels: torch.Tensor,
                               ignore_index: int = -100,
                               reduction: str = "mean",
                               block_n: Optional[int] = None,
                               block_v: Optional[int] = None,
                               impl: Optional[str] = None,
                               interpret: bool = False) -> torch.Tensor:
    """CE(hidden @ w, labels) without materialising the logits.

    hidden [..., H], w [H, V], labels [...] ints; rows labelled
    ``ignore_index`` give 0 and do not count toward the mean.
    ``reduction``: "mean" (token-weighted, fp32), "sum" or "none"
    (per-token nll shaped like ``labels``). The JAX signature: the
    tensors' device chooses kernels or plain versions, so ``block_n``,
    ``impl`` (checked against the JAX package's names) and ``interpret``
    change nothing; ``block_v`` sets the plain versions' block."""
    # trace-lint: waive(nonstatic-branch) impl is a Python string or None
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    if reduction not in ("mean", "sum", "none"):
        raise ValueError(f"reduction must be 'mean'|'sum'|'none', got "
                         f"{reduction!r}")
    lead = hidden.shape[:-1]
    h2 = hidden.reshape(-1, hidden.shape[-1])
    lab = labels.reshape(-1)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, -1).to(torch.int32)  # tgt = 0
    lse, tgt = lse_and_target(h2, w, safe, block_v)
    nll = torch.where(valid, lse - tgt, 0.0)
    if reduction == "none":
        return nll.reshape(lead)
    if reduction == "sum":
        return nll.sum()
    return nll.sum() / valid.sum().float().clamp_min(1.0)


__all__ = ["lse_and_target", "fused_linear_cross_entropy"]
