"""Functional ops of the training path (counterpart of
``paddle_tpu/nn/functional.py``): the hard-label mean cross entropy and
``scaled_dot_product_attention``."""

from __future__ import annotations

import torch

from ..ops import attention as attn_ops


def cross_entropy(input: torch.Tensor, label: torch.Tensor,
                  ignore_index: int = -100) -> torch.Tensor:
    """Softmax cross entropy over the last axis with hard integer labels,
    as ``paddle_tpu.nn.functional.cross_entropy`` computes it: fp32
    ``log_softmax``, labels equal to ``ignore_index`` count 0, and the
    mean divides by max(number of counted labels, 1), so a batch whose
    labels are all ignored gives 0 (``F.cross_entropy`` gives NaN there).
    Only this hard-label mean is ported."""
    logp = torch.log_softmax(input.float(), dim=-1)
    label = label.long()
    if label.dim() == logp.dim():                # [..., 1] labels
        label = label.squeeze(-1)
    valid = label != ignore_index
    safe = torch.where(valid, label, 0)
    nll = -torch.gather(logp, -1, safe[..., None]).squeeze(-1)
    nll = torch.where(valid, nll, 0.0)
    return nll.sum() / valid.sum().float().clamp_min(1.0)


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p: float = 0.0,
                                 is_causal: bool = False,
                                 training: bool = True, segment_ids=None,
                                 dropout_seed=None) -> torch.Tensor:
    """[batch, seq, heads, head_dim] attention through the flash kernels
    (``ops.attention.flash_attention``); dropout only when ``training``.
    ``segment_ids`` ([b, s] ints or a (q_seg, kv_seg) pair) restricts
    attention to equal ids."""
    return attn_ops.flash_attention(
        query, key, value, attn_mask=attn_mask,
        dropout_p=dropout_p if training else 0.0, causal=is_causal,
        segment_ids=segment_ids, dropout_seed=dropout_seed)


__all__ = ["cross_entropy", "scaled_dot_product_attention"]
