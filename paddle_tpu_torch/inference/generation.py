"""Sampling for the serving engine (counterpart of the per-row half of
``paddle_tpu/inference/generation.py``).

Every knob is a per-row tensor, so one decode block serves any mix of
greedy and sampled requests. Sampled streams are replay-exact: a row's
random numbers are a pure function of (engine seed, request seed, token
index), independent of batching, pipelining depth and preemption.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops.hash32 import M32, mul32


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    eos_token_id: Optional[int] = None
    pad_token_id: int = 0
    seed: int = 0


def mask_logits_rowwise(logits: torch.Tensor, temperature: torch.Tensor,
                        top_k: torch.Tensor,
                        top_p: torch.Tensor) -> torch.Tensor:
    """Copy of ``_mask_logits_rowwise``: [b, vocab] fp32 logits + per-row
    temperature [b] f32, top_k [b] int (0 = off), top_p [b] f32 (1.0 =
    off) → logits with the excluded tokens at -inf. Top-p runs over the
    top-k-filtered distribution; ties at the k-th value all survive."""
    b, vocab = logits.shape
    x = logits / temperature.clamp_min(1e-6)[:, None]
    sorted_x = torch.sort(x, dim=-1, descending=True).values
    k_eff = torch.where(top_k > 0, top_k.clamp_max(vocab),
                        torch.full_like(top_k, vocab)).long()
    kth = sorted_x.gather(1, (k_eff - 1)[:, None])
    neg = x.new_full((), float("-inf"))       # a fill: no host copy
    x = torch.where(x < kth, neg, x)
    sorted_m = torch.where(sorted_x >= kth, sorted_x, neg)
    cum = torch.cumsum(torch.softmax(sorted_m, dim=-1), dim=-1)
    cutoff_idx = (cum < top_p[:, None]).sum(dim=-1).clamp_max(vocab - 1)
    cutoff = sorted_m.gather(1, cutoff_idx[:, None])
    # top_p >= 1 must be a strict no-op: the fp32 cumsum reaches 1.0 long
    # before the last token at real vocabulary sizes
    cutoff = torch.where((top_p < 1.0)[:, None], cutoff, neg)
    return torch.where(x < cutoff, neg, x)


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xorshift-multiply) on int64 tensors
    holding values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def row_uniforms(seed: int, rseed: torch.Tensor, token_index: torch.Tensor,
                 vocab: int) -> torch.Tensor:
    """[b, vocab] fp32 uniforms in (0, 1) from a counter-based hash of
    (seed, rseed[b], token_index[b], vocab index), computed with int64
    tensor ops. The bits are the same on the CPU and on the card.

    This stands in for the JAX engine's ``fold_sampling_keys`` (threefry
    keys folded from the same three counters): the streams are
    replay-exact in the same way but are NOT the JAX package's streams."""
    dev = rseed.device
    row = _mix32(torch.full_like(rseed, int(seed) & M32, dtype=torch.int64))
    row = _mix32(row ^ (rseed.long() & M32))
    row = _mix32(row ^ (token_index.long() & M32))
    col = torch.arange(vocab, dtype=torch.int64, device=dev)
    return _unit_open(_mix32(_mix32(col[None, :] ^ row[:, None])
                             ^ 0x9E3779B9))


def _unit_open(bits: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) → fp32 in the open interval (0, 1).
    The top 23 bits plus one half fit fp32's 24-bit significand exactly;
    with 24 bits the largest value would round up to 1.0, whose Gumbel
    noise is +inf."""
    return ((bits >> 9).float() + 0.5) * (1.0 / (1 << 23))


def sample_logits_per_slot(logits: torch.Tensor, temperature, top_k, top_p,
                           do_sample, seed: int, rseed,
                           token_index) -> torch.Tensor:
    """Per-row sampling: [b, vocab] fp32 logits + per-row knobs → [b]
    int64 tokens. Sampled rows take the Gumbel-max of the masked logits
    with :func:`row_uniforms`; other rows take the argmax."""
    greedy = torch.argmax(logits, dim=-1)
    x = mask_logits_rowwise(logits, temperature, top_k, top_p)
    u = row_uniforms(seed, rseed, token_index, logits.shape[-1])
    sampled = torch.argmax(x - torch.log(-torch.log(u)), dim=-1)
    return torch.where(do_sample, sampled, greedy)


def decode_stop_update(tok: torch.Tensor, active: torch.Tensor,
                       budget: torch.Tensor, eos_id: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """On-device stop detection for one decode step (copy of
    ``decode_stop_update``): a row deactivates AFTER emitting its eos or
    budget-exhausting token. Returns ``(new_active, new_budget)``."""
    budget = budget - active.to(budget.dtype)
    stop = active & ((budget <= 0) | ((eos_id >= 0) & (tok == eos_id)))
    return active & ~stop, budget


__all__ = ["GenerationConfig", "mask_logits_rowwise", "row_uniforms",
           "sample_logits_per_slot", "decode_stop_update"]
