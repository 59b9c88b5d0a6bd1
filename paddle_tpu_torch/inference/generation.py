"""Generation (counterpart of ``paddle_tpu/inference/generation.py``).

One-shot generation over the model's KV caches: :func:`generate` (an
eager loop over the dense cache, stopping once every row has emitted
``eos_token_id``), :func:`generate_scan` (the same loop with no host
sync between the prefill and the returned tensor: EOS and pad decided
on the device, finished rows emitting pad, the last decode, whose
logits nobody reads, skipped) and :func:`generate_paged` (that loop
over the page pools, through the paged decode kernel on the card).
JAX compiles its scan loops into cached executables; the port runs
them eagerly, so there is no executable cache to keep.

Sampling: :func:`sample_logits_per_slot` and :func:`sample_logits_batched`
take per-row knob tensors, so one decode block serves any mix of greedy
and sampled requests; the one-shot generators take scalar knobs from a
:class:`GenerationConfig`. Sampled tokens are a Gumbel-max over
:func:`row_uniforms`, a counter-based hash of (seed, row seed, token
index) whose bits are the same on the CPU and on the card. It stands in
for JAX's ``fold_sampling_keys`` and its per-step ``jax.random.split``
(threefry keys): the streams are replay-exact in the same way but are
not the JAX package's streams. Greedy is an argmax (ties to the first
index), the same tokens as JAX's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
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


def _knobs(cfg: GenerationConfig, b: int, dev) -> Tuple[torch.Tensor, ...]:
    """``cfg``'s scalar knobs as the per-row tensors of
    :func:`sample_logits_per_slot`: (temperature, top_k, top_p,
    do_sample), each [b]. A scalar knob is a knob broadcast to every row,
    as JAX's ``_mask_logits_rowwise`` documents."""
    def full(v, dtype):
        return torch.full((b,), v, dtype=dtype, device=dev)
    return (full(cfg.temperature, torch.float32),
            full(cfg.top_k, torch.int64), full(cfg.top_p, torch.float32),
            full(cfg.do_sample, torch.bool))


def _sample_logits(logits: torch.Tensor, cfg: GenerationConfig,
                   step: int) -> torch.Tensor:
    """[b, vocab] fp32 logits → [b] int64 next tokens of one-shot
    generation step ``step``: the argmax (ties to the first index), or
    with ``cfg.do_sample`` :func:`sample_logits_batched` over ``cfg``'s
    knobs."""
    if not cfg.do_sample:
        return torch.argmax(logits, dim=-1)
    knobs = _knobs(cfg, logits.shape[0], logits.device)
    return sample_logits_batched(logits, *knobs, cfg.seed, step)


def sample_logits_batched(logits: torch.Tensor, temperature, top_k, top_p,
                          do_sample, seed: int, step: int) -> torch.Tensor:
    """Per-row knobs (as :func:`sample_logits_per_slot`) with one draw
    per step: row i takes the uniforms of (seed, i, step), where JAX's
    version draws every row from one key. Returns [b] int64."""
    rows = torch.arange(logits.shape[0], device=logits.device)
    return sample_logits_per_slot(logits, temperature, top_k, top_p,
                                  do_sample, seed, rows,
                                  torch.full_like(rows, step))


def _on_device(input_ids, dev: torch.device) -> torch.Tensor:
    """The prompt ids as a tensor on ``dev``; a host tensor goes up
    through pinned memory, without a host sync."""
    ids = (input_ids if isinstance(input_ids, torch.Tensor)
           else torch.from_numpy(np.array(input_ids)))
    if ids.device != dev and dev.type == "cuda":
        return ids.pin_memory().to(dev, non_blocking=True)
    return ids.to(dev)


def _generate(model, input_ids, cfg: GenerationConfig, kind: str,
              page_size: int, early_exit: bool) -> torch.Tensor:
    """The one-shot loop of every generator: the prompt's prefill over
    ``kind``'s caches ("dense" or "paged"), then a token a step and a
    decode for every token but the last. With ``eos_token_id`` a row
    emits ``pad_token_id`` after its EOS; ``early_exit`` stops (one host
    read a step) once every row has. Returns [b, prompt +
    max_new_tokens] in the input's dtype on the model's device."""
    core = getattr(model, "model", model)
    head = model.logits if hasattr(model, "logits") else (lambda h: h)
    # the whole vocabulary: a vocab-parallel embedding holds V / tp rows
    dev, vocab = core.embed_tokens.device, core.cfg.vocab_size
    eos, pad = cfg.eos_token_id, cfg.pad_token_id
    with torch.inference_mode():
        ids = _on_device(input_ids, dev)
        b, s = ids.shape
        n = cfg.max_new_tokens
        prompt = ids.long()
        if kind == "paged":
            pools, tables = core.alloc_paged_caches(b, s + n, page_size)
            hidden, caches = core.prefill_paged(prompt, pools, tables)

            def decode(tok, pos, c):
                return core.decode_step_paged(tok, pos, c, tables)
        else:
            hidden, caches = core.prefill(prompt, s + n)
            decode = core.decode_step
        logits = head(hidden[:, -1, :])
        finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        out = [prompt]
        for i in range(n):
            tok = _sample_logits(logits.float(), cfg, i)
            if eos is not None:
                tok = tok.masked_fill(finished, pad)
                finished = finished | (tok == eos)
            out.append(tok[:, None])
            if early_exit and eos is not None and bool(finished.all()):
                if n - i - 1:
                    out.append(tok.new_full((b, n - i - 1), pad))
                break
            if i < n - 1:
                pos = torch.full((b,), s + i, dtype=torch.int64,
                                 device=dev)
                # a finished row feeds its pad back: a negative id reads
                # the row it wraps to, as JAX's take does
                h, caches = decode(tok.remainder(vocab), pos, caches)
                logits = head(h[:, 0, :])
        return torch.cat(out, dim=1).to(ids.dtype)


def generate(model, input_ids, generation_config: GenerationConfig = None,
             **kwargs) -> torch.Tensor:
    """Autoregressive generation for a model exposing
    ``model.model.prefill(ids, max_len)`` / ``decode_step(tok, pos,
    caches)`` and a ``logits(hidden)`` head (``LlamaForCausalLM``):
    [b, prompt + max_new_tokens] token ids, the prompt included. Stops
    early once every row has emitted ``eos_token_id`` (the rest pad).
    Runs on the model's device under ``torch.inference_mode``."""
    cfg = generation_config or GenerationConfig(**kwargs)
    return _generate(model, input_ids, cfg, "dense", 0, early_exit=True)


def generate_scan(model, input_ids,
                  generation_config: GenerationConfig = None,
                  **kwargs) -> torch.Tensor:
    """:func:`generate` with no host sync from the prefill to the
    returned tensor: finished rows keep emitting pad and the loop runs
    every step. The same tokens as :func:`generate`."""
    cfg = generation_config or GenerationConfig(**kwargs)
    return _generate(model, input_ids, cfg, "dense", 0, early_exit=False)


def generate_paged(model, input_ids,
                   generation_config: GenerationConfig = None,
                   page_size: int = 128, **kwargs) -> torch.Tensor:
    """:func:`generate_scan` over paged KV caches (``alloc_paged_caches``,
    ``prefill_paged``, ``decode_step_paged``): each decode step writes
    one page slot and attends through the paged decode kernel on the
    card (its int8 half for ``kv_dtype="int8"`` pools)."""
    cfg = generation_config or GenerationConfig(**kwargs)
    return _generate(model, input_ids, cfg, "paged", page_size,
                     early_exit=False)


__all__ = ["GenerationConfig", "generate", "generate_scan", "generate_paged",
           "sample_logits_batched", "sample_logits_per_slot",
           "decode_stop_update"]
