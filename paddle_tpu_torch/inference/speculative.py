"""Draft proposers for token-level speculative decoding (counterpart of
``paddle_tpu/inference/speculative.py``).

A cheap draft proposes k tokens and the target model verifies all k in
one forward (Leviathan et al., 2023). The serving engine
(``ContinuousBatchingEngine(spec_k=k)``) owns the verify loop; a
``DraftProvider`` owns the drafting. ``propose`` runs inside the
engine's tick on the device, in stream order: tensors in, tensors out,
no host read of a device value (no ``.item()``, no data-dependent
Python branch), so the tick stays free of host syncs.
"""

from __future__ import annotations

import torch


class DraftProvider:
    """Contract for speculative-draft proposers.

    ``propose(history, hist_len, k)`` → ``[B, k]`` int64 draft tokens.

    * ``history`` ``[B, H]`` int64: each slot's token history (prompt +
      committed generations) on the device, kept by the engine; entries
      at index >= ``hist_len`` are stale and must be ignored.
    * ``hist_len`` ``[B]`` int64: the valid prefix length of each row.
      The engine calls ``propose`` after appending the tick's first
      (unconditionally committed) token, so drafts condition on it.
    * ``k``: the draft length, a Python int.

    Rows the engine has deactivated are proposed for anyway and masked by
    the engine. A wrong draft costs verify width, never a wrong token:
    the engine commits only drafts equal to what it would have emitted.
    """

    def propose(self, history: torch.Tensor, hist_len: torch.Tensor,
                k: int) -> torch.Tensor:
        raise NotImplementedError


class NgramDraftProvider(DraftProvider):
    """Prompt-lookup / n-gram drafting over the slot's own history
    (Saxena, 2023): for each row, the most recent PRIOR occurrence of
    the trailing ``n``-gram (longest ``n`` first, ``max_ngram`` down to
    ``min_ngram``) and the ``k`` tokens that followed it. Rows with no
    match, or whose continuation runs past the history, repeat their
    last token. Vectorized over ``[B, H]`` as the JAX provider is, with
    the same choices token for token."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not (1 <= min_ngram <= max_ngram):
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"({min_ngram}, {max_ngram})")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)

    def propose(self, history, hist_len, k: int):
        B, H = history.shape
        dev = history.device
        hist_len = hist_len.long()
        pos_i = torch.arange(H, device=dev)[None, :]                # [1, H]
        last_tok = history.gather(1, (hist_len - 1).clamp(0, H - 1)[:, None])
        best = torch.full((B,), -1, dtype=torch.int64, device=dev)
        for n in range(self.max_ngram, self.min_ngram - 1, -1):
            suf_idx = (hist_len[:, None] - n
                       + torch.arange(n, device=dev)[None, :]).clamp(0, H - 1)
            suffix = history.gather(1, suf_idx)                     # [B, n]
            m = torch.ones((B, H), dtype=torch.bool, device=dev)
            for j in range(n):
                # roll wraps, but i + n < hist_len <= H below keeps every
                # wrapped position out
                m &= torch.roll(history, -j, dims=1) == suffix[:, j:j + 1]
            # a strictly PRIOR occurrence with one continuation token or
            # more (the trailing n-gram itself sits at hist_len - n)
            m &= (pos_i + n) < hist_len[:, None]
            m &= (hist_len >= n + 1)[:, None]
            cand = torch.where(m, pos_i + n, -1).amax(dim=1)
            best = torch.where(best < 0, cand, best)      # longest n wins
        d_idx = best[:, None] + torch.arange(k, device=dev)[None, :]
        in_hist = (best[:, None] >= 0) & (d_idx < hist_len[:, None])
        toks = history.gather(1, d_idx.clamp(0, H - 1))
        return torch.where(in_hist, toks, last_tok)


__all__ = ["DraftProvider", "NgramDraftProvider"]
