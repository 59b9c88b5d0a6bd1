"""Prefix digests: the compact routing signal a replica advertises (copy
of ``paddle_tpu/serving_fabric/digest.py``).

The router's PREFIX-AFFINITY decision needs to know "which replica's
radix tree already holds the longest prefix of this prompt" WITHOUT
shipping the tree (or the prompt) anywhere. Each replica folds its
tree's top into a :class:`PrefixDigest` on the heartbeat: a set of
ROLLING page fingerprints — ``fp_0 = seed``, ``fp_{i+1} =
blake2b(fp_i || tokens of page i)`` — one entry per page boundary along
every root path. The router replays the same rolling chain over a
queued prompt and the longest ``fp_i`` present in a replica's set IS
the number of whole pages that replica's tree matched (modulo 64-bit
collisions, which only ever cost one misroute, never correctness — the
replica's own admission re-matches exactly).

Properties that make this the right wire shape:

* **Chain-structured, not positional.** A fingerprint commits to the
  ENTIRE token history before it, so two trees sharing page 3's tokens
  but not pages 0-2 can't alias — a plain per-page hash set would.
* **Top-of-tree under a cap.** ``token_paths`` enumerates breadth-first
  and the walk stops at ``max_entries``, so a digest truncates from
  the LEAVES inward: the shared system prompts that drive affinity live
  at the top and survive any cap.
* **Staleness is bounded, not prevented.** A digest is a snapshot at
  ``epoch``; between heartbeats the tree may evict (match overestimates
  → the miss costs one suffix prefill at the routed replica) or grow
  (underestimate → a tie falls back to least-loaded). Both degrade
  toward the non-affinity baseline, never below it.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, List, Optional

import numpy as np

__all__ = ["PrefixDigest"]

_FP_SEED = 0x9E3779B97F4A7C15        # golden-ratio constant; any fixed seed


def _page_fp(parent_fp: int, page_tokens: np.ndarray) -> int:
    """fp of one page given its predecessor chain — blake2b (stable
    across processes/platforms, unlike hash()) truncated to 64 bits."""
    h = hashlib.blake2b(parent_fp.to_bytes(8, "little")
                        + np.ascontiguousarray(page_tokens,
                                               np.int32).tobytes(),
                        digest_size=8)
    return int.from_bytes(h.digest(), "little")


class PrefixDigest:
    """A replica radix tree's routing fingerprint; see module doc."""

    __slots__ = ("page_size", "fps", "epoch", "hit_rate")

    def __init__(self, page_size: int, fps: Iterable[int] = (),
                 epoch: int = 0, hit_rate: Optional[float] = None):
        self.page_size = int(page_size)
        self.fps = {int(f) for f in fps}
        self.epoch = int(epoch)
        # the replica's live pt_serving_prefix_hit_rate reading rides
        # along: a router can deprioritize a replica whose tree is
        # nominally matching but not actually hitting (thrash)
        self.hit_rate = hit_rate

    # -- construction --------------------------------------------------------

    @classmethod
    def from_cache(cls, cache, max_pages: int = 32,
                   max_entries: int = 1024,
                   hit_rate: Optional[float] = None) -> "PrefixDigest":
        """Fold ``cache`` (a ``RadixPrefixCache``) into a digest:
        rolling fps at every page boundary of every root path,
        breadth-first, capped at ``max_entries`` (top-of-tree wins).
        The walk carries the parent fp down the tree, so every page is
        hashed exactly ONCE — a shared system-prompt top is not
        re-hashed per descendant leaf, which matters because the tree's
        epoch (the rebuild trigger) moves on most admissions."""
        ps = cache.page_size
        fps: set = set()
        # (node, fp entering the node, pages already above it)
        frontier = [(c, _FP_SEED, 0)
                    for c in cache.root.children.values()]
        while frontier and len(fps) < max_entries:
            nxt = []
            for node, fp, depth in frontier:
                for i in range(len(node.pages)):
                    if depth >= max_pages or len(fps) >= max_entries:
                        break
                    fp = _page_fp(fp, node.tokens[i * ps:(i + 1) * ps])
                    fps.add(fp)
                    depth += 1
                else:
                    nxt.extend((c, fp, depth)
                               for c in node.children.values())
            frontier = nxt
        return cls(ps, fps, epoch=cache.epoch, hit_rate=hit_rate)

    # -- matching ------------------------------------------------------------

    def match_pages(self, tokens) -> int:
        """Whole pages of ``tokens`` the source tree held at digest
        time: the rolling chain is replayed until its first absence —
        the router-side estimate of the replica's prefix hit."""
        toks = np.asarray(tokens, np.int32).reshape(-1)
        fp, n = _FP_SEED, 0
        for i in range(len(toks) // self.page_size):
            fp = _page_fp(fp, toks[i * self.page_size:
                                   (i + 1) * self.page_size])
            if fp not in self.fps:
                break
            n += 1
        return n

    # -- wire form (JSON-safe) -----------------------------------------------

    def to_dict(self) -> Dict[str, object]:
        return {"page_size": self.page_size, "epoch": self.epoch,
                "hit_rate": self.hit_rate,
                "fps": sorted(self.fps)}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "PrefixDigest":
        return cls(d["page_size"], d.get("fps", ()),
                   epoch=d.get("epoch", 0), hit_rate=d.get("hit_rate"))

    def __len__(self) -> int:
        return len(self.fps)

    def __repr__(self):
        return (f"PrefixDigest(pages={len(self.fps)}, "
                f"epoch={self.epoch}, hit_rate={self.hit_rate})")
