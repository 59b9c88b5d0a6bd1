"""Radix prefix-shared KV cache index (copy of
``paddle_tpu/inference/prefix_cache.py``; pure numpy, no device state).

RadixAttention (Zheng et al., SGLang 2024) over the serving engine's
paged pool: a radix tree over TOKEN sequences whose nodes own physical
pages in the pool the engine allocates from. Admission walks the tree,
maps the matched pages straight into the new slot's page table and
prefills only the unmatched suffix.

* **Page-aligned edges and splits.** Every node's edge label is a whole
  number of pages (``len(tokens) == len(pages) * page_size``), and a
  node only splits AT a page boundary, so mapping a matched prefix is
  copying page ids into a table row, and a page is shareable iff all
  ``page_size`` of its tokens matched. A divergence inside a page is
  either recomputed (the suffix prefill) or, when the whole prompt
  matched, copied on write by the engine; the tree only answers "who
  owns this page".
* **Refcount == number of mapping tables.** ``node.ref`` counts the
  live :class:`PrefixLock` objects (one per engine slot) holding the
  node; a slot's table maps all pages of every node in its lock and no
  page of another node. Splits keep this by giving the lower half the
  same ref and splicing it into every registered lock that held the
  original.
* **Eviction only at ref 0, LRU, tail-first.** Under pool pressure the
  engine asks :meth:`evict` for pages: only leaves nobody maps, oldest
  ``last_use`` first, trimming pages from the END of an edge and
  unlinking emptied nodes. ``protect`` pins the match path of the
  request being admitted.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

__all__ = ["RadixPrefixCache", "PrefixLock"]


def _common_len(a: np.ndarray, b: np.ndarray) -> int:
    """Length of the common prefix of two int token arrays."""
    n = min(len(a), len(b))
    if n == 0:
        return 0
    neq = np.nonzero(a[:n] != b[:n])[0]
    return int(neq[0]) if len(neq) else n


class _Node:
    """One radix edge: ``tokens`` (page-multiple length) + the physical
    pages holding their KV. ``ref`` = live locks holding this node."""

    __slots__ = ("tokens", "pages", "children", "parent", "ref",
                 "last_use")

    def __init__(self, tokens: np.ndarray, pages: List[int],
                 parent: Optional["_Node"]):
        self.tokens = np.asarray(tokens, np.int32)
        self.pages = list(pages)
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.ref = 0
        self.last_use = 0


class PrefixLock:
    """A slot's hold on a root-to-descendant node path. The owning
    table maps exactly ``pages()`` (in order); releasing decrements
    every node once. Registered with the tree so node splits can splice
    the new half into the path and keep refcounts page-exact."""

    __slots__ = ("nodes",)

    def __init__(self, nodes: List[_Node]):
        self.nodes = list(nodes)

    def pages(self) -> List[int]:
        out: List[int] = []
        for n in self.nodes:
            out.extend(n.pages)
        return out


class RadixPrefixCache:
    """Page-granular radix index over token sequences; see module doc."""

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = int(page_size)
        self.root = _Node(np.zeros((0,), np.int32), [], None)
        # page id -> owning node (the "is this page tree-owned" oracle
        # the engine's free/COW paths consult per page)
        self._pages: Dict[int, _Node] = {}
        self._locks: List[PrefixLock] = []     # live locks (split fixup)
        self._clock = 0                        # LRU tick
        # bumped whenever a mutation can change match() results
        # (insert grows coverage, evict shrinks it — splits don't):
        # callers may cache per-sequence match lengths against it
        self.epoch = 0

    # -- introspection -------------------------------------------------------

    def owns(self, page: int) -> bool:
        return page in self._pages

    @property
    def num_pages(self) -> int:
        return len(self._pages)

    def num_nodes(self) -> int:
        return sum(1 for _ in self._iter_nodes())

    def _iter_nodes(self):
        stack = list(self.root.children.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    # -- matching / locking --------------------------------------------------

    def _walk(self, tokens: np.ndarray, touch: bool = True):
        """Yield ``(node, n_matched_in_edge)`` along the match path of
        ``tokens``; the last yield is the first partial (or zero) edge
        match. With ``touch`` (default) bumps ``last_use`` on every
        node — a read that precedes a mapping IS a use for LRU
        purposes; pass ``touch=False`` for speculative reads (admission
        PRICING of queued requests) so a request that is deferred every
        tick cannot keep its prefix LRU-hot and crowd out the pages of
        conversations actually being served."""
        tokens = np.asarray(tokens, np.int32)
        if touch:
            self._clock += 1
        node, i = self.root, 0
        while i < len(tokens):
            child = node.children.get(int(tokens[i]))
            if child is None:
                return
            if touch:
                child.last_use = self._clock
            m = _common_len(child.tokens, tokens[i:])
            yield child, m
            if m < len(child.tokens):
                return
            node, i = child, i + m

    def match(self, tokens, touch: bool = True) -> int:
        """Token-granular length of the longest tree prefix of
        ``tokens`` (may end mid-page; the CALLER decides how many whole
        pages of it to map and whether the partial page is COW-able).
        ``touch=False`` reads without bumping LRU (see ``_walk``)."""
        return sum(m for _, m in self._walk(tokens, touch))

    def new_lock(self) -> PrefixLock:
        """An empty registered lock — the engine gives every admitted
        slot one even on a cold miss, so later :meth:`insert` calls can
        attach donated nodes to it and release stays uniform."""
        lock = PrefixLock([])
        self._locks.append(lock)
        return lock

    def lock_prefix(self, tokens, n_pages: int) -> PrefixLock:
        """Take a refcounted hold on exactly the first ``n_pages`` pages
        of the match path (splitting the boundary node page-aligned if
        needed) and return the lock whose ``pages()`` the caller maps
        into its table. ``n_pages`` must not exceed the full pages the
        tree can serve for ``tokens`` (i.e. ``match(tokens) //
        page_size``)."""
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32)
        self._clock += 1
        nodes: List[_Node] = []
        node, i, need = self.root, 0, int(n_pages)
        while need > 0:
            child = (node.children.get(int(tokens[i]))
                     if i < len(tokens) else None)
            if child is None:
                raise ValueError(f"lock_prefix: tree holds fewer than "
                                 f"{n_pages} matched pages for this "
                                 f"prefix")
            child.last_use = self._clock
            m = _common_len(child.tokens, tokens[i:])
            have = min(m // ps, need)
            if have == 0:
                raise ValueError(f"lock_prefix: tree holds fewer than "
                                 f"{n_pages} matched pages for this "
                                 f"prefix")
            if have < len(child.pages):
                self._split(child, have)
            nodes.append(child)
            need -= have
            node, i = child, i + have * ps
        for n in nodes:
            n.ref += 1
        lock = PrefixLock(nodes)
        self._locks.append(lock)
        return lock

    def match_page_ids(self, tokens, touch: bool = False) -> List[int]:
        """Physical ids of every FULLY matched page along the match path
        of ``tokens``, in order — the serialize_pages export set (and
        exactly the pages ``lock_prefix`` could map). Defaults to a
        non-touching read: an export must not bump LRU rank the way a
        mapping admission does."""
        ps = self.page_size
        ids: List[int] = []
        for child, m in self._walk(tokens, touch):
            ids.extend(int(p) for p in child.pages[:m // ps])
            if m < len(child.tokens):
                break
        return ids

    def page_at(self, tokens, page_index: int) -> Optional[int]:
        """Physical id of page ``page_index`` along the match path of
        ``tokens`` — the engine's COW source. The page is returned as
        soon as the match reaches INTO it (it may be only partially
        matched — the caller knows how many of its token slots are
        valid); None when the match stops short of it."""
        ps = self.page_size
        idx = 0
        for child, m in self._walk(tokens):
            for j in range(-(-m // ps)):       # ceil: partial page counts
                if idx == page_index:
                    return int(child.pages[j])
                idx += 1
            if m < len(child.tokens):
                return None
        return None

    def release(self, lock: PrefixLock) -> None:
        """Drop a slot's hold: every node's ref falls by one; pages of
        ref-0 nodes stay CACHED (that is the point) but become
        LRU-evictable under pool pressure."""
        try:
            self._locks.remove(lock)
        except ValueError:
            raise RuntimeError("release of a lock not held (double "
                               "release would corrupt refcounts)")
        for n in lock.nodes:
            n.ref -= 1
            assert n.ref >= 0, "refcount underflow"
        lock.nodes = []

    # -- insertion -----------------------------------------------------------

    def insert(self, tokens, pages: List[int],
               lock: Optional[PrefixLock] = None) -> List[int]:
        """Donate ``pages`` (one per ``page_size`` tokens of
        ``tokens``) to the tree. Ranges the tree already covers are
        skipped — the caller KEEPS those duplicate pages private (they
        stay in its table; the return value lists the donated ids that
        actually became tree-owned so the caller can account). Newly
        created nodes join ``lock`` (ref 1) when given, so the owning
        slot's release path needs no special casing; pass ``lock=None``
        only when the donor no longer maps the pages (ref starts 0).

        A divergence INSIDE a page is not insertable past the aligned
        boundary (page-granularity limit, documented in serving's
        design notes) — the remainder is silently dropped and stays the
        caller's private pages."""
        ps = self.page_size
        tokens = np.asarray(tokens, np.int32)
        if len(tokens) % ps:
            raise ValueError("insert needs a whole-page token multiple")
        if len(tokens) != len(pages) * ps:
            raise ValueError(f"insert: {len(tokens)} tokens need "
                             f"{len(tokens) // ps} pages, got {len(pages)}")
        self._clock += 1
        donated: List[int] = []
        node, i = self.root, 0
        while i < len(tokens):
            child = node.children.get(int(tokens[i]))
            if child is None:
                new = _Node(tokens[i:], pages[i // ps:], node)
                new.last_use = self._clock
                node.children[int(tokens[i])] = new
                for p in new.pages:
                    self._pages[p] = new
                donated.extend(new.pages)
                self.epoch += 1
                if lock is not None:
                    new.ref = 1
                    lock.nodes.append(new)
                return donated
            child.last_use = self._clock
            m = _common_len(child.tokens, tokens[i:])
            k = m // ps
            if m == len(child.tokens):
                node, i = child, i + m          # full edge: descend
                continue
            if k == 0:
                return donated                  # mid-page divergence
            if k < len(child.pages):
                self._split(child, k)
            node, i = child, i + k * ps
        return donated

    # -- splits --------------------------------------------------------------

    def _split(self, node: _Node, k: int) -> None:
        """Split ``node`` page-aligned after its first ``k`` pages:
        ``node`` keeps the top, a new lower node takes the rest (same
        ref — every holder of the original maps both halves). Every
        registered lock holding ``node`` gets the lower half spliced in
        right after it, so release stays one-decrement-per-node."""
        ps = self.page_size
        assert 0 < k < len(node.pages)
        lower = _Node(node.tokens[k * ps:], node.pages[k:], node)
        lower.children = node.children
        for c in lower.children.values():
            c.parent = lower
        lower.ref = node.ref
        lower.last_use = node.last_use
        node.tokens = node.tokens[:k * ps]
        node.pages = node.pages[:k]
        node.children = {int(lower.tokens[0]): lower}
        for p in lower.pages:
            self._pages[p] = lower
        for lk in self._locks:
            if node in lk.nodes:
                lk.nodes.insert(lk.nodes.index(node) + 1, lower)

    # -- eviction ------------------------------------------------------------

    def evict(self, n: int, protect=None) -> List[int]:
        """Free up to ``n`` pages from refcount-0 LRU leaves (tail pages
        first; emptied nodes are unlinked so parents become leaves) and
        return the freed physical ids. ``protect`` pins every node on
        that token sequence's match path — admission evicts FOR a
        request without eating the prefix it is about to map."""
        pinned = set()
        if protect is not None:
            for child, _ in self._walk(protect):
                pinned.add(id(child))
        freed: List[int] = []
        while len(freed) < n:
            victim = None
            for cand in self._iter_nodes():
                if (cand.ref == 0 and not cand.children
                        and id(cand) not in pinned
                        and (victim is None
                             or cand.last_use < victim.last_use)):
                    victim = cand
            if victim is None:
                break
            ps = self.page_size
            while victim.pages and len(freed) < n:
                p = victim.pages.pop()
                victim.tokens = victim.tokens[:len(victim.pages) * ps]
                del self._pages[p]
                freed.append(p)
            if not victim.pages:
                # unlink by identity (the emptied node's first-token
                # key is gone with its tokens)
                parent = victim.parent
                for key, c in list(parent.children.items()):
                    if c is victim:
                        del parent.children[key]
                        break
        if freed:
            self.epoch += 1
        return freed

    # -- invariants (test hook) ---------------------------------------------

    def check(self) -> None:
        """Structural self-check: page-aligned edges, page-map
        consistency, non-negative refs, child keys, lock paths."""
        ps = self.page_size
        seen: Dict[int, _Node] = {}
        for n in self._iter_nodes():
            assert len(n.tokens) == len(n.pages) * ps, "unaligned edge"
            assert len(n.pages) > 0, "empty node left linked"
            assert n.ref >= 0, "negative refcount"
            for key, c in n.children.items():
                assert c.parent is n and int(c.tokens[0]) == key
            for p in n.pages:
                assert p not in seen, f"page {p} owned twice"
                seen[p] = n
        assert seen == self._pages, "page map out of sync"
        for key, c in self.root.children.items():
            assert c.parent is self.root and int(c.tokens[0]) == key
        held: Dict[int, int] = {}
        for lk in self._locks:
            for nnode in lk.nodes:
                held[id(nnode)] = held.get(id(nnode), 0) + 1
        for n in self._iter_nodes():
            assert n.ref == held.get(id(n), 0), \
                "node ref != live locks holding it"
