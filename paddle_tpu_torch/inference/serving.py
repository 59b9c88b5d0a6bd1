"""Continuous-batching serving engine over the paged-KV decode path
(counterpart of ``paddle_tpu/inference/serving.py``
``ContinuousBatchingEngine``, core path).

- ``max_batch`` fixed slots. Inactive slots write their K/V into a
  reserved garbage page (page 0) and their sampled token is ignored.
- A host-side free-list page allocator over one global pool. Prompt pages
  are claimed at admission; decode pages are claimed lazily when a
  sequence's projected position crosses a page boundary.
- Recompute preemption: when the pool is dry and a running sequence needs
  a page, the most recently admitted other slot goes back to the queue
  (pages freed, generated tokens kept for the replay prefill).
- Prefill runs per request with the prompt padded up to a page multiple;
  the first-token logits are taken at the true last prompt index.
- Decode runs in blocks of ``decode_block`` steps with stop detection on
  the device: a slot that emits its eos or exhausts its budget
  deactivates for the rest of the block, and its later tokens are pad
  with K/V routed to the garbage page.
- Up to ``async_depth`` blocks are in flight: each block's tokens and
  flags are copied to pinned host buffers without blocking, a CUDA event
  marks their arrival, and the host reconciles the oldest block while
  the card runs the next one. Scheduler state (last logits, positions,
  active mask, budgets, token counts, sampling knobs) lives on the
  device as tensors updated in place, in stream order.

- A quantized model (``quantization.quantize_model``, int8 weights and
  ``kv_dtype="int8"`` pools) runs unchanged: its pools are 4-tuples with
  per-page scales, ``kv_quant`` says so and ``kv_quant_ticks`` counts
  the decode blocks dispatched over them. Idle slots' K/V land on the
  garbage page and grow only its scale.

Not ported yet, each listed in ROADMAP.md: speculative decoding, the
prefix cache, admission policies, chunked prefill, KV-page handoff
(int8 with any of those four as well), the metrics/tracing/sentry hooks
and the dense/paged crossover (the port always decodes through the
paged kernel).

The engine is exact over native pools: greedy outputs equal per-request
greedy decoding whatever the batching, preemption or pipelining. Over
int8 pools a page claimed during decode keeps the scale its previous
owner left (as in the JAX package), so a request's codes, and at a
near-tie its tokens, can depend on which pages it was given (ROADMAP.md,
D4).
"""

from __future__ import annotations

import itertools
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from .generation import (GenerationConfig, decode_stop_update,
                         sample_logits_per_slot)


@dataclass
class _Request:
    rid: int
    prompt: np.ndarray                  # [L] int32
    max_new_tokens: int
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    do_sample: bool = False
    eos_token_id: Optional[int] = None
    # sampling-stream identity (defaults to rid)
    rseed: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    done: bool = False
    slot: int = -1
    submit_t: float = 0.0
    first_tok_t: float = 0.0
    done_t: float = 0.0
    last_emit_t: float = 0.0
    itl_gaps: List[float] = field(default_factory=list)
    prefill_target: int = 0


@dataclass
class _InflightBlock:
    """One dispatched decode block awaiting reconciliation: host buffers
    the block's outputs are being copied into, the event that marks the
    copies done (None on the CPU, where they are synchronous) and the
    (slot, request) pairs the host believed live at dispatch."""
    toks: torch.Tensor                  # [K, B] int64, host
    kept: torch.Tensor                  # [K, B] bool, host
    active: torch.Tensor                # [B] bool, host, post-block
    event: Optional[torch.cuda.Event]
    participants: List[Tuple[int, "_Request"]]
    K: int


class _PoolDry(Exception):
    """Page pool exhausted while blocks are still in flight: drain them
    first (retirements may free pages) before preempting."""


class ContinuousBatchingEngine:
    """Continuous batching over a model exposing ``alloc_paged_caches`` /
    ``prefill_paged`` / ``decode_step_paged`` on its core and a
    ``logits`` head (``LlamaForCausalLM``). Runs on the model's device.

    ``async_depth``: in-flight dispatch window; 1 is synchronous."""

    def __init__(self, model, max_batch: int = 8, page_size: int = 128,
                 max_len: int = 2048, num_pages: Optional[int] = None,
                 generation_config: Optional[GenerationConfig] = None,
                 decode_block: int = 1, async_depth: int = 2):
        self.model = model
        self.core = model.model
        self.device = self.core.embed_tokens.device
        self.cfg = generation_config or GenerationConfig()
        self.max_batch = max_batch
        self.page_size = page_size
        self.max_len = max_len
        self.pages_per_seq = -(-max_len // page_size)
        # page 0 of the pool is the reserved garbage page
        total = (num_pages if num_pages is not None
                 else max_batch * self.pages_per_seq) + 1
        self.pools, _ = self.core.alloc_paged_caches(
            1, total * page_size, page_size)
        self._total_pages = total - 1
        self.kv_quant = len(self.pools[0]) == 4
        self.kv_quant_ticks = 0             # decode blocks on int8 pools
        self._free: List[int] = list(range(total - 1, 0, -1))
        self.tables = np.zeros((max_batch, self.pages_per_seq), np.int32)
        self._tables_dev: Optional[torch.Tensor] = None
        self._tables_dirty = True
        # positions and token counts PROJECTED over the in-flight blocks:
        # page claims are made against them
        self._proj_pos = np.zeros((max_batch,), np.int64)
        self._proj_gen = np.zeros((max_batch,), np.int64)
        self._dosample = np.zeros((max_batch,), bool)
        self._slots: List[Optional[_Request]] = [None] * max_batch
        self._queue: Deque[_Request] = deque()
        self._requests: Dict[int, _Request] = {}
        self._rid = itertools.count()
        self.decode_block = max(1, int(decode_block))
        self.async_depth = max(1, int(async_depth))
        self._inflight: Deque[_InflightBlock] = deque()
        # device-resident scheduler state, created at first activation
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._knobs: Optional[Dict[str, torch.Tensor]] = None
        self.preemptions = 0
        self.pool_dry_drains = 0
        self.decode_blocks = 0
        self._latencies = deque(maxlen=10_000)  # (ttft_s, total_s, n_tok)
        self._itl_gaps = deque(maxlen=100_000)

    # -- public API ---------------------------------------------------------

    def submit(self, input_ids, max_new_tokens: Optional[int] = None,
               generation_config: Optional[GenerationConfig] = None,
               rseed: Optional[int] = None) -> int:
        """Queue one request; returns its id. ``generation_config``
        overrides the sampling knobs and eos for this request;
        ``max_new_tokens`` (default: the engine's config) is its budget;
        ``rseed`` is its sampling-stream identity (default: its id)."""
        ids = np.asarray(input_ids, np.int32).reshape(-1)
        gc = generation_config or self.cfg
        new = (max_new_tokens if max_new_tokens is not None
               else self.cfg.max_new_tokens)
        if len(ids) == 0:
            raise ValueError("empty prompt")
        if new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {new}")
        if len(ids) + new > self.max_len:
            raise ValueError(f"prompt {len(ids)} + max_new {new} exceeds "
                             f"engine max_len {self.max_len}")
        if -(-len(ids) // self.page_size) > self._total_pages:
            raise ValueError(f"prompt needs more pages than the pool "
                             f"holds ({self._total_pages}); raise "
                             f"num_pages")
        req = _Request(next(self._rid), ids, new,
                       temperature=float(gc.temperature),
                       top_k=int(gc.top_k), top_p=float(gc.top_p),
                       do_sample=bool(gc.do_sample),
                       eos_token_id=gc.eos_token_id,
                       rseed=None if rseed is None else int(rseed))
        req.submit_t = time.perf_counter()
        self._requests[req.rid] = req
        self._queue.append(req)
        return req.rid

    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    @torch.inference_mode()
    def step(self) -> List[tuple]:
        """One scheduler tick: admit what fits, dispatch the next decode
        block, reconcile drained blocks. Returns [(rid, token), ...] that
        arrived this tick."""
        emitted: List[tuple] = []
        self._admit()
        dispatched = self._dispatch_block(emitted)
        if not dispatched and self._inflight:
            emitted.extend(self._reconcile_one())
        while len(self._inflight) > self.async_depth - 1:
            emitted.extend(self._reconcile_one())
        while self._inflight and self._block_ready(self._inflight[0]):
            emitted.extend(self._reconcile_one())
        return emitted

    @torch.inference_mode()
    def run(self) -> Dict[int, np.ndarray]:
        """Drive until every submitted request completes; returns
        {rid: generated tokens} for the requests this call finished and
        releases them."""
        while self.has_work():
            self.step()
        while self._inflight:
            self._reconcile_one()
        out = {rid: np.asarray(r.generated, np.int32)
               for rid, r in self._requests.items() if r.done}
        for rid in out:
            del self._requests[rid]
        return out

    def stats(self) -> Dict[str, int]:
        return {"free_pages": len(self._free),
                "active": sum(s is not None for s in self._slots),
                "queued": len(self._queue),
                "preemptions": self.preemptions,
                "pool_dry_drains": self.pool_dry_drains,
                "inflight": len(self._inflight),
                "decode_blocks": self.decode_blocks}

    def latency_stats(self) -> Dict[str, float]:
        """TTFT / end-to-end latency percentiles over the most recent
        retired requests, stamped at token ARRIVAL on the host."""
        if not self._latencies:
            return {}
        arr = np.asarray(self._latencies, np.float64)
        ttft, total = arr[:, 0], arr[:, 1]
        out = {"requests": int(arr.shape[0]),
               "tokens": int(arr[:, 2].sum()),
               "ttft_p50_s": float(np.percentile(ttft, 50)),
               "ttft_p99_s": float(np.percentile(ttft, 99)),
               "latency_p50_s": float(np.percentile(total, 50)),
               "latency_p99_s": float(np.percentile(total, 99))}
        if self._itl_gaps:
            gaps = np.asarray(self._itl_gaps, np.float64)
            out["itl_p50_s"] = float(np.percentile(gaps, 50))
            out["itl_p99_s"] = float(np.percentile(gaps, 99))
        return out

    # -- page allocator -----------------------------------------------------

    def _alloc_pages(self, n: int) -> Optional[List[int]]:
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def _free_slot(self, slot: int):
        req = self._slots[slot]
        self._free.extend(int(p) for p in self.tables[slot] if p != 0)
        self.tables[slot] = 0
        self._tables_dirty = True
        self._proj_pos[slot] = 0
        self._proj_gen[slot] = 0
        self._slots[slot] = None
        if req is not None:
            req.slot = -1

    # -- device-resident scheduler state ------------------------------------

    def _init_state(self, logits_row: torch.Tensor):
        B, dev = self.max_batch, self.device
        i64 = dict(dtype=torch.int64, device=dev)
        self._state = {
            "logits": torch.zeros((B, logits_row.shape[-1]),
                                  dtype=logits_row.dtype, device=dev),
            "pos": torch.zeros((B,), **i64),
            "active": torch.zeros((B,), dtype=torch.bool, device=dev),
            "budget": torch.zeros((B,), **i64),
            "gen": torch.zeros((B,), **i64)}
        self._knobs = {
            "rseed": torch.zeros((B,), **i64),
            "eos": torch.full((B,), -1, **i64),
            "temp": torch.ones((B,), dtype=torch.float32, device=dev),
            "topk": torch.zeros((B,), **i64),
            "topp": torch.ones((B,), dtype=torch.float32, device=dev),
            "dosample": torch.zeros((B,), dtype=torch.bool, device=dev)}

    def _activate(self, slot: int, req: _Request, logits_row: torch.Tensor):
        """Flip a slot live on the device after its prefill: set its row
        of every scheduler tensor and its first-token logits."""
        if self._state is None:
            self._init_state(logits_row)
        L = req.prefill_target
        eos = req.eos_token_id if req.eos_token_id is not None \
            else self.cfg.eos_token_id
        st, kn = self._state, self._knobs
        st["logits"][slot] = logits_row.to(st["logits"].dtype)
        st["pos"][slot] = L
        st["active"][slot] = True
        st["budget"][slot] = req.max_new_tokens - len(req.generated)
        st["gen"][slot] = len(req.generated)
        kn["rseed"][slot] = (req.rid if req.rseed is None
                             else req.rseed) & 0x7FFFFFFF
        kn["eos"][slot] = -1 if eos is None else int(eos)
        kn["temp"][slot] = req.temperature
        kn["topk"][slot] = req.top_k
        kn["topp"][slot] = req.top_p
        kn["dosample"][slot] = req.do_sample
        self._proj_pos[slot] = L
        self._proj_gen[slot] = len(req.generated)
        self._dosample[slot] = req.do_sample

    def _deactivate(self, slot: int):
        if self._state is not None:
            self._state["active"][slot] = False

    # -- admission / prefill ------------------------------------------------

    def _bucket(self, L: int) -> int:
        return -(-L // self.page_size) * self.page_size

    def _prefill(self, slot: int, toks: np.ndarray) -> torch.Tensor:
        """Prompt (+ replay) pass for one slot, padded to a page
        multiple; returns the logits row at the last real token."""
        L = len(toks)
        ids = np.zeros((1, self._bucket(L)), np.int64)
        ids[0, :L] = toks
        tables1 = torch.tensor(self.tables[slot:slot + 1],
                               device=self.device)
        hidden, _ = self.core.prefill_paged(
            torch.tensor(ids, device=self.device), self.pools, tables1)
        return self.model.logits(hidden[0, L - 1])

    def _admit(self):
        while self._queue:
            slot = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if slot is None:
                return
            req = self._queue[0]
            toks = np.concatenate([req.prompt,
                                   np.asarray(req.generated, np.int32)])
            L = len(toks)
            need = -(-L // self.page_size)
            pages = self._alloc_pages(need)
            if pages is None:
                if any(s is not None for s in self._slots):
                    return                   # wait for pages to free up
                raise RuntimeError(
                    f"request {req.rid} needs {need} pages but the pool "
                    f"holds {self._total_pages}; raise num_pages")
            self._queue.popleft()
            self.tables[slot, :need] = pages
            self._tables_dirty = True
            self._slots[slot] = req
            req.slot = slot
            req.prefill_target = L
            self._activate(slot, req, self._prefill(slot, toks))

    # -- decode -------------------------------------------------------------

    def _decode_block(self, K: int, any_sample: bool
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K sample + decode steps over every slot, in stream order with
        no host sync: returns device [K, B] tokens and kept masks and
        leaves the scheduler state advanced in place. Inactive rows write
        to the garbage page through the masked table."""
        st, kn = self._state, self._knobs
        B = self.max_batch
        toks = torch.empty((K, B), dtype=torch.int64, device=self.device)
        kept = torch.empty((K, B), dtype=torch.bool, device=self.device)
        tables = self._tables_dev
        for j in range(K):
            lf = st["logits"].float()
            if any_sample:
                tok = sample_logits_per_slot(
                    lf, kn["temp"], kn["topk"], kn["topp"], kn["dosample"],
                    self.cfg.seed, kn["rseed"], st["gen"])
            else:
                tok = torch.argmax(lf, dim=-1)
            active = st["active"]
            tok = torch.where(active, tok, torch.zeros_like(tok))
            tbl = tables * active[:, None].to(tables.dtype)
            h, _ = self.core.decode_step_paged(tok, st["pos"], self.pools,
                                               tbl)
            new_logits = self.model.logits(h[:, 0, :])
            new_active, budget = decode_stop_update(tok, active,
                                                    st["budget"], kn["eos"])
            adv = active.to(torch.int64)
            toks[j] = tok
            kept[j] = active
            st["logits"].copy_(new_logits)
            st["pos"].add_(adv)
            st["gen"].add_(adv)
            st["budget"].copy_(budget)
            st["active"].copy_(new_active)
        return toks, kept

    def _participants(self) -> List[Tuple[int, _Request]]:
        """Slots the next block decodes for: prefilled and not yet
        scheduled through their whole budget."""
        return [(s, r) for s in range(self.max_batch)
                if (r := self._slots[s]) is not None
                and int(self._proj_gen[s]) < r.max_new_tokens]

    def _ensure_decode_pages(self, K: int):
        """Claim every page a live slot may write within the next K steps
        (against its projected position, capped by its remaining
        budget); preempt when the pool is dry."""
        for slot in range(self.max_batch):
            req = self._slots[slot]
            if req is None:
                continue
            pos = int(self._proj_pos[slot])
            span = min(K, req.max_new_tokens - int(self._proj_gen[slot]))
            if span <= 0:
                continue
            first = pos // self.page_size
            last = (pos + span - 1) // self.page_size
            for pidx in range(first, last + 1):
                if pidx >= self.pages_per_seq:
                    raise RuntimeError("sequence exceeded engine max_len")
                if self.tables[slot, pidx] != 0:
                    continue
                self.tables[slot, pidx] = self._claim_one(slot)
                self._tables_dirty = True

    def _claim_one(self, exclude_slot: int) -> int:
        """One page for a decode-time claim; recompute-preempts the
        newest other request once the pool is dry, raising _PoolDry first
        while blocks are in flight."""
        page = self._alloc_pages(1)
        while page is None:
            if self._inflight:
                raise _PoolDry()
            cands = [i for i in range(self.max_batch)
                     if self._slots[i] is not None and i != exclude_slot]
            if not cands:
                raise RuntimeError("page pool too small for one request")
            victim = max(cands, key=lambda i: self._slots[i].rid)
            self.preemptions += 1
            vreq = self._slots[victim]
            self._deactivate(victim)
            self._free_slot(victim)
            self._queue.appendleft(vreq)
            page = self._alloc_pages(1)
        return page[0]

    def _dispatch_block(self, emitted: List[tuple]) -> bool:
        """Issue the next decode block without waiting for in-flight ones.
        Returns False when no slot has budget left to schedule."""
        while True:
            parts = self._participants()
            if not parts:
                return False
            cap = self.pages_per_seq * self.page_size
            K = max(1, min(self.decode_block,
                           min(cap - int(self._proj_pos[s])
                               for s, _ in parts)))
            try:
                self._ensure_decode_pages(K)
            except _PoolDry:
                self.pool_dry_drains += 1
                emitted.extend(self._drain_all())
                continue
            parts = self._participants()
            if not parts:
                return False
            break
        any_sample = bool(any(self._dosample[s] for s, _ in parts))
        if self._tables_dirty:
            self._tables_dev = torch.tensor(self.tables, device=self.device)
            self._tables_dirty = False
        toks, kept = self._decode_block(K, any_sample)
        self.decode_blocks += 1
        if self.kv_quant:
            self.kv_quant_ticks += 1
        blk = self._start_drain(toks, kept, parts, K)
        for s, req in parts:
            steps = min(K, req.max_new_tokens - int(self._proj_gen[s]))
            self._proj_gen[s] += steps
            self._proj_pos[s] += steps
        self._inflight.append(blk)
        return True

    def _start_drain(self, toks, kept, parts, K) -> _InflightBlock:
        """Copy the block's outputs to host buffers: pinned and
        non-blocking on the card, with an event marking arrival."""
        srcs = (toks, kept, self._state["active"])
        if self.device.type != "cuda":
            return _InflightBlock(*(t.clone() for t in srcs), None, parts, K)
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in srcs]
        for h, t in zip(host, srcs):
            h.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return _InflightBlock(*host, event, parts, K)

    @staticmethod
    def _block_ready(blk: _InflightBlock) -> bool:
        return blk.event is None or blk.event.query()

    def _drain_all(self) -> List[tuple]:
        emitted: List[tuple] = []
        while self._inflight:
            emitted.extend(self._reconcile_one())
        return emitted

    def _reconcile_one(self) -> List[tuple]:
        """Drain the oldest in-flight block: append kept tokens, retire
        slots whose done flag came back, stamp arrival latencies."""
        blk = self._inflight.popleft()
        if blk.event is not None:
            blk.event.synchronize()
        toks, kept = blk.toks.numpy(), blk.kept.numpy()
        active_after = blk.active.numpy()
        emitted: List[tuple] = []
        now = time.perf_counter()
        for slot, req in blk.participants:
            if self._slots[slot] is not req or req.done:
                continue      # retired or preempted since dispatch
            nk = 0
            for j in range(blk.K):
                if not kept[j, slot]:
                    break
                t = int(toks[j, slot])
                req.generated.append(t)
                nk += 1
                if req.first_tok_t == 0.0:
                    req.first_tok_t = now
                emitted.append((req.rid, t))
            if nk:
                if req.last_emit_t:
                    req.itl_gaps.extend([(now - req.last_emit_t) / nk] * nk)
                req.last_emit_t = now
            if not active_after[slot]:
                req.done = True
                req.done_t = now
                self._latencies.append((req.first_tok_t - req.submit_t,
                                        req.done_t - req.submit_t,
                                        len(req.generated)))
                self._itl_gaps.extend(req.itl_gaps)
                self._free_slot(slot)
        return emitted


__all__ = ["ContinuousBatchingEngine"]
