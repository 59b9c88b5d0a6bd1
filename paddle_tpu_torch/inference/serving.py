"""Continuous-batching serving engine over the paged-KV decode path
(counterpart of ``paddle_tpu/inference/serving.py``
``ContinuousBatchingEngine``).

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
  active mask, budgets, token counts, sampling knobs, the speculative
  token history) lives on the device as tensors updated in place, in
  stream order; host arrays reach the card through pinned memory
  without a host sync.

Serving-engine features, each off by default:

- ``cancel``, ``take_finished`` and ``submit(replay_prefix=)``: a
  request ends now, finished requests are collected between ticks, and
  a request resumes from tokens an earlier incarnation emitted.
- Chunked prefill (``chunked_prefill=True``): admission claims a
  request's pages and its prompt is written ``prefill_chunk`` tokens (a
  page multiple) a tick through the model's ``prefill_chunk_paged``,
  between the decode blocks of the running slots, which skip it until
  its last chunk activates it.
- Radix prefix cache (``prefix_cache=True``): a radix tree over token
  sequences (``prefix_cache.RadixPrefixCache``) owns refcounted pages of
  the pool. Admission maps every fully matched page into the slot's
  table and prefills only the suffix from the page-aligned offset; a
  full-prompt match copies the page holding the last prompt token into
  a private page (copy on write) and re-forwards that one token through
  ``decode_verify_paged`` for the first-token logits. Retiring and
  preempted slots donate their completed pages; refcount-0 tree pages
  are evicted LRU-first only under pool pressure. Every pool page is
  free, private to one table, or tree-owned with ``ref`` equal to the
  tables mapping it (``_check_page_invariants``).
- Speculative decoding (``spec_k > 0``): a tick drafts ``spec_k`` tokens
  from the slot's token history on the device (``DraftProvider``,
  n-gram prompt lookup by default), verifies them in one
  ``spec_k + 1``-wide ``decode_verify_paged`` and commits the agreeing
  prefix. The token at in-tick offset j is picked with the stream
  position ``gen + j``, so a draft is accepted only if it equals the
  token the non-speculative block would emit: spec-on streams equal
  spec-off, greedy and sampled. The host projects the largest stride a
  block can commit and re-anchors at drain time.
- A quantized model (``quantization.quantize_model``, int8 weights and
  ``kv_dtype="int8"`` pools) runs every path above unchanged: its pools
  are 4-tuples with per-page scales (a copied page takes its scale
  along), ``kv_quant`` says so and ``kv_quant_ticks`` counts the decode
  blocks dispatched over them. Idle slots' K/V land on the garbage page
  and grow only its scale.
- The dense/paged crossover (``attn_crossover``, default
  ``ops.attention.paged_decode_crossover()``): each decode block takes
  the dense route (``paged_decode_dense``) when the batch's largest
  projected context after the block is at or below it, the paged kernel
  otherwise; ``attn_path_ticks`` counts the blocks of each route.
  Speculative ticks have no such fork.
- Admission policies (``admission=``, ``inference.admission``): the
  policy picks which queued request to admit (priced by
  ``_uncached_tokens``) or defers all, and picks the preemption victim.
- KV-page handoff (``serialize_pages`` / ``adopt_pages``, the prefill to
  decode transfer of ``serving_fabric``): a payload holds the pages the
  prefix tree covers for a token run, in the JAX package's layout and
  format, with a sha256 that adoption checks before it touches the pool.
- Metrics and tracing: with ``observability.REGISTRY`` enabled the engine
  publishes ``pt_serving_*`` gauges each tick and counters and
  percentiles at ``publish_metrics()`` (labelled ``engine=<name>`` when
  named) and ticks the installed SLO sentry after each (``step`` and
  ``run``); ``submit(trace=)`` stitches replica spans under a caller's
  trace context. The cost gauges (``observability.costs.CostWatch``,
  component "serving"): the first decode block of each shape (K, the
  sampling mix, the attention route, spec) dispatched with the registry
  on runs under a census (a stall of one traced block, counted in
  ``pt_cost_census_seconds_total``; ``cost_census=False`` takes none, so
  a timed window stays clean, and publishes against censuses taken
  before), and ``publish_metrics()`` publishes the breakdown, MFU,
  bandwidth and drift gauges against the median-filtered drain-to-drain
  gap, the measured seconds a block (the gap ending at a censused
  block's drain left out). ``profiler.RecordEvent`` spans mark admission
  (``serving::admit``), each prefill (``serving::prefill``), each decode
  block's dispatch (``serving::dispatch``) and each block's drain
  (``serving::drain``): host time, a global load and a branch when no
  profiler records.
- Threads: grad and inference mode are thread-local, so every verb that
  touches the pools or the model (``submit``, ``step``, ``run``,
  ``cancel``, ``serialize_pages``, ``adopt_pages``) sets inference mode
  itself; a front door's drive thread or a breaker's worker thread may
  call any of them on an engine built elsewhere.

The engine is exact over native pools: greedy outputs equal per-request
greedy decoding whatever the batching, preemption, pipelining, chunking,
prefix sharing or speculation. Over int8 pools a page claimed during
decode keeps the scale its previous owner left (as in the JAX package),
so a request's codes, and at a near-tie its tokens, can depend on which
pages it was given (ROADMAP.md, D4).
"""

from __future__ import annotations

import hashlib
import itertools
import time
import contextlib
from collections import Counter, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..observability.metrics import REGISTRY as _REG
from ..observability.sentry import sentry as _sentry
from ..observability.tracing import TRACER as _TRACE
from ..ops.attention import force_decode_impl, paged_decode_crossover
from ..profiler import RecordEvent
from .admission import AdmissionPolicy, VictimInfo
from .generation import (GenerationConfig, decode_stop_update,
                         sample_logits_per_slot)
from .prefix_cache import RadixPrefixCache
from .speculative import DraftProvider, NgramDraftProvider

# the KV-page handoff payload's format (serialize_pages / adopt_pages),
# the JAX package's: v2 carries the pool dtype and, for int8 pools, the
# per-page fp32 K/V scales; v1 (scale-less, float pages) is adopted by
# native pools only
HANDOFF_FMT = "pt-kv-pages-v2"
HANDOFF_FMT_V1 = "pt-kv-pages-v1"
# a payload's dtype names (numpy's and JAX's) and the pool dtypes
HANDOFF_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                  "int8": torch.int8}
_DTYPE_NAMES = {v: k for k, v in HANDOFF_DTYPES.items()}


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
    prefilled: int = 0                  # KV tokens written so far
    prefill_target: int = 0             # prompt + replay length
    # tracing: {"tr": tracer, "parent": wire ctx, "queue"/"res": open
    # spans, "last": decode-epoch wall stamp}; None when untraced
    tspans: Optional[dict] = None


@dataclass
class _InflightBlock:
    """One dispatched decode block awaiting reconciliation: host buffers
    the block's outputs are being copied into, the event that marks the
    copies done (None on the CPU, where they are synchronous) and the
    (slot, request) pairs the host believed live at dispatch. Speculative
    blocks also bring back the post-block positions and keep the stride
    the host projected for each slot."""
    toks: torch.Tensor                  # [K, B] int64, host
    kept: torch.Tensor                  # [K, B] bool, host
    active: torch.Tensor                # [B] bool, host, post-block
    pos: Optional[torch.Tensor]         # [B] int64, host, post-block (spec)
    event: Optional[torch.cuda.Event]
    participants: List[Tuple[int, "_Request"]]
    K: int
    steps: Optional[Dict[int, int]] = None


class _PoolDry(Exception):
    """Page pool exhausted while blocks are still in flight: drain them
    first (retirements may free pages) before preempting."""


def _entry_page_copy(entry, src: int, dst: int) -> None:
    """Copy physical page ``src`` to ``dst`` within one layer's pool
    entry, in place: 4-D page pools carry pages on axis 1, the 1-D
    per-page scales of int8 pools on axis 0, so a copied page takes its
    scale along."""
    for a in entry:
        if a.dim() == 4:
            a[:, dst].copy_(a[:, src])
        else:
            a[dst].copy_(a[src])


def _payload_sha256(toks: np.ndarray, kv: torch.Tensor,
                    scales: Optional[torch.Tensor] = None) -> str:
    """The handoff checksum, the JAX package's: sha256 over the bytes of
    tokens, kv and scales in row-major order (bf16 as its 16-bit
    patterns, as ``ml_dtypes.bfloat16`` holds them), hashed in place."""
    h = hashlib.sha256(np.ascontiguousarray(toks, np.int32))
    for t in (kv, scales):
        if t is not None:
            h.update(t.contiguous().view(torch.uint8).numpy())
    return h.hexdigest()


def _is_host_tensor(a) -> bool:
    """A payload's arrays are CPU tensors (``payload_from_wire`` makes
    them from the wire form)."""
    return isinstance(a, torch.Tensor) and a.device.type == "cpu"


class ContinuousBatchingEngine:
    """Continuous batching over a model exposing ``alloc_paged_caches`` /
    ``prefill_paged`` / ``decode_step_paged`` (and, for chunked prefill,
    the prefix cache and speculation, ``prefill_chunk_paged`` /
    ``decode_verify_paged``) on its core and a ``logits`` head
    (``LlamaForCausalLM``). Runs on the model's device.

    ``async_depth``: in-flight dispatch window; 1 is synchronous.
    ``spec_k``: draft tokens a speculative tick (0 = off); a tick is then
    one ``spec_k + 1``-wide verify and ``decode_block`` is not read.
    ``attn_crossover``: context length at or below which a decode block
    takes the dense route (default ``paged_decode_crossover()``).
    ``admission``: an ``AdmissionPolicy`` (None: FIFO admission and the
    newest request as the preemption victim).
    ``name``: the replica's name, the ``engine=`` label of its metrics."""

    def __init__(self, model, max_batch: int = 8, page_size: int = 128,
                 max_len: int = 2048, num_pages: Optional[int] = None,
                 generation_config: Optional[GenerationConfig] = None,
                 decode_block: int = 1, async_depth: int = 2,
                 chunked_prefill: bool = False,
                 prefill_chunk: Optional[int] = None, spec_k: int = 0,
                 draft_provider: Optional[DraftProvider] = None,
                 prefix_cache: bool = False,
                 attn_crossover: Optional[int] = None,
                 admission: Optional[AdmissionPolicy] = None,
                 name: Optional[str] = None, cost_census: bool = True):
        self.model = model
        # N engines in one process (the in-process serving fabric) keep
        # their registry series apart by an engine=<name> label
        self.name = name or ""
        self._mlabels: Dict[str, str] = ({"engine": self.name}
                                         if self.name else {})
        # a tracer of its own (tests play both sides of a TCP hop in one
        # process); None: the process tracer
        self._tracer = None
        self.core = getattr(model, "model", model)
        if spec_k and not hasattr(self.core, "decode_verify_paged"):
            raise ValueError(
                f"spec_k={spec_k} needs a model whose core implements "
                f"decode_verify_paged (multi-token paged verify); "
                f"{type(self.core).__name__} does not")
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
        # speculative decoding: the draft provider and each slot's token
        # history on the device (prompt + committed tokens)
        self.spec_k = max(0, int(spec_k))
        self._draft: Optional[DraftProvider] = None
        self._hist: Optional[torch.Tensor] = None
        self.spec_tokens_proposed = 0       # drafts scored by a verify
        self.spec_tokens_accepted = 0       # drafts committed
        self._spec_drains = 0               # committing spec drains
        if self.spec_k:
            self._draft = draft_provider or NgramDraftProvider()
            self._hist = torch.zeros((max_batch, max_len),
                                     dtype=torch.int64, device=self.device)
        # radix prefix cache: tree nodes own refcounted pages of this
        # pool; one lock per occupied slot names the nodes it maps
        self._prefix = RadixPrefixCache(page_size) if prefix_cache else None
        self._tree_locks: List[Optional[object]] = [None] * max_batch
        self.prefix_hit_tokens = 0          # prompt tokens not recomputed
        self.prefix_cow_copies = 0          # shared pages copied on write
        self._prefix_prompt_tokens = 0      # the hit rate's denominator
        self._admission = admission
        self._price_cache: Dict[int, tuple] = {}   # rid -> (key, price)
        # each decode block's attention route: dense at or below the
        # crossover (the batch's largest projected context), else paged
        self.attn_crossover = int(paged_decode_crossover()
                                  if attn_crossover is None
                                  else attn_crossover)
        self.attn_path_ticks = {"dense": 0, "paged": 0}
        # KV-page handoff counters (serialize_pages / adopt_pages)
        self.pages_exported = 0
        self.pages_adopted = 0
        # chunked prefill: one page-aligned chunk a tick
        self.chunked_prefill = bool(chunked_prefill)
        self.prefill_chunk = int(prefill_chunk or page_size)
        if self.prefill_chunk % page_size:
            raise ValueError(f"prefill_chunk ({self.prefill_chunk}) must "
                             f"be a multiple of page_size ({page_size})")
        # device-resident scheduler state, created at first activation
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._knobs: Optional[Dict[str, torch.Tensor]] = None
        self.preemptions = 0
        self.pool_dry_drains = 0
        self.decode_blocks = 0
        # cost observatory: the decode block's census per block shape and
        # the drain times whose gaps are the measured seconds a block
        self._cost_watch = None
        self.cost_census = bool(cost_census)
        self._census_pending = False    # a census ran in this dispatch
        self._census_block = None       # ... and this in-flight block
        self._drain_stamps: Deque[float] = deque(maxlen=256)
        self._latencies = deque(maxlen=10_000)  # (ttft_s, total_s, n_tok)
        self._itl_gaps = deque(maxlen=100_000)
        # lifetime counters publish_metrics mirrors into the registry as
        # deltas since its previous call
        self._tokens_emitted = 0
        self._requests_retired = 0
        # tokens other requests committed in a cancel's drain: the next
        # step() emits them first (D13)
        self._carried: List[tuple] = []
        self._published: Dict[str, float] = {}
        # gauge handles resolved once: the per-tick path pays no lookup
        self._g_queue = _REG.gauge("pt_serving_queue_depth",
                                   "requests waiting for a slot")
        self._g_inflight = _REG.gauge(
            "pt_serving_inflight_blocks",
            "decode blocks dispatched but not yet drained")
        self._g_active = _REG.gauge("pt_serving_active_slots",
                                    "slots holding a request")
        self._g_free = _REG.gauge("pt_serving_free_pages",
                                  "KV pool pages unclaimed")
        self._g_occupancy = _REG.gauge(
            "pt_serving_page_pool_occupancy",
            "fraction of the KV page pool claimed")
        self._g_prefix_pages = _REG.gauge(
            "pt_serving_prefix_shared_pages",
            "pool pages owned by the radix prefix cache")
        self._g_prefix_hit = _REG.gauge(
            "pt_serving_prefix_hit_rate",
            "prefix-cache hit tokens / admitted prompt tokens")

    # -- public API ---------------------------------------------------------

    @torch.inference_mode()
    def submit(self, input_ids, max_new_tokens: Optional[int] = None,
               generation_config: Optional[GenerationConfig] = None,
               rseed: Optional[int] = None, replay_prefix=None,
               trace=None) -> int:
        """Queue one request; returns its id. ``generation_config``
        overrides the sampling knobs and eos for this request;
        ``max_new_tokens`` (default: the engine's config) is its budget;
        ``rseed`` is its sampling-stream identity (default: its id).
        ``replay_prefix`` holds tokens an earlier incarnation already
        emitted: they are prefilled with the prompt (or mapped from the
        prefix cache), count against the budget, and generation resumes
        at token index ``len(replay_prefix)`` as after a preemption.
        ``trace``: the wire ``TraceContext`` dict the fabric carried; with
        the tracer enabled, the request's replica spans (queue, resident,
        prefill, decode) stitch under it."""
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
        replay = ([] if replay_prefix is None
                  else [int(t) for t in np.asarray(replay_prefix,
                                                   np.int32).reshape(-1)])
        if len(replay) >= new:
            raise ValueError(f"replay_prefix ({len(replay)} tokens) "
                             f"exhausts max_new_tokens ({new})")
        if -(-(len(ids) + len(replay)) // self.page_size) \
                > self._total_pages:
            raise ValueError(f"prompt needs more pages than the pool "
                             f"holds ({self._total_pages}); raise "
                             f"num_pages")
        req = _Request(next(self._rid), ids, new,
                       temperature=float(gc.temperature),
                       top_k=int(gc.top_k), top_p=float(gc.top_p),
                       do_sample=bool(gc.do_sample),
                       eos_token_id=gc.eos_token_id,
                       rseed=None if rseed is None else int(rseed))
        req.generated = replay
        req.submit_t = time.perf_counter()
        if trace is not None:
            tr = self._tracer or _TRACE
            if tr.enabled:
                sp = tr.start("replica::queue", parent=trace,
                              tags={"rid": req.rid, "engine": self.name})
                if sp is not None:
                    req.tspans = {"tr": tr, "parent": trace, "queue": sp}
        self._requests[req.rid] = req
        self._queue.append(req)
        return req.rid

    def has_work(self) -> bool:
        """True while a request is queued or active, or tokens that a
        cancel's drain committed wait for the next ``step()``."""
        return (bool(self._queue) or bool(self._carried)
                or any(s is not None for s in self._slots))

    @torch.inference_mode()
    def step(self) -> List[tuple]:
        """One scheduler tick: admit what fits, advance one prefill chunk
        (chunked mode), dispatch the next decode block, reconcile drained
        blocks. Returns [(rid, token), ...] that arrived this tick, after
        those a cancel's drain committed since the last tick."""
        emitted, self._carried = self._carried, []
        with RecordEvent("serving::admit"):
            self._admit()
        if self.chunked_prefill:
            self._prefill_tick()
        dispatched = self._dispatch_block(emitted)
        if not dispatched and self._inflight:
            emitted.extend(self._reconcile_one())
        while len(self._inflight) > self.async_depth - 1:
            emitted.extend(self._reconcile_one())
        while self._inflight and self._block_ready(self._inflight[0]):
            emitted.extend(self._reconcile_one())
        if _REG.enabled:
            self._tick_gauges()
            # the gauges above are fresh: the sentry's drain boundary (an
            # uninstalled sentry is a load and a branch)
            _sentry.maybe_tick()
        return emitted

    @torch.inference_mode()
    def run(self) -> Dict[int, np.ndarray]:
        """Drive until every submitted request completes; returns
        {rid: generated tokens} for the requests this call finished and
        releases them (and publishes the metrics when they are on)."""
        while self.has_work():
            self.step()
        while self._inflight:
            self._reconcile_one()
        out = self.take_finished()
        if _REG.enabled:
            self.publish_metrics()
            # the percentile gauges were just republished
            _sentry.maybe_tick()
        return out

    def take_finished(self) -> Dict[int, np.ndarray]:
        """Finished requests' token streams (replay prefix included),
        released: the incremental form of ``run()``'s collection, for a
        caller that drives ``step()`` itself."""
        out = {rid: np.asarray(r.generated, np.int32)
               for rid, r in self._requests.items() if r.done}
        for rid in out:
            del self._requests[rid]
        return out

    @torch.inference_mode()
    def cancel(self, rid: int) -> bool:
        """End ``rid`` now and free its slot and pages. A queued request
        is removed; an active one first drains the in-flight blocks (a
        dispatched block may still write its pages), then its slot is
        freed with ``cache=True`` (its completed pages stay future
        prefix hits). Returns True when the request existed and had not
        finished; a finished request stays for ``take_finished``."""
        req = self._requests.get(rid)
        if req is None or req.done:
            return False
        try:
            self._queue.remove(req)
        except ValueError:
            pass
        slot = next((i for i, s in enumerate(self._slots) if s is req), -1)
        if slot >= 0:
            # tokens other slots commit in this drain reach their
            # streams, and the next step() emits them (D13: a streaming
            # caller would otherwise miss them)
            self._carried.extend((r, t) for r, t in self._drain_all()
                                 if r != rid)
            if not req.done and self._slots[slot] is req:
                self._deactivate(slot)
                self._free_slot(slot, cache=True)
        if req.done:
            return False
        if req.tspans is not None:
            for k in ("queue", "res"):
                sp = req.tspans.pop(k, None)
                if sp is not None:
                    sp.tag(outcome="cancelled").end()
        self._requests.pop(rid, None)
        self._price_cache.pop(rid, None)
        return True

    def stats(self) -> Dict[str, int]:
        out = {"free_pages": len(self._free),
               "active": sum(s is not None for s in self._slots),
               "queued": len(self._queue),
               "preemptions": self.preemptions,
               "pool_dry_drains": self.pool_dry_drains,
               "inflight": len(self._inflight),
               "decode_blocks": self.decode_blocks,
               "attn_dense_ticks": self.attn_path_ticks["dense"],
               "attn_paged_ticks": self.attn_path_ticks["paged"]}
        if self.spec_k:
            out["spec_tokens_proposed"] = self.spec_tokens_proposed
            out["spec_tokens_accepted"] = self.spec_tokens_accepted
        if self._prefix is not None:
            out["prefix_hit_tokens"] = self.prefix_hit_tokens
            out["prefix_cow_copies"] = self.prefix_cow_copies
            out["prefix_shared_pages"] = self._prefix.num_pages
        return out

    def prefix_stats(self) -> Dict[str, float]:
        """Prefix-cache effectiveness over the engine's life: hit tokens
        (prompt tokens served from shared pages), the hit rate against
        every admitted prompt token, copies on write and the tree's size.
        Empty when ``prefix_cache=False``."""
        if self._prefix is None:
            return {}
        out = {"prefix_hit_tokens": float(self.prefix_hit_tokens),
               "prefix_prompt_tokens": float(self._prefix_prompt_tokens),
               "prefix_cow_copies": float(self.prefix_cow_copies),
               "prefix_shared_pages": float(self._prefix.num_pages),
               "prefix_nodes": float(self._prefix.num_nodes())}
        if self._prefix_prompt_tokens:
            out["prefix_hit_rate"] = (self.prefix_hit_tokens
                                      / self._prefix_prompt_tokens)
        return out

    def spec_stats(self) -> Dict[str, float]:
        """Speculation over the engine's life: acceptance rate (accepted
        ÷ proposed drafts) and mean committed tokens per committing drain
        (1.0 = no gain, spec_k + 1 = every draft accepted). Empty when
        ``spec_k == 0``."""
        if not self.spec_k:
            return {}
        out = {"spec_k": float(self.spec_k),
               "spec_tokens_proposed": float(self.spec_tokens_proposed),
               "spec_tokens_accepted": float(self.spec_tokens_accepted)}
        if self.spec_tokens_proposed:
            out["spec_accept_rate"] = (self.spec_tokens_accepted
                                       / self.spec_tokens_proposed)
        if self._spec_drains:
            out["spec_mean_accepted_len"] = 1.0 + (
                self.spec_tokens_accepted / self._spec_drains)
        return out

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

    def reset_latency_stats(self) -> None:
        """Drop the retired-request latency window (e.g. after a warm-up)."""
        self._latencies.clear()
        self._itl_gaps.clear()
        self._drain_stamps.clear()

    def _block_census(self, key):
        """The census scope of a decode block of shape ``key``: the first
        such block dispatched while the registry is on and
        ``cost_census`` is set; else a no-op."""
        if not _REG.enabled:
            return contextlib.nullcontext()
        if self._cost_watch is None:
            from ..observability.costs import CostWatch
            self._cost_watch = CostWatch("serving")
        if self._cost_watch.observe(key) or not self.cost_census:
            return contextlib.nullcontext()
        self._census_pending = True
        return self._cost_watch.census(key)

    def _publish_cost_metrics(self) -> None:
        """Breakdown/MFU gauges for the serving tick: measured seconds
        per decode block from drain-to-drain gaps (median-filtered so
        idle gaps between runs don't pollute the estimate), attributed
        against the last dispatched block shape's census."""
        watch = self._cost_watch
        if watch is None or not watch.attached:
            return
        stamps = list(self._drain_stamps)
        gaps = sorted(b - a for a, b in zip(stamps, stamps[1:]))
        if not gaps:
            return
        med = gaps[len(gaps) // 2]
        kept = [g for g in gaps if g <= 10 * med] or [med]
        watch.publish(sum(kept) / len(kept))

    # -- KV-page handoff (the serving fabric's prefill -> decode transfer) --

    @torch.inference_mode()
    def serialize_pages(self, tokens) -> Optional[Dict[str, object]]:
        """Export the KV pages the radix tree holds for the longest
        page-aligned prefix of ``tokens``: every layer's K and V pages
        (``kv`` [L, 2, H_kv, n, page, D], a CPU tensor of the pool's dtype;
        int8 pools add ``scales`` [L, 2, n] fp32), the covered token run
        and a sha256 over the bytes of tokens, kv and scales, in the JAX
        package's layout and format. None when the tree covers no full
        page of ``tokens``. ``serving_fabric.transport.payload_to_wire``
        is its wire form."""
        if self._prefix is None:
            raise RuntimeError("serialize_pages needs prefix_cache=True "
                               "(the radix tree owns the exportable "
                               "pages)")
        toks = np.asarray(tokens, np.int32).reshape(-1)
        ids = self._prefix.match_page_ids(toks)
        if not ids:
            return None
        toks = toks[:len(ids) * self.page_size]
        pids = torch.tensor(ids, dtype=torch.int64, device=self.device)
        kv = torch.stack([torch.stack([e[0][:, pids], e[1][:, pids]])
                          for e in self.pools]).cpu()
        scales = (torch.stack([torch.stack([e[2][pids], e[3][pids]])
                               for e in self.pools]).float().cpu()
                  if self.kv_quant else None)
        self.pages_exported += len(ids)
        payload = {"fmt": HANDOFF_FMT, "page_size": self.page_size,
                   "tokens": toks, "kv": kv,
                   "dtype": _DTYPE_NAMES[kv.dtype], "shape": list(kv.shape),
                   "sha256": _payload_sha256(toks, kv, scales)}
        if scales is not None:
            payload["scales"] = scales
            payload["scales_shape"] = list(scales.shape)
        return payload

    @torch.inference_mode()
    def adopt_pages(self, payload) -> List[int]:
        """Adopt a :meth:`serialize_pages` payload into this engine's pool
        and radix tree (the JAX package's arrives through
        ``serving_fabric.transport.payload_from_wire``): the pages the
        tree does not cover yet land in freshly allocated pool pages
        (under pressure the allocator evicts from the tree) and the token
        run is inserted at refcount 0, so the next admission of a
        matching prompt hits. Returns the page ids
        that became tree-owned ([] when the tree already covered the
        run). Validation comes first: a payload of an unknown format, a
        v1 payload into an int8 pool, scales into a native pool, or a
        shape, dtype or sha256 mismatch raises ValueError, and a pool
        that cannot hold the pages RuntimeError, before anything
        changes."""
        if self._prefix is None:
            raise RuntimeError("adopt_pages needs prefix_cache=True")
        fmt = payload.get("fmt") if isinstance(payload, dict) else None
        if fmt not in (HANDOFF_FMT, HANDOFF_FMT_V1):
            raise ValueError("handoff payload: unknown format")
        if fmt == HANDOFF_FMT_V1 and self.kv_quant:
            raise ValueError("handoff payload: v1 (scale-less) payload "
                             "cannot seed an int8 KV pool")
        if int(payload.get("page_size", -1)) != self.page_size:
            raise ValueError(
                f"handoff payload: page_size {payload.get('page_size')} "
                f"!= engine page_size {self.page_size}")
        toks = np.asarray(payload.get("tokens"), np.int32).reshape(-1)
        ps = self.page_size
        if len(toks) == 0 or len(toks) % ps:
            raise ValueError("handoff payload: token run is not a "
                             "whole-page multiple")
        n = len(toks) // ps
        kp0 = self.pools[0][0]
        want = (len(self.pools), 2, kp0.shape[0], n, ps, kp0.shape[3])
        kv = payload.get("kv")
        if not _is_host_tensor(kv) or tuple(kv.shape) != want \
                or list(kv.shape) != list(payload.get("shape", [])):
            raise ValueError(
                f"handoff payload: kv shape {getattr(kv, 'shape', None)} "
                f"!= expected {want}")
        name = _DTYPE_NAMES.get(kv.dtype)
        if name != payload.get("dtype") or kv.dtype != kp0.dtype:
            raise ValueError(
                f"handoff payload: dtype {payload.get('dtype')} != pool "
                f"dtype {_DTYPE_NAMES.get(kp0.dtype)}")
        scales = payload.get("scales")
        if self.kv_quant:
            sc_want = (len(self.pools), 2, n)
            if not _is_host_tensor(scales) or tuple(scales.shape) != sc_want \
                    or scales.dtype != torch.float32 \
                    or list(scales.shape) != list(
                        payload.get("scales_shape", [])):
                raise ValueError(
                    f"handoff payload: scales shape "
                    f"{getattr(scales, 'shape', None)} != expected "
                    f"{sc_want} (int8 pool needs per-page fp32 scales)")
        elif scales is not None:
            raise ValueError("handoff payload: scales present but this "
                             "engine's KV pool is not quantized")
        if _payload_sha256(toks, kv, scales) != payload.get("sha256"):
            raise ValueError("handoff payload: checksum mismatch "
                             "(corrupt or truncated transfer)")
        # validated: only now touch the pool, and stage only the uncovered
        # whole-page suffix (allocating the covered pages under pressure
        # could evict the very prefixes the transfer exists to seed)
        k = min(self._prefix.match(toks, touch=False) // ps, n)
        if k >= n:
            return []
        pages = self._alloc_pages(n - k, protect=toks)
        if pages is None:
            raise RuntimeError(
                f"adopt_pages: pool cannot hold {n - k} more pages "
                f"even after tree eviction; raise num_pages")
        pids = torch.tensor(pages, dtype=torch.int64, device=self.device)
        data = kv[:, :, :, k:].to(self.device)
        sc = scales[:, :, k:].to(self.device) if self.kv_quant else None
        for i, e in enumerate(self.pools):
            e[0][:, pids] = data[i, 0]
            e[1][:, pids] = data[i, 1]
            if sc is not None:
                e[2][pids] = sc[i, 0]
                e[3][pids] = sc[i, 1]
        # insert walks the whole run; the covered prefix takes page-id
        # placeholders it never reads (it consumes ids from the first
        # uncovered boundary on)
        donated = self._prefix.insert(toks, [0] * k + pages, lock=None)
        assert set(donated) <= set(pages), \
            "placeholder page id donated to the tree"
        taken = set(donated)
        self._free.extend(p for p in pages if p not in taken)
        self.pages_adopted += len(donated)
        return donated

    # -- metrics -------------------------------------------------------------

    def _tick_gauges(self) -> None:
        """Per-tick point-in-time gauges (reached only with the registry
        enabled)."""
        lb = self._mlabels
        self._g_queue.set(len(self._queue), **lb)
        self._g_inflight.set(len(self._inflight), **lb)
        self._g_active.set(sum(s is not None for s in self._slots), **lb)
        self._g_free.set(len(self._free), **lb)
        self._g_occupancy.set(
            1.0 - len(self._free) / max(self._total_pages, 1), **lb)
        if self._prefix is not None:
            self._g_prefix_pages.set(self._prefix.num_pages, **lb)

    def publish_metrics(self) -> Dict[str, float]:
        """Mirror the engine's counters and latency percentiles into the
        metrics registry under the JAX package's ``pt_serving_*`` names.
        Lifetime counters publish as deltas since the previous call, so
        registry counters stay monotonic; an empty latency window clears
        its percentile gauges. Called by ``run()``; returns
        ``latency_stats()``."""
        lat = self.latency_stats()
        if not _REG.enabled:
            return lat
        lb = self._mlabels
        for name, val, help in (
                ("pt_serving_preemptions_total", self.preemptions,
                 "recompute-policy slot evictions"),
                ("pt_serving_pool_dry_drains_total", self.pool_dry_drains,
                 "dry pools answered by draining the in-flight window"),
                ("pt_serving_tokens_total", self._tokens_emitted,
                 "tokens emitted to clients"),
                ("pt_serving_requests_total", self._requests_retired,
                 "requests retired"),
                ("pt_spec_tokens_proposed_total",
                 self.spec_tokens_proposed,
                 "draft tokens scored by speculative verify passes"),
                ("pt_spec_tokens_accepted_total",
                 self.spec_tokens_accepted,
                 "draft tokens committed by speculative verify passes"),
                ("pt_serving_prefix_hit_tokens_total",
                 self.prefix_hit_tokens,
                 "prompt tokens served from shared prefix pages"),
                ("pt_serving_cow_copies_total", self.prefix_cow_copies,
                 "shared pages copy-on-written at divergence"),
                ("pt_serving_kv_quant_ticks_total", self.kv_quant_ticks,
                 "decode/verify ticks served from an int8 KV pool")):
            prev = self._published.get(name, 0)
            if val > prev:
                _REG.counter(name, help).inc(val - prev, **lb)
            self._published[name] = val
        sp = self.spec_stats()
        if "spec_accept_rate" in sp:
            _REG.gauge("pt_spec_accept_rate",
                       "accepted / proposed speculative drafts").set(
                sp["spec_accept_rate"], **lb)
        if "spec_mean_accepted_len" in sp:
            _REG.gauge("pt_spec_mean_accepted_len",
                       "mean committed tokens per speculative drain").set(
                sp["spec_mean_accepted_len"], **lb)
        if self._prefix is not None and self._prefix_prompt_tokens:
            self._g_prefix_hit.set(self.prefix_hit_tokens
                                   / self._prefix_prompt_tokens, **lb)
        _REG.gauge("pt_serving_kv_quant_enabled",
                   "1 when the KV page pool is int8 with per-page "
                   "scales").set(float(self.kv_quant), **lb)
        if self.kv_quant:
            _REG.gauge("pt_serving_kv_quant_pool_bytes",
                       "HBM bytes held by the int8 KV pool incl. scale "
                       "arrays", "By").set(float(sum(
                           a.numel() * a.element_size()
                           for e in self.pools for a in e)), **lb)
        for key, metric in (("ttft", "pt_serving_ttft_seconds"),
                            ("latency", "pt_serving_latency_seconds"),
                            ("itl", "pt_serving_itl_seconds")):
            for q in ("p50", "p99"):
                v = lat.get(f"{key}_{q}_s")
                g = _REG.gauge(metric, f"{key} percentile over the "
                                       f"retired-request window", "s")
                if v is not None:
                    g.set(v, q=q, **lb)
                else:
                    g.clear(q=q, **lb)
        _REG.gauge("pt_serving_window_requests",
                   "retired requests in the latency window").set(
            lat.get("requests", 0), **lb)
        self._publish_cost_metrics()
        self._tick_gauges()
        return lat

    # -- page allocator -----------------------------------------------------

    def _alloc_pages(self, n: int, protect=None) -> Optional[List[int]]:
        """Pop ``n`` pages; under pressure refcount-0 prefix-tree pages
        are LRU-evicted into the free list first (``protect`` pins the
        match path of the request being admitted). None when even that
        cannot cover ``n``."""
        if len(self._free) < n and self._prefix is not None:
            self._free.extend(
                self._prefix.evict(n - len(self._free), protect))
        if len(self._free) < n:
            return None
        return [self._free.pop() for _ in range(n)]

    def _free_slot(self, slot: int, cache: bool = False):
        """Release a slot: with the prefix cache, ``cache`` donates its
        completed pages first (retirement, preemption, cancel), its lock
        is released exactly once, and only its private pages return to
        the free list."""
        req = self._slots[slot]
        if self._prefix is not None:
            if cache and self._decode_ready(req):
                self._insert_prefix(slot, req)
            lock = self._tree_locks[slot]
            if lock is not None:
                self._prefix.release(lock)
                self._tree_locks[slot] = None
            self._free.extend(int(p) for p in self.tables[slot]
                              if p != 0 and not self._prefix.owns(int(p)))
        else:
            self._free.extend(int(p) for p in self.tables[slot] if p != 0)
        self.tables[slot] = 0
        self._tables_dirty = True
        self._proj_pos[slot] = 0
        self._proj_gen[slot] = 0
        self._slots[slot] = None
        if req is not None:
            req.slot = -1
            req.prefilled = 0     # the freed pages took the written KV
            if req.tspans is not None:
                rsp = req.tspans.pop("res", None)
                if rsp is not None:
                    rsp.tag(reason="done" if req.done else "preempt",
                            n=len(req.generated)).end()

    # -- device-resident scheduler state ------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the engine's device: on the card through
        pinned memory, without a host sync (stream order keeps it ahead
        of the work that reads it)."""
        t = torch.from_numpy(np.array(a))       # a copy the host may reuse
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

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
        of every scheduler tensor, its first-token logits and, with
        speculation, its token history."""
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
        if req.tspans is not None:
            # the first replica::decode span of this residency starts here
            req.tspans["last"] = time.time()
        if self.spec_k:
            row = np.zeros((self.max_len,), np.int64)
            row[:L] = self._req_tokens(req)
            self._hist[slot] = self._to_device(row)

    def _deactivate(self, slot: int):
        if self._state is not None:
            self._state["active"][slot] = False

    # -- admission / prefill ------------------------------------------------

    def _bucket(self, L: int) -> int:
        return -(-L // self.page_size) * self.page_size

    @staticmethod
    def _req_tokens(req: _Request) -> np.ndarray:
        """Prompt + tokens generated before a preemption or replay: the
        one sequence the prefix match, donation and prefill key on."""
        return np.concatenate([req.prompt,
                               np.asarray(req.generated, np.int32)])

    def _decode_ready(self, req: Optional[_Request]) -> bool:
        return req is not None and req.prefilled >= req.prefill_target

    def _prefill(self, slot: int, toks: np.ndarray) -> torch.Tensor:
        """Prompt (+ replay) pass for one slot, padded to a page
        multiple; returns the logits row at the last real token."""
        L = len(toks)
        ids = np.zeros((1, self._bucket(L)), np.int64)
        ids[0, :L] = toks
        hidden, _ = self.core.prefill_paged(
            self._to_device(ids), self.pools,
            self._to_device(self.tables[slot:slot + 1]))
        return self.model.logits(hidden[0, L - 1])

    def _chunk_step(self, ids: torch.Tensor, off: int, tables1: torch.Tensor,
                    last: int) -> torch.Tensor:
        """One prefill chunk on the device: ``ids`` [1, C] at positions
        off .. off + C - 1 through ``prefill_chunk_paged``; returns the
        logits row at position ``last`` (meaningful on a final chunk)."""
        hidden, _ = self.core.prefill_chunk_paged(ids, off, self.pools,
                                                  tables1)
        return self.model.logits(hidden[0, last - off])

    def _chunk_logits(self, slot: int, toks: np.ndarray, off: int, C: int,
                      last: int) -> torch.Tensor:
        """Prefill ``toks[off:off + C]`` (zero-padded to C) of ``slot``."""
        ids = np.zeros((1, C), np.int64)
        chunk = toks[off:off + C]
        ids[0, :len(chunk)] = chunk
        return self._chunk_step(self._to_device(ids), off,
                                self._to_device(self.tables[slot:slot + 1]),
                                last)

    def _tail_logits(self, slot: int, tok: int, pos: int, src: int,
                     dst: int) -> torch.Tensor:
        """The full-prompt hit's whole compute: copy the shared page
        ``src`` holding position ``pos`` into the slot's private page
        ``dst`` (every layer, scales included), then re-forward the one
        token at ``pos`` through ``decode_verify_paged``; its K/V land in
        the copy and its logits row is what a full prefill gives."""
        for entry in self.pools:
            _entry_page_copy(entry, src, dst)
        h, _ = self.core.decode_verify_paged(
            self._to_device(np.array([[tok]], np.int64)),
            self._to_device(np.array([pos], np.int64)), self.pools,
            self._to_device(self.tables[slot:slot + 1]))
        return self.model.logits(h[0, 0])

    def _insert_prefix(self, slot: int, req: _Request) -> None:
        """Donate the slot's completed full pages (prompt + committed
        generations) to the radix tree. Ranges the tree already covers
        stay the slot's private duplicates; new nodes join the slot's
        lock at ref 1."""
        toks = self._req_tokens(req)
        n_ins = len(toks) // self.page_size
        if n_ins == 0:
            return
        lock = self._tree_locks[slot]
        if lock is None:
            lock = self._tree_locks[slot] = self._prefix.new_lock()
        self._prefix.insert(toks[:n_ins * self.page_size],
                            [int(p) for p in self.tables[slot, :n_ins]],
                            lock)

    def _uncached_tokens(self, req: _Request) -> int:
        """Predicted prefill cost of admitting ``req`` now: the tokens its
        admission would recompute (1 for a full-prompt hit, the logits
        re-forward). The admission policy prices with it. Prices are
        cached per request against the tree's mutation epoch and the
        replay length; a pricing read does not touch the tree's LRU."""
        L = len(req.prompt) + len(req.generated)
        if self._prefix is None:
            return L
        key = (self._prefix.epoch, L)
        hit = self._price_cache.get(req.rid)
        if hit is not None and hit[0] == key:
            return hit[1]
        m = self._prefix.match(self._req_tokens(req), touch=False)
        if m >= L and hasattr(self.core, "decode_verify_paged"):
            price = 1
        else:
            price = L - (min(m, L - 1) // self.page_size) * self.page_size
        if len(self._price_cache) > 4 * self.max_batch + 1024:
            self._price_cache.clear()          # bound stale-rid growth
        self._price_cache[req.rid] = (key, price)
        return price

    @staticmethod
    def _prefill_span(req: _Request, kind: str):
        """A replica::prefill span under ``req``'s resident span (None when
        untraced)."""
        ts = req.tspans
        if ts is None:
            return None
        return ts["tr"].start("replica::prefill",
                              parent=ts.get("res") or ts["parent"],
                              tags={"kind": kind})

    def _admit(self):
        lat, prices, q_snap = None, {}, None
        while self._queue:
            slot = next((i for i, s in enumerate(self._slots) if s is None),
                        None)
            if slot is None:
                return
            if self._admission is not None:
                if lat is None:
                    lat = self.latency_stats()

                # each queued request priced at most once per call
                def _price(r):
                    v = prices.get(r.rid)
                    if v is None:
                        v = prices[r.rid] = self._uncached_tokens(r)
                    return v
                q_snap = list(self._queue)
                qi = self._admission.select(q_snap, _price, lat)
                if qi is None:
                    return                   # the policy defers them all
                req = q_snap[qi]
            else:
                qi, req = 0, self._queue[0]
            toks = self._req_tokens(req)
            L = len(toks)
            need = -(-L // self.page_size)
            # prefix sharing: map every fully matched page; a full-prompt
            # match keeps the boundary page shared too and copies it on
            # write, otherwise the page holding the first unmatched token
            # is recomputed by the suffix prefill. n_lock * page_size < L,
            # so decode positions land beyond the shared region.
            n_lock, fast, m = 0, False, 0
            if self._prefix is not None:
                m = self._prefix.match(toks)
                fast = m >= L
                n_lock = (L - 1) // self.page_size if fast \
                    else m // self.page_size
            pages = self._alloc_pages(need - n_lock,
                                      protect=toks if m else None)
            if pages is None:
                if any(s is not None for s in self._slots):
                    return                   # wait for pages to free up
                if m:
                    # nothing running, and the protected match path holds
                    # the pages the private remainder needs: admit cold
                    n_lock, fast = 0, False
                    pages = self._alloc_pages(need)
                if pages is None:
                    raise RuntimeError(
                        f"request {req.rid} needs {need} pages but the "
                        f"pool holds {self._total_pages}; raise num_pages")
            if self._admission is not None:
                # pages really claimed: now the requests passed over are
                # charged a skip
                self._admission.note_admitted(q_snap, qi)
                del self._queue[qi]
            else:
                self._queue.popleft()
            if self._prefix is not None:
                lock = (self._prefix.lock_prefix(toks, n_lock) if n_lock
                        else self._prefix.new_lock())
                self._tree_locks[slot] = lock
                self.tables[slot, :n_lock] = lock.pages()
                self._prefix_prompt_tokens += L
                self.prefix_hit_tokens += (L - 1) if fast \
                    else n_lock * self.page_size
            self.tables[slot, n_lock:n_lock + len(pages)] = pages
            self._tables_dirty = True
            self._slots[slot] = req
            req.slot = slot
            if req.tspans is not None:
                ts = req.tspans
                q = ts.pop("queue", None)
                if q is not None:     # absent on preemption re-admits
                    q.tag(outcome="admitted", slot=slot).end()
                rsp = ts["tr"].start("replica::resident",
                                     parent=ts["parent"],
                                     tags={"slot": slot})
                if rsp is not None:
                    ts["res"] = rsp
                ts["last"] = time.time()
            self._dosample[slot] = req.do_sample
            req.prefill_target = L
            if fast:
                # positions < L - 1 of the shared page matched, so their
                # K/V are what this request would compute; the copy takes
                # position L - 1 onwards
                src = self._prefix.page_at(toks, n_lock)
                if src is None:
                    raise RuntimeError("the matched tail page vanished")
                self.prefix_cow_copies += 1
                psp = self._prefill_span(req, "cow")
                with RecordEvent("serving::prefill"):
                    logits = self._tail_logits(slot, int(toks[L - 1]),
                                               L - 1, src, pages[0])
                if psp is not None:
                    psp.end()
                req.prefilled = L
                self._activate(slot, req, logits)
                self._insert_prefix(slot, req)
                continue
            off = n_lock * self.page_size
            if self.chunked_prefill:
                # pages claimed now; K/V written one chunk a tick from
                # the page-aligned end of the shared prefix
                req.prefilled = off
                self._proj_pos[slot] = 0
                self._proj_gen[slot] = 0
                continue
            req.prefilled = L
            psp = self._prefill_span(req, "suffix" if off else "full")
            with RecordEvent("serving::prefill"):
                if off:
                    # the suffix only, from the page-aligned offset,
                    # attending over the mapped shared history plus itself
                    logits = self._chunk_logits(slot, toks, off,
                                                self._bucket(L) - off, L - 1)
                else:
                    logits = self._prefill(slot, toks)
            if psp is not None:
                psp.end()
            self._activate(slot, req, logits)
            if self._prefix is not None:
                self._insert_prefix(slot, req)

    def _prefill_tick(self):
        """Advance the oldest in-prefill slot by one chunk."""
        cand = [(self._slots[s].rid, s) for s in range(self.max_batch)
                if self._slots[s] is not None
                and not self._decode_ready(self._slots[s])]
        if not cand:
            return
        slot = min(cand)[1]
        req = self._slots[slot]
        C, off = self.prefill_chunk, req.prefilled
        psp = self._prefill_span(req, "chunk")
        with RecordEvent("serving::prefill"):
            logits = self._chunk_logits(
                slot, self._req_tokens(req), off, C,
                min(req.prefill_target - 1, off + C - 1))
        if psp is not None:
            psp.tag(off=off).end()
        req.prefilled = min(off + C, self._bucket(req.prefill_target))
        if req.prefilled >= req.prefill_target:
            self._activate(slot, req, logits)
            if self._prefix is not None:
                self._insert_prefix(slot, req)

    # -- decode -------------------------------------------------------------

    def _pick(self, lf: torch.Tensor, off: int,
              any_sample: bool) -> torch.Tensor:
        """The token each row emits from fp32 logits ``lf`` [B, V] at
        stream position gen + ``off``: argmax, or the per-row sampler."""
        if not any_sample:
            return torch.argmax(lf, dim=-1)
        kn = self._knobs
        return sample_logits_per_slot(
            lf, kn["temp"], kn["topk"], kn["topp"], kn["dosample"],
            self.cfg.seed, kn["rseed"], self._state["gen"] + off)

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
            tok = self._pick(st["logits"].float(), 0, any_sample)
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

    def _spec_tick(self, any_sample: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One speculative tick on the device, with no host sync: the
        first token from the carried logits (committed unconditionally),
        ``spec_k`` drafts from the history including it, one
        ``spec_k + 1``-wide verify, and the agreeing prefix committed
        through the same stop update the decode block carries (eos or
        budget inside the accepted run truncates it, rejection through
        the prefix count). Returns device [spec_k + 1, B] tokens and kept
        masks; positions advance by the committed count only, so rejected
        drafts' K/V are overwritten by the next verify or sit on the
        garbage page."""
        st, kn = self._state, self._knobs
        k, hist = self.spec_k, self._hist
        B, H = hist.shape
        pos, active = st["pos"], st["active"]
        rows = torch.arange(B, device=self.device)
        tok0 = self._pick(st["logits"].float(), 0, any_sample)
        tok0 = torch.where(active, tok0, 0)
        wp = pos.clamp_max(H - 1)
        hist[rows, wp] = torch.where(active, tok0, hist[rows, wp])
        drafts = self._draft.propose(hist, pos + active.long(), k)
        drafts = torch.where(active[:, None], drafts.long(), 0)
        inputs = torch.cat([tok0[:, None], drafts], dim=1)   # [B, k + 1]
        tbl = self._tables_dev * active[:, None].to(self._tables_dev.dtype)
        h, _ = self.core.decode_verify_paged(inputs, pos, self.pools, tbl)
        logits_all = self.model.logits(h)                    # [B, k + 1, V]
        lf_all = logits_all.float()
        targets = torch.stack([self._pick(lf_all[:, j - 1], j, any_sample)
                               for j in range(1, k + 1)], dim=1)
        n_commit = 1 + torch.cumprod((drafts == targets).long(),
                                     dim=1).sum(dim=1)       # [B] 1..k+1
        alive, bud = active, st["budget"]
        toks = torch.empty((k + 1, B), dtype=torch.int64, device=self.device)
        kept = torch.empty((k + 1, B), dtype=torch.bool, device=self.device)
        for j in range(k + 1):
            tj = inputs[:, j]
            commit = alive & (j < n_commit)
            toks[j] = torch.where(commit, tj, 0)
            kept[j] = commit
            cont, bud = decode_stop_update(tj, commit, bud, kn["eos"])
            alive = torch.where(commit, cont, alive)
        nkept = kept.long().sum(dim=0)
        for j in range(1, k + 1):
            wp = (pos + j).clamp_max(H - 1)
            hist[rows, wp] = torch.where(kept[j], toks[j], hist[rows, wp])
        # the carried logits: the row after the last accepted token, whose
        # whole input prefix matched the committed stream (a row stopped
        # inside the run retires, so its carry is never read)
        sel = (n_commit - 1).clamp_max(k)
        st["logits"].copy_(logits_all[rows, sel])
        st["pos"].add_(nkept)
        st["gen"].add_(nkept)
        st["budget"].copy_(bud)
        st["active"].copy_(alive)
        return toks, kept

    def _participants(self) -> List[Tuple[int, _Request]]:
        """Slots the next block decodes for: prefilled and not yet
        scheduled through their whole budget. With speculation the
        projection assumes the largest stride, so a slot is excluded
        only when the least its in-flight blocks can have committed (one
        token each while the row lives) exhausts its budget; otherwise
        its row, still active on the device, would commit tokens that no
        drain reads."""
        if self.spec_k:
            def _done(s, r):
                # only this request's blocks: a reused slot may sit in
                # stale blocks of its previous occupant
                min_gen = len(r.generated) + sum(
                    1 for b in self._inflight
                    if any(s2 == s and r2 is r
                           for s2, r2 in b.participants))
                return min_gen >= r.max_new_tokens
            return [(s, r) for s in range(self.max_batch)
                    if self._decode_ready(r := self._slots[s])
                    and not _done(s, r)]
        return [(s, r) for s in range(self.max_batch)
                if self._decode_ready(r := self._slots[s])
                and int(self._proj_gen[s]) < r.max_new_tokens]

    def _ensure_decode_pages(self, K: int):
        """Claim every page a decoding slot may write within the next K
        steps (against its projected position, capped by its remaining
        budget); preempt when the pool is dry. Admission keeps the mapped
        prefix below the first decode position and donation takes only
        pages wholly behind it, so a tree-owned page in that span is a
        broken invariant and raises."""
        for slot in range(self.max_batch):
            req = self._slots[slot]
            if not self._decode_ready(req):
                continue              # mid-prefill slots claim at admission
            pos = int(self._proj_pos[slot])
            span = min(K, req.max_new_tokens - int(self._proj_gen[slot]))
            if span <= 0:
                continue
            first = pos // self.page_size
            last = (pos + span - 1) // self.page_size
            for pidx in range(first, last + 1):
                if pidx >= self.pages_per_seq:
                    raise RuntimeError("sequence exceeded engine max_len")
                existing = int(self.tables[slot, pidx])
                if existing != 0:
                    if self._prefix is not None \
                            and self._prefix.owns(existing):
                        raise RuntimeError(f"decode would write the shared "
                                           f"page {existing}")
                    continue
                self.tables[slot, pidx] = self._claim_one(slot)
                self._tables_dirty = True

    def _claim_one(self, exclude_slot: int) -> int:
        """One page for a decode-time claim; recompute-preempts another
        request (the admission policy's victim, else the newest) once the
        pool and the evictable prefix tree are dry, raising _PoolDry
        first while blocks are in flight."""
        page = self._alloc_pages(1)
        while page is None:
            if self._inflight:
                raise _PoolDry()
            cands = [i for i in range(self.max_batch)
                     if self._slots[i] is not None and i != exclude_slot]
            if not cands:
                raise RuntimeError("page pool too small for one request")
            if self._admission is not None:
                infos = []
                for i in cands:
                    r = self._slots[i]
                    priv = shared = 0
                    for p in self.tables[i]:
                        if p == 0:
                            continue
                        if self._prefix is not None \
                                and self._prefix.owns(int(p)):
                            shared += 1
                        else:
                            priv += 1
                    infos.append(VictimInfo(slot=i, rid=r.rid,
                                            progress=len(r.generated),
                                            private_pages=priv,
                                            shared_pages=shared))
                victim = self._admission.choose_victim(infos)
            else:
                victim = max(cands, key=lambda i: self._slots[i].rid)
            self.preemptions += 1
            vreq = self._slots[victim]
            self._deactivate(victim)
            # the victim's completed pages go to the tree (prefix mode):
            # its replay maps them instead of prefilling again
            self._free_slot(victim, cache=True)
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
            if self.spec_k:
                # a fixed spec_k + 1-row tick; drafts written past the
                # claimed pages land on the garbage page
                K = self.spec_k + 1
            else:
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
            self._tables_dev = self._to_device(self.tables)
            self._tables_dirty = False
        with RecordEvent("serving::dispatch"):
            if self.spec_k:
                # the verify forward has its own context attention: no
                # fork
                with self._block_census(("spec", self.spec_k, any_sample)):
                    toks, kept = self._spec_tick(any_sample)
            else:
                # the route from the batch's largest context after this
                # block
                ctx_len = max(int(self._proj_pos[s]) for s, _ in parts) + K
                attn_impl = ("dense" if ctx_len <= self.attn_crossover
                             else "paged")
                self.attn_path_ticks[attn_impl] += 1
                with force_decode_impl(attn_impl), self._block_census(
                        ("decode", K, any_sample, attn_impl)):
                    toks, kept = self._decode_block(K, any_sample)
        self.decode_blocks += 1
        if self.kv_quant:
            self.kv_quant_ticks += 1
        stride: Optional[Dict[int, int]] = {} if self.spec_k else None
        for s, req in parts:
            steps = min(K, req.max_new_tokens - int(self._proj_gen[s]))
            if self.spec_k:
                # a slot whose projection is saturated rides along so its
                # device commits drain, projecting nothing new
                steps = max(0, steps)
                stride[s] = steps
            self._proj_gen[s] += steps
            self._proj_pos[s] += steps
        blk = self._start_drain(toks, kept, parts, K, stride)
        if self._census_pending:
            self._census_pending = False
            self._census_block = blk
        self._inflight.append(blk)
        return True

    def _start_drain(self, toks, kept, parts, K, steps) -> _InflightBlock:
        """Copy the block's outputs to host buffers: pinned and
        non-blocking on the card, with an event marking arrival."""
        srcs = [toks, kept, self._state["active"]]
        if self.spec_k:
            srcs.append(self._state["pos"])
        if self.device.type != "cuda":
            host = [t.clone() for t in srcs]
            event = None
        else:
            host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    for t in srcs]
            for h, t in zip(host, srcs):
                h.copy_(t, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        pos = host[3] if self.spec_k else None
        return _InflightBlock(host[0], host[1], host[2], pos, event, parts,
                              K, steps)

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
        slots whose done flag came back, stamp arrival latencies, and in
        speculative mode re-anchor the projections at the drained truth."""
        blk = self._inflight.popleft()
        with RecordEvent("serving::drain"):
            if blk.event is not None:
                blk.event.synchronize()
            toks, kept = blk.toks.numpy(), blk.kept.numpy()
            active_after = blk.active.numpy()
        emitted: List[tuple] = []
        now = time.perf_counter()
        if _REG.enabled:
            # cost observatory: drain-to-drain gaps are the measured
            # seconds a block its breakdown divides; the gap that ends at
            # a censused block's drain holds the census, so the series
            # restarts there
            if blk is self._census_block:
                self._census_block = None
                self._drain_stamps.clear()
            self._drain_stamps.append(now)
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
                self._tokens_emitted += nk
                if self.spec_k:
                    # every committing drain scored spec_k drafts; commits
                    # beyond the tick's first token are accepted drafts
                    self._spec_drains += 1
                    self.spec_tokens_proposed += self.spec_k
                    self.spec_tokens_accepted += nk - 1
                if req.last_emit_t:
                    req.itl_gaps.extend([(now - req.last_emit_t) / nk] * nk)
                req.last_emit_t = now
                if req.tspans is not None:
                    # one replica::decode span a committing drain, from
                    # the previous commit to this one
                    ts = req.tspans
                    wnow = time.time()
                    sp = ts["tr"].start(
                        "replica::decode",
                        parent=ts.get("res") or ts["parent"],
                        start=ts.get("last", wnow), tags={"n": nk})
                    if sp is not None:
                        sp.end(wnow)
                    ts["last"] = wnow
            if not active_after[slot]:
                req.done = True
                req.done_t = now
                self._requests_retired += 1
                self._latencies.append((req.first_tok_t - req.submit_t,
                                        req.done_t - req.submit_t,
                                        len(req.generated)))
                self._itl_gaps.extend(req.itl_gaps)
                self._free_slot(slot, cache=True)
        if self.spec_k:
            # the projection assumed the largest stride per block; the
            # device may have committed fewer. Tables keep every page ever
            # claimed, so claim coverage stays ahead of the commits.
            pos_after = blk.pos.numpy()
            for slot, req in blk.participants:
                if self._slots[slot] is not req or req.done:
                    continue
                extra = sum((b2.steps or {}).get(slot, 0)
                            for b2 in self._inflight)
                self._proj_gen[slot] = len(req.generated) + extra
                self._proj_pos[slot] = int(pos_after[slot]) + extra
        return emitted

    def _check_page_invariants(self) -> None:
        """Test hook: every pool page is exactly one of free / private to
        ONE table / tree-owned with ``node.ref`` equal to the tables
        mapping it, and none is lost."""
        free = [int(p) for p in self._free]
        assert len(set(free)) == len(free), "duplicate pages in free list"
        assert 0 not in free, "garbage page leaked into the free list"
        mapped = Counter(int(p) for row in self.tables for p in row if p)
        tree = dict(self._prefix._pages) if self._prefix is not None \
            else {}
        assert not set(free) & set(mapped), "page both free and mapped"
        assert not set(free) & set(tree), "page both free and tree-owned"
        for p, node in tree.items():
            assert mapped.get(p, 0) == node.ref, (
                f"tree page {p}: refcount {node.ref} != "
                f"{mapped.get(p, 0)} mapping tables")
        for p, c in mapped.items():
            if p not in tree:
                assert c == 1, f"private page {p} mapped by {c} tables"
        accounted = (len(free) + len(tree)
                     + sum(1 for p in mapped if p not in tree))
        assert accounted == self._total_pages, (
            f"page leak: {self._total_pages - accounted} unaccounted")
        if self._prefix is not None:
            self._prefix.check()


__all__ = ["ContinuousBatchingEngine", "HANDOFF_FMT", "HANDOFF_FMT_V1",
           "HANDOFF_DTYPES"]
