"""ServingFabric: the front door over N replicas (copy of
``paddle_tpu/serving_fabric/router.py`` without its SLO-sentry ticks).

One router owns the GLOBAL request queue and drives every replica
through a :class:`~.transport.FabricTransport`. Per scheduler pass
(``step()``):

1. **Heartbeat** — refresh each replica's status (load, pool, latency
   percentiles, prefix digest) and run the ITL hysteresis: a replica
   whose ``itl_p99`` breaches the target goes HOT (affinity stops
   pinning it) and only cools once it recovers past the band — no
   flapping at the threshold.
2. **Release + route** — the per-tenant weighted fair policy (when
   installed) picks which request leaves the global queue; routing then
   picks the replica: ``affinity`` routes to the longest
   digest-matched prefix (ties and cold prompts fall back to
   least-loaded = free slots × free pages), ``least-loaded`` and
   ``round-robin`` are the baselines. Dispatch is capacity-gated (a
   replica is only handed requests while it has free slots), so the
   global queue — where fairness and SLO policy live — stays the ONE
   place requests wait.
3. **Disaggregation** — a cold prompt whose priced uncached suffix
   reaches ``disagg_threshold_tokens`` is routed to a PREFILL-role
   replica first (budget 1 token); on completion its KV pages + radix
   path cross to a decode replica via serialize_pages → adopt_pages
   (seeding that replica's tree — the transfer IS a future prefix hit)
   and the real request is submitted there, where admission
   prefix-hits and decode ITL never sees the long prefill.
4. **Poll + failover** — drain every replica one engine tick; any op
   raising :class:`ReplicaDown` re-queues that replica's in-flight
   requests at the FRONT with ``replay_prefix=`` the tokens already
   delivered and the ORIGINAL ``rseed`` — the survivor re-prefills the
   prefix (cheap when its tree holds it) and continues the stream
   token-identically with the remaining budget. Zero duplicates (the
   engine never re-emits a replay prefix), zero losses (the router's
   delivered list is authoritative).

Everything observable publishes through the metrics registry under
``pt_fabric_*`` (per-replica/per-tenant label sets).
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..observability.metrics import REGISTRY as _REG
from ..observability.tracing import TRACER as _TRACE, TraceContext
from .digest import PrefixDigest
from .fair import TenantFairPolicy
from .robust import AllReplicasDown, LoadShedder
from .transport import FabricTransport, ReplicaDown

__all__ = ["FabricRequest", "ServingFabric"]


@dataclass
class FabricRequest:
    """One logical request as the router tracks it across replicas."""
    fid: int
    prompt: np.ndarray
    max_new_tokens: int
    tenant: str = "default"
    knobs: Optional[dict] = None
    state: str = "queued"       # queued | prefill | decode | done | failed
    error: Optional[str] = None      # set when state == "failed"
    replica: Optional[str] = None
    local_rid: Optional[int] = None
    # sampling-stream identity override: a retry of an earlier logical
    # request reuses ITS rseed so the continuation is token-identical
    rseed: Optional[int] = None
    ttft_deadline_ms: Optional[float] = None
    deadline_ms: Optional[float] = None
    delivered: List[int] = field(default_factory=list)
    result: Optional[np.ndarray] = None
    prefill_done: bool = False
    handoff_pages: int = 0
    readmissions: int = 0
    submit_t: float = 0.0
    first_tok_t: float = 0.0
    last_emit_t: float = 0.0
    done_t: float = 0.0
    itl_gaps: List[float] = field(default_factory=list)
    # tracing: ``trace`` is the request's span (child of the caller's
    # context, or itself a root on a bare fabric),
    # ``tqueue`` the open queue-wait span, ``tctx`` the wire dict
    # replica payloads carry. All None on untraced requests — every
    # tracing touch on the hot path guards on that one attribute.
    trace: Optional[object] = None
    tqueue: Optional[object] = None
    tctx: Optional[dict] = None


class ServingFabric:
    """Router + replica pool; see module doc.

    ``policy`` — "affinity" (default), "least-loaded" or "round-robin".
    ``fair`` — optional :class:`TenantFairPolicy`; None releases FIFO.
    ``itl_p99_target_s`` — per-replica ITL SLO driving the affinity
    hysteresis (None disables it).
    ``hysteresis_band`` — a hot replica cools only below
    ``target × (1 - band)``.
    ``disagg_threshold_tokens`` — priced uncached suffix at or above
    this routes through a prefill-role replica first (None disables
    disaggregation).
    ``affinity_min_pages`` — digest matches shorter than this count as
    cold (least-loaded fallback)."""

    POLICIES = ("affinity", "least-loaded", "round-robin")

    def __init__(self, transport: FabricTransport,
                 policy: str = "affinity",
                 fair: Optional[TenantFairPolicy] = None,
                 itl_p99_target_s: Optional[float] = None,
                 hysteresis_band: float = 0.25,
                 disagg_threshold_tokens: Optional[int] = None,
                 affinity_min_pages: int = 1,
                 shedder: Optional[LoadShedder] = None,
                 default_retry_after_ms: float = 250.0,
                 name: Optional[str] = None):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; pick one of "
                             f"{self.POLICIES}")
        self.transport = transport
        self.policy = policy
        # fabric identity: same rule the engines follow with engine= —
        # two routers in one process (a bench A/B) must not merge
        # their pt_fabric_* series
        self.name = name or ""
        self._flabels: Dict[str, str] = ({"fabric": self.name}
                                         if self.name else {})
        self.fair = fair
        self.itl_p99_target_s = itl_p99_target_s
        self.hysteresis_band = float(hysteresis_band)
        self.disagg_threshold_tokens = disagg_threshold_tokens
        self.affinity_min_pages = int(affinity_min_pages)
        self.shedder = shedder
        self.default_retry_after_ms = float(default_retry_after_ms)
        self._browned = False
        # local rids a dead replica still held: on breaker readmission
        # they are best-effort cancelled so the recovered engine stops
        # burning pages on streams a survivor already re-owns
        self._stale_rids: Dict[str, List[int]] = {}
        self._fid = 0
        self._reqs: Dict[int, FabricRequest] = {}
        self._queue: deque = deque()
        self._assign: Dict[Tuple[str, int], int] = {}
        self._status: Dict[str, dict] = {}
        self._digests: Dict[str, PrefixDigest] = {}
        self._dead: set = set()
        self._hot: set = set()
        self._outstanding: Dict[str, int] = {}
        self._rr = 0
        # lifetime telemetry (plain attrs; registry mirrors on events)
        self.routed: Dict[str, int] = {}
        self.affinity_hits = 0
        self.misrouted = 0
        self.cold_routes = 0
        self.handoffs = 0
        self.handoff_bytes = 0
        self.handoff_failures = 0
        self.readmitted = 0
        self.failed: Dict[int, str] = {}    # fid -> replica rejection
        # fid -> (epoch signature, price): _est_uncached runs several
        # times per request per pass (fair price, dispatch cost, the
        # disagg gate); the blake2b chain replay only changes when a
        # digest epoch or the replay length moves
        self._price_memo: Dict[int, tuple] = {}
        self._latencies = deque(maxlen=10_000)
        self._itl_gaps = deque(maxlen=100_000)

    # -- public API ----------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               tenant: str = "default",
               knobs: Optional[dict] = None,
               ttft_deadline_ms: Optional[float] = None,
               deadline_ms: Optional[float] = None,
               rseed: Optional[int] = None,
               replay: Optional[List[int]] = None,
               trace: Optional[TraceContext] = None) -> int:
        """Queue one request; returns its fabric id. ``knobs`` (optional
        dict of do_sample/temperature/top_k/top_p/eos_token_id)
        overrides the replica engines' default GenerationConfig. The
        fabric id doubles as the sampling-stream identity (``rseed``),
        so a request's sampled tokens are the same whichever replica —
        or sequence of replicas, after a failover — serves it.

        Lifecycle knobs: ``ttft_deadline_ms`` / ``deadline_ms``
        bound time-to-first-token and total latency (a miss CANCELs the
        request, frees its slot/pages and fails it typed). ``rseed`` +
        ``replay`` let an idempotent RETRY of an earlier logical request
        resume its exact stream: same rseed ⇒ same sampling keys, the
        replay prefix is never re-emitted, so the retry delivers exactly
        the tokens the first attempt didn't.

        Raises :class:`~.robust.AllReplicasDown` when no replica is
        reachable and :class:`~.robust.Overloaded` when the shed ladder
        refuses this tenant — both carry ``retry_after_ms``."""
        if not self._alive_names():
            raise AllReplicasDown(
                "serving fabric: every replica is down; submission "
                "refused", retry_after_ms=self._retry_after_ms())
        if self.shedder is not None:
            w = (self.fair.spec(tenant).weight
                 if self.fair is not None else 1.0)
            self.shedder.admit(str(tenant), w, len(self._queue))
        ids = np.asarray(prompt, np.int32).reshape(-1)
        req = FabricRequest(self._fid, ids, int(max_new_tokens),
                            tenant=str(tenant), knobs=knobs,
                            rseed=rseed,
                            ttft_deadline_ms=ttft_deadline_ms,
                            deadline_ms=deadline_ms)
        if replay:
            req.delivered = [int(t) for t in replay]
        req.submit_t = time.perf_counter()
        if _TRACE.enabled:
            # ``trace`` (the caller's root context) parents this
            # request's span; a bare fabric submit mints its own root.
            # The queue span opens NOW: fair-admission wait is part of
            # the queue hop, readmissions add sibling queue spans.
            sp = _TRACE.start("fabric::request", parent=trace,
                              tags={"fid": req.fid,
                                    "tenant": req.tenant})
            req.trace = sp
            req.tctx = sp.ctx.to_wire()
            req.tqueue = _TRACE.start("fabric::queue", parent=sp,
                                      tags={"readmission": 0})
        self._fid += 1
        self._reqs[req.fid] = req
        self._queue.append(req)
        return req.fid

    def cancel(self, fid: int, error: str = "cancelled") -> bool:
        """Terminate ``fid`` NOW (client disconnect, slow-loris
        eviction, deadline miss): dequeue it, cancel it replica-side so
        its slot/pages free through the engine's one ``_free_slot``
        path, and fail it with ``error``. True when it existed and had
        not already finished."""
        req = self._reqs.get(fid)
        if req is None or req.state in ("done", "failed"):
            return False
        try:
            self._queue.remove(req)
        except ValueError:
            pass
        if req.replica is not None and req.local_rid is not None:
            self._assign.pop((req.replica, req.local_rid), None)
            self._outstanding[req.replica] = max(
                0, self._outstanding.get(req.replica, 0) - 1)
            try:
                self.transport.cancel(req.replica, req.local_rid)
            except Exception:       # noqa: BLE001 — replica down or
                pass                # transport can't cancel: the slot
                                    # is reaped with the replica instead
        req.state, req.error = "failed", error
        self._trace_done(req)
        return True

    # -- tracing hooks -------------------------------------------------------

    @staticmethod
    def _trace_done(req: FabricRequest, **tags) -> None:
        """Terminal state: close the request's open spans exactly once.
        Ending the span completes the trace when the fabric owns the
        root (no caller context above)."""
        sp = req.trace
        if sp is None:
            return
        req.trace = None
        q = req.tqueue
        if q is not None:
            req.tqueue = None
            q.tag(outcome=req.state).end()
        sp.tag(state=req.state,
               error=req.error, readmissions=req.readmissions, **tags)
        sp.end()

    @staticmethod
    def _trace_route(req: FabricRequest, t0: float, name: str,
                     how: str) -> None:
        """The route DECISION as a span: [dispatch-pass entry → submit
        accepted], tagged with the policy's verdict (affinity hit /
        spill / cold / rr / ll / prefill / disagg)."""
        if req.trace is not None and _TRACE.enabled:
            sp = _TRACE.start("fabric::route", parent=req.trace,
                              start=t0, tags={"replica": name,
                                              "how": how})
            sp.end()

    def has_work(self) -> bool:
        return any(r.state not in ("done", "failed")
                   for r in self._reqs.values())

    def step(self) -> List[Tuple[int, int]]:
        """One fabric pass: heartbeat → dead-replica probes → shed ladder
        → release+route → poll → deadline sweep. Returns the (fid, token)
        pairs delivered this pass."""
        self._refresh_status()
        self._probe_dead()
        if self.shedder is not None:
            # percentile aggregation only when a latency ceiling is
            # actually armed — queue depth alone is a dict len
            lat = (self.latency_stats()
                   if (self.shedder.ttft_p99_ceiling_s is not None
                       or self.shedder.itl_p99_ceiling_s is not None)
                   else {})
            self._apply_brownout(
                self.shedder.observe(len(self._queue), lat))
        self._dispatch_queue()
        delivered = self._poll_replicas()
        self._enforce_deadlines()
        if _REG.enabled:
            self._tick_gauges()
        return delivered

    def take_finished(self) -> Dict[int, Optional[np.ndarray]]:
        """Release every finished request: {fid: full stream} (None for
        a failed one, its error text kept in ``self.failed[fid]``) —
        the streaming front door's harvest; run() is this in a loop."""
        out: Dict[int, Optional[np.ndarray]] = {}
        for fid, r in list(self._reqs.items()):
            if r.state == "done":
                out[fid] = r.result
            elif r.state == "failed":
                out[fid] = None
                self.failed[fid] = r.error or "rejected"
            else:
                continue
            del self._reqs[fid]
        return out

    def run(self) -> Dict[int, np.ndarray]:
        """Drive until every submitted request completes; returns
        {fid: full token stream} for the requests finished by this call
        and releases them (same contract as the engine's run()). A
        request a replica REJECTED at submit (deterministic application
        error, e.g. a prompt no pool can hold) maps to None here and
        its error text is kept in ``self.failed[fid]``."""
        out: Dict[int, Optional[np.ndarray]] = {}
        while self.has_work():
            if not self._alive_names():
                left = sum(r.state not in ("done", "failed")
                           for r in self._reqs.values())
                raise AllReplicasDown(
                    f"serving fabric: every replica is down with {left} "
                    f"requests outstanding",
                    retry_after_ms=self._retry_after_ms())
            self.step()
            out.update(self.take_finished())
        out.update(self.take_finished())
        if _REG.enabled:
            self.publish_metrics()
        return out

    # -- heartbeat / hysteresis ----------------------------------------------

    def _alive_names(self) -> List[str]:
        return [n for n in self.transport.replica_names()
                if n not in self._dead]

    def _role(self, name: str) -> str:
        st = self._status.get(name)
        return st.get("role", "both") if st else "both"

    def _app_error(self, name: str, op: str, e: Exception) -> None:
        """A live replica answered an op with an APPLICATION error
        (engine raised, remote answered ok:false). The router owns
        recovery and a broken engine cannot be reasoned with: treat it
        as a failed replica — its requests re-admit on survivors — and
        never let the exception kill the fabric loop."""
        import warnings
        warnings.warn(f"serving fabric: replica {name!r} failed "
                      f"{op} ({e!r}); treating it as down",
                      RuntimeWarning)
        self._on_replica_down(name)

    def _refresh_status(self) -> None:
        for name in self._alive_names():
            try:
                st = self.transport.status(name)
            except ReplicaDown:
                self._on_replica_down(name)
                continue
            except (ValueError, RuntimeError) as e:
                self._app_error(name, "status", e)
                continue
            self._status[name] = st
            d = st.get("digest")
            if d is not None:
                cur = self._digests.get(name)
                if cur is None or cur.epoch != d.get("epoch"):
                    self._digests[name] = PrefixDigest.from_dict(d)
            if self.itl_p99_target_s is not None:
                itl = st.get("itl_p99_s")
                if itl is not None:
                    if itl > self.itl_p99_target_s:
                        self._hot.add(name)
                    elif itl < self.itl_p99_target_s * (
                            1.0 - self.hysteresis_band):
                        self._hot.discard(name)

    def probe_recovery(self) -> None:
        """Public half-open probe pass: drive readmission while the
        fabric is otherwise IDLE (step() probes as part of every busy
        pass, but a recovered replica must not stay quarantined just
        because traffic paused)."""
        self._probe_dead()

    def _probe_dead(self) -> None:
        """Half-open probing: when the transport can ``probe``, ask it to
        probe each replica the router holds as dead; a replica that
        passes is readmitted into routing. Stale local
        rids it still held are best-effort cancelled — the survivors
        re-own those streams, the recovered engine must not keep
        burning pages on them. A genuinely crashed replica's probe just
        keeps failing: readmission only ever follows demonstrated
        progress."""
        probe = getattr(self.transport, "probe", None)
        if probe is None or not self._dead:
            return
        for name in sorted(self._dead):
            try:
                ok = bool(probe(name))
            except Exception:       # noqa: BLE001 — a probe must never
                ok = False          # kill the fabric loop
            if not ok:
                continue
            self._dead.discard(name)
            for rid in self._stale_rids.pop(name, ()):
                try:
                    self.transport.cancel(name, rid)
                except Exception:   # noqa: BLE001 — best-effort reap
                    pass
            if _REG.enabled:
                _REG.counter("pt_fabric_replica_readmitted_total",
                             "replicas readmitted after a breaker "
                             "half-open probe succeeded").inc(
                    replica=name, **self._flabels)

    def _retry_after_ms(self, default: Optional[float] = None) -> float:
        """Server-side recovery estimate for typed rejections: the
        breaker's soonest half-open window when one is armed, else the
        configured default."""
        hint = getattr(self.transport, "retry_after_ms", None)
        v = None
        if callable(hint):
            try:
                v = hint()
            except Exception:       # noqa: BLE001 — hint is advisory
                v = None
        if v is None:
            v = (self.default_retry_after_ms
                 if default is None else default)
        return float(v)

    def _apply_brownout(self, level: int) -> None:
        """Level 2 pushes the draft-budget cap to every live replica
        (``spec_k`` shrink: verification-exact, just fewer drafts per
        tick — FLOPs shift from speculation to admitted decodes);
        leaving level 2 restores construction-time values."""
        want = level >= 2
        if want == self._browned:
            return
        knobs = {"spec_k": (self.shedder.spec_k_cap if want else None)}
        for name in self._alive_names():
            try:
                self.transport.configure(name, knobs)
            except Exception:       # noqa: BLE001 — a replica that
                pass                # can't configure just keeps its k
        self._browned = want

    def _enforce_deadlines(self) -> None:
        """Drain-boundary deadline sweep: a request past its TTFT or
        total budget is CANCELLED (slot/pages freed replica-side) and
        fails typed — the budget is spent, finishing late serves
        nobody and the capacity goes to requests that can still make
        theirs."""
        now = time.perf_counter()
        for req in list(self._reqs.values()):
            if req.state in ("done", "failed"):
                continue
            age_ms = (now - req.submit_t) * 1000.0
            kind = None
            if (req.deadline_ms is not None
                    and age_ms > req.deadline_ms):
                kind = "total"
            elif (req.ttft_deadline_ms is not None
                    and req.first_tok_t == 0.0 and not req.delivered
                    and age_ms > req.ttft_deadline_ms):
                kind = "ttft"
            if kind is None:
                continue
            self.cancel(req.fid, error=f"deadline_exceeded:{kind}")
            if _REG.enabled:
                _REG.counter("pt_frontdoor_deadline_miss_total",
                             "requests cancelled past their deadline"
                             ).inc(kind=kind, **self._flabels)

    # -- routing -------------------------------------------------------------

    def _capacity(self, name: str) -> int:
        st = self._status.get(name)
        if st is None:
            return 0
        return st.get("max_batch", 0) - self._outstanding.get(name, 0)

    def _load_score(self, name: str) -> Tuple:
        """Higher = less loaded: free slots × free pages, then free
        slots, then stable name order for determinism."""
        st = self._status.get(name) or {}
        free_slots = max(0, self._capacity(name))
        free_pages = st.get("free_pages", 0)
        return (free_slots * (free_pages + 1), free_slots)

    def _least_loaded(self, cands: List[str]) -> str:
        return max(sorted(cands), key=self._load_score)

    def _digest_match(self, name: str, tokens) -> int:
        d = self._digests.get(name)
        return 0 if d is None else d.match_pages(tokens)

    def _est_uncached(self, req: FabricRequest) -> int:
        """Router-side price of admitting ``req`` now: its replay token
        run minus the BEST digest match across serving replicas — the
        same uncached-suffix unit the per-replica admission prices
        with, estimated from heartbeat state."""
        toks = self._replay_tokens(req)
        names = self._serving_names()
        sig = (len(toks), tuple(
            (n, self._digests[n].epoch) for n in names
            if n in self._digests))
        hit = self._price_memo.get(req.fid)
        if hit is not None and hit[0] == sig:
            return hit[1]
        best_pages, ps = 0, None
        for n in names:
            d = self._digests.get(n)
            if d is None:
                continue
            ps = d.page_size
            best_pages = max(best_pages, d.match_pages(toks))
        price = len(toks) if ps is None else max(
            1, len(toks) - best_pages * ps)
        if len(self._price_memo) > 4096:
            self._price_memo.clear()       # bound stale-fid growth
        self._price_memo[req.fid] = (sig, price)
        return price

    @staticmethod
    def _replay_tokens(req: FabricRequest) -> np.ndarray:
        if not req.delivered:
            return req.prompt
        return np.concatenate([req.prompt,
                               np.asarray(req.delivered, np.int32)])

    def _serving_names(self) -> List[str]:
        alive = self._alive_names()
        out = [n for n in alive if self._role(n) in ("both", "decode")]
        # a fabric of ONLY prefill replicas still serves (degenerate
        # deployments / tests) — prefill-role exclusion is a preference
        return out or alive

    def _prefill_names(self) -> List[str]:
        return [n for n in self._alive_names()
                if self._role(n) == "prefill"]

    def _pick(self, req: FabricRequest,
              cands: List[str]) -> Tuple[str, str]:
        """(replica, how) among ``cands`` (all with capacity)."""
        if self.policy == "round-robin":
            name = sorted(cands)[self._rr % len(cands)]
            self._rr += 1
            return name, "rr"
        if self.policy == "least-loaded":
            return self._least_loaded(cands), "ll"
        toks = self._replay_tokens(req)
        matches = {n: self._digest_match(n, toks) for n in cands}
        best = max(matches.values(), default=0)
        if best >= self.affinity_min_pages:
            top = [n for n, m in matches.items() if m == best]
            cool = [n for n in top if n not in self._hot]
            if cool:
                return self._least_loaded(cool), "affinity"
            # the affine replica(s) are past their ITL SLO: hysteresis
            # says spill — prefer any cool replica, even at match 0
            spill = [n for n in cands if n not in self._hot]
            if spill:
                return self._least_loaded(spill), "spill"
            return self._least_loaded(top), "affinity"
        cool = [n for n in cands if n not in self._hot] or cands
        return self._least_loaded(cool), "cold"

    # -- dispatch ------------------------------------------------------------

    def _dispatch_queue(self) -> None:
        if self.fair is not None:
            self.fair.tick()
        # skip-and-continue: a request WAITING on its pinned (affinity)
        # or prefill replica must not head-of-line-block requests that
        # can dispatch elsewhere this pass
        blocked: set = set()
        for _ in range(2 * len(self._queue) + 4):
            view = [r for r in self._queue if id(r) not in blocked]
            if not view:
                return
            if self.fair is not None:
                qi = self.fair.select(view, self._est_uncached)
                if qi is None:
                    return
                req = view[qi]
            else:
                qi, req = 0, view[0]
            cost = self._est_uncached(req)
            if not self._dispatch(req):
                blocked.add(id(req))
                continue
            # a replica REJECTION consumed no capacity: the tenant's
            # bucket/vtime must not be charged for work never performed
            if self.fair is not None and req.state != "failed":
                self.fair.note_admitted(view, qi, cost)
            self._queue.remove(req)

    def _dispatch(self, req: FabricRequest) -> bool:
        """Route + submit ``req``; False when nothing can take it this
        pass (it stays queued)."""
        t_route = time.time() if req.trace is not None else 0.0
        # brownout (shed level 2): cold expensive prefills WAIT — the
        # skip loop keeps cheap/warm requests flowing and running
        # decodes keep their ITL; fairness still orders the wait
        if (self.shedder is not None and not req.delivered
                and self.shedder.defer_cold(self._est_uncached(req))):
            return False
        # disaggregation: a cold long prompt goes to a prefill replica
        # first — unless it already prefilled (handoff done) or was
        # re-admitted with progress (its replay is the expensive part
        # and a survivor may hold its prefix)
        if (self.disagg_threshold_tokens is not None
                and not req.prefill_done and not req.delivered):
            prefill_roles = self._prefill_names()
            serving = self._serving_names()
            if (prefill_roles and serving
                    and self._est_uncached(req)
                    >= self.disagg_threshold_tokens):
                prefills = [n for n in prefill_roles
                            if self._capacity(n) > 0]
                if not prefills:
                    # prefill replicas exist but are momentarily full:
                    # WAIT for one (skip loop keeps others flowing) —
                    # spilling the long cold prefill onto a decode
                    # replica would inflict exactly the ITL breach
                    # disaggregation exists to prevent
                    return False
                name = self._least_loaded(prefills)
                if not self._submit_to(req, name, prefill=True):
                    return False
                if req.state != "failed":
                    self._trace_route(req, t_route, name, "prefill")
                if req.state != "failed" and _REG.enabled:
                    _REG.counter("pt_fabric_routed_total",
                                 "requests routed to a replica").inc(
                        replica=name, how="prefill", **self._flabels)
                return True
        if self.policy == "affinity":
            # affinity PINS: pick over every serving replica; a request
            # whose matched replica is at capacity WAITS for it (the
            # skip loop keeps others flowing) — spilling it cold would
            # replicate its prefix onto another tree and erode the very
            # partitioning affinity exists to build. Hysteresis (hot
            # replicas) stays the escape valve, capacity is not one.
            cands = self._serving_names()
            if not cands:
                return False
            name, how = self._pick(req, cands)
            if self._capacity(name) <= 0:
                if how == "affinity":
                    return False            # wait for the pinned replica
                free = [n for n in cands if self._capacity(n) > 0]
                if not free:
                    return False
                name, how = self._pick(req, free)
                if self._capacity(name) <= 0:
                    return False
        else:
            cands = [n for n in self._serving_names()
                     if self._capacity(n) > 0]
            if not cands:
                return False
            name, how = self._pick(req, cands)
        if not self._submit_to(req, name, prefill=False):
            return False
        if req.state == "failed":
            return True              # rejected at submit: consumed
        self._trace_route(req, t_route, name, how)
        if how == "affinity":
            self.affinity_hits += 1
        elif how == "spill":
            self.misrouted += 1
        else:
            self.cold_routes += 1
        if _REG.enabled:
            _REG.counter("pt_fabric_routed_total",
                         "requests routed to a replica").inc(
                replica=name, how=how, **self._flabels)
        return True

    def _submit_to(self, req: FabricRequest, name: str,
                   prefill: bool) -> bool:
        payload = {"prompt": req.prompt,
                   "max_new_tokens": (1 if prefill
                                      else req.max_new_tokens),
                   "rseed": (req.fid if req.rseed is None
                             else req.rseed),
                   "knobs": req.knobs,
                   "replay": (None if prefill or not req.delivered
                              else list(req.delivered))}
        asp = None
        if req.trace is not None and _TRACE.enabled:
            payload["trace"] = req.tctx
            asp = _TRACE.start("fabric::submit", parent=req.trace,
                               tags={"replica": name,
                                     "attempt": req.readmissions})
        try:
            rid = self.transport.submit(name, payload)
        except ReplicaDown:
            if asp is not None:
                asp.tag(outcome="replica_down").end()
            self._on_replica_down(name)
            return False
        except (ValueError, RuntimeError) as e:
            # an application error (the replica REJECTED the request —
            # e.g. a prompt its pool can never hold) is deterministic:
            # retrying or crashing the whole fabric would strand every
            # other in-flight request. The request fails terminally and
            # surfaces through run()/stats(); the pass continues.
            req.state = "failed"
            req.error = f"{name}: {e}"
            if asp is not None:
                asp.tag(outcome="rejected").end()
                self._trace_done(req)
            if _REG.enabled:
                _REG.counter("pt_fabric_rejected_total",
                             "requests a replica rejected at submit"
                             ).inc(replica=name, **self._flabels)
            return True            # consumed: remove from the queue
        if asp is not None:
            asp.tag(outcome="ok", rid=int(rid)).end()
            q = req.tqueue
            if q is not None and not prefill:
                req.tqueue = None
                q.tag(outcome="admitted", replica=name).end()
        req.state = "prefill" if prefill else "decode"
        req.replica = name
        req.local_rid = int(rid)
        self._assign[(name, int(rid))] = req.fid
        self._outstanding[name] = self._outstanding.get(name, 0) + 1
        self.routed[name] = self.routed.get(name, 0) + 1
        if _REG.enabled:
            _REG.counter("pt_fabric_tenant_admitted_total",
                         "requests released from the global queue").inc(
                tenant=req.tenant, **self._flabels)
        return True

    # -- polling / completion ------------------------------------------------

    def _poll_replicas(self) -> List[Tuple[int, int]]:
        delivered: List[Tuple[int, int]] = []
        for name in list(self._alive_names()):
            try:
                res = self.transport.poll(name)
            except ReplicaDown:
                self._on_replica_down(name)
                continue
            except (ValueError, RuntimeError) as e:
                self._app_error(name, "poll", e)
                continue
            if _TRACE.enabled and res.get("spans"):
                # replica-side spans piggyback on poll responses; the
                # router (which owns the roots) stitches them in
                _TRACE.ingest(res["spans"])
            now = time.perf_counter()
            arrived: Dict[int, List[int]] = {}
            for rid, tok in res.get("emitted", ()):
                fid = self._assign.get((name, int(rid)))
                if fid is None:
                    continue
                req = self._reqs.get(fid)
                if req is None:
                    continue
                if req.state != "decode" or req.replica != name:
                    continue         # prefill probe token: discarded
                arrived.setdefault(fid, []).append(int(tok))
            for fid, toks in arrived.items():
                req = self._reqs[fid]
                if req.trace is not None:
                    req.trace.event("tok", n=len(toks))
                req.delivered.extend(toks)
                if req.first_tok_t == 0.0:
                    req.first_tok_t = now
                if req.last_emit_t:
                    gap = (now - req.last_emit_t) / len(toks)
                    req.itl_gaps.extend([gap] * len(toks))
                req.last_emit_t = now
                delivered.extend((fid, t) for t in toks)
            for rid, toks in res.get("finished", {}).items():
                fid = self._assign.pop((name, int(rid)), None)
                if fid is None:
                    continue
                self._outstanding[name] = max(
                    0, self._outstanding.get(name, 0) - 1)
                req = self._reqs.get(fid)
                if req is None:
                    continue
                if req.state == "prefill" and req.replica == name:
                    self._complete_prefill(req, name)
                elif req.state == "decode" and req.replica == name:
                    req.result = np.asarray(toks, np.int32)
                    # authoritative stream: replay prefix + continuation
                    req.delivered = [int(t) for t in toks]
                    req.state = "done"
                    req.done_t = now
                    self._trace_done(req, replica=name)
                    self._latencies.append(
                        (req.first_tok_t - req.submit_t,
                         req.done_t - req.submit_t, len(toks)))
                    self._itl_gaps.extend(req.itl_gaps)
        return delivered

    def _complete_prefill(self, req: FabricRequest, src: str) -> None:
        """The prefill replica finished its 1-token probe: its tree now
        holds the prompt's full pages. Hand them to a decode replica
        (adopt seeds its tree), then submit the real request there —
        admission prefix-hits, so decode-side prefill work is at most
        one partial page. This placement deliberately SKIPS the
        capacity gate: the pages just landed in that replica's tree and
        waiting in its engine queue is cheaper than re-routing away
        from them."""
        req.prefill_done = True
        payload = None
        hsp = None
        if req.trace is not None and _TRACE.enabled:
            hsp = _TRACE.start("fabric::handoff_extract",
                               parent=req.trace, tags={"src": src})
        try:
            payload = self.transport.extract(src, req.prompt)
        except ReplicaDown:
            self._on_replica_down(src)
        except ValueError:
            payload = None
        if hsp is not None:
            hsp.tag(ok=payload is not None).end()
        cands = [n for n in self._serving_names() if n != src] \
            or self._serving_names()
        if not cands:
            # no decode replica right now: back to the queue (front —
            # it has waited longest)
            req.state, req.replica, req.local_rid = "queued", None, None
            self._queue.appendleft(req)
            return
        name, _how = self._pick(req, cands)
        if payload is not None:
            adp = None
            if req.trace is not None and _TRACE.enabled:
                adp = _TRACE.start("fabric::handoff_adopt",
                                   parent=req.trace,
                                   tags={"src": src, "dst": name})
            try:
                adopted = self.transport.adopt(name, payload)
                self.handoffs += 1
                nbytes = (payload["kv"].nbytes
                          + np.asarray(payload["tokens"]).nbytes)
                self.handoff_bytes += nbytes
                req.handoff_pages = int(adopted)
                if adp is not None:
                    adp.tag(outcome="ok", pages=int(adopted),
                            nbytes=nbytes).end()
                if _REG.enabled:
                    _REG.counter("pt_fabric_handoffs_total",
                                 "prefill→decode KV-page handoffs").inc(
                        src=src, dst=name, **self._flabels)
                    _REG.counter("pt_fabric_handoff_bytes_total",
                                 "KV bytes moved by handoffs").inc(
                        nbytes, src=src, dst=name, **self._flabels)
            except ReplicaDown:
                if adp is not None:
                    adp.tag(outcome="replica_down").end()
                self._on_replica_down(name)
                self.handoff_failures += 1
                self._fail_handoff_counter()
                req.state, req.replica, req.local_rid = \
                    "queued", None, None
                self._queue.appendleft(req)
                return
            except (ValueError, RuntimeError):
                # corrupt transfer or a pool that can't hold the pages:
                # serve COLD rather than stall the request
                if adp is not None:
                    adp.tag(outcome="failed").end()
                self.handoff_failures += 1
                self._fail_handoff_counter()
        else:
            self.handoff_failures += 1
            self._fail_handoff_counter()
        if not self._submit_to(req, name, prefill=False):
            req.state, req.replica, req.local_rid = "queued", None, None
            self._queue.appendleft(req)
        elif req.state != "failed" and _REG.enabled:
            # disagg decode placement is routing too — without this the
            # routed census undercounts exactly the traffic
            # disaggregation exists for
            _REG.counter("pt_fabric_routed_total",
                         "requests routed to a replica").inc(
                replica=name, how="disagg", **self._flabels)

    def _fail_handoff_counter(self) -> None:
        if _REG.enabled:
            _REG.counter("pt_fabric_handoff_failures_total",
                         "handoffs that fell back to cold serving").inc(
                **self._flabels)

    # -- failover ------------------------------------------------------------

    def _on_replica_down(self, name: str) -> None:
        """Replica death: re-queue its in-flight requests (front,
        original order) with their delivered tokens as replay prefixes.
        The re-dispatch happens in this same pass's _dispatch_queue or
        the next — survivors continue every stream token-identically
        with the remaining budget."""
        if name in self._dead:
            return
        self._dead.add(name)
        self._stale_rids[name] = sorted(
            rid for (n, rid) in self._assign if n == name)
        self._status.pop(name, None)
        self._digests.pop(name, None)
        self._hot.discard(name)
        self._outstanding.pop(name, None)
        lost = sorted(fid for (n, _rid), fid in self._assign.items()
                      if n == name)
        self._assign = {k: v for k, v in self._assign.items()
                        if k[0] != name}
        for fid in reversed(lost):
            req = self._reqs[fid]
            if req.state == "done":
                continue
            req.state, req.replica, req.local_rid = "queued", None, None
            req.readmissions += 1
            self.readmitted += 1
            if req.trace is not None and _TRACE.enabled:
                req.trace.event("replica_down")
                if req.tqueue is None:   # sibling queue span: the wait
                    req.tqueue = _TRACE.start(   # after re-admission
                        "fabric::queue", parent=req.trace,
                        tags={"readmission": req.readmissions})
            self._queue.appendleft(req)
            if _REG.enabled:
                _REG.counter(
                    "pt_fabric_readmitted_total",
                    "requests re-admitted after a replica death").inc(
                    tenant=req.tenant, **self._flabels)
        if _REG.enabled:
            _REG.counter("pt_fabric_replica_deaths_total",
                         "replicas lost").inc(replica=name,
                                              **self._flabels)

    # -- telemetry -----------------------------------------------------------

    def _tick_gauges(self) -> None:
        _REG.gauge("pt_fabric_queue_depth",
                   "requests waiting in the global queue").set(
            len(self._queue), **self._flabels)
        _REG.gauge("pt_fabric_replicas_alive",
                   "replicas the router can reach").set(
            len(self._alive_names()), **self._flabels)

    def latency_stats(self) -> Dict[str, float]:
        """Aggregate TTFT / end-to-end / ITL percentiles at the ROUTER
        boundary (what a client of the fabric observes), over the most
        recent 10k retired requests."""
        if not self._latencies:
            return {}
        arr = np.asarray(self._latencies, np.float64)
        out = {"requests": int(arr.shape[0]),
               "tokens": int(arr[:, 2].sum()),
               "ttft_p50_s": float(np.percentile(arr[:, 0], 50)),
               "ttft_p99_s": float(np.percentile(arr[:, 0], 99)),
               "latency_p50_s": float(np.percentile(arr[:, 1], 50)),
               "latency_p99_s": float(np.percentile(arr[:, 1], 99))}
        if self._itl_gaps:
            gaps = np.asarray(self._itl_gaps, np.float64)
            out["itl_p50_s"] = float(np.percentile(gaps, 50))
            out["itl_p99_s"] = float(np.percentile(gaps, 99))
        return out

    def reset_latency_stats(self) -> None:
        self._latencies.clear()
        self._itl_gaps.clear()

    def stats(self) -> Dict[str, object]:
        out = {"queued": len(self._queue),
               "outstanding": dict(self._outstanding),
               "routed": dict(self.routed),
               "affinity_hits": self.affinity_hits,
               "misrouted": self.misrouted,
               "cold_routes": self.cold_routes,
               "handoffs": self.handoffs,
               "handoff_bytes": self.handoff_bytes,
               "handoff_failures": self.handoff_failures,
               "readmitted": self.readmitted,
               "failed": dict(self.failed),
               "replicas_alive": self._alive_names(),
               "replicas_dead": sorted(self._dead),
               "hot": sorted(self._hot)}
        if self.shedder is not None:
            out["shed"] = self.shedder.stats()
        if self.fair is not None:
            out["tenant_admitted"] = dict(self.fair.admitted)
            out["tenant_admitted_tokens"] = {
                k: round(v, 1)
                for k, v in self.fair.admitted_tokens.items()}
            out["tenant_deferred"] = dict(self.fair.deferred)
        return out

    def publish_metrics(self) -> Dict[str, float]:
        """Aggregate percentile gauges + per-tenant counters into the
        registry (the fabric's drain-boundary publish; the per-replica
        engine series publish from the replicas themselves)."""
        lat = self.latency_stats()
        if not _REG.enabled:
            return lat
        for key, metric in (("ttft", "pt_fabric_ttft_seconds"),
                            ("latency", "pt_fabric_latency_seconds"),
                            ("itl", "pt_fabric_itl_seconds")):
            for q in ("p50", "p99"):
                v = lat.get(f"{key}_{q}_s")
                g = _REG.gauge(metric, f"fabric-aggregate {key} "
                                       f"percentile", "s")
                if v is not None:
                    g.set(v, q=q, **self._flabels)
                else:
                    g.clear(q=q, **self._flabels)
        if self.fair is not None:
            g = _REG.gauge("pt_fabric_tenant_admitted_tokens",
                           "uncached-suffix tokens admitted per tenant")
            for t, v in self.fair.admitted_tokens.items():
                g.set(v, tenant=t, **self._flabels)
            c = _REG.gauge("pt_fabric_tenant_deferred",
                           "fair-policy defer passes per tenant")
            for t, v in self.fair.deferred.items():
                c.set(v, tenant=t, **self._flabels)
        self._tick_gauges()
        return lat
