"""Per-replica circuit breaker: a transport wrapper that makes a HUNG
replica indistinguishable from a crashed one (copy of
``paddle_tpu/serving_fabric/breaker.py``).

The router's failover only fires when an op RAISES — a replica that accepts
the connection and then never answers stalls the router forever, which
under real traffic is the common failure (GC pause, wedged accelerator,
network partition half-open). :class:`BreakerTransport` wraps any
:class:`~.transport.FabricTransport` and adds:

* **Op-class timeouts** — each verb runs on a worker thread and must
  answer within its class budget (a poll that moves a scheduler tick
  gets more than a status heartbeat; extract/adopt move KV pages and
  get the most). A miss raises :class:`~.transport.ReplicaDown`, the
  exact signal the router's replay-exact failover already handles — the
  breaker converts "hung" into "crashed" and the recovery machinery
  downstream needs no new cases.
* **The breaker lifecycle** — a trip OPENs the replica (ops fail fast,
  no thread spent) for ``open_cooldown_s``; then HALF-OPEN: the
  router's probe loop calls :meth:`probe`, which must see
  ``probe_successes`` consecutive good status+poll round-trips before
  the breaker CLOSEs and the router readmits. The probe runs a real
  ``poll`` on purpose: a wedged replica can keep heartbeating
  (``status`` is served off cached gauges) while its tick loop is
  stuck — readmission must demonstrate *progress*, not liveness.
* **Serialized access** — one lock per replica held for the duration of
  each op. Engines are not thread-safe; the lock means a stuck op
  leaves followers queued (they time out waiting, which is correct:
  the replica IS unavailable) instead of racing the engine. A follower
  that never got the lock gives up without touching the replica, so an
  abandoned op can't fire late against a recovered engine.

Wrap order: ``BreakerTransport(InProcTransport(...))`` or
``BreakerTransport(TcpTransport(...))``. Chaos hooks (``kill``,
``hang``, ``unhang``) and any other inner extras pass through via
``__getattr__``.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..observability.metrics import REGISTRY as _REG
from ..observability.tracing import TRACER as _TRACE
from .transport import FabricTransport, ReplicaDown

__all__ = ["BreakerTransport", "DEFAULT_OP_TIMEOUTS"]

# Generous by default (sized for the slowest first op of a CPU run);
# tests and latency-sensitive deployments pass tighter budgets. On the
# card, a poll that prefills a long prompt at full width can take
# hundreds of ms: size a tight budget from a measured healthy poll.
DEFAULT_OP_TIMEOUTS: Dict[str, float] = {
    "submit": 10.0, "poll": 30.0, "status": 5.0,
    "extract": 60.0, "adopt": 60.0, "cancel": 10.0, "configure": 10.0,
}


class _State:
    __slots__ = ("mode", "open_until", "successes", "why")

    def __init__(self):
        self.mode = "closed"            # closed | open | half-open
        self.open_until = 0.0
        self.successes = 0
        self.why = ""


class BreakerTransport(FabricTransport):
    """See module doc."""

    def __init__(self, inner: FabricTransport,
                 op_timeouts: Optional[Dict[str, float]] = None,
                 open_cooldown_s: float = 1.0,
                 probe_successes: int = 2,
                 probe_timeout_s: float = 2.0,
                 clock=time.monotonic):
        self.inner = inner
        self.op_timeouts = dict(DEFAULT_OP_TIMEOUTS)
        if op_timeouts:
            self.op_timeouts.update(
                {k: float(v) for k, v in op_timeouts.items()})
        self.open_cooldown_s = float(open_cooldown_s)
        self.probe_successes = int(probe_successes)
        # probes get their OWN (tight) budget: a probe against a
        # still-hung replica must not stall the router's pass for a
        # full op budget — the fabric has healthy replicas to drive
        self.probe_timeout_s = float(probe_timeout_s)
        self._clock = clock
        self._states: Dict[str, _State] = {}
        self._locks: Dict[str, threading.RLock] = {}
        self._meta = threading.Lock()
        self.trips = 0

    # -- plumbing ------------------------------------------------------------

    def __getattr__(self, item):
        # chaos hooks (kill/hang/unhang), alive(), close(), ... pass
        # through to the wrapped transport
        return getattr(self.inner, item)

    def _st(self, name: str) -> _State:
        with self._meta:
            st = self._states.get(name)
            if st is None:
                st = self._states[name] = _State()
                self._locks[name] = threading.RLock()
            return st

    def _lock(self, name: str) -> threading.RLock:
        self._st(name)
        return self._locks[name]

    def _trip(self, name: str, why: str) -> None:
        st = self._st(name)
        st.mode = "open"
        st.open_until = self._clock() + self.open_cooldown_s
        st.successes = 0
        st.why = why
        self.trips += 1
        if _REG.enabled:
            _REG.counter("pt_frontdoor_breaker_open_total",
                         "circuit-breaker trips (hung or crashed "
                         "replica opened)").inc(replica=name)

    def _run(self, name: str, op: str, fn, trip: bool = True,
             timeout: Optional[float] = None):
        """Run ``fn`` under the replica lock on a worker thread with the
        op-class budget. Timeout / inner ReplicaDown trip the breaker
        (unless ``trip=False``: probe handles its own state)."""
        st = self._st(name)
        if st.mode == "open" and trip:
            if self._clock() < st.open_until:
                raise ReplicaDown(
                    name, f"breaker open ({st.why}); "
                          f"probe due in "
                          f"{max(0.0, st.open_until - self._clock()):.2f}s")
            # cooldown elapsed but not yet probed healthy: still fail
            # fast — only probe() readmits
            raise ReplicaDown(name, f"breaker open ({st.why}); "
                                    f"awaiting half-open probe")
        if timeout is None:
            timeout = self.op_timeouts.get(op, 30.0)
        lock = self._lock(name)
        box: dict = {}
        done = threading.Event()
        gate = threading.Lock()

        def relay(**result):
            # once the caller has given up the result is dropped: a late
            # error's traceback leads back (through its frames' f_back)
            # to the worker's frame and ``box``, a cycle that would pin
            # the replica and its engine until a full collection
            with gate:
                if not box.get("abandoned"):
                    box.update(result)
                done.set()

        def work():
            # bounded wait for the lock: if a stuck op holds it past
            # our own budget, give up WITHOUT touching the replica —
            # a late fire against a recovered engine would race it
            if not lock.acquire(timeout=timeout * 2):
                relay(e=ReplicaDown(name, f"{op}: queued behind a stuck op"))
                return
            try:
                relay(r=fn())
            except BaseException as e:       # noqa: BLE001 — relayed
                relay(e=e)
            finally:
                lock.release()

        t = threading.Thread(target=work, daemon=True,
                             name=f"breaker-{name}-{op}")
        t.start()
        if not done.wait(timeout):
            with gate:
                hung = not done.is_set()
                box["abandoned"] = hung
            if hung:
                why = f"{op} exceeded {timeout:g}s op budget (hung)"
                if trip:
                    self._trip(name, why)
                raise ReplicaDown(name, why)
        err = box.pop("e", None)
        if err is not None:
            if isinstance(err, ReplicaDown) and trip:
                self._trip(name, str(err))
            try:
                raise err
            finally:
                # the raised error's traceback holds this frame: the
                # frame must not hold the error back
                err = None
        return box["r"]

    # -- breaker lifecycle ---------------------------------------------------

    def state(self, name: str) -> str:
        return self._st(name).mode

    def retry_after_ms(self, name: Optional[str] = None
                       ) -> Optional[float]:
        """Soonest half-open window: remaining cooldown for ``name``,
        or the minimum across all open breakers. None = nothing open
        (the caller falls back to its own default)."""
        now = self._clock()
        names = [name] if name is not None else list(self._states)
        waits = [max(0.0, self._states[n].open_until - now) * 1000.0
                 for n in names
                 if n in self._states
                 and self._states[n].mode in ("open", "half-open")]
        return min(waits) if waits else None

    def probe(self, name: str) -> bool:
        """Half-open probe; True once the breaker CLOSEd and the router
        may readmit ``name``. Call periodically for replicas the router
        holds as dead — cheap while the cooldown runs (no I/O)."""
        st = self._st(name)
        if st.mode == "closed":
            return True
        if st.mode == "open" and self._clock() < st.open_until:
            return False
        st.mode = "half-open"
        try:
            # liveness AND progress: a wedged tick loop can still
            # answer status, so the probe drives a real poll through
            # the probe budget
            self._run(name, "status",
                      lambda: self.inner.status(name), trip=False,
                      timeout=self.probe_timeout_s)
            self._run(name, "poll",
                      lambda: self.inner.poll(name), trip=False,
                      timeout=self.probe_timeout_s)
        except Exception as e:               # noqa: BLE001 — any fault
            st.mode = "open"
            st.open_until = self._clock() + self.open_cooldown_s
            st.successes = 0
            st.why = f"half-open probe failed: {e}"
            return False
        st.successes += 1
        if st.successes >= self.probe_successes:
            st.mode = "closed"
            st.open_until = 0.0
            st.successes = 0
            st.why = ""
            return True
        return False

    def open_names(self) -> List[str]:
        return [n for n, st in self._states.items()
                if st.mode in ("open", "half-open")]

    # -- verb set ------------------------------------------------------------

    def replica_names(self) -> List[str]:
        return self.inner.replica_names()

    def submit(self, name, req):
        # each breaker-mediated submit ATTEMPT is a sibling span under
        # the request's trace (req carries the wire context) — retries
        # and hedges show up side by side, tagged with their outcomes
        sp = None
        if _TRACE.enabled and isinstance(req, dict) and req.get("trace"):
            sp = _TRACE.start("breaker::attempt", parent=req["trace"],
                              tags={"replica": name, "op": "submit",
                                    "mode": self._st(name).mode})
        try:
            out = self._run(name, "submit",
                            lambda: self.inner.submit(name, req))
        except BaseException as e:           # noqa: BLE001 — relayed
            if sp is not None:
                sp.tag(outcome=type(e).__name__).end()
            raise
        if sp is not None:
            sp.tag(outcome="ok").end()
        return out

    def poll(self, name):
        return self._run(name, "poll", lambda: self.inner.poll(name))

    def status(self, name):
        return self._run(name, "status",
                         lambda: self.inner.status(name))

    def extract(self, name, tokens):
        return self._run(name, "extract",
                         lambda: self.inner.extract(name, tokens))

    def adopt(self, name, payload):
        return self._run(name, "adopt",
                         lambda: self.inner.adopt(name, payload))

    def cancel(self, name, rid):
        return self._run(name, "cancel",
                         lambda: self.inner.cancel(name, rid))

    def configure(self, name, knobs):
        return self._run(name, "configure",
                         lambda: self.inner.configure(name, knobs))
