"""FrontDoor: the concurrent streaming server in front of a
:class:`~.router.ServingFabric` (copy of
``paddle_tpu/serving_fabric/frontdoor.py``).

The TCP transport connects the ROUTER to its replicas; this module
connects CLIENTS to the router. It is that edge, built for the
traffic assumptions of the north star (many concurrent clients, some of
them slow, dead, or duplicated):

* **Framing** — length-bounded newline-JSON, the same wire idiom as the
  replica transport. A line over ``max_line_bytes`` closes the
  connection (unbounded-buffer defense); a bounded line that fails to
  parse (torn frame) gets an ``error`` event and the connection LIVES —
  one corrupt request must not kill a multiplexed client's other
  streams. Every server event carries a per-connection ``seq`` so
  clients can assert ordered, gapless delivery.
* **Streaming** — one drive thread steps the fabric and fans committed
  tokens out to per-connection OUTBOXES as drains commit them. Outboxes
  are bounded queues serviced by per-connection writer threads: a
  slow-loris client (reads stalled, outbox full) never blocks the
  drive loop — its requests are CANCELLED (slot/pages freed through the
  engine's one ``_free_slot`` path) and the connection is closed.
  Mid-stream disconnect does the same via the reader thread.
* **Idempotent retry (dedupe)** — clients name requests with their own
  ``id``. The server keeps a per-id stream record (rseed = the first
  attempt's fabric id, committed tokens) surviving the connection, so
  a retry RESUMES: resubmitted with the original rseed and the
  committed tokens as ``replay_prefix``, the engine never re-emits the
  prefix and the retry delivers exactly the tokens the client lacks
  (``have``) — zero duplicated, zero lost. A retry while the previous
  connection still lives is a TAKEOVER (the new connection owns the
  stream; the old one is told), which is what makes the client's
  hedged attempt safe: at most one attempt owns a stream.
* **Typed refusals** — admission errors (:class:`~.robust.Overloaded`,
  :class:`~.robust.AllReplicasDown`) and deadline cancellations surface
  as ``reject`` events carrying ``kind`` + ``retry_after_ms``; nothing
  is silently dropped and no client fault can raise out of the server
  loops.

Wire protocol (client → server)::

    {"op": "submit", "id": "req-1", "prompt": [...],
     "max_new_tokens": 32, "tenant": "t0", "knobs": {...},
     "ttft_deadline_ms": 500, "deadline_ms": 10000, "have": 0}
    {"op": "cancel", "id": "req-1"}
    {"op": "ping"}

Server → client events (all carry ``seq``)::

    {"ev": "ack",       "id", "seq"}
    {"ev": "tok",       "id", "seq", "toks": [..]}      # incremental
    {"ev": "done",      "id", "seq", "toks": [..], "n": total}
    {"ev": "reject",    "id", "seq", "kind", "error", "retry_after_ms"}
    {"ev": "cancelled", "id", "seq", "reason"}
    {"ev": "error",           "seq", "error"}           # torn frame
    {"ev": "pong",            "seq"}
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
from typing import Dict, List, Optional

import numpy as np

from ..observability.metrics import REGISTRY as _REG
from ..observability.tracing import TRACER as _TRACE
from .robust import FabricRejected
from .router import ServingFabric

__all__ = ["FrontDoor"]


class _Conn:
    """One client connection: reader thread (ops), writer thread
    (bounded outbox), per-connection event sequence."""

    def __init__(self, sock: socket.socket, outbox_max: int):
        self.sock = sock
        self.outbox: "queue.Queue" = queue.Queue(maxsize=outbox_max)
        self.seq = 0
        self.lock = threading.Lock()     # seq + liveness
        self.open = True
        self.ids: set = set()            # stream ids this conn owns
        # writer-blocked-in-sendall marker: the OS absorbs small event
        # volumes into socket buffers, so a slow-loris peer shows up as
        # a sendall that never returns long before the outbox fills —
        # the drive loop checks this age in _flush
        self.writing_since: Optional[float] = None

    def send(self, ev: dict) -> bool:
        """Enqueue an event; False when the outbox is FULL (slow
        client) or the connection already closed — never blocks."""
        with self.lock:
            if not self.open:
                return False
            ev = dict(ev)
            ev["seq"] = self.seq
            self.seq += 1
            try:
                self.outbox.put_nowait(ev)
            except queue.Full:
                return False
            return True

    def close(self) -> None:
        with self.lock:
            if not self.open:
                return
            self.open = False
        try:
            self.outbox.put_nowait(None)      # wake the writer
        except queue.Full:
            pass                              # writer drains to the None
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self.sock.close()
        except OSError:
            pass


class _Stream:
    """Per-client-id dedupe record; survives its connection so a retry
    resumes instead of restarting."""

    def __init__(self, sid: str, fid: int, rseed: int, prompt,
                 max_new_tokens: int, tenant: str = "default",
                 knobs: Optional[dict] = None,
                 ttft_deadline_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None):
        self.sid = sid
        self.fid = fid                   # current fabric id
        self.rseed = rseed               # sampling identity: FIRST fid
        self.prompt = np.asarray(prompt, np.int32)
        self.max_new_tokens = int(max_new_tokens)
        self.tenant = str(tenant)
        self.knobs = knobs
        self.ttft_deadline_ms = ttft_deadline_ms
        self.deadline_ms = deadline_ms
        self.toks: List[int] = []        # committed full stream
        self.state = "active"            # active | orphaned | done | failed
        self.conn: Optional[_Conn] = None
        self.sent = 0                    # toks shipped to current conn
        self.error: Optional[dict] = None     # reject event body
        # distributed-tracing root span: minted at submit
        # when the tracer is live, ended once at done/failed. None on
        # untraced streams — every tracing touch guards on this.
        self.tspan = None


class FrontDoor:
    """See module doc. ``fabric`` is driven ONLY by this object's
    drive thread once :meth:`start` runs — external step()/run() calls
    would race it (engines are not thread-safe; one RLock serializes
    every fabric touch)."""

    def __init__(self, fabric: ServingFabric, host: str = "127.0.0.1",
                 port: int = 0, max_line_bytes: int = 1 << 20,
                 outbox_max: int = 256,
                 poll_interval_s: float = 0.001,
                 write_stall_s: float = 10.0,
                 sndbuf: Optional[int] = None):
        self.fabric = fabric
        self.max_line_bytes = int(max_line_bytes)
        self.outbox_max = int(outbox_max)
        self.poll_interval_s = float(poll_interval_s)
        # a writer blocked in sendall longer than this is a slow-loris
        # peer (TCP window closed); sndbuf (when set) shrinks the
        # server-side send buffer so tests hit that state cheaply
        self.write_stall_s = float(write_stall_s)
        self.sndbuf = sndbuf
        self._last_idle_probe = 0.0
        self._flock = threading.RLock()       # every fabric touch
        self._streams: Dict[str, _Stream] = {}
        self._by_fid: Dict[int, _Stream] = {}
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []
        self.retries = 0                      # resumed submissions
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "FrontDoor":
        for fn, nm in ((self._accept_loop, "accept"),
                       (self._drive_loop, "drive")):
            t = threading.Thread(target=fn, daemon=True,
                                 name=f"frontdoor-{nm}")
            t.start()
            self._threads.append(t)
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            c.close()
        for t in self._threads:
            t.join(timeout=5.0)

    # -- accept / per-connection threads -------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.25)
                sock, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            if self.sndbuf is not None:
                sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF,
                                int(self.sndbuf))
            conn = _Conn(sock, self.outbox_max)
            with self._conns_lock:
                self._conns.add(conn)
            for fn, nm in ((self._read_loop, "read"),
                           (self._write_loop, "write")):
                threading.Thread(target=fn, args=(conn,), daemon=True,
                                 name=f"frontdoor-{nm}").start()

    def _write_loop(self, conn: _Conn) -> None:
        try:
            while True:
                ev = conn.outbox.get()
                if ev is None:
                    return
                conn.writing_since = time.monotonic()
                conn.sock.sendall(json.dumps(ev).encode() + b"\n")
                conn.writing_since = None
        except OSError:
            self._drop_conn(conn, reason="write_error")
        finally:
            pass

    def _read_loop(self, conn: _Conn) -> None:
        f = conn.sock.makefile("rb")
        reason = "eof"
        try:
            while not self._stop.is_set():
                line = f.readline(self.max_line_bytes + 1)
                if not line:
                    break
                if (len(line) > self.max_line_bytes
                        or not line.endswith(b"\n")):
                    reason = "overlong_frame"
                    break
                if not line.strip():
                    continue
                try:
                    msg = json.loads(line)
                    if not isinstance(msg, dict):
                        raise ValueError("frame is not an object")
                except ValueError as e:
                    # torn frame: typed error, connection SURVIVES
                    conn.send({"ev": "error",
                               "error": f"bad frame: {e}"})
                    continue
                try:
                    self._handle(conn, msg)
                except Exception as e:    # noqa: BLE001 — client input
                    conn.send({"ev": "error",   # must never kill loops
                               "error": f"{type(e).__name__}: {e}"})
        except OSError:
            reason = "reset"
        finally:
            self._drop_conn(conn, reason=reason)

    def _drop_conn(self, conn: _Conn, reason: str) -> None:
        """Connection teardown: cancel its live fabric requests (frees
        slots/pages NOW) but KEEP the dedupe records — a retry on a new
        connection resumes them."""
        with self._conns_lock:
            if conn not in self._conns:
                return
            self._conns.discard(conn)
        conn.close()
        with self._flock:
            for sid in list(conn.ids):
                st = self._streams.get(sid)
                if st is None or st.conn is not conn:
                    continue
                st.conn = None
                if st.state == "active":
                    st.state = "orphaned"
                    self.fabric.cancel(st.fid,
                                       error="client_disconnect")
                    self._by_fid.pop(st.fid, None)
        if _REG.enabled:
            _REG.counter("pt_frontdoor_disconnects_total",
                         "client connections dropped").inc(
                reason=reason)

    # -- op handling (reader threads) ----------------------------------------

    def _handle(self, conn: _Conn, msg: dict) -> None:
        op = msg.get("op")
        if op == "ping":
            conn.send({"ev": "pong"})
            return
        if op == "cancel":
            sid = str(msg.get("id"))
            with self._flock:
                st = self._streams.get(sid)
                if st is not None and st.state == "active":
                    self.fabric.cancel(st.fid, error="client_cancel")
                    self._by_fid.pop(st.fid, None)
                    st.state = "orphaned"
            conn.send({"ev": "cancelled", "id": sid,
                       "reason": "client_cancel"})
            return
        if op != "submit":
            conn.send({"ev": "error", "error": f"unknown op {op!r}"})
            return
        sid = msg.get("id")
        if not isinstance(sid, str) or not sid:
            conn.send({"ev": "error", "error": "submit needs a "
                                               "string id"})
            return
        have = max(0, int(msg.get("have", 0)))
        with self._flock:
            st = self._streams.get(sid)
            if st is not None:
                self._resume(conn, st, have)
                return
            # the trace root is minted HERE — the FrontDoor edge — and
            # its context rides the fabric request (explicit injection;
            # contextvars would stop at the TCP hop). A client-supplied
            # trace_id joins its trace to ours for end-to-end logs.
            root = None
            if _TRACE.enabled:
                tid = msg.get("trace_id")
                root = _TRACE.start(
                    "frontdoor::request",
                    trace_id=str(tid) if tid else None,
                    tags={"id": sid,
                          "tenant": str(msg.get("tenant", "default"))})
                acc = _TRACE.start("frontdoor::submit", parent=root)
            try:
                fid = self.fabric.submit(
                    np.asarray(msg["prompt"], np.int32),
                    int(msg["max_new_tokens"]),
                    tenant=str(msg.get("tenant", "default")),
                    knobs=msg.get("knobs"),
                    ttft_deadline_ms=msg.get("ttft_deadline_ms"),
                    deadline_ms=msg.get("deadline_ms"),
                    trace=None if root is None else root.ctx)
            except FabricRejected as e:
                if root is not None:
                    acc.tag(outcome="rejected").end()
                    root.tag(state="rejected").end()
                conn.send({"ev": "reject", "id": sid, **e.to_wire()})
                return
            if root is not None:
                acc.tag(outcome="ok").end()
            st = _Stream(sid, fid, rseed=fid, prompt=msg["prompt"],
                         max_new_tokens=int(msg["max_new_tokens"]),
                         tenant=str(msg.get("tenant", "default")),
                         knobs=msg.get("knobs"),
                         ttft_deadline_ms=msg.get("ttft_deadline_ms"),
                         deadline_ms=msg.get("deadline_ms"))
            st.conn = conn
            st.tspan = root
            self._streams[sid] = st
            self._by_fid[fid] = st
            conn.ids.add(sid)
            # ack INSIDE the lock: the drive loop (also behind the lock)
            # must not flush a tok event ahead of the ack
            conn.send({"ev": "ack", "id": sid})

    def _resume(self, conn: _Conn, st: _Stream, have: int) -> None:
        """A submit for an id we know: dedupe. Ship what the client
        lacks; re-admit to the fabric only when the stream is orphaned
        mid-generation. Caller holds the fabric lock."""
        prev = st.conn
        st.conn = conn
        st.sent = min(have, len(st.toks))
        conn.ids.add(st.sid)
        # every dedupe attempt is a SIBLING span under the stream's
        # root, tagged with its outcome — hedge-as-takeover is visible
        # as resume(takeover) next to the still-running first attempt
        rsp = None
        if st.tspan is not None and _TRACE.enabled:
            rsp = _TRACE.start("frontdoor::resume", parent=st.tspan,
                               tags={"have": have})
        if prev is not None and prev is not conn:
            # hedge/takeover: exactly one attempt owns a stream
            prev.ids.discard(st.sid)
            prev.send({"ev": "cancelled", "id": st.sid,
                       "reason": "taken_over"})
            if st.state == "active":
                # the old attempt's fabric request keeps running and
                # this connection now receives it — nothing to resubmit
                if rsp is not None:
                    rsp.tag(outcome="takeover").end()
                conn.send({"ev": "ack", "id": st.sid})
                self._flush(st)
                self.retries += 1
                self._count_retry()
                return
        if st.state in ("done", "failed"):
            if rsp is not None:
                rsp.tag(outcome="replayed").end()
            conn.send({"ev": "ack", "id": st.sid})
            self._flush(st)
            self._finish_events(st)
            self.retries += 1
            self._count_retry()
            return
        if st.state == "orphaned":
            # resume: original rseed + committed tokens as the replay
            # prefix — the engine re-emits nothing, the client receives
            # exactly what it lacks. The retry gets fresh deadline
            # budgets (its clock restarted with the new attempt).
            try:
                fid = self.fabric.submit(
                    st.prompt, st.max_new_tokens,
                    tenant=st.tenant, knobs=st.knobs,
                    ttft_deadline_ms=st.ttft_deadline_ms,
                    deadline_ms=st.deadline_ms,
                    rseed=st.rseed, replay=list(st.toks),
                    trace=(None if st.tspan is None
                           else st.tspan.ctx))
            except FabricRejected as e:
                if rsp is not None:
                    rsp.tag(outcome="rejected").end()
                st.conn = None
                conn.ids.discard(st.sid)
                conn.send({"ev": "reject", "id": st.sid,
                           **e.to_wire()})
                return
            st.fid = fid
            st.state = "active"
            self._by_fid[fid] = st
            if rsp is not None:
                rsp.tag(outcome="resubmit", replay=len(st.toks))
        if rsp is not None:
            if "outcome" not in rsp.tags:
                rsp.tag(outcome="reattach")
            rsp.end()
        conn.send({"ev": "ack", "id": st.sid})
        self._flush(st)
        self.retries += 1
        self._count_retry()

    @staticmethod
    def _count_retry() -> None:
        if _REG.enabled:
            _REG.counter("pt_frontdoor_retries_total",
                         "deduped resubmissions resumed").inc()

    # -- drive thread --------------------------------------------------------

    def _drive_loop(self) -> None:
        while not self._stop.is_set():
            with self._flock:
                worked = self._drive_once()
            # ALWAYS yield between passes, not only when idle: reader
            # and teardown threads contend for _flock, and a hot
            # release→reacquire loop starves them under continuous
            # traffic (CPython hands the GIL back to the releaser) —
            # a mid-stream disconnect would then not cancel until the
            # stream drained on its own. The busy yield is a fraction
            # of the idle one: long enough for a blocked waiter to
            # take the lock, short against a decode step.
            time.sleep(self.poll_interval_s
                       if not worked else self.poll_interval_s / 4.0)

    def _drive_once(self) -> bool:
        """One fabric pass + fan-out; caller holds the lock. Returns
        False when the fabric was idle (the loop then sleeps)."""
        if not self.fabric.has_work():
            # keep breaker readmission moving while idle: a replica
            # that recovers between waves must not stay quarantined
            # until the next request arrives (throttled — probes are
            # real status+poll round-trips)
            if getattr(self.fabric, "_dead", None):
                now = time.monotonic()
                if now - self._last_idle_probe >= 0.05:
                    self._last_idle_probe = now
                    self.fabric.probe_recovery()
            return False
        try:
            delivered = self.fabric.step()
        except FabricRejected:
            # every replica down mid-run: requests stay queued; the
            # probe loop inside step() readmits when a breaker closes.
            # Clients see progress stall, their deadlines (or retries
            # against a recovered fabric) decide — the server must not
            # crash its own drive loop.
            time.sleep(self.poll_interval_s)
            return True
        arrived: Dict[int, List[int]] = {}
        for fid, tok in delivered:
            arrived.setdefault(fid, []).append(int(tok))
        for fid, toks in arrived.items():
            st = self._by_fid.get(fid)
            if st is None:
                continue
            if st.tspan is not None and not st.toks and _TRACE.enabled:
                # the TTFT stamp the critical-path walk attributes:
                # first token committed at the client-facing edge
                st.tspan.event("first_tok")
            st.toks.extend(toks)
            self._flush(st)
        for fid, result in self.fabric.take_finished().items():
            st = self._by_fid.pop(fid, None)
            if st is None:
                continue
            if result is not None:
                st.toks = [int(t) for t in np.asarray(result).ravel()]
                st.state = "done"
            else:
                err = self.fabric.failed.get(fid, "rejected")
                if st.state == "orphaned" or err in (
                        "client_disconnect", "client_cancel"):
                    continue        # we cancelled it; nothing to report
                st.state = "failed"
                kind = ("deadline"
                        if err.startswith("deadline_exceeded")
                        else "rejected")
                # retry hint 0: the deadline clock restarts with the
                # retry, so there is nothing to wait out
                st.error = {"kind": kind, "error": err,
                            "retry_after_ms": 0.0}
            self._flush(st)
            self._finish_events(st)
        return True

    def _flush(self, st: _Stream) -> None:
        """Ship ``toks[sent:]`` to the owning connection; a full outbox
        here IS the slow-loris signal — cancel + drop."""
        conn = st.conn
        if conn is None or st.sent >= len(st.toks):
            return
        since = conn.writing_since
        if since is not None and \
                time.monotonic() - since > self.write_stall_s:
            self._evict_slow(st, conn)
            return
        dsp = None
        if st.tspan is not None and _TRACE.enabled:
            dsp = _TRACE.start("frontdoor::drain", parent=st.tspan)
        pend = st.toks[st.sent:]
        if conn.send({"ev": "tok", "id": st.sid, "toks": pend}):
            st.sent = len(st.toks)
            if dsp is not None:
                dsp.tag(n=len(pend)).end()
        else:
            if dsp is not None:
                dsp.tag(n=len(pend), outcome="slow_evict").end()
            self._evict_slow(st, conn)

    def _finish_events(self, st: _Stream) -> None:
        root = st.tspan
        if root is not None:
            # root end assembles the trace: ingested replica spans,
            # flagged orphans and all. Ended exactly once (replayed
            # resumes re-enter here with tspan already cleared).
            st.tspan = None
            root.tag(state=st.state, n=len(st.toks)).end()
        conn = st.conn
        if conn is None:
            return
        if st.state == "done":
            conn.send({"ev": "done", "id": st.sid, "toks": [],
                       "n": len(st.toks)})
        elif st.state == "failed" and st.error is not None:
            conn.send({"ev": "reject", "id": st.sid, **st.error})

    def _evict_slow(self, st: _Stream, conn: _Conn) -> None:
        """The outbox stayed full: the peer stopped reading. Cancel its
        requests (slots/pages free NOW for clients that do read) and
        sever the connection; the dedupe record stays for a retry."""
        if st.state == "active":
            st.state = "orphaned"
            self.fabric.cancel(st.fid, error="slow_client")
            self._by_fid.pop(st.fid, None)
        st.conn = None
        with self._conns_lock:
            self._conns.discard(conn)
        conn.close()
        if _REG.enabled:
            _REG.counter("pt_frontdoor_disconnects_total",
                         "client connections dropped").inc(
                reason="slow")

    # -- introspection -------------------------------------------------------

    def stream_states(self) -> Dict[str, str]:
        with self._flock:
            return {sid: st.state for sid, st in self._streams.items()}
