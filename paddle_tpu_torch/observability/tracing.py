"""Request tracing across the serving fabric (copy of
``paddle_tpu/observability/tracing.py``): one span tree per request,
stitched across the router and every replica it touched, including
replicas in other processes behind the TCP transport.

* **Zero cost when disabled** — every instrumented call site guards on
  ``TRACER.enabled`` (one attribute load + branch) before allocating
  anything; with tracing off no :class:`Span` is constructed.
* **Explicit context propagation** — a :class:`TraceContext`
  ``(trace_id, span_id)`` is handed down call chains as a plain argument
  and rides the request payload dict as a ``"trace"`` key, so it crosses
  any JSON transport untouched and in-proc and TCP replicas stitch alike.
* **Remote stitching via poll piggyback** — each process runs its own
  tracer. A replica process never owns a trace's root, so its finished
  spans are foreign: :meth:`Tracer.drain_for_wire` hands them to
  ``Replica.poll()``, which ships them in the poll response, and the
  router ingests them. In-proc replicas share the root-owning tracer, so
  the drain is empty.
* **Orphans are flagged, never dropped** — at assembly (root span end),
  spans still open carry ``unfinished: true`` and spans whose parent
  never arrived carry ``orphan: true``.

Timestamps are ``time.time()`` (wall clock), so spans from processes on
one host share an axis. Completed traces land in a bounded ring
(:data:`TRACE_RING`) and, with ``dir``, one JSON line per trace.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from collections import deque
from typing import Dict, List, Optional, Union

__all__ = ["TraceContext", "Span", "Tracer", "TRACER", "tracer",
           "TRACE_RING"]

TRACE_RING = 32          # complete traces retained
_MAX_ACTIVE = 256        # concurrent unfinished traces before eviction


class TraceContext:
    """The propagated identity: which trace, and which span to parent
    under. This is the ONLY thing that crosses a hop — spans themselves
    stay in their owning process until drained."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)

    def to_wire(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    @classmethod
    def from_wire(cls, d) -> Optional["TraceContext"]:
        """Tolerant extraction: a payload without (or with a mangled)
        trace key yields None — an untraced request, never an error."""
        if isinstance(d, TraceContext):
            return d
        if not isinstance(d, dict):
            return None
        tid, sid = d.get("trace_id"), d.get("span_id")
        if not tid or not sid:
            return None
        return cls(str(tid), str(sid))

    def __repr__(self):
        return f"TraceContext({self.trace_id!r}, {self.span_id!r})"


class Span:
    """One timed hop. Constructed ONLY via :meth:`Tracer.start` behind
    the enabled guard — the zero-cost test counts these."""

    __slots__ = ("_tracer", "trace_id", "span_id", "parent_id", "name",
                 "start", "end_t", "tags", "events", "pid")

    def __init__(self, tracer: "Tracer", trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, start: float,
                 tags: Optional[dict]):
        self._tracer = tracer
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = float(start)
        self.end_t: Optional[float] = None
        self.tags: dict = dict(tags) if tags else {}
        self.events: List[list] = []      # [ts, name, n]
        self.pid = os.getpid()

    @property
    def ctx(self) -> TraceContext:
        return TraceContext(self.trace_id, self.span_id)

    def tag(self, **kw) -> "Span":
        self.tags.update(kw)
        return self

    def event(self, name: str, ts: Optional[float] = None,
              n: int = 1) -> None:
        self.events.append([time.time() if ts is None else float(ts),
                            str(name), int(n)])

    def end(self, ts: Optional[float] = None) -> None:
        if self.end_t is not None:
            return                        # idempotent: first end wins
        self.end_t = time.time() if ts is None else float(ts)
        self._tracer._finish(self)

    def to_dict(self) -> dict:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_id": self.parent_id, "name": self.name,
                "start": self.start, "end": self.end_t,
                "pid": self.pid, "tags": self.tags,
                "events": self.events}


class Tracer:
    """Process-local span factory + per-trace assembler; see module doc.
    The module singleton :data:`TRACER` is what instrumented sites load;
    extra instances exist so one test process can faithfully play both
    sides of the TCP hop (router tracer + replica tracer)."""

    def __init__(self):
        self.enabled = False
        self._lock = threading.RLock()
        self._dir: Optional[str] = None
        self._roots: Dict[str, Span] = {}      # locally-rooted traces
        self._open: Dict[str, Dict[str, Span]] = {}
        self._done: Dict[str, List[dict]] = {}  # finished, unassembled
        self.completed: deque = deque(maxlen=TRACE_RING)
        self.dropped = 0                       # evicted active traces
        self.spans_started = 0

    # -- lifecycle -----------------------------------------------------------

    def enable(self, dir: Optional[str] = None,
               ring: int = TRACE_RING) -> "Tracer":
        with self._lock:
            self._dir = dir
            if dir:
                os.makedirs(dir, exist_ok=True)
            self._roots.clear()
            self._open.clear()
            self._done.clear()
            self.completed = deque(maxlen=int(ring))
            self.dropped = 0
            self.enabled = True
        return self

    def disable(self) -> None:
        with self._lock:
            self.enabled = False
            self._roots.clear()
            self._open.clear()
            self._done.clear()

    # -- span factory --------------------------------------------------------

    def start(self, name: str,
              parent: Union[Span, TraceContext, dict, None] = None,
              tags: Optional[dict] = None, start: Optional[float] = None,
              trace_id: Optional[str] = None) -> Optional[Span]:
        """Open a span. ``parent=None`` mints a new trace root (or joins
        ``trace_id`` when a caller supplied one).
        Returns None when disabled, so call sites can keep the
        ``sp = TRACER.start(...) if TRACER.enabled else None`` shape."""
        if not self.enabled:
            return None
        if isinstance(parent, dict):
            parent = TraceContext.from_wire(parent)
        if isinstance(parent, Span):
            parent = parent.ctx
        with self._lock:
            if parent is None:
                tid = (str(trace_id) if trace_id
                       else uuid.uuid4().hex[:16])
                pid = None
            else:
                tid, pid = parent.trace_id, parent.span_id
            sp = Span(self, tid, uuid.uuid4().hex[:16], pid, name,
                      time.time() if start is None else start, tags)
            self.spans_started += 1
            if parent is None and tid not in self._roots:
                self._roots[tid] = sp
            self._open.setdefault(tid, {})[sp.span_id] = sp
            self._evict_locked()
        return sp

    def _evict_locked(self) -> None:
        # bound unfinished-trace state: streams that orphan and never
        # resume leak a root each; cap the table rather than the server
        while len(self._open) > _MAX_ACTIVE:
            tid = next(iter(self._open))
            self._open.pop(tid, None)
            self._roots.pop(tid, None)
            self._done.pop(tid, None)
            self.dropped += 1

    # -- assembly ------------------------------------------------------------

    def _finish(self, sp: Span) -> None:
        if not self.enabled:
            return
        with self._lock:
            open_t = self._open.get(sp.trace_id)
            if open_t is not None:
                open_t.pop(sp.span_id, None)
                if not open_t and sp.trace_id not in self._roots:
                    # foreign trace fully quiesced: drop the table entry
                    # so the active-trace bound counts real work
                    del self._open[sp.trace_id]
            root = self._roots.get(sp.trace_id)
            if root is sp:
                self._complete_locked(sp.trace_id)
            else:
                self._done.setdefault(sp.trace_id, []).append(
                    sp.to_dict())

    def ingest(self, span_dicts: List[dict]) -> None:
        """Adopt finished spans another process shipped (poll
        piggyback). Spans of already-assembled traces are dropped —
        bounded, and only reachable by a late poll racing completion."""
        if not self.enabled or not span_dicts:
            return
        with self._lock:
            for d in span_dicts:
                tid = d.get("trace_id")
                if not tid:
                    continue
                self._done.setdefault(str(tid), []).append(dict(d))

    def drain_for_wire(self) -> List[dict]:
        """Finished spans of traces whose root lives elsewhere — the
        replica side of the poll piggyback. A tracer that owns the root
        (in-proc fabric) keeps everything and returns []."""
        if not self.enabled:
            return []
        with self._lock:
            out: List[dict] = []
            for tid in list(self._done):
                if tid not in self._roots:
                    out.extend(self._done.pop(tid))
            return out

    def _complete_locked(self, tid: str) -> None:
        root = self._roots.pop(tid)
        spans = self._done.pop(tid, [])
        for sp in self._open.pop(tid, {}).values():
            d = sp.to_dict()
            d["tags"]["unfinished"] = True   # flagged, not dropped
            spans.append(d)
        spans.append(root.to_dict())
        ids = {s["span_id"] for s in spans}
        for s in spans:
            if s["parent_id"] is not None and s["parent_id"] not in ids:
                s["tags"]["orphan"] = True   # parent lost with its proc
        spans.sort(key=lambda s: s["start"])
        ttft = None
        for ts, name, _n in root.events:
            if name == "first_tok":
                ttft = ts - root.start
                break
        trace = {"trace_id": tid, "root": root.span_id,
                 "spans": spans,
                 "summary": {"name": root.name,
                             "start": root.start, "end": root.end_t,
                             "total_s": (None if root.end_t is None
                                         else root.end_t - root.start),
                             "ttft_s": ttft,
                             "n_spans": len(spans),
                             "tags": dict(root.tags)}}
        self.completed.append(trace)
        if self._dir:
            try:
                path = os.path.join(self._dir, "traces.jsonl")
                with open(path, "a", encoding="utf-8") as f:
                    f.write(json.dumps(trace, sort_keys=True) + "\n")
                    f.flush()
            except OSError:
                pass                      # tracing must never kill serving

    # -- consumers -----------------------------------------------------------

    def recent_traces(self) -> List[dict]:
        with self._lock:
            return list(self.completed)

    def take_completed(self) -> List[dict]:
        with self._lock:
            out = list(self.completed)
            self.completed.clear()
            return out

    def worst_traces(self, k: int = 3,
                     key: str = "ttft_s") -> List[dict]:
        """The K completed traces with the worst ``summary[key]`` — what
        a TTFT/ITL incident attaches as evidence."""
        with self._lock:
            have = [t for t in self.completed
                    if isinstance(t["summary"].get(key), (int, float))]
            have.sort(key=lambda t: t["summary"][key], reverse=True)
            return [dict(t) for t in have[:max(0, int(k))]]

    def stats(self) -> dict:
        with self._lock:
            return {"enabled": self.enabled,
                    "spans_started": self.spans_started,
                    "active_traces": len(self._open),
                    "completed": len(self.completed),
                    "dropped": self.dropped}


TRACER = Tracer()


def tracer() -> Tracer:
    return TRACER
