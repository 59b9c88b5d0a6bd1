"""Critical-path attribution over serving traces (copy of
``paddle_tpu/analysis/critical_path.py``).

Input: one completed trace dict from
:mod:`paddle_tpu_torch.observability.tracing` — a span tree stitched
across front door, router, breaker and replica processes. Output:
*exclusive self-time per hop* over a time interval, the attribution
operators reason with ("queue ate 60% of the TTFT") and the SLO sentry
breaches on (``pt_trace_ttft_frac{hop=queue}``).

The attribution sweep is deepest-span-wins: the interval is cut at
every span boundary, and each elementary segment is charged to the
deepest span covering it (ties to the latest-started — the innermost
retry). A segment no span covers — or only the root covers — is
``untracked``: the residual the acceptance bound keeps honest (>= 95% of
TTFT must land on named hops).

Two intervals matter per trace: TTFT (root start -> ``first_tok`` event)
and the worst inter-token gap (consecutive ``tok`` events on the
``fabric::request`` span) — the p99-ITL culprit for that request.

The port's span names are the JAX package's (``frontdoor::*``,
``fabric::*``, ``breaker::attempt``, ``replica::*``), so :data:`HOPS` is
the same table. Pure stdlib over plain dicts: importable by the tracer's
gauge hook, the trace_report CLI and the tests without torch.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

__all__ = ["HOPS", "hop_of", "span_depths", "attribute_interval",
           "attribute_trace", "aggregate", "format_table",
           "format_span_tree", "chrome_trace", "export_chrome",
           "load_trace_dir"]

# span-name prefix -> hop, FIRST match wins (most specific first).
# "untracked" for the frontdoor root: its exclusive self-time is
# precisely the time no instrumented hop owns.
HOPS: List[Tuple[str, str]] = [
    ("frontdoor::submit", "accept"),
    ("frontdoor::resume", "resume"),
    ("frontdoor::drain", "stream_drain"),
    ("frontdoor::request", "untracked"),
    ("fabric::queue", "queue"),
    ("fabric::route", "route"),
    ("fabric::submit", "dispatch"),
    ("fabric::handoff", "handoff"),
    ("fabric::request", "router"),
    ("breaker::attempt", "breaker_retry"),
    ("replica::queue", "admission"),
    ("replica::prefill", "prefill"),
    ("replica::decode", "decode"),
    ("replica::resident", "replica_stall"),
]


def hop_of(name: str) -> str:
    for prefix, hop in HOPS:
        if name.startswith(prefix):
            return hop
    return name.rsplit("::", 1)[-1]


def span_depths(trace: dict) -> Dict[str, int]:
    """span_id -> tree depth (root = 0). Orphans (parent missing —
    crashed replica) hang at depth 1 so their time still attributes
    deeper than the root."""
    spans = trace["spans"]
    parent = {s["span_id"]: s["parent_id"] for s in spans}
    depths: Dict[str, int] = {}

    def depth(sid: str, hops: int = 0) -> int:
        if sid in depths:
            return depths[sid]
        if hops > len(parent) + 1:        # cycle guard: corrupt input
            return 1
        p = parent.get(sid)
        if p is None:
            d = 0
        elif p not in parent:
            d = 1                         # orphan: parent never arrived
        else:
            d = depth(p, hops + 1) + 1
        depths[sid] = d
        return d

    for s in spans:
        depth(s["span_id"])
    return depths


def _root_span(trace: dict) -> Optional[dict]:
    rid = trace.get("root")
    for s in trace["spans"]:
        if s["span_id"] == rid:
            return s
    return None


def attribute_interval(trace: dict, t0: float,
                       t1: float) -> Dict[str, float]:
    """Exclusive self-time per hop over [t0, t1]; see module doc.
    An unfinished span (end=None — flagged orphan work) extends to t1:
    the dead replica owned that time until the interval closed."""
    if t1 <= t0:
        return {}
    depths = span_depths(trace)
    root_id = trace.get("root")
    clipped = []
    for s in trace["spans"]:
        a = max(float(s["start"]), t0)
        b = min(t1 if s["end"] is None else float(s["end"]), t1)
        if b > a:
            clipped.append((a, b, depths.get(s["span_id"], 1),
                            float(s["start"]), s))
    cuts = sorted({t0, t1} | {c[0] for c in clipped}
                  | {c[1] for c in clipped})
    out: Dict[str, float] = {}
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2.0
        best = None
        for ca, cb, d, st, s in clipped:
            if ca <= mid < cb:
                key = (d, st)
                if best is None or key > best[0]:
                    best = (key, s)
        if best is None or best[1]["span_id"] == root_id:
            hop = "untracked"
        else:
            hop = hop_of(best[1]["name"])
        out[hop] = out.get(hop, 0.0) + (b - a)
    return out


def _tok_events(trace: dict) -> List[Tuple[float, int]]:
    """Token-arrival (ts, n) pairs from the fabric request span (the
    router-side delivery stamps)."""
    evs: List[Tuple[float, int]] = []
    for s in trace["spans"]:
        if s["name"].startswith("fabric::request"):
            for ts, name, n in s.get("events", ()):
                if name == "tok":
                    evs.append((float(ts), int(n)))
    evs.sort()
    return evs


def attribute_trace(trace: dict) -> dict:
    """TTFT + worst-ITL-gap attribution for one trace. Keys:
    ``ttft_s``, ``ttft_hops`` (seconds), ``ttft_frac``, ``untracked_s``,
    ``itl_worst_gap_s``, ``itl_hops``."""
    root = _root_span(trace)
    out = {"trace_id": trace.get("trace_id"), "ttft_s": None,
           "ttft_hops": {}, "ttft_frac": {}, "untracked_s": 0.0,
           "itl_worst_gap_s": None, "itl_hops": {}}
    if root is None:
        return out
    first_tok = None
    for ts, name, _n in root.get("events", ()):
        if name == "first_tok":
            first_tok = float(ts)
            break
    if first_tok is None:                 # fabric-only trace: root IS
        evs = _tok_events(trace)          # fabric::request; use its toks
        if evs:
            first_tok = evs[0][0]
    if first_tok is not None and first_tok > root["start"]:
        ttft = first_tok - root["start"]
        hops = attribute_interval(trace, root["start"], first_tok)
        out["ttft_s"] = ttft
        out["ttft_hops"] = hops
        out["ttft_frac"] = {h: v / ttft for h, v in hops.items()}
        out["untracked_s"] = hops.get("untracked", 0.0)
    evs = _tok_events(trace)
    worst: Optional[Tuple[float, float, float]] = None
    for (ta, _na), (tb, _nb) in zip(evs, evs[1:]):
        gap = tb - ta
        if worst is None or gap > worst[0]:
            worst = (gap, ta, tb)
    if worst is not None and worst[0] > 0:
        out["itl_worst_gap_s"] = worst[0]
        out["itl_hops"] = attribute_interval(trace, worst[1], worst[2])
    return out


def aggregate(traces: List[dict]) -> Dict[str, dict]:
    """Per-hop p50/p99 of TTFT share across traces: hop ->
    {n, p50_s, p99_s, p50_frac, p99_frac}."""
    per_hop: Dict[str, List[Tuple[float, float]]] = {}
    for t in traces:
        att = attribute_trace(t)
        if att["ttft_s"] is None:
            continue
        for hop, sec in att["ttft_hops"].items():
            per_hop.setdefault(hop, []).append(
                (sec, att["ttft_frac"].get(hop, 0.0)))
    def pct(vals, q):
        vals = sorted(vals)
        if not vals:
            return 0.0
        i = min(len(vals) - 1, int(round(q * (len(vals) - 1))))
        return vals[i]
    out: Dict[str, dict] = {}
    for hop, pairs in per_hop.items():
        secs = [p[0] for p in pairs]
        fracs = [p[1] for p in pairs]
        out[hop] = {"n": len(pairs),
                    "p50_s": pct(secs, 0.50), "p99_s": pct(secs, 0.99),
                    "p50_frac": pct(fracs, 0.50),
                    "p99_frac": pct(fracs, 0.99)}
    return out


def format_table(agg: Dict[str, dict]) -> str:
    """The per-hop critical-path table, worst p99 share first."""
    lines = [f"{'hop':<14} {'n':>4} {'p50_ms':>9} {'p99_ms':>9} "
             f"{'p50_frac':>9} {'p99_frac':>9}"]
    for hop, row in sorted(agg.items(),
                           key=lambda kv: -kv[1]["p99_frac"]):
        lines.append(
            f"{hop:<14} {row['n']:>4} {row['p50_s'] * 1e3:>9.2f} "
            f"{row['p99_s'] * 1e3:>9.2f} {row['p50_frac']:>9.3f} "
            f"{row['p99_frac']:>9.3f}")
    return "\n".join(lines)


def format_span_tree(trace: dict) -> str:
    """One trace as an indented tree (children by start time), with
    durations, hop names and noteworthy tags."""
    spans = trace["spans"]
    by_parent: Dict[Optional[str], List[dict]] = {}
    ids = {s["span_id"] for s in spans}
    for s in spans:
        p = s["parent_id"] if s["parent_id"] in ids else None
        by_parent.setdefault(p, []).append(s)
    for kids in by_parent.values():
        kids.sort(key=lambda s: s["start"])
    t0 = min(s["start"] for s in spans) if spans else 0.0
    lines = [f"trace {trace.get('trace_id')} "
             f"(ttft={trace['summary'].get('ttft_s')})"]

    def walk(sid: Optional[str], indent: int) -> None:
        for s in by_parent.get(sid, ()):
            dur = ("open" if s["end"] is None
                   else f"{(s['end'] - s['start']) * 1e3:.2f}ms")
            tags = {k: v for k, v in s["tags"].items()
                    if k in ("outcome", "how", "replica", "state",
                             "reason", "orphan", "unfinished",
                             "readmission", "n")}
            tag_s = f" {tags}" if tags else ""
            lines.append(f"{'  ' * indent}- {s['name']} "
                         f"[+{(s['start'] - t0) * 1e3:.2f}ms "
                         f"{dur}]{tag_s}")
            walk(s["span_id"], indent + 1)

    walk(None, 1)
    return "\n".join(lines)


def chrome_trace(trace: dict) -> dict:
    """Perfetto/chrome-trace JSON for one trace — the profiler
    exporter's shape (complete "X" events, µs timestamps) so the same
    chrome://tracing / Perfetto flow renders request traces too.
    pid = the span's real OS process (cross-process hops land on
    separate tracks), tid = tree depth (nesting stays readable)."""
    depths = span_depths(trace)
    t0 = min((s["start"] for s in trace["spans"]), default=0.0)
    events = []
    for s in trace["spans"]:
        end = s["end"] if s["end"] is not None else s["start"]
        events.append({
            "name": s["name"], "ph": "X", "cat": hop_of(s["name"]),
            "pid": int(s.get("pid", 0)),
            "tid": depths.get(s["span_id"], 1),
            "ts": (s["start"] - t0) * 1e6,
            "dur": max(0.0, (end - s["start"]) * 1e6),
            "args": dict(s.get("tags", {})),
        })
    return {"traceEvents": events,
            "metadata": {"trace_id": trace.get("trace_id"),
                         "source": "paddle_tpu.tracing",
                         "summary": trace.get("summary", {})}}


def export_chrome(trace: dict, path: str) -> str:
    with open(path, "w", encoding="utf-8") as f:
        json.dump(chrome_trace(trace), f)
    return path


def load_trace_dir(dir_path: str) -> List[dict]:
    """Every trace in a tracer JSONL dir (torn tails tolerated — the
    exporter's crash contract, one definition)."""
    import os
    from ..observability.exporters import JSONLExporter
    out: List[dict] = []
    if not os.path.exists(dir_path):
        return out
    if os.path.isfile(dir_path):
        return [t for t in JSONLExporter.load_jsonl(dir_path)
                if isinstance(t, dict) and t.get("spans")]
    for name in sorted(os.listdir(dir_path)):
        if name.endswith(".jsonl"):
            out.extend(t for t in JSONLExporter.load_jsonl(
                os.path.join(dir_path, name))
                if isinstance(t, dict) and t.get("spans"))
    return out
