"""Metric exporters: crash-safe JSONL time-series, Prometheus text
exposition (file snapshot + optional stdlib HTTP endpoint), console table
(copy of ``paddle_tpu/observability/exporters.py``).

All exporters consume the plain-dict snapshot from
``MetricsRegistry.collect()`` — they never reach into live metric state, so
an exporter crash can't corrupt the registry and the set of exporters is
trivially extensible.
"""

from __future__ import annotations

import json
import os
import threading
import time
import warnings
from typing import Dict, List, Optional

__all__ = ["JSONLExporter", "PrometheusExporter", "ConsoleSummary",
           "render_prometheus", "parse_prometheus"]


# ---------------------------------------------------------------------------
# JSONL time-series
# ---------------------------------------------------------------------------

class JSONLExporter:
    """Append-only JSONL: each export appends one line per series with a
    shared timestamp. Crash-safe by construction — lines are written with
    a single ``write`` + flush, so a crash can at worst leave one torn
    final line, which a line-by-line reader skips (``load_jsonl``).

    Long runs rotate: with ``max_bytes`` set, an
    export that would push the live file past the cap first rotates it to
    ``<path>.1`` (shifting ``.1 -> .2`` … and dropping beyond
    ``keep_segments``), so a week-long serving job holds at most
    ``(keep_segments + 1) * max_bytes`` of telemetry on disk. One export
    is never split across segments — each segment stays independently
    parseable, and :meth:`load_rotated` reads them oldest-first."""

    def __init__(self, path: str, max_bytes: Optional[int] = None,
                 keep_segments: int = 3):
        if max_bytes is not None and max_bytes <= 0:
            raise ValueError("max_bytes must be positive (None disables "
                             "rotation)")
        if keep_segments < 1:
            raise ValueError("keep_segments must be >= 1")
        self.path = path
        self.max_bytes = max_bytes
        self.keep_segments = int(keep_segments)
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._f = open(path, "a", encoding="utf-8")
        self._closed = False
        self._lock = threading.Lock()

    def export(self, snapshot: List[dict]) -> int:
        ts = round(time.time(), 3)
        lines = []
        for entry in snapshot:
            rec = dict(entry)
            rec["ts"] = ts
            lines.append(json.dumps(rec, sort_keys=True))
        blob = "".join(ln + "\n" for ln in lines)
        with self._lock:
            if self._closed:
                # close() is final — enable()'s replace-and-close relies
                # on a replaced exporter never appending again
                raise ValueError("export() on a closed JSONLExporter")
            if self._f is None or self._f.closed:
                # a failed rotation reopen must not brick the exporter
                # forever — retry the open on the next export
                self._f = open(self.path, "a", encoding="utf-8")
            if (self.max_bytes is not None and self._f.tell() > 0
                    and self._f.tell() + len(blob.encode("utf-8"))
                    > self.max_bytes):
                self._rotate_locked()
            self._f.write(blob)
            self._f.flush()
        return len(lines)

    def _rotate_locked(self) -> None:
        """Shift the segment chain by one: live -> .1, .k -> .k+1,
        .keep_segments dropped. The live file reopens empty; a crash
        mid-rotation at worst loses the oldest (dropped-anyway) segment
        — the newest data always survives because the live file is only
        renamed, never rewritten. A filesystem that accepts appends but
        refuses renames disables rotation after ONE failed attempt
        (warned): re-shifting the chain on every export would delete
        every kept segment while the live file grew anyway."""
        try:
            self._f.close()
        except Exception:
            pass
        self._f = None
        try:
            # drop the end of the chain AND any segments beyond it — a
            # previous run with a larger keep_segments leaves .k files
            # this run's shift would otherwise never touch, silently
            # breaking the (keep_segments + 1) * max_bytes disk bound
            for k in self._segment_numbers(self.path):
                if k >= self.keep_segments:
                    os.remove(f"{self.path}.{k}")
            for k in range(self.keep_segments - 1, 0, -1):
                src = f"{self.path}.{k}"
                if os.path.exists(src):
                    os.replace(src, f"{self.path}.{k + 1}")
            os.replace(self.path, f"{self.path}.1")
        except OSError as e:
            warnings.warn(f"JSONLExporter: segment rotation of "
                          f"{self.path} failed ({e}); rotation disabled "
                          f"for this exporter", RuntimeWarning)
            self.max_bytes = None
        finally:
            self._f = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            self._closed = True
            try:
                if self._f is not None:
                    self._f.close()
            except Exception:
                pass

    @staticmethod
    def _segment_numbers(path: str) -> List[int]:
        """Numeric suffixes of ``<path>.N`` segments on disk, ascending
        — the ONE definition of what belongs to the rotation chain."""
        ks = []
        d = os.path.dirname(os.path.abspath(path)) or "."
        base = os.path.basename(path)
        for name in os.listdir(d):
            if name.startswith(base + "."):
                suffix = name[len(base) + 1:]
                if suffix.isdigit():
                    ks.append(int(suffix))
        return sorted(ks)

    @staticmethod
    def load_jsonl(path: str) -> List[dict]:
        """Parse line-by-line, skipping a torn final line (the crash-safety
        contract)."""
        out = []
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except ValueError:
                    # only the LAST line may be torn; anything else is
                    # corruption the caller must see
                    rest = f.read().strip()
                    if rest:
                        raise
        return out

    @staticmethod
    def load_rotated(path: str) -> List[dict]:
        """Load the full rotated series oldest-first: ``<path>.N`` …
        ``<path>.1`` then the live file, each through the torn-tail-
        tolerant per-file parser (a rotated segment was closed cleanly,
        but a crash can still tear its final line — same tolerance
        applies)."""
        out: List[dict] = []
        for k in reversed(JSONLExporter._segment_numbers(path)):
            out.extend(JSONLExporter.load_jsonl(f"{path}.{k}"))
        if os.path.exists(path):
            out.extend(JSONLExporter.load_jsonl(path))
        return out


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _prom_labels(labels: Dict[str, str]) -> str:
    if not labels:
        return ""
    inner = ",".join(
        '%s="%s"' % (k, str(v).replace("\\", "\\\\").replace('"', '\\"'))
        for k, v in sorted(labels.items()))
    return "{" + inner + "}"


def render_prometheus(snapshot: List[dict]) -> str:
    """Render a collect() snapshot in Prometheus text exposition format
    (one # TYPE header per metric, histogram as _bucket/_sum/_count).

    Empty histograms are NOT special-cased here: ``collect()`` emits a
    zeroed series (all ``_bucket`` counts 0, ``_count`` 0) for every
    registered histogram with no observations, so the exposition carries
    a stable series set from the first scrape — this renderer just prints
    whatever bucket rows the snapshot holds."""
    by_name: Dict[str, List[dict]] = {}
    for e in snapshot:
        by_name.setdefault(e["name"], []).append(e)
    lines: List[str] = []
    for name in sorted(by_name):
        entries = by_name[name]
        lines.append(f"# TYPE {name} {entries[0]['type']}")
        for e in entries:
            if e["type"] == "histogram":
                for le, cum in e["buckets"]:
                    lb = dict(e["labels"])
                    lb["le"] = str(le)
                    lines.append(f"{name}_bucket{_prom_labels(lb)} {cum}")
                lines.append(
                    f"{name}_sum{_prom_labels(e['labels'])} {e['sum']}")
                lines.append(
                    f"{name}_count{_prom_labels(e['labels'])} {e['count']}")
            else:
                lines.append(
                    f"{name}{_prom_labels(e['labels'])} {e['value']}")
    return "\n".join(lines) + "\n"


def parse_prometheus(text: str) -> Dict[str, Dict[tuple, float]]:
    """Minimal text-format parser (the round-trip validator the smoke
    test uses): {metric_name: {sorted-label-tuple: value}}. Handles the
    subset render_prometheus emits — enough to prove the exposition is
    well-formed, not a general scraper."""
    out: Dict[str, Dict[tuple, float]] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        body, _, val = line.rpartition(" ")
        if not body:
            raise ValueError(f"unparseable sample line: {line!r}")
        labels: Dict[str, str] = {}
        if body.endswith("}"):
            name, _, rest = body.partition("{")
            for item in _split_label_items(rest[:-1]):
                k, _, v = item.partition("=")
                if not (v.startswith('"') and v.endswith('"')):
                    raise ValueError(f"bad label value in: {line!r}")
                labels[k] = v[1:-1].replace('\\"', '"').replace("\\\\", "\\")
        else:
            name = body
        out.setdefault(name, {})[tuple(sorted(labels.items()))] = float(val)
    return out


def _split_label_items(s: str) -> List[str]:
    """Split `a="x",b="y,z"` on commas outside quotes."""
    items, cur, in_q, esc = [], [], False, False
    for ch in s:
        if esc:
            cur.append(ch)
            esc = False
            continue
        if ch == "\\":
            cur.append(ch)
            esc = True
            continue
        if ch == '"':
            in_q = not in_q
        if ch == "," and not in_q:
            items.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if cur:
        items.append("".join(cur))
    return [i for i in items if i]


class _PromHandler:
    """Lazily-built BaseHTTPRequestHandler subclass bound to an exporter."""

    @staticmethod
    def build(exporter: "PrometheusExporter"):
        from http.server import BaseHTTPRequestHandler

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib API name)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = exporter.latest_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):  # silence per-request stderr spam
                pass

        return Handler


class PrometheusExporter:
    """Text-format exposition. ``path`` writes an atomic snapshot file per
    export (node-exporter textfile-collector style); ``http_port`` serves
    the latest snapshot at ``/metrics`` from a stdlib ThreadingHTTPServer
    daemon thread (port 0 = ephemeral; see ``.port`` after start)."""

    def __init__(self, path: Optional[str] = None,
                 http_port: Optional[int] = None):
        self.path = path
        self._text = "# no export yet\n"
        self._lock = threading.Lock()
        self._server = None
        self._thread = None
        self.port = None
        if http_port is not None:
            self._start_http(http_port)

    def latest_text(self) -> str:
        with self._lock:
            return self._text

    def export(self, snapshot: List[dict]) -> str:
        text = render_prometheus(snapshot)
        with self._lock:
            self._text = text
        if self.path:
            tmp = f"{self.path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                f.write(text)
            os.replace(tmp, self.path)
        return text

    def _start_http(self, port: int) -> None:
        from http.server import ThreadingHTTPServer

        self._server = ThreadingHTTPServer(
            ("127.0.0.1", int(port)), _PromHandler.build(self))
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="pt-prom-http", daemon=True)
        self._thread.start()

    def close(self) -> None:
        if self._server is not None:
            try:
                self._server.shutdown()
                self._server.server_close()
            except Exception:
                pass
            self._server = None


# ---------------------------------------------------------------------------
# console summary
# ---------------------------------------------------------------------------

class ConsoleSummary:
    """Human-readable table of the snapshot (the `p.summary()` of the
    metrics plane). ``export`` returns the string; ``echo=True`` also
    prints it."""

    def __init__(self, echo: bool = False):
        self.echo = echo

    def export(self, snapshot: List[dict]) -> str:
        lines = [f"{'Metric':<44} {'Labels':<28} {'Value':>14}"]
        for e in sorted(snapshot, key=lambda e: (e["name"],
                                                 sorted(e["labels"].items()))):
            lb = ",".join(f"{k}={v}" for k, v in sorted(e["labels"].items()))
            if e["type"] == "histogram":
                val = (f"n={e['count']} p50={e.get('p50', float('nan')):.4g}"
                       f" p99={e.get('p99', float('nan')):.4g}")
                lines.append(f"{e['name']:<44} {lb[:28]:<28} {val:>14}")
            else:
                v = e["value"]
                sval = f"{v:.6g}" if isinstance(v, float) else str(v)
                lines.append(f"{e['name']:<44} {lb[:28]:<28} {sval:>14}")
        out = "\n".join(lines)
        if self.echo:
            print(out, flush=True)
        return out
