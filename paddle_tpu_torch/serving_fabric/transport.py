"""FabricTransport: how the router reaches its replicas (counterpart of
``paddle_tpu/serving_fabric/transport.py``).

The router speaks ONE verb set — submit / poll / status / extract /
adopt — against a :class:`FabricTransport`, and two implementations
provide it:

* :class:`InProcTransport` — N :class:`~.replica.Replica` objects in one
  process, direct method calls. ``kill()`` drops a replica exactly the
  way a SIGKILL would look from the router's side — every subsequent op
  raises :class:`ReplicaDown`, with no goodbye.
* :class:`TcpTransport` + :class:`TcpReplicaServer` — newline-delimited
  JSON over TCP; KV-page handoff payloads cross as base64
  (:func:`payload_to_wire` / :func:`payload_from_wire`), byte for byte
  the JAX package's wire form, so either framework's replica adopts the
  other's pages. Framing, encoding and death detection only — routing
  policy never leaks down here.

Every fault surfaces as :class:`ReplicaDown`; the ROUTER owns recovery
(re-admission with the request's remaining budget), transports only
detect.
"""

from __future__ import annotations

import base64
import json
import socket
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from ..inference.serving import HANDOFF_DTYPES

__all__ = ["ReplicaDown", "FabricTransport", "InProcTransport",
           "TcpTransport", "TcpReplicaServer", "payload_to_wire",
           "payload_from_wire"]


class ReplicaDown(RuntimeError):
    """The replica is unreachable/dead; the router must fail over."""

    def __init__(self, name: str, why: str = ""):
        super().__init__(f"replica {name!r} is down"
                         + (f": {why}" if why else ""))
        self.name = name


class FabricTransport:
    """The verb set the router drives; every method may raise
    :class:`ReplicaDown` for its replica."""

    def replica_names(self) -> List[str]:
        raise NotImplementedError

    def submit(self, name: str, req: dict) -> int:
        """Queue a request payload on ``name``; returns its local rid.

        Trace propagation contract: when tracing is on, ``req`` carries
        a JSON-safe ``"trace"`` key (the wire form of
        :class:`~..observability.tracing.TraceContext`) that every
        transport must deliver verbatim — explicit context injection is
        what lets replica-side spans stitch under the router's tree
        across a process boundary."""
        raise NotImplementedError

    def poll(self, name: str) -> dict:
        """Advance ``name`` one scheduler tick; returns
        ``{"emitted": [[rid, tok], ...], "finished": {rid: [tokens]}}``
        plus, when tracing is on, ``"spans"``: finished replica-side
        span dicts piggybacking home for the router to ingest."""
        raise NotImplementedError

    def status(self, name: str) -> dict:
        """Heartbeat: load, pool, latency gauges + prefix digest."""
        raise NotImplementedError

    def extract(self, name: str, tokens) -> Optional[dict]:
        """serialize_pages on ``name`` for ``tokens`` (handoff source)."""
        raise NotImplementedError

    def adopt(self, name: str, payload: dict) -> int:
        """adopt_pages on ``name``; returns pages adopted."""
        raise NotImplementedError

    # Optional verbs. Defaults are safe no-ops so scripted
    # stub transports in tests (and third-party transports) keep
    # working without implementing them: a False/{} answer just means
    # "this transport can't do that", which the router tolerates.

    def cancel(self, name: str, rid: int) -> bool:
        """Terminate local ``rid`` on ``name`` and free its slot/pages
        (deadline miss, client disconnect, slow-loris eviction).
        Returns True when the request existed and was cancelled."""
        return False

    def configure(self, name: str, knobs: dict) -> dict:
        """Push runtime knobs (brownout ``spec_k`` cap, …) to ``name``;
        returns the knobs the replica actually applied."""
        return {}


# ---------------------------------------------------------------------------
# in-process
# ---------------------------------------------------------------------------

class InProcTransport(FabricTransport):
    """N replicas, one process. ``kill`` simulates replica death: the
    object stays (its pages/engine die with it conceptually) but every
    op raises :class:`ReplicaDown` from then on."""

    def __init__(self, replicas):
        # accepts a list (names from the replicas) or a dict
        if isinstance(replicas, dict):
            self._replicas = dict(replicas)
        else:
            self._replicas = {r.name: r for r in replicas}
        self._dead: set = set()
        self._hung: Dict[str, threading.Event] = {}

    def _get(self, name: str, op: str = ""):
        if name in self._dead:
            raise ReplicaDown(name, "killed")
        ev = self._hung.get(name)
        if ev is not None and op != "status":
            # the hang failure mode: the replica heartbeats but never
            # progresses — callers block here exactly like a wedged
            # remote. The engine is never touched by a hung op; on
            # release the op reports ReplicaDown (the stalled call's
            # answer is lost).
            ev.wait()
            raise ReplicaDown(name, "hang released; op abandoned")
        r = self._replicas.get(name)
        if r is None:
            raise ReplicaDown(name, "unknown replica")
        return r

    def replica_names(self) -> List[str]:
        return list(self._replicas)

    def kill(self, name: str) -> None:
        """Drop ``name`` mid-whatever-it-was-doing."""
        self._dead.add(name)
        ev = self._hung.pop(name, None)
        if ev is not None:
            ev.set()

    def hang(self, name: str) -> None:
        """Wedge ``name``: ``status`` still answers but every other op
        blocks until :meth:`unhang`."""
        if name not in self._replicas:
            raise ReplicaDown(name, "unknown replica")
        self._hung.setdefault(name, threading.Event())

    def unhang(self, name: str) -> None:
        """Release a hang: blocked ops wake (and report ReplicaDown);
        fresh ops succeed again."""
        ev = self._hung.pop(name, None)
        if ev is not None:
            ev.set()

    def alive(self, name: str) -> bool:
        return name in self._replicas and name not in self._dead

    def submit(self, name, req):
        return self._get(name, "submit").submit(req)

    def poll(self, name):
        return self._get(name, "poll").poll()

    def status(self, name):
        return self._get(name, "status").status()

    def extract(self, name, tokens):
        return self._get(name, "extract").extract(tokens)

    def adopt(self, name, payload):
        return self._get(name, "adopt").adopt(payload)

    def cancel(self, name, rid):
        return self._get(name, "cancel").cancel(rid)

    def configure(self, name, knobs):
        return self._get(name, "configure").configure(knobs)


# ---------------------------------------------------------------------------
# KV-payload wire codec (shared by the TCP transport and any file/queue
# transport a deployment adds)
# ---------------------------------------------------------------------------

def _raw_bytes(t: torch.Tensor) -> bytes:
    """A CPU tensor's bytes in row-major order (bf16 as its 16-bit
    patterns)."""
    return t.contiguous().view(torch.uint8).numpy().tobytes()


def payload_to_wire(payload: dict) -> dict:
    """serialize_pages dict → JSON-safe dict (tokens as a list, kv as
    base64 of its raw bytes; shape/dtype/sha256 ride along so the far
    side validates end to end, not per hop). v2 payloads of an int8 pool
    also carry the per-page fp32 scales (base64, little-endian), which
    the sha256 covers. The JAX package's wire form, byte for byte."""
    wire = {"fmt": payload["fmt"], "page_size": payload["page_size"],
            "tokens": np.asarray(payload["tokens"],
                                 np.int32).tolist(),
            "dtype": payload["dtype"], "shape": list(payload["shape"]),
            "sha256": payload["sha256"],
            "kv_b64": base64.b64encode(
                _raw_bytes(payload["kv"])).decode("ascii")}
    if payload.get("scales") is not None:
        wire["scales_b64"] = base64.b64encode(
            _raw_bytes(payload["scales"])).decode("ascii")
        wire["scales_shape"] = list(payload["scales_shape"])
    return wire


def _from_bytes(raw: bytes, dtype: str, shape) -> torch.Tensor:
    return torch.frombuffer(bytearray(raw), dtype=HANDOFF_DTYPES[dtype]) \
        .reshape([int(d) for d in shape])


def payload_from_wire(wire: dict) -> dict:
    """Inverse of :func:`payload_to_wire`: kv and scales come back as CPU
    tensors (bf16 pages from their raw 16-bit patterns, no
    ``ml_dtypes``). Decode errors become ValueError — the same rejection
    class adopt_pages raises, so a mangled wire payload can't crash the
    replica loop."""
    try:
        kv = _from_bytes(base64.b64decode(wire["kv_b64"]), wire["dtype"],
                         wire["shape"])
        scales = None
        if wire.get("scales_b64") is not None:
            scales = _from_bytes(base64.b64decode(wire["scales_b64"]),
                                 "float32", wire["scales_shape"])
    except Exception as e:
        raise ValueError(f"handoff payload: undecodable wire form "
                         f"({e})")
    out = {"fmt": wire.get("fmt"), "page_size": wire.get("page_size"),
           "tokens": np.asarray(wire.get("tokens", ()), np.int32),
           "kv": kv, "dtype": wire.get("dtype"),
           "shape": list(wire.get("shape", ())),
           "sha256": wire.get("sha256")}
    if scales is not None:
        out["scales"] = scales
        out["scales_shape"] = list(wire.get("scales_shape", ()))
    return out


# ---------------------------------------------------------------------------
# TCP (multi-host)
# ---------------------------------------------------------------------------

class TcpReplicaServer:
    """Host one replica behind newline-delimited JSON on a TCP socket.
    Single-threaded request handling on purpose: the router is the only
    client and the engine is not thread-safe — ops execute in arrival
    order, exactly like the in-proc transport."""

    def __init__(self, replica, host: str = "127.0.0.1", port: int = 0,
                 max_line_bytes: int = 32 << 20):
        self.replica = replica
        self.max_line_bytes = int(max_line_bytes)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(4)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # EVERY live connection, not just the latest: stop() must sever
        # them all or a peer holding an older socket keeps a zombie
        # replica answering after "death"
        self._conns: set = set()
        self._conns_lock = threading.Lock()

    def _handle(self, op: str, args: dict):
        if op == "submit":
            return self.replica.submit(args["req"])
        if op == "poll":
            return self.replica.poll()
        if op == "status":
            return self.replica.status()
        if op == "extract":
            payload = self.replica.extract(args["tokens"])
            return None if payload is None else payload_to_wire(payload)
        if op == "adopt":
            return self.replica.adopt(payload_from_wire(args["payload"]))
        if op == "cancel":
            return self.replica.cancel(args["rid"])
        if op == "configure":
            return self.replica.configure(args.get("knobs") or {})
        raise ValueError(f"unknown op {op!r}")

    def serve_forever(self) -> None:
        while not self._stop.is_set():
            try:
                self._sock.settimeout(0.25)
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            with self._conns_lock:
                self._conns.add(conn)
            try:
                with conn:
                    f = conn.makefile("rwb")
                    while not self._stop.is_set():
                        # bounded read: a peer that streams bytes
                        # without ever sending a newline gets cut off
                        # at the cap instead of growing server memory
                        line = f.readline(self.max_line_bytes + 1)
                        if not line:
                            break
                        if (len(line) > self.max_line_bytes
                                or not line.endswith(b"\n")):
                            break
                        try:
                            msg = json.loads(line)
                            result = self._handle(msg.get("op", ""),
                                                  msg.get("args", {}))
                            out = {"ok": True, "result": result}
                        except Exception as e:
                            out = {"ok": False,
                                   "error": f"{type(e).__name__}: {e}"}
                        f.write(json.dumps(out).encode() + b"\n")
                        f.flush()
            except OSError:
                pass
            finally:
                with self._conns_lock:
                    self._conns.discard(conn)

    def start(self) -> "TcpReplicaServer":
        self._thread = threading.Thread(target=self.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        """Tear the replica down like a kill: the LISTENER closes and
        every live router connection is severed too — the router's next
        op sees a reset (→ ReplicaDown), not a replica that keeps
        answering through a socket it already held."""
        self._stop.set()
        with self._conns_lock:
            conns = list(self._conns)
        for s in [self._sock] + conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass


class TcpTransport(FabricTransport):
    """Router-side client: one persistent connection per replica,
    request/response JSON lines. Any socket fault — refused, reset,
    torn mid-line — is :class:`ReplicaDown`; the router decides what to
    do about it."""

    def __init__(self, endpoints: Dict[str, tuple],
                 connect_timeout_s: float = 2.0,
                 op_timeout_s: float = 60.0,
                 max_line_bytes: int = 32 << 20):
        self._endpoints = dict(endpoints)
        self._conns: Dict[str, object] = {}
        self._connect_timeout = float(connect_timeout_s)
        self._op_timeout = float(op_timeout_s)
        self.max_line_bytes = int(max_line_bytes)

    def replica_names(self) -> List[str]:
        return list(self._endpoints)

    def _call(self, name: str, op: str, args: dict):
        # A persistent connection can be STALE (the server restarted
        # since the last op): retry exactly once on a fresh socket in
        # that case, so a rolling replica restart looks like a blip,
        # not ReplicaDown. First-contact failures are never retried —
        # nothing was stale, the replica is genuinely unreachable.
        had_conn = name in self._conns
        try:
            return self._call_once(name, op, args)
        except ReplicaDown:
            if not had_conn:
                raise
            return self._call_once(name, op, args)

    def _call_once(self, name: str, op: str, args: dict):
        try:
            f = self._conns.get(name)
            if f is None:
                host, port = self._endpoints[name]
                s = socket.create_connection(
                    (host, port), timeout=self._connect_timeout)
                s.settimeout(self._op_timeout)
                f = self._conns[name] = s.makefile("rwb")
            f.write(json.dumps({"op": op, "args": args}).encode() + b"\n")
            f.flush()
            line = f.readline(self.max_line_bytes + 1)
            if not line:
                raise ConnectionError("connection closed")
            if (len(line) > self.max_line_bytes
                    or not line.endswith(b"\n")):
                raise ConnectionError("overlong response line")
            resp = json.loads(line)
        except (OSError, ValueError, KeyError) as e:
            self._conns.pop(name, None)
            raise ReplicaDown(name, str(e))
        if not resp.get("ok"):
            # an application error (bad payload) is NOT replica death —
            # re-raise as ValueError so the router treats it as a
            # failed op against a live replica
            raise ValueError(resp.get("error", "remote error"))
        return resp.get("result")

    def submit(self, name, req):
        # numpy arrays → lists for the JSON hop
        wire = dict(req)
        for k in ("prompt", "replay"):
            if wire.get(k) is not None:
                wire[k] = np.asarray(wire[k], np.int32).tolist()
        return self._call(name, "submit", {"req": wire})

    def poll(self, name):
        return self._call(name, "poll", {})

    def status(self, name):
        return self._call(name, "status", {})

    def extract(self, name, tokens):
        wire = self._call(name, "extract",
                          {"tokens": np.asarray(tokens,
                                                np.int32).tolist()})
        return None if wire is None else payload_from_wire(wire)

    def adopt(self, name, payload):
        return self._call(name, "adopt",
                          {"payload": payload_to_wire(payload)})

    def cancel(self, name, rid):
        return bool(self._call(name, "cancel", {"rid": int(rid)}))

    def configure(self, name, knobs):
        return self._call(name, "configure", {"knobs": dict(knobs)})

    def close(self) -> None:
        for f in self._conns.values():
            try:
                f.close()
            except OSError:
                pass
        self._conns.clear()
