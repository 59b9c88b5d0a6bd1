"""FabricClient: the retry-correct client of a :class:`~.frontdoor.
FrontDoor` (copy of ``paddle_tpu/serving_fabric/client.py``).

It imports no ``torch`` (nor anything that does), so a client process
never initializes a card.

The front door makes retries SAFE (per-id dedupe + replay resume); this
client makes them AUTOMATIC:

* **Jittered exponential backoff** — :class:`~.robust.Backoff` full
  jitter, floored by any server ``retry_after_ms`` hint, so a rejected
  herd decorrelates above the server's own recovery estimate.
* **Idempotent resubmission** — every attempt carries the SAME client
  id and ``have`` = tokens already received; the server resumes the
  stream via its dedupe record (original rseed + replay prefix), so a
  retry after a mid-stream disconnect delivers exactly the missing
  suffix — zero duplicated, zero lost tokens, asserted by seq/count
  checks here.
* **Hedged attempt on TTFT-deadline miss** — when ``hedge_after_s`` is
  set and no first token arrives in time, the client abandons the
  silent connection and re-attaches on a fresh one. The server's
  single-owner takeover semantics make this the correct form of a
  hedge: a parallel second attempt would immediately steal the stream
  from the first anyway, so at most one socket ever owns it and the
  "race" collapses to fail over fast.

Retryable: ``overloaded`` / ``all_down`` rejections (server says when),
connection faults (reset, EOF, refused — the door may be restarting),
and hedge timeouts. NOT retryable: ``deadline`` (the budget is spent)
and application rejects — those raise typed immediately.
"""

from __future__ import annotations

import itertools
import json
import os
import socket
import time
from typing import Callable, List, Optional

from .robust import (AllReplicasDown, Backoff, DeadlineExceeded,
                     FabricRejected, Overloaded)

__all__ = ["FabricClient", "ClientResult"]

_KIND_EXC = {"overloaded": Overloaded, "all_down": AllReplicasDown,
             "deadline": DeadlineExceeded}
_uniq = itertools.count()


class ClientResult:
    """Outcome of one generate(): the token stream plus the client-side
    robustness ledger the tests assert on."""

    def __init__(self, tokens: List[int], attempts: int,
                 retries: int, hedged: int, rejects: List[dict]):
        self.tokens = tokens
        self.attempts = attempts
        self.retries = retries
        self.hedged = hedged
        self.rejects = rejects          # typed rejections absorbed


class FabricClient:
    """See module doc. One client may run many sequential requests;
    each concurrent stream wants its own client (one socket each)."""

    def __init__(self, host: str, port: int,
                 connect_timeout_s: float = 5.0,
                 io_timeout_s: float = 60.0,
                 max_attempts: int = 5,
                 backoff: Optional[Backoff] = None,
                 hedge_after_s: Optional[float] = None,
                 max_line_bytes: int = 1 << 20):
        self.host, self.port = host, int(port)
        self.connect_timeout_s = float(connect_timeout_s)
        self.io_timeout_s = float(io_timeout_s)
        self.max_attempts = int(max_attempts)
        self.backoff = backoff or Backoff()
        self.hedge_after_s = hedge_after_s
        self.max_line_bytes = int(max_line_bytes)

    # -- wire plumbing -------------------------------------------------------

    def _connect(self):
        s = socket.create_connection((self.host, self.port),
                                     timeout=self.connect_timeout_s)
        s.settimeout(self.io_timeout_s)
        return s, s.makefile("rb")

    @staticmethod
    def _send(sock, msg: dict) -> None:
        sock.sendall(json.dumps(msg).encode() + b"\n")

    def _recv(self, f) -> dict:
        line = f.readline(self.max_line_bytes + 1)
        if not line:
            raise ConnectionError("server closed the connection")
        if len(line) > self.max_line_bytes or not line.endswith(b"\n"):
            raise ConnectionError("overlong server frame")
        return json.loads(line)

    # -- the request loop ----------------------------------------------------

    def generate(self, prompt, max_new_tokens: int,
                 tenant: str = "default",
                 knobs: Optional[dict] = None,
                 ttft_deadline_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None,
                 request_id: Optional[str] = None,
                 on_token: Optional[Callable[[int], None]] = None,
                 trace_id: Optional[str] = None) -> ClientResult:
        """Run one streaming request to completion through every
        robustness path; returns the full token stream. Raises the
        typed rejection when attempts are exhausted or the refusal is
        terminal (``deadline``). ``trace_id`` joins this request to a
        caller-owned distributed trace (the front door mints one per
        request otherwise, when tracing is on)."""
        sid = request_id or f"c{os.getpid()}-{next(_uniq)}"
        toks: List[int] = []
        seq_next: Optional[int] = None
        attempts = retries = hedged = 0
        rejects: List[dict] = []
        last_exc: Optional[Exception] = None
        while attempts < self.max_attempts:
            attempts += 1
            if attempts > 1:
                retries += 1
            sock = f = None
            try:
                sock, f = self._connect()
                if self.hedge_after_s is not None and not toks:
                    # TTFT hedge window: a silent server past this
                    # budget is abandoned for a fresh attempt
                    sock.settimeout(self.hedge_after_s)
                self._send(sock, {
                    "op": "submit", "id": sid,
                    "prompt": [int(t) for t in prompt],
                    "max_new_tokens": int(max_new_tokens),
                    "tenant": tenant, "knobs": knobs,
                    "ttft_deadline_ms": ttft_deadline_ms,
                    "deadline_ms": deadline_ms, "have": len(toks),
                    "trace_id": trace_id})
                seq_next = None
                while True:
                    try:
                        ev = self._recv(f)
                    except socket.timeout:
                        if self.hedge_after_s is not None and not toks:
                            hedged += 1
                            raise ConnectionError("ttft hedge fired")
                        raise
                    # per-connection seq: ordered and gapless, or the
                    # transport lied to us
                    s = ev.get("seq")
                    if s is not None:
                        if seq_next is not None and s != seq_next:
                            raise ConnectionError(
                                f"seq gap: got {s}, wanted {seq_next}")
                        seq_next = s + 1
                    kind = ev.get("ev")
                    if kind == "tok" and ev.get("id") == sid:
                        new = [int(t) for t in ev.get("toks", ())]
                        toks.extend(new)
                        if toks and sock.gettimeout() != \
                                self.io_timeout_s:
                            sock.settimeout(self.io_timeout_s)
                        if on_token is not None:
                            for t in new:
                                on_token(t)
                    elif kind == "done" and ev.get("id") == sid:
                        toks.extend(int(t) for t in ev.get("toks", ()))
                        n = int(ev.get("n", len(toks)))
                        if len(toks) != n:
                            raise ConnectionError(
                                f"stream short: {len(toks)}/{n} tokens")
                        return ClientResult(toks, attempts, retries,
                                            hedged, rejects)
                    elif kind == "reject" and ev.get("id") == sid:
                        exc = _KIND_EXC.get(ev.get("kind"),
                                            FabricRejected)(
                            ev.get("error", "rejected"),
                            retry_after_ms=ev.get("retry_after_ms"))
                        if isinstance(exc, (Overloaded,
                                            AllReplicasDown)):
                            rejects.append(ev)
                            last_exc = exc
                            raise exc          # → backoff + retry
                        raise exc              # terminal: propagate
                    elif kind == "cancelled" and ev.get("id") == sid:
                        # takeover by another attempt of OURS would be
                        # a client bug (one generate per id); treat as
                        # a dropped attempt and retry
                        raise ConnectionError(
                            f"server cancelled: {ev.get('reason')}")
                    # ack / pong / other-id events: keep reading
            except (Overloaded, AllReplicasDown) as e:
                time.sleep(self.backoff.delay_s(attempts - 1,
                                                e.retry_after_ms))
            except (OSError, ValueError, ConnectionError) as e:
                last_exc = e
                time.sleep(self.backoff.delay_s(attempts - 1))
            finally:
                for c in (f, sock):
                    if c is not None:
                        try:
                            c.close()
                        except OSError:
                            pass
        raise (last_exc if isinstance(last_exc, FabricRejected)
               else FabricRejected(
                   f"request {sid!r} failed after "
                   f"{attempts} attempts: {last_exc}"))
