"""Job master / membership service for multi-node launches (counterpart
of ``paddle_tpu/distributed/launch/master.py``).

One service over one ``torch.distributed.TCPStore`` endpoint covers the
reference's two tiers (launch/controllers/master.py: HTTPMaster's
``sync_peers`` and ETCDMaster's heartbeats and watch):

- ``sync_peers``: epoch-scoped registration: each pod takes a slot
  (``add``) and publishes its record; everyone waits until all
  ``nnodes`` records exist. Registration order is the node rank.
- heartbeats: pods stamp ``hb/<pod>`` every ``interval``; a stamp that
  stays unchanged for a TTL on the OBSERVER's clock marks its pod dead
  (never the producer's wall clock against ours).
- restart epochs: a pod that sees a failure bumps ``epoch``; every
  watcher sees the bump, tears its pod down and registers again under
  the new epoch.

The store is PyTorch's own, the one ``torchrun`` and
``init_process_group`` use. Its methods map onto the JAX package's
native store: ``try_get`` is ``check`` then ``get``; a ``get`` with a
timeout is ``wait`` with that timeout, then ``get``. The server side
lives wherever ``Master(..., is_server=True)`` runs (the node whose
address is ``--master``); clients retry the connection until it is up,
so the controllers may start in any order.
"""

from __future__ import annotations

import datetime
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist


def _td(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=seconds)


class Master:
    """Membership service over one TCPStore endpoint."""

    def __init__(self, host: str, port: int, job_id: str = "default",
                 is_server: bool = False, timeout: float = 120.0,
                 connect_retry_s: float = 60.0):
        self.job = job_id
        self._server = bool(is_server)
        self._timeout = float(timeout)
        self._hb_thread: Optional[threading.Thread] = None
        self._hb_stop = threading.Event()
        # (stamp, first-seen LOCAL time) per observed pod
        self._hb_seen: Dict[str, Tuple[str, float]] = {}
        if is_server:
            self.store = dist.TCPStore(host, int(port), is_master=True,
                                       timeout=_td(timeout),
                                       wait_for_workers=False)
            return
        try:
            # the client retries its connection until this timeout
            self.store = dist.TCPStore(host, int(port), is_master=False,
                                       timeout=_td(connect_retry_s))
        except RuntimeError as e:
            raise RuntimeError(
                f"Master: no server at {host}:{port} after "
                f"{connect_retry_s:.0f}s: {e}") from e
        self.store.set_timeout(_td(timeout))

    def _k(self, *parts) -> str:
        return "/".join(("ptmaster", self.job) + tuple(str(p) for p in parts))

    @property
    def is_server(self) -> bool:
        """True when this Master hosts the store in-process: it must be
        the LAST controller standing on success (its exit ends the
        store)."""
        return self._server

    def try_get(self, key: str) -> Optional[bytes]:
        """The value of ``key``, or None when it is not set."""
        return self.store.get(key) if self.store.check([key]) else None

    def get(self, key: str, timeout: float) -> bytes:
        """The value of ``key``, waiting up to ``timeout`` seconds for it
        to be set; TimeoutError when it is not."""
        try:
            self.store.wait([key], _td(timeout))
        except dist.DistStoreError as e:
            raise TimeoutError(f"Master: {key} not set within "
                               f"{timeout:.1f}s") from e
        return self.store.get(key)

    # -- peer sync ----------------------------------------------------------

    def sync_peers(self, value: str, nnodes: int, epoch: int = 0,
                   timeout: float = 120.0) -> Tuple[List[str], int]:
        """Register this pod's record and wait for the full set.

        Returns (records ordered by node rank, this pod's node rank). A
        new epoch is a fresh registration round."""
        rank = self.store.add(self._k("e", epoch, "count"), 1) - 1
        if rank >= nnodes:
            raise RuntimeError(
                f"sync_peers: {rank + 1} pods registered for a {nnodes}-"
                f"node job (duplicate launch or stale epoch?)")
        self.store.set(self._k("e", epoch, "peer", rank), value)
        deadline = time.time() + timeout
        peers: List[str] = []
        for i in range(nnodes):
            left = max(deadline - time.time(), 0.1)
            peers.append(self.get(self._k("e", epoch, "peer", i),
                                  left).decode())
        return peers, rank

    def done_barrier(self, nnodes: int, epoch: int) -> bool:
        """Two-phase completion barrier for one epoch: True when every pod
        registered done, False if the restart epoch moved first. Phase 2
        (ack) keeps the server-hosting Master alive until every peer has
        seen the completion: exiting earlier ends the store under peers
        still polling."""
        self.store.add(self._k("e", epoch, "done"), 1)
        while True:
            n = self.store.add(self._k("e", epoch, "done"), 0)
            if n >= nnodes:
                self.store.add(self._k("e", epoch, "ack"), 1)
                if self.is_server:
                    deadline = time.time() + 60
                    while (self.store.add(self._k("e", epoch, "ack"), 0)
                           < nnodes and time.time() < deadline):
                        time.sleep(0.2)
                return True
            if self.restart_epoch() != epoch:
                return False
            time.sleep(0.3)

    # -- heartbeats ---------------------------------------------------------

    def heartbeat(self, pod_name: str) -> None:
        self.store.set(self._k("hb", pod_name), repr(time.time()))

    def start_heartbeat(self, pod_name: str, interval: float = 2.0) -> None:
        """A background stamping thread; each start gets a fresh stop
        event, so the elastic loop can stop and start it across epochs."""
        self._hb_stop = threading.Event()
        self.heartbeat(pod_name)
        stop = self._hb_stop

        def run():
            while not stop.wait(interval):
                try:
                    self.heartbeat(pod_name)
                except RuntimeError:
                    return                   # store gone: the job is over
        self._hb_thread = threading.Thread(target=run, daemon=True)
        self._hb_thread.start()

    def stop_heartbeat(self) -> None:
        self._hb_stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)

    def heartbeats(self, pod_names: List[str]) -> Dict[str, float]:
        out = {}
        for p in pod_names:
            v = self.try_get(self._k("hb", p))
            if v is not None:
                out[p] = float(v.decode())
        return out

    def dead_pods(self, pod_names: List[str], ttl: float) -> List[str]:
        """Pods whose heartbeat stamp has not CHANGED for ``ttl`` seconds
        of this observer's clock (a pod never seen stamping is not dead:
        it may not have started). Staleness of the stamp, not stamp
        against now: the producer's clock may be skewed by more than the
        TTL."""
        now = time.time()
        dead = []
        for p in pod_names:
            v = self.try_get(self._k("hb", p))
            if v is None:
                continue
            stamp = v.decode()
            prev = self._hb_seen.get(p)
            if prev is None or prev[0] != stamp:
                self._hb_seen[p] = (stamp, now)
                continue
            if now - prev[1] > ttl:
                dead.append(p)
        return dead

    # -- restart epochs -----------------------------------------------------

    def restart_epoch(self) -> int:
        return self.store.add(self._k("epoch"), 0)

    def bump_epoch(self, reason: str = "failure") -> int:
        """Signal every pod to tear down and register again. ``reason``
        ("failure" or "preempt") tells watchers whether the restart
        spends their failure budget. The reason rides an atomic counter
        advanced FIRST, so any observer of the epoch's move sees it;
        observers compare deltas, and a window mixing a failure with a
        preemption reads as a failure (the budget-spending reading)."""
        if reason == "preempt":
            self.store.add(self._k("preempt_epochs"), 1)
        return self.store.add(self._k("epoch"), 1)

    def preempt_epochs(self) -> int:
        """Preemption-reason bumps so far (see :meth:`bump_epoch`)."""
        return self.store.add(self._k("preempt_epochs"), 0)


__all__ = ["Master"]
