"""Elastic training manager (counterpart of
``paddle_tpu/distributed/elastic.py``; reference:
python/paddle/distributed/fleet/elastic/manager.py:126 ElasticManager,
ElasticLevel at manager.py:43).

Reference behavior: nodes register in etcd, a watcher tracks membership;
on scale-in/out (or node death) training is killed and relaunched with a
regenerated rank map; checkpoint/resume provides continuity.

Here the registry is ``torch.distributed.TCPStore`` (as the launcher's
``Master`` and ``rpc`` use it): membership is heartbeat keys checked
against a timeout window. A process holds one card and a process group
cannot shrink in place, so a CHANGED world size is survived the
reference's way: ``train_fn(attempt, world_size)`` under
:meth:`ElasticManager.run_elastic` launches a pod of ``world_size``
ranks through the port's launcher (``distributed.launch``); a rank that
sees :class:`WorldSizeChanged` commits its checkpoint and exits with
:data:`WORLD_SIZE_CHANGED_EXIT`, which the launching process maps back to
:class:`WorldSizeChanged` (:func:`raise_for_pod_exit`), and
:meth:`ElasticManager.run_elastic` re-enters at the new size — full-jitter
backoff, no restart budget burned. :func:`replan_and_apply` asks the
auto-parallel planner for the best legal config on the new world and
re-places the trainer's state through ``Trainer.apply_plan``; the
resharded checkpoint restore is ``resilience/reshard.py``.
``pt_elastic_*`` counters publish the flow through the registry;
``observability.sentry.elastic_rules()`` is the matching alert pack.
"""

from __future__ import annotations

import datetime
import json
import os
import random
import threading
import time
from enum import IntEnum
from typing import Callable, Optional

#: a rank's exit code for "membership changed: my checkpoint is
#: committed, relaunch me at the new world size"
WORLD_SIZE_CHANGED_EXIT = 76


def backoff_delays(base: float, cap: float, attempts: int,
                   rng: Optional[random.Random] = None):
    """Jittered exponential backoff schedule ("full jitter": U(0, base·2^k),
    capped). A restarting coordinator must not be stampeded by every worker
    retrying in lockstep — the jitter spreads the reconnect wave."""
    rng = rng or random.Random()
    delay = float(base)
    for _ in range(attempts):
        yield rng.uniform(0.0, min(delay, cap))
        delay = min(delay * 2.0, cap)


class WorldSizeChanged(RuntimeError):
    """Membership changed under a live run (a worker died or joined).

    Raised from inside a training callable (e.g. a heartbeat-driven
    ``membership_probe`` callback) to unwind to
    :meth:`ElasticManager.run_elastic`, which re-plans on the surviving
    devices and re-enters — WITHOUT burning the failure-restart budget
    (losing a host is the normal weather of preemptible pods, not a bug
    in the training code). Across processes it travels as the exit code
    :data:`WORLD_SIZE_CHANGED_EXIT` (:func:`raise_for_pod_exit`)."""

    def __init__(self, old_size: int, new_size: int):
        super().__init__(f"world size changed {old_size} -> {new_size}")
        self.old_size = int(old_size)
        self.new_size = int(new_size)


class ElasticLevel(IntEnum):
    FAULT_TOLERANCE = 1   # fixed world size, relaunch on failure
    ELASTIC = 2           # world size may change between restarts


class ElasticStatus:
    COMPLETED = "completed"
    ERROR = "error"
    HOLD = "hold"
    RESTART = "restart"
    EXIT = "exit"


class ElasticManager:
    """Membership and restart policy.

    ``host_port`` addresses the rank-0 TCPStore (None → host one in-process
    as master). Each node heartbeats ``node/<id>``; :meth:`watch` reports
    membership health; :meth:`run` relaunches a training callable on failure
    up to ``max_restarts`` times, passing the restart ordinal so the callable
    can resume from its latest checkpoint.
    """

    def __init__(self, host_port: Optional[str] = None, *,
                 np: Optional[int] = None, is_master: bool = False,
                 elastic_level: ElasticLevel = ElasticLevel.FAULT_TOLERANCE,
                 heartbeat_interval: float = 2.0,
                 heartbeat_timeout: float = 30.0, max_restarts: int = 3,
                 node_id: Optional[str] = None,
                 reconnect_backoff_base: float = 0.5,
                 reconnect_backoff_cap: float = 30.0,
                 max_reconnect_attempts: int = 8):
        import torch.distributed as dist
        self.np = np or int(os.environ.get("PADDLE_TRAINERS_NUM", "1"))
        self.elastic_level = elastic_level
        self.heartbeat_interval = heartbeat_interval
        self.heartbeat_timeout = heartbeat_timeout
        self.max_restarts = max_restarts
        self.node_id = node_id or os.environ.get(
            "PADDLE_TRAINER_ID", f"node-{os.getpid()}")
        if host_port is None:
            self.store = dist.TCPStore("127.0.0.1", 0, is_master=True,
                                       wait_for_workers=False)
            self.host, self.port = "127.0.0.1", self.store.port
        else:
            host, port = host_port.rsplit(":", 1)
            self.store = dist.TCPStore(host, int(port),
                                       is_master=is_master,
                                       wait_for_workers=False,
                                       timeout=datetime.timedelta(
                                           seconds=heartbeat_timeout))
            self.host, self.port = host, int(port)
        self.reconnect_backoff_base = reconnect_backoff_base
        self.reconnect_backoff_cap = reconnect_backoff_cap
        self.max_reconnect_attempts = max_reconnect_attempts
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self.restarts = 0
        self.preemptions = 0
        self.reconnects = 0

    # -- membership --------------------------------------------------------

    def register(self) -> None:
        """Announce membership and start heartbeating (reference register +
        etcd lease refresh). Node ids are also indexed through a shared
        counter because the store (like the reference's) has no prefix scan."""
        self._register_keys()
        self._hb_thread = threading.Thread(target=self._hb_loop, daemon=True)
        self._hb_thread.start()

    def _register_keys(self) -> None:
        slot = self.store.add("node_count", 1) - 1
        self.store.set(f"node_ids/{slot}", self.node_id)
        self._beat()

    def _try_get(self, key: str):
        """The value of ``key``, or None when it is not set."""
        if not self.store.check([key]):
            return None
        return self.store.get(key)

    def _beat(self) -> None:
        self.store.set(f"node/{self.node_id}",
                       json.dumps({"ts": time.time(), "pid": os.getpid()}))

    def _hb_loop(self) -> None:
        while not self._stop.wait(self.heartbeat_interval):
            try:
                self._beat()
            except Exception:
                if not self._reregister():
                    return

    def _reregister(self) -> bool:
        """Heartbeat hit a dead/restarting coordinator: retry registration
        with jittered exponential backoff. All workers land in this path at
        once when the master restarts; without jitter they would retry in
        lockstep and stampede the fresh store."""
        for delay in backoff_delays(self.reconnect_backoff_base,
                                    self.reconnect_backoff_cap,
                                    self.max_reconnect_attempts):
            if self._stop.wait(delay):
                return False
            try:
                self._register_keys()
                self.reconnects += 1
                return True
            except Exception:
                continue
        return False

    def alive_nodes(self) -> list[str]:
        """Nodes whose latest heartbeat is inside the timeout window."""
        alive = []
        # scan every ALLOCATED slot (add(k, 0) reads the counter), skipping
        # holes: a registration that died between the slot add and the id
        # set must not truncate the scan and hide later registrants
        total = self.store.add("node_count", 0)
        for slot in range(total):
            raw = self._try_get(f"node_ids/{slot}")
            if raw is None:
                continue
            node_id = raw.decode()
            # re-registration after a coordinator restart can index the same
            # node under a second slot — count each node once
            if node_id not in alive:
                hb = self._try_get(f"node/{node_id}")
                if hb is not None:
                    data = json.loads(hb)
                    if time.time() - data["ts"] <= self.heartbeat_timeout:
                        alive.append(node_id)
        return alive

    def watch(self) -> str:
        """One health poll (reference ElasticManager.watch loop body)."""
        alive = self.alive_nodes()
        if len(alive) >= self.np:
            return (ElasticStatus.COMPLETED if self._stop.is_set()
                    else ElasticStatus.HOLD)
        if not alive:
            return ElasticStatus.ERROR
        if self.elastic_level == ElasticLevel.ELASTIC:
            return ElasticStatus.RESTART
        return ElasticStatus.RESTART

    def world_size(self) -> int:
        """Live membership count (heartbeats inside the timeout window)."""
        return len(self.alive_nodes())

    def membership_probe(self, expected: int) -> Callable[..., None]:
        """An ``on_metrics``-shaped callback that raises
        :class:`WorldSizeChanged` when the heartbeat registry disagrees
        with ``expected`` — the detection half of the reference's
        ``_update_hosts`` watch loop, wired into the step loop the
        trainer already runs."""
        expected = int(expected)

        def probe(*_args, **_kw):
            ws = self.world_size()
            if ws != expected:
                raise WorldSizeChanged(expected, ws)
        return probe

    # -- restart policy ----------------------------------------------------

    def run(self, train_fn: Callable[[int], None],
            max_preemptions: int = 100) -> bool:
        """Run with restart-on-failure (the relaunch half of manager.py; the
        reference shells out to launch — here train_fn encapsulates it,
        e.g. through ``distributed.launch.launch``).
        train_fn receives the restart ordinal (0 = first run) and should
        resume from its latest checkpoint when > 0.

        A :class:`~paddle_tpu_torch.resilience.TrainingPreempted` exit (or a
        SystemExit carrying RESUMABLE_EXIT_CODE) is an ORDERLY preemption:
        state was checkpointed, so the relaunch resumes without consuming
        the failure-restart budget (bounded separately by
        ``max_preemptions`` so a flapping host still terminates)."""
        from ..resilience.preemption import RESUMABLE_EXIT_CODE
        while True:
            try:
                train_fn(self.restarts + self.preemptions)
                return True
            except SystemExit as e:
                if e.code != RESUMABLE_EXIT_CODE:
                    raise
                if self.preemptions >= max_preemptions:
                    print(f"[elastic] giving up after {self.preemptions} "
                          f"preemptions")
                    return False
                self.preemptions += 1
                print(f"[elastic] preempted (checkpointed); resume "
                      f"{self.preemptions}/{max_preemptions}")
            except Exception as e:  # noqa: BLE001 — any training failure
                if self.restarts >= self.max_restarts:
                    print(f"[elastic] giving up after {self.restarts} "
                          f"restarts: {e}")
                    return False
                self.restarts += 1
                print(f"[elastic] training failed ({e}); restart "
                      f"{self.restarts}/{self.max_restarts}")

    def run_elastic(self, train_fn: Callable[[int, int], None], *,
                    world_size_fn: Optional[Callable[[], int]] = None,
                    max_membership_changes: int = 32,
                    max_preemptions: int = 100,
                    sleep: Callable[[float], None] = time.sleep) -> bool:
        """:meth:`run` upgraded to the ELASTIC level: survive a CHANGED
        world size, not just restarts of the same one.

        ``train_fn(attempt, world_size)`` trains on ``world_size``
        workers and is expected to (a) resume from its latest checkpoint
        when ``attempt > 0`` and (b) raise :class:`WorldSizeChanged`
        when its membership probe sees the registry disagree. On a
        membership change the manager backs off with full jitter (the
        survivors must not stampede re-registration), re-reads the world
        size, and re-enters — burning ``max_membership_changes``, NOT
        the failure-restart budget. Orderly preemptions keep their own
        budget as in :meth:`run`. ``world_size_fn`` defaults to the
        heartbeat registry; tests inject a schedule."""
        from ..resilience.preemption import RESUMABLE_EXIT_CODE
        ws_fn = world_size_fn or self.world_size
        changes = 0
        last_ws: Optional[int] = None
        backoff = backoff_delays(self.reconnect_backoff_base,
                                 self.reconnect_backoff_cap,
                                 max(1, max_membership_changes))
        while True:
            ws = int(ws_fn())
            if last_ws is not None and ws != last_ws:
                changes += 1
                _elastic_counter("pt_elastic_membership_changes_total",
                                 "world-size changes survived",
                                 direction=("in" if ws < last_ws
                                            else "out"))
                _elastic_gauge("pt_elastic_world_size", ws)
                if changes > max_membership_changes:
                    print(f"[elastic] giving up after {changes - 1} "
                          f"membership changes")
                    return False
                sleep(next(backoff))
                ws = int(ws_fn())    # may have changed again during backoff
            elif last_ws is None:
                _elastic_gauge("pt_elastic_world_size", ws)
            last_ws = ws
            attempt = self.restarts + self.preemptions + changes
            try:
                train_fn(attempt, ws)
                return True
            except WorldSizeChanged as e:
                last_ws = e.old_size    # next loop top counts the change
                print(f"[elastic] membership change detected "
                      f"({e.old_size} -> {e.new_size}); re-planning "
                      f"({changes + 1}/{max_membership_changes})")
            except SystemExit as e:
                if e.code != RESUMABLE_EXIT_CODE:
                    raise
                if self.preemptions >= max_preemptions:
                    print(f"[elastic] giving up after {self.preemptions} "
                          f"preemptions")
                    return False
                self.preemptions += 1
                _elastic_counter("pt_elastic_resumes_total",
                                 "orderly preemption resumes")
                print(f"[elastic] preempted (checkpointed); resume "
                      f"{self.preemptions}/{max_preemptions}")
            except Exception as e:  # noqa: BLE001 — any training failure
                if self.restarts >= self.max_restarts:
                    print(f"[elastic] giving up after {self.restarts} "
                          f"restarts: {e}")
                    return False
                self.restarts += 1
                print(f"[elastic] training failed ({e}); restart "
                      f"{self.restarts}/{self.max_restarts}")

    def exit(self) -> None:
        self._stop.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5)
        self.store = None


def raise_for_pod_exit(code: int, world_size: int,
                       new_size: Optional[int] = None) -> None:
    """Map a launched pod's exit code back to the launching process's
    exceptions: 0 returns, :data:`WORLD_SIZE_CHANGED_EXIT` raises
    :class:`WorldSizeChanged` (``world_size`` -> ``new_size``), the
    resumable preemption exit raises ``SystemExit`` with it (which
    :meth:`ElasticManager.run_elastic` resumes), anything else
    RuntimeError (a failure that spends the restart budget)."""
    from ..resilience.preemption import RESUMABLE_EXIT_CODE
    if code == 0:
        return
    if code == WORLD_SIZE_CHANGED_EXIT:
        raise WorldSizeChanged(world_size, new_size if new_size is not None
                               else world_size)
    if code == RESUMABLE_EXIT_CODE:
        raise SystemExit(code)
    raise RuntimeError(f"pod of {world_size} ranks exited {code}")


# -- metrics (registry; no-ops when observability is disabled) ---------------

def _elastic_counter(name: str, desc: str, **labels) -> None:
    from ..observability.metrics import REGISTRY
    if REGISTRY.enabled:
        REGISTRY.counter(name, desc).inc(**labels)


def _elastic_gauge(name: str, value: float) -> None:
    from ..observability.metrics import REGISTRY
    if REGISTRY.enabled:
        REGISTRY.gauge(name, "live world size seen by the elastic "
                             "manager").set(float(value))


# -- the replan half of a membership change ----------------------------------

def replan_and_apply(trainer, model_cfg, *, devices=None, global_batch=8,
                     seq_len=32, configs=None, drift="ignore", **plan_kw):
    """Membership changed: ask the auto-parallel planner for the best
    legal config on the new world (the live ``torch.distributed`` world
    of this relaunched pod; HBM-prune included) and re-place the
    trainer's params/optimizer state through ``Trainer.apply_plan``.
    Collective: rank 0 plans and broadcasts its choice. Returns ``(plan,
    mesh)`` — the caller enters the mesh and re-enters
    ``fit(resume='auto')``; the checkpoint manager reshards the restore
    against the recorded source plan. Raises ``InfeasibleMeshError``
    when no legal config exists on the survivors (e.g. fewer devices
    than any tp that divides the heads). ``devices`` is the mesh's
    device type ("cuda" or "cpu")."""
    import time as _time
    import torch.distributed as dist
    from .auto_parallel import plan as _plan
    from .auto_parallel.emit import ShardingPlan
    t0 = _time.perf_counter()
    world = dist.get_world_size() if dist.is_initialized() else 1
    chosen = None
    if not dist.is_initialized() or dist.get_rank() == 0:
        report = _plan(model_cfg, n_devices=world,
                       global_batch=global_batch, seq_len=seq_len,
                       configs=configs, drift=drift, **plan_kw)
        chosen = report.chosen.plan.as_dict()
    if world > 1:
        box = [chosen]
        dist.broadcast_object_list(box, src=0)
        chosen = box[0]
    chosen = ShardingPlan.from_dict(chosen)
    hm = trainer.apply_plan(chosen, devices=devices)
    _elastic_counter("pt_elastic_replans_total",
                     "planner-picked re-configurations",
                     config=chosen.config_str)
    from ..observability.metrics import REGISTRY
    if REGISTRY.enabled:
        REGISTRY.histogram("pt_elastic_replan_seconds",
                           "plan + re-place duration on membership change",
                           "s").observe(_time.perf_counter() - t0)
    return chosen, hm


__all__ = ["WORLD_SIZE_CHANGED_EXIT", "backoff_delays", "WorldSizeChanged",
           "ElasticLevel", "ElasticStatus", "ElasticManager",
           "raise_for_pod_exit", "replan_and_apply"]
