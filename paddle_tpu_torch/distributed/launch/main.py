"""Launcher core (counterpart of ``paddle_tpu/distributed/launch/main.py``;
reference: launch/main.py + controllers/collective.py).

The job model is the reference's: a **Pod** is this host's set of worker
**Containers**; the controller starts them with each rank's environment,
streams their output to log files, watches their exit codes and tears
the pod down at the first failure, or relaunches it under
``max_restarts``. A resumable exit (75, a worker that checkpointed on
preemption) is relaunched under a budget of its own.

Each rank's environment carries both sources that
``parallel.mesh.pod_bootstrap_env`` reads: torchrun's ``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``, and
Paddle's ``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``,
``PADDLE_CURRENT_ENDPOINT``, ``PADDLE_TRAINER_ENDPOINTS``,
``PADDLE_LOCAL_RANK`` and ``PADDLE_JOB_ID``, with ``FLAGS_selected_gpus``
naming the card the rank takes (0 when ``--devices`` leaves it one).
Rank 0's ``init_process_group`` serves the ranks' store on
``MASTER_PORT``. In a multi-node job the launcher's own membership
store (:class:`~.master.Master`) lives on the ``--master`` endpoint, and
``MASTER_PORT`` is another port, node 0's, as in JAX: the two stores
never share a port.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from ...resilience.preemption import RESUMABLE_EXIT_CODE  # 75


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("", 0))
        return s.getsockname()[1]


@dataclasses.dataclass
class LaunchConfig:
    """The launcher's command line (the reference's arguments that
    matter here)."""
    nproc_per_node: int = 1
    nnodes: int = 1
    node_rank: int = 0
    master: Optional[str] = None          # "host:port"
    log_dir: str = "log"
    job_id: str = "default"
    devices: Optional[str] = None          # visible-device list per rank
    max_restarts: int = 0                  # >0 enables elastic relaunch
    max_preempt_relaunches: int = 100      # resumable exits don't burn budget
    run_mode: str = "collective"


@dataclasses.dataclass
class Container:
    """One worker process (reference: launch/job/container.py)."""
    rank: int
    local_rank: int
    env: Dict[str, str]
    cmd: List[str]
    log_path: str
    proc: Optional[subprocess.Popen] = None

    def start(self):
        os.makedirs(os.path.dirname(self.log_path) or ".", exist_ok=True)
        env = dict(os.environ)
        env.update(self.env)
        with open(self.log_path, "ab") as logf:
            self.proc = subprocess.Popen(self.cmd, env=env, stdout=logf,
                                         stderr=subprocess.STDOUT)

    def alive(self) -> bool:
        return self.proc is not None and self.proc.poll() is None

    @property
    def exit_code(self) -> Optional[int]:
        return None if self.proc is None else self.proc.poll()

    def terminate(self, grace: float = 10.0):
        if self.proc is None or self.proc.poll() is not None:
            return
        self.proc.send_signal(signal.SIGTERM)
        try:
            self.proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def _pod_exit_code(bad: List["Container"]) -> int:
    """The exit code of a failed pod: resumable (75) only when EVERY
    failed container exited 75, so that one real crash inside a
    preempted pod spends the failure budget."""
    codes = [c.exit_code or 1 for c in bad]
    if all(c == RESUMABLE_EXIT_CODE for c in codes):
        return RESUMABLE_EXIT_CODE
    return next(c for c in codes if c != RESUMABLE_EXIT_CODE)


@dataclasses.dataclass
class Pod:
    """This node's containers (reference: launch/job/pod.py)."""
    containers: List[Container] = dataclasses.field(default_factory=list)

    def start(self):
        for c in self.containers:
            c.start()

    def alive(self) -> bool:
        return any(c.alive() for c in self.containers)

    def failed(self) -> List[Container]:
        return [c for c in self.containers
                if c.exit_code not in (None, 0)]

    def join(self, poll: float = 0.2) -> int:
        """Watch until all exit or one fails (the first non-zero exit
        tears the pod down). Returns the pod's exit code."""
        while True:
            bad = self.failed()
            if bad:
                self.terminate()
                return _pod_exit_code(bad)
            if not self.alive():
                return 0
            time.sleep(poll)

    def terminate(self):
        for c in self.containers:
            c.terminate()


def _make_pod(cfg: LaunchConfig, training_script: str,
              script_args: Sequence[str], node_rank: int,
              endpoints: List[str], coord: str) -> Pod:
    """The one per-rank container builder of the single-node and
    multi-node tiers (only the endpoints and the rendezvous differ)."""
    world = cfg.nnodes * cfg.nproc_per_node
    coord_host, coord_port = coord.rsplit(":", 1)
    devs = cfg.devices.split(",") if cfg.devices is not None else None
    pod = Pod()
    for local_rank in range(cfg.nproc_per_node):
        rank = node_rank * cfg.nproc_per_node + local_rank
        env = {
            "PADDLE_TRAINER_ID": str(rank),
            "PADDLE_TRAINERS_NUM": str(world),
            "PADDLE_CURRENT_ENDPOINT": endpoints[rank],
            "PADDLE_TRAINER_ENDPOINTS": ",".join(endpoints),
            "PADDLE_LOCAL_RANK": str(local_rank),
            "PADDLE_JOB_ID": cfg.job_id,
            "MASTER_ADDR": coord_host,
            "MASTER_PORT": coord_port,
            "WORLD_SIZE": str(world),
            "RANK": str(rank),
            "LOCAL_RANK": str(local_rank),
            "LOCAL_WORLD_SIZE": str(cfg.nproc_per_node),
            # the card this rank takes: with --devices each rank sees one
            "FLAGS_selected_gpus": "0" if devs else str(local_rank),
        }
        if devs:
            env["CUDA_VISIBLE_DEVICES"] = devs[local_rank % len(devs)]
        pod.containers.append(Container(
            rank=rank, local_rank=local_rank, env=env,
            cmd=[sys.executable, "-u", training_script, *script_args],
            log_path=os.path.join(cfg.log_dir, f"workerlog.{rank}")))
    return pod


def build_pod(cfg: LaunchConfig, training_script: str,
              script_args: Sequence[str]) -> Pod:
    """The per-rank containers with the collective environment
    (reference controllers/collective.py:build_pod)."""
    if cfg.master is None:
        master_host, master_port = "127.0.0.1", _free_port()
    else:
        master_host, master_port = cfg.master.rsplit(":", 1)
        master_port = int(master_port)
    # endpoints across the whole job, node-major
    base_port = _free_port()
    endpoints = []
    for _ in range(cfg.nnodes):
        host = master_host if cfg.nnodes > 1 else "127.0.0.1"
        for lr in range(cfg.nproc_per_node):
            endpoints.append(f"{host}:{base_port + lr}")
    return _make_pod(cfg, training_script, script_args, cfg.node_rank,
                     endpoints, f"{master_host}:{master_port}")


def _build_pod_multinode(cfg: LaunchConfig, training_script: str,
                         script_args: Sequence[str], node_rank: int,
                         peers: List[str]) -> Pod:
    """Per-rank containers from the synced peer list (each record is
    "host:base_port:coord_port"); the ranks' rendezvous is node 0's
    host:coord_port."""
    parsed = [p.rsplit(":", 2) for p in peers]
    endpoints = [f"{h}:{int(base) + lr}"
                 for h, base, _ in parsed
                 for lr in range(cfg.nproc_per_node)]
    return _make_pod(cfg, training_script, script_args, node_rank,
                     endpoints, f"{parsed[0][0]}:{parsed[0][2]}")


def launch(cfg: LaunchConfig, training_script: str,
           script_args: Sequence[str] = ()) -> int:
    """Run the job to completion; with ``cfg.max_restarts`` > 0 a failed
    pod is relaunched (reference fleet/elastic/manager.py:43
    ElasticLevel.FAULT_TOLERANCE), and a resumable exit (75) is
    relaunched without spending that budget, up to
    ``max_preempt_relaunches``.

    ``nnodes`` > 1 with ``master`` set takes the multi-node tier: pods
    meet through the membership service (:mod:`.master`), node ranks go
    by registration order, heartbeats and restart epochs coordinate the
    recovery across hosts."""
    if cfg.nnodes > 1 and cfg.master:
        return _launch_multinode(cfg, training_script, script_args)
    attempt = preempts = 0
    while True:
        pod = build_pod(cfg, training_script, script_args)
        pod.start()
        code = pod.join()
        if code == 0:
            return 0
        if code == RESUMABLE_EXIT_CODE:
            # orderly preemption: the worker checkpointed and asked to be
            # resumed; relaunch without spending the failure budget
            if preempts >= cfg.max_preempt_relaunches:
                return code
            preempts += 1
            print(f"[launch] pod preempted (resumable); relaunch "
                  f"{preempts}/{cfg.max_preempt_relaunches}", file=sys.stderr)
            continue
        if attempt >= cfg.max_restarts:
            return code
        attempt += 1
        print(f"[launch] pod failed (exit {code}); restart "
              f"{attempt}/{cfg.max_restarts}", file=sys.stderr)


def _local_host(master_host: str) -> str:
    """This machine's address as seen on the route to the master (the
    UDP connect reads the outbound interface and sends nothing)."""
    try:
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.connect((master_host, 9))
            return s.getsockname()[0]
    except OSError:
        return "127.0.0.1"


def _host_is_local(host: str) -> bool:
    """Does ``host`` name this machine? Decided by a bind probe: only the
    owning host can bind its own address. Only the master host may try
    to serve the store."""
    if host in ("localhost", "0.0.0.0"):
        return True
    try:
        target = socket.gethostbyname(host)
    except OSError:
        return False
    if target.startswith("127."):
        return True
    try:
        with socket.socket() as s:
            s.bind((target, 0))
        return True
    except OSError:
        return False


def _launch_multinode(cfg: LaunchConfig, training_script: str,
                      script_args: Sequence[str]) -> int:
    """The multi-node controller, one a host. The one whose bind of the
    master port succeeds serves the membership store. A local failure
    bumps the restart epoch; every controller watching the epoch tears
    its pod down and registers again; the heartbeat TTL catches hosts
    that die without reporting."""
    from .master import Master

    host, port = cfg.master.rsplit(":", 1)
    master = None
    if _host_is_local(host):
        # two controllers on one machine race the bind: the loser is a
        # client
        try:
            master = Master(host, int(port), cfg.job_id, is_server=True)
        except RuntimeError:
            master = None
    if master is None:
        master = Master(host, int(port), cfg.job_id, is_server=False)

    attempt = preempts = 0
    code = 0
    # the preempt counter first, the epoch second: the mirror of
    # bump_epoch's order
    seen_pre = master.preempt_epochs()
    epoch = master.restart_epoch()
    while True:
        base_port, coord_port = _free_port(), _free_port()
        rec = f"{_local_host(host)}:{base_port}:{coord_port}"
        try:
            peers, node_rank = master.sync_peers(rec, cfg.nnodes, epoch,
                                                 timeout=60.0)
        except TimeoutError:
            # the peers moved to a newer epoch between our read and the
            # sync: read again and register again
            seen_pre = master.preempt_epochs()
            new_epoch = master.restart_epoch()
            if new_epoch == epoch:
                raise
            epoch = new_epoch
            continue
        others = [f"e{epoch}-n{i}" for i in range(cfg.nnodes)
                  if i != node_rank]
        pod = _build_pod_multinode(cfg, training_script, script_args,
                                   node_rank, peers)
        master.start_heartbeat(f"e{epoch}-n{node_rank}")
        pod.start()
        print(f"[launch] epoch {epoch}: node {node_rank}/{cfg.nnodes} "
              f"up ({cfg.nproc_per_node} workers)", file=sys.stderr)

        failed = False
        while True:
            bad = pod.failed()
            if bad:
                code = _pod_exit_code(bad)
                print(f"[launch] epoch {epoch}: local worker failed "
                      f"(exit {code}); signaling restart", file=sys.stderr)
                master.bump_epoch("preempt" if code == RESUMABLE_EXIT_CODE
                                  else "failure")
                pod.terminate()
                failed = True
                break
            if master.restart_epoch() != epoch:
                print(f"[launch] epoch {epoch}: peer signaled restart",
                      file=sys.stderr)
                pod.terminate()
                code = 0
                failed = True
                break
            dead = master.dead_pods(others, ttl=15.0)
            if dead:
                print(f"[launch] epoch {epoch}: peer heartbeat lost "
                      f"({dead}); signaling restart", file=sys.stderr)
                master.bump_epoch()
                pod.terminate()
                code = 1
                failed = True
                break
            if not pod.alive():
                break                        # all local workers exited 0
            time.sleep(0.5)

        if not failed:
            # heartbeats keep running through the completion barrier: a
            # pod whose workers finish early must not look dead to peers
            # still training
            if master.done_barrier(cfg.nnodes, epoch):
                master.stop_heartbeat()
                return 0
            failed = True
            code = 0
        master.stop_heartbeat()

        new_pre = master.preempt_epochs()
        new_epoch = master.restart_epoch()
        # every bump in the window preemption-reasoned: resumable; any
        # failure in the mix spends the budget
        resumable = (code == RESUMABLE_EXIT_CODE
                     or (code == 0 and new_epoch > epoch
                         and new_pre - seen_pre >= new_epoch - epoch))
        seen_pre = new_pre
        if resumable:
            preempts += 1
            if preempts > cfg.max_preempt_relaunches:
                print(f"[launch] preemption budget exhausted "
                      f"({cfg.max_preempt_relaunches})", file=sys.stderr)
                return code or RESUMABLE_EXIT_CODE
            print(f"[launch] node preempted (resumable); relaunch "
                  f"{preempts}/{cfg.max_preempt_relaunches}", file=sys.stderr)
        else:
            attempt += 1
            if attempt > cfg.max_restarts:
                print(f"[launch] restart budget exhausted "
                      f"({cfg.max_restarts})", file=sys.stderr)
                return code or 1
        epoch = new_epoch


def _parse_args(argv: Sequence[str]):
    import argparse
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="multi-process launcher (reference: "
                    "python -m paddle.distributed.launch)")
    p.add_argument("--nproc_per_node", type=int, default=1)
    p.add_argument("--nnodes", type=int, default=1)
    p.add_argument("--node_rank", type=int, default=0)
    p.add_argument("--master", type=str, default=None)
    p.add_argument("--log_dir", type=str, default="log")
    p.add_argument("--job_id", type=str, default="default")
    p.add_argument("--devices", type=str, default=None)
    p.add_argument("--max_restarts", type=int, default=0)
    p.add_argument("training_script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ns = _parse_args(argv if argv is not None else sys.argv[1:])
    cfg = LaunchConfig(
        nproc_per_node=ns.nproc_per_node, nnodes=ns.nnodes,
        node_rank=ns.node_rank, master=ns.master, log_dir=ns.log_dir,
        job_id=ns.job_id, devices=ns.devices, max_restarts=ns.max_restarts)
    return launch(cfg, ns.training_script, ns.script_args)
