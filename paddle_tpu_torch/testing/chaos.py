"""Fault-injection helpers (counterpart of ``paddle_tpu/testing/chaos.py``):

* :func:`kill_mid_save` — a checkpoint write that "dies" after the data is
  durable but BEFORE the commit marker (the classic torn save);
* :func:`corrupt_checkpoint` — bit-flip / truncate / unlink files inside a
  committed step dir (bit-rot, partial GC, fat-fingered operator);
* :func:`nan_batch` / :func:`nan_injector` — poison-batch streams for
  AnomalyGuard tests;
* :func:`kill_at_step` — an ``on_metrics`` callback that SIGTERMs the
  current process at a chosen step (preemption mid-fit);
* :func:`spawn_trainer` — run ``paddle_tpu_torch.testing._chaos_train`` in
  a subprocess for the real kill -9 / exit-status tests;
* :func:`kill_replica` / :func:`hang_replica` / :func:`unhang_replica` —
  serving-fabric faults through a transport's hooks.

``spawn_elastic`` (a resume on fewer devices) comes with the elastic and
resharding slice (ROADMAP.md, A.5).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
from typing import Iterable, Iterator, Optional, Sequence

import numpy as np

__all__ = ["kill_mid_save", "corrupt_checkpoint", "nan_batch",
           "nan_injector", "kill_at_step", "spawn_trainer", "kill_replica",
           "hang_replica", "unhang_replica"]


def kill_mid_save(manager, step: int, tree) -> str:
    """Write checkpoint ``step`` but simulate process death BEFORE the
    commit marker: the payload is fully durable, the ``.PENDING`` sidecar
    remains, no ``_COMMITTED`` exists. Returns the step dir.

    This is exactly the state a SIGKILL between the async write's
    completion and ``finalize()`` leaves behind; a correct resume must skip
    it (checkpoint.latest_step) or quarantine it (CheckpointManager)."""
    from .. import checkpoint as ckpt
    manager.save(step, tree, async_save=True)
    ckpt.wait_until_finished()      # data durable...
    manager._pending = None         # ...but the committer "died" here
    return manager.step_dir(step)


def corrupt_checkpoint(step_dir: str, mode: str = "flip",
                       skip: Sequence[str] = ("_COMMITTED",)) -> str:
    """Damage a checkpoint dir in place; returns the path of the file hit.

    mode="flip" inverts a byte in the LARGEST payload file (silent bit-rot:
    sizes still match, only the checksum catches it); "truncate" halves a
    file; "delete" unlinks it; "manifest" overwrites _MANIFEST.json with
    junk."""
    if mode == "manifest":
        target = os.path.join(step_dir, "_MANIFEST.json")
        with open(target, "w") as f:
            f.write("{corrupt")
        return target
    files = []
    for dirpath, _dirs, names in os.walk(step_dir):
        for name in names:
            if name in skip or name == "_MANIFEST.json":
                continue
            full = os.path.join(dirpath, name)
            files.append((os.path.getsize(full), full))
    if not files:
        raise FileNotFoundError(f"no payload files under {step_dir}")
    _, target = max(files)
    if mode == "flip":
        with open(target, "r+b") as f:
            f.seek(os.path.getsize(target) // 2)
            b = f.read(1)
            f.seek(-1, os.SEEK_CUR)
            f.write(bytes([b[0] ^ 0xFF]))
    elif mode == "truncate":
        with open(target, "r+b") as f:
            f.truncate(max(1, os.path.getsize(target) // 2))
    elif mode == "delete":
        os.remove(target)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return target


def nan_batch(batch: dict, fields: Optional[Iterable[str]] = None) -> dict:
    """Copy of ``batch`` with float arrays or tensors replaced by NaN
    (poison batch). Integer ones (token ids) are left alone unless named in
    ``fields`` — those are replaced by out-of-range -1 ids instead. Values
    keep their type (numpy array or torch tensor, on its device)."""
    import torch
    fields = set(fields) if fields is not None else None
    out = {}
    for k, v in batch.items():
        named = fields is None or k in fields
        if isinstance(v, torch.Tensor):
            if fields is not None and k in fields and not (
                    v.is_floating_point() or v.is_complex()):
                out[k] = torch.full_like(v, -1)
            elif v.is_floating_point() and named:
                out[k] = torch.full_like(v, float("nan"))
            else:
                out[k] = v
            continue
        arr = np.asarray(v)
        if fields is not None and k in fields and arr.dtype.kind in "iu":
            out[k] = np.full_like(arr, -1)
        elif np.issubdtype(arr.dtype, np.floating) and named:
            out[k] = np.full_like(arr, np.nan)
        else:
            out[k] = v
    return out


def nan_injector(batches: Iterable[dict], at: int,
                 fields: Optional[Iterable[str]] = None) -> Iterator[dict]:
    """Yield from ``batches``, poisoning the ``at``-th one (0-based)."""
    for i, b in enumerate(batches):
        yield nan_batch(b, fields) if i == at else b


def kill_at_step(step: int, sig: int = signal.SIGTERM):
    """``on_metrics`` callback delivering ``sig`` to THIS process when the
    given step is reached (use log_every=1 for per-step resolution). With a
    PreemptionGuard installed the signal latches instead of killing."""
    def cb(metrics):
        if metrics.step >= step:
            os.kill(os.getpid(), sig)
    return cb


def spawn_trainer(ckpt_dir: str, *, steps: int, extra_args: Sequence[str] = (),
                  env: Optional[dict] = None) -> subprocess.Popen:
    """Launch the chaos training script (a seeded Llama over a seeded token
    stream) as a subprocess: ``python -m
    paddle_tpu_torch.testing._chaos_train``. It trains on the card unless
    ``extra_args`` holds ``--device cpu``. The caller kills/waits on the
    returned Popen (stdout and stderr merged)."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    cmd = [sys.executable, "-m", "paddle_tpu_torch.testing._chaos_train",
           "--ckpt-dir", ckpt_dir, "--steps", str(steps), *extra_args]
    full_env = dict(os.environ)
    full_env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in full_env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    if env:
        full_env.update(env)
    return subprocess.Popen(cmd, env=full_env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT)


def kill_replica(transport, name: str) -> None:
    """Drop a serving-fabric replica mid-whatever-it-was-doing — the
    serving analogue of kill -9. Requires a transport with a ``kill``
    hook (the in-process transport: every later router op raises
    ``ReplicaDown``, exactly what a SIGKILLed remote looks like through
    the TCP transport); for transports without one (TCP), SIGKILL the
    replica's server process directly — the raised TypeError says so.
    The router's failover re-admission (replay-exact continuation on a
    survivor) is what the chaos tests then assert."""
    k = getattr(transport, "kill", None)
    if k is not None:
        k(name)
        return
    raise TypeError(f"transport {type(transport).__name__} has no kill "
                    f"hook; SIGKILL the replica's server process "
                    f"directly (TcpReplicaServer.stop / os.kill)")


def hang_replica(transport, name: str) -> None:
    """Wedge a serving-fabric replica: it still answers ``status``
    (heartbeats look healthy) but every op that would make PROGRESS —
    poll, submit, extract, adopt — blocks forever. This is crash's
    evil twin (GC pause, wedged accelerator, half-open partition) and
    the failure mode the circuit breaker's op-class timeouts exist
    for: without a breaker the router stalls on the hung poll; with
    one the op times out, trips ReplicaDown, and the router's
    replay-exact failover takes over. Requires a transport with a ``hang`` hook
    (the in-process transport); for TCP, SIGSTOP the replica's server
    process instead — the raised TypeError says so. Undo with
    :func:`unhang_replica`."""
    h = getattr(transport, "hang", None)
    if h is not None:
        h(name)
        return
    raise TypeError(f"transport {type(transport).__name__} has no hang "
                    f"hook; SIGSTOP the replica's server process "
                    f"directly (os.kill(pid, signal.SIGSTOP))")


def unhang_replica(transport, name: str) -> None:
    """Release :func:`hang_replica`: blocked ops wake and report
    ReplicaDown (their answers are lost — that RPC already failed);
    fresh ops succeed, so a breaker's half-open probe readmits."""
    u = getattr(transport, "unhang", None)
    if u is not None:
        u(name)
        return
    raise TypeError(f"transport {type(transport).__name__} has no "
                    f"unhang hook; SIGCONT the server process instead")
