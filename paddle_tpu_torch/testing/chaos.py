"""Fault injection for the serving fabric (the fabric half of
``paddle_tpu/testing/chaos.py``): kill, hang and release a replica
through its transport's hooks. The checkpoint and trainer helpers of the
JAX module wait for the port's trainer runtime (ROADMAP.md, A.1)."""

from __future__ import annotations

__all__ = ["kill_replica", "hang_replica", "unhang_replica"]


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
