"""paddle_tpu_torch.serving_fabric — a router and replica pool over N
ContinuousBatchingEngines, with prefill/decode disaggregation
(counterpart of ``paddle_tpu/serving_fabric``).

* :class:`ServingFabric` — the global queue, PREFIX-AFFINITY routing on
  replica-advertised digests (least-loaded fallback, ITL hysteresis),
  per-tenant weighted fair admission, prefill/decode disaggregation via
  KV-page handoff, and failover re-admission with replay-exact streams.
* :class:`Replica` / :func:`build_replicas` — one engine behind the
  fabric verb set (submit/poll/status/extract/adopt); the replicas of
  one process share the model and own separate page pools.
* :class:`InProcTransport` / :class:`TcpTransport` — the same verbs
  in-process or as JSON lines over TCP (:class:`TcpReplicaServer`).
* :class:`PrefixDigest` — rolling page fingerprints of a replica's
  radix-tree top, the routing signal.
* :class:`TenantFairPolicy` / :class:`TenantSpec` — router-level
  weighted fairness and token-bucket quotas priced in uncached-suffix
  tokens.
* :class:`LoadShedder`, :class:`Backoff` and the typed rejections.
* :class:`FrontDoor` / :class:`FabricClient` — the concurrent streaming
  TCP edge over a fabric (newline-JSON, per-connection ``seq``, per-id
  dedupe with replay resume, slow-client eviction, typed refusals) and
  the retrying, hedging client of it.
* :class:`BreakerTransport` — a per-replica circuit breaker (op-class
  timeouts, open → half-open probe → closed) around any transport.

The names load on first use: a client process imports
``serving_fabric.client`` alone and never imports ``torch``.

Quickstart (``device="cpu"`` models in tests; the card by default)::

    from paddle_tpu_torch.serving_fabric import (ServingFabric,
                                                 InProcTransport,
                                                 build_replicas)

    reps = build_replicas(model, 2, roles=["prefill", "both"],
                          page_size=128, max_len=2048)
    fabric = ServingFabric(InProcTransport(reps), policy="affinity",
                           disagg_threshold_tokens=512)
    fid = fabric.submit(prompt_ids, max_new_tokens=64, tenant="a")
    out = fabric.run()          # {fid: np.ndarray tokens}
"""

from __future__ import annotations

import importlib

# public name -> submodule that defines it
_WHERE = {
    "ServingFabric": "router", "FabricRequest": "router",
    "Replica": "replica", "build_replicas": "replica",
    "FabricTransport": "transport", "InProcTransport": "transport",
    "TcpTransport": "transport", "TcpReplicaServer": "transport",
    "ReplicaDown": "transport", "payload_to_wire": "transport",
    "payload_from_wire": "transport",
    "PrefixDigest": "digest",
    "TenantFairPolicy": "fair", "TenantSpec": "fair",
    "FrontDoor": "frontdoor", "FabricClient": "client",
    "BreakerTransport": "breaker",
    "LoadShedder": "robust", "Backoff": "robust",
    "FabricRejected": "robust", "Overloaded": "robust",
    "AllReplicasDown": "robust", "DeadlineExceeded": "robust",
}

__all__ = list(_WHERE)


def __getattr__(name):
    mod = _WHERE.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)


def __dir__():
    return sorted(set(globals()) | set(_WHERE))
