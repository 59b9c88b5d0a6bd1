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

The front door (``FrontDoor``, ``FabricClient``, ``BreakerTransport``)
and the SLO sentry's fabric rules are not ported (ROADMAP.md, A.9).

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

from .digest import PrefixDigest
from .fair import TenantFairPolicy, TenantSpec
from .replica import Replica, build_replicas
from .robust import (AllReplicasDown, Backoff, DeadlineExceeded,
                     FabricRejected, LoadShedder, Overloaded)
from .router import FabricRequest, ServingFabric
from .transport import (FabricTransport, InProcTransport, ReplicaDown,
                        TcpReplicaServer, TcpTransport, payload_from_wire,
                        payload_to_wire)

__all__ = [
    "ServingFabric", "FabricRequest",
    "Replica", "build_replicas",
    "FabricTransport", "InProcTransport", "TcpTransport",
    "TcpReplicaServer", "ReplicaDown",
    "payload_to_wire", "payload_from_wire",
    "PrefixDigest", "TenantFairPolicy", "TenantSpec",
    "LoadShedder", "Backoff", "FabricRejected", "Overloaded",
    "AllReplicasDown", "DeadlineExceeded",
]
