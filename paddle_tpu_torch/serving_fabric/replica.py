"""Replica: one ContinuousBatchingEngine behind the fabric verb set (copy
of ``paddle_tpu/serving_fabric/replica.py``).

A replica is the server side of :class:`~.transport.FabricTransport`:
it owns an engine (with an ``engine=<name>`` metric label so N replicas
in one process never merge registry series), answers the heartbeat with
a load/latency snapshot plus its :class:`~.digest.PrefixDigest`, and
exposes the KV-page handoff pair (extract/adopt) the disaggregation
path rides on. Roles:

* ``"both"`` (default) — takes any traffic;
* ``"decode"`` — never assigned a disaggregated prefill job;
* ``"prefill"`` — ONLY takes prefill jobs (cold long prompts routed for
  chunked prefill + handoff); excluded from normal routing while any
  both/decode replica is alive.

The digest is rebuilt lazily: only when the tree's mutation epoch moved
since the last heartbeat — a hot steady-state tree costs one dict
lookup per status call, not a tree walk.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..inference.generation import GenerationConfig
from ..observability.tracing import TRACER as _TRACE
from .digest import PrefixDigest

__all__ = ["Replica", "build_replicas"]

_KNOB_FIELDS = ("do_sample", "temperature", "top_k", "top_p",
                "eos_token_id")


class Replica:
    """See module doc. ``engine`` should be constructed with
    ``name=<this name>`` (build_replicas does) so its registry series
    carry the replica label."""

    def __init__(self, engine, name: str, role: str = "both",
                 digest_max_pages: int = 32,
                 digest_max_entries: int = 1024):
        if role not in ("both", "decode", "prefill"):
            raise ValueError(f"unknown replica role {role!r}")
        self.engine = engine
        self.name = name
        self.role = role
        self.digest_max_pages = int(digest_max_pages)
        self.digest_max_entries = int(digest_max_entries)
        self._digest: Optional[dict] = None
        self._digest_epoch = -1
        self._lat_cache: tuple = (-1, {})
        self._spec_k0 = int(getattr(engine, "spec_k", 0))

    # -- fabric verb set -----------------------------------------------------

    def submit(self, req: dict) -> int:
        """Router payload → engine.submit. Absent knobs mean the
        engine's default GenerationConfig — the pass-through contract
        the 1-replica parity anchor rides on."""
        knobs = req.get("knobs")
        gc = None
        if knobs:
            base = self.engine.cfg
            vals = {k: knobs.get(k, getattr(base, k))
                    for k in _KNOB_FIELDS}
            gc = GenerationConfig(max_new_tokens=base.max_new_tokens,
                                  seed=base.seed, **vals)
        return self.engine.submit(
            np.asarray(req["prompt"], np.int32),
            max_new_tokens=req.get("max_new_tokens"),
            generation_config=gc,
            rseed=req.get("rseed"),
            replay_prefix=req.get("replay"),
            trace=req.get("trace"))

    def poll(self) -> dict:
        """One scheduler tick + completions. Emissions are NEW tokens
        only (a replay prefix is never re-emitted); ``finished`` maps
        rid → the FULL stream including any replay prefix, which is the
        router's authoritative copy."""
        emitted = self.engine.step() if self.engine.has_work() else []
        finished = self.engine.take_finished()
        if finished:
            # drain boundary with retirements: refresh the replica's
            # registry series (per-engine labels)
            self.engine.publish_metrics()
        out = {"emitted": [[int(r), int(t)] for r, t in emitted],
               "finished": {int(r): np.asarray(v).tolist()
                            for r, v in finished.items()}}
        # piggyback finished replica-side spans: over TCP this replica
        # never owns a trace root, so drain_for_wire ships them to the
        # router for stitching; in-proc (shared tracer) it's a no-op
        tr = getattr(self.engine, "_tracer", None) or _TRACE
        if tr.enabled:
            spans = tr.drain_for_wire()
            if spans:
                out["spans"] = spans
        return out

    def status(self) -> dict:
        eng = self.engine
        # the router heartbeats every step: percentiles over the 10k/
        # 100k windows must not run per tick — they only change when a
        # request retires (same epoch-keyed discipline as the digest)
        key = eng._requests_retired
        if self._lat_cache[0] != key:
            self._lat_cache = (key, eng.latency_stats())
        lat = self._lat_cache[1]
        active = sum(s is not None for s in eng._slots)
        out = {"name": self.name, "role": self.role,
               "max_batch": eng.max_batch,
               "active": active,
               "free_slots": eng.max_batch - active,
               "queued": len(eng._queue),
               "free_pages": len(eng._free),
               "total_pages": eng._total_pages,
               "itl_p99_s": lat.get("itl_p99_s"),
               "ttft_p99_s": lat.get("ttft_p99_s"),
               "prefix_hit_rate": None,
               "digest": None}
        if eng._prefix is not None:
            ps = eng.prefix_stats()
            out["prefix_hit_rate"] = ps.get("prefix_hit_rate")
            if eng._prefix.epoch != self._digest_epoch:
                self._digest = PrefixDigest.from_cache(
                    eng._prefix, max_pages=self.digest_max_pages,
                    max_entries=self.digest_max_entries,
                    hit_rate=out["prefix_hit_rate"]).to_dict()
                self._digest_epoch = eng._prefix.epoch
            elif self._digest is not None:
                self._digest["hit_rate"] = out["prefix_hit_rate"]
            out["digest"] = self._digest
        return out

    def extract(self, tokens) -> Optional[dict]:
        return self.engine.serialize_pages(np.asarray(tokens, np.int32))

    def adopt(self, payload: dict) -> int:
        return len(self.engine.adopt_pages(payload))

    def cancel(self, rid: int) -> bool:
        """Kill local ``rid`` now, freeing its slot/pages (deadline miss,
        client disconnect)."""
        return bool(self.engine.cancel(int(rid)))

    def configure(self, knobs: dict) -> dict:
        """Apply runtime knobs; returns what actually took effect.

        ``spec_k``: brownout draft-budget cap, clamped to
        ``[1, construction-time spec_k]`` — never toggled through 0
        (the draft history only exists when the engine was built
        speculative, and the 0↔k edge would flip executable shapes
        mid-run). ``None`` restores the construction-time value. The
        decode executable cache keys on the (spec_k+1) block width, so
        a shrink is a cache switch, not a recompile storm, and spec
        output stays verification-exact at any k."""
        applied: Dict[str, object] = {}
        if "spec_k" in knobs and self._spec_k0 > 0:
            want = knobs["spec_k"]
            if want is None:
                self.engine.spec_k = self._spec_k0
            else:
                self.engine.spec_k = max(1, min(int(want),
                                                self._spec_k0))
            applied["spec_k"] = self.engine.spec_k
        return applied


def build_replicas(model, n: int, roles: Optional[List[str]] = None,
                   names: Optional[List[str]] = None,
                   replica_cls=Replica, **engine_kwargs) -> List[Replica]:
    """N same-model in-process replicas: one model, a page pool each.
    ``engine_kwargs`` go to every ContinuousBatchingEngine;
    ``prefix_cache`` defaults ON — affinity routing and handoff both
    need the tree."""
    from ..inference.serving import ContinuousBatchingEngine
    engine_kwargs.setdefault("prefix_cache", True)
    roles = list(roles or ["both"] * n)
    if len(roles) != n:
        raise ValueError(f"{n} replicas need {n} roles, got {len(roles)}")
    names = list(names or [f"r{i}" for i in range(n)])
    if len(set(names)) != n:
        raise ValueError(f"replica names must be unique: {names}")
    return [replica_cls(
        ContinuousBatchingEngine(model, name=names[i], **engine_kwargs),
        names[i], role=roles[i]) for i in range(n)]
