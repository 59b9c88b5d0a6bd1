"""Front-door load test: goodput vs offered load through the full
client → FrontDoor → ServingFabric → replica stack (the port of
``tools/load_test.py``; the tiny Llama with seeded random weights, on the
CUDA card unless ``--device cpu``).

Three entry points:

* ``--smoke`` — the acceptance leg (tests/test_torch_frontdoor.py runs
  it in-process on the CPU): ~20 concurrent streaming FabricClients against a
  2-replica fabric with the shed ladder, tenant weights, and a circuit
  breaker armed, plus one slow-loris client and one injected
  hang-then-recover mid-run. Asserts the acceptance contract: every
  rejection is TYPED and carries ``retry_after_ms``, every admitted
  stream completes exactly, the slow client is evicted (and its
  capacity reused), the hung replica trips/fails-over/readmits, and
  admitted p99 TTFT stays under the ``frontdoor_rules()`` ceiling.
  The wave runs traced: its stitched traces must carry every hop's
  spans, and ``analysis.critical_path`` must attribute at least 95% of
  every traced request's TTFT to named hops (JAX's acceptance bound
  holds for its best trace; here for each). The per-hop table and the
  worst trace's span tree go to stderr.
* ``trace_overhead_legs()`` — wall time of one fabric wave with request
  tracing on against off, interleaved, the minimum over rounds.
* ``overload_leg()`` — offered load at a multiple of pool capacity,
  shed ladder on vs off; goodput = deadline-met tokens per second.
  The shed-off leg admits everything and burns slot-time on requests
  the deadline then cancels; the shed-on leg refuses the excess at
  admission (typed, with a retry hint) and finishes what it admits.
  ``main`` prints on ÷ off as ``goodput_under_overload``.
* ``hang_leg()`` — p99 TTFT with a replica hung mid-run, breaker
  budgets tight vs loose. "Breaker off" is approximated with an 8x
  budget, NOT no budget — an unbounded poll on a hung replica wedges
  the router's pass forever.

Usage::

    python -m paddle_tpu_torch.tools.load_test --smoke --device cpu
    python -m paddle_tpu_torch.tools.load_test --offered 20

Prints one JSON summary line; exit 0 = pass. ``main(argv)`` is
importable.
"""

import argparse
import json
import socket
import sys
import threading
import time


# -- stack construction ------------------------------------------------------

def _tiny_model(device=None):
    """The tiny Llama, weights from seed 0, on ``device`` (the card by
    default; raises without one unless ``device="cpu"``)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    dev = pt.resolve_device(device)
    return LlamaForCausalLM(LlamaConfig.tiny(), device=dev,
                            generator=pt.generator(0, dev))


def build_stack(model, *, replicas=2, max_batch=2, max_len=96,
                shedder=None, fair=None, breaker_kwargs=None,
                door_kwargs=None, policy="round-robin", names=None):
    """The full front-door stack on in-process replicas. Returns
    (door, fab, breaker); caller owns door.stop()."""
    from paddle_tpu_torch.inference.generation import GenerationConfig
    from paddle_tpu_torch.serving_fabric import (BreakerTransport,
                                                 FrontDoor,
                                                 InProcTransport,
                                                 ServingFabric,
                                                 build_replicas)
    reps = build_replicas(
        model, replicas, page_size=8, max_len=max_len,
        max_batch=max_batch, names=names,
        generation_config=GenerationConfig(max_new_tokens=8,
                                           do_sample=False))
    br = BreakerTransport(InProcTransport(reps), **(breaker_kwargs or {}))
    fab = ServingFabric(br, policy=policy, fair=fair, shedder=shedder)
    door = FrontDoor(fab, **(door_kwargs or {}))
    return door, fab, br


def _prompts(n, length=6, seed=7):
    import numpy as np
    rs = np.random.RandomState(seed)
    return [rs.randint(0, 32, (length,)).astype(np.int32).tolist()
            for _ in range(n)]


def _warmup(door, fab, *, replicas=2, max_batch=2):
    """Run every shape the waves will hit BEFORE anything is timed: the
    cold prefill buckets (short prompts and the longer prompt+replay
    re-prefill bucket a failover pays) and the full-batch decode shape,
    on EVERY replica (first calls pay allocator and library warm-up)."""
    from paddle_tpu_torch.serving_fabric import FabricClient
    n = replicas * max_batch
    shorts = _prompts(n, length=6, seed=1)
    longs = _prompts(replicas, length=14, seed=2)
    errs = []

    def one(i, p):
        try:
            c = FabricClient(door.host, door.port, max_attempts=2,
                             io_timeout_s=300.0)
            c.generate(p, 8, request_id=f"warm-{i}")
        except Exception as e:      # noqa: BLE001 — surfaced below
            errs.append(e)

    for batch in (shorts, longs):
        ts = [threading.Thread(target=one, args=(i, p))
              for i, p in enumerate(batch)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300.0)
        if errs:
            raise RuntimeError(f"warmup failed: {errs[0]}")
    fab.reset_latency_stats()


# -- the smoke leg -----------------------------------------------------------

def _slow_loris(door, *, sid, n_tokens=48):
    """Connect, submit, then never read: the server must evict us (the
    write path stalls against our closed TCP window) without stalling
    anyone else. The long id pads every event so a few dozen tokens
    overflow the shrunken server-side send buffer. Returns the open
    socket (caller keeps it alive for the duration of the wave)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    # tiny receive window BEFORE connect: with the server's shrunken
    # send buffer, a couple of padded events fill both and the writer
    # blocks — the stalled-sendall state a real slow-loris produces
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 2048)
    s.settimeout(5.0)
    s.connect((door.host, door.port))
    msg = {"op": "submit", "id": sid, "prompt": [3, 1, 4, 1, 5, 9],
           "max_new_tokens": n_tokens}
    s.sendall(json.dumps(msg).encode() + b"\n")
    return s


def smoke(ttft_ceiling_s: float = 30.0, device=None) -> dict:
    from paddle_tpu_torch.observability.metrics import REGISTRY
    from paddle_tpu_torch.observability.sentry import (SloSentry,
                                                       frontdoor_rules)
    from paddle_tpu_torch.observability.tracing import TRACER
    from paddle_tpu_torch.serving_fabric import (FabricClient, LoadShedder,
                                                 TenantFairPolicy,
                                                 TenantSpec)
    from paddle_tpu_torch.testing.chaos import hang_replica, unhang_replica

    was_enabled = REGISTRY.enabled
    REGISTRY.enable()
    TRACER.enable()          # the smoke wave runs traced
    errors = []
    model = _tiny_model(device)
    fair = TenantFairPolicy({"prod": TenantSpec(weight=2.0),
                             "bulk": TenantSpec(weight=0.5)})
    shedder = LoadShedder(queue_depth_hi=4, queue_depth_lo=1,
                          queue_cap=10, breach_ticks=1, recover_ticks=3,
                          retry_after_ms=200.0)
    door, fab, br = build_stack(
        model, shedder=shedder, fair=fair,
        breaker_kwargs=dict(open_cooldown_s=0.5, probe_successes=2,
                            probe_timeout_s=0.3),
        door_kwargs=dict(outbox_max=64, write_stall_s=0.25,
                         sndbuf=2048),
        names=["ld0", "ld1"])
    door.start()
    summary = {}
    try:
        _warmup(door, fab)

        results, failures = {}, {}
        lock = threading.Lock()
        go = threading.Barrier(19)

        def client(cid, tenant, attempts):
            c = FabricClient(door.host, door.port,
                             max_attempts=attempts, io_timeout_s=300.0)
            go.wait(timeout=60.0)
            try:
                r = c.generate(_prompts(1, seed=100 + cid)[0], 8,
                               tenant=tenant,
                               request_id=f"{tenant}-{cid}")
                with lock:
                    results[f"{tenant}-{cid}"] = r
            except Exception as e:   # noqa: BLE001 — collected
                with lock:
                    failures[f"{tenant}-{cid}"] = e

        threads = [threading.Thread(target=client,
                                    args=(i, "prod", 8), daemon=True)
                   for i in range(13)]
        threads += [threading.Thread(target=client,
                                     args=(i, "bulk", 2), daemon=True)
                    for i in range(5)]

        # the hang controller: wedge one replica mid-wave, tighten the
        # poll budget ONLY for detection (the survivor's failover
        # re-prefill is warmed, but budgets stay honest), then recover
        # and wait for half-open readmission
        hang_report = {}

        def busy():
            with door._flock:
                return fab.has_work()

        def hangman():
            go.wait(timeout=60.0)
            # hang mid-wave: as soon as the fabric holds wave requests
            # (a fixed delay can land after a fast engine finished the
            # whole wave, and an idle fabric polls nothing that could
            # trip). The budget is tightened first, so no poll started
            # under the loose one meets the hang.
            t0 = time.monotonic()
            while not busy() and time.monotonic() - t0 < 60.0:
                time.sleep(0.002)
            victim = "ld0"
            br.op_timeouts["poll"] = 1.2
            hang_replica(br, victim)
            t0 = time.monotonic()
            while victim not in fab._dead and \
                    time.monotonic() - t0 < 15.0:
                time.sleep(0.02)
            hang_report["tripped_s"] = round(time.monotonic() - t0, 3)
            hang_report["tripped"] = victim in fab._dead
            br.op_timeouts["poll"] = 30.0
            time.sleep(0.5)
            unhang_replica(br, victim)
            t1 = time.monotonic()
            while (victim in fab._dead or br.state(victim) != "closed") \
                    and time.monotonic() - t1 < 20.0:
                time.sleep(0.05)
            hang_report["readmitted"] = victim not in fab._dead
            hang_report["breaker"] = br.state(victim)

        threads.append(threading.Thread(target=hangman, daemon=True))
        # every event echoes the id: an 8KB id makes each tok event
        # outweigh the shrunken socket buffers on its own
        slow_sid = "slow-" + "x" * 8000
        slow_sock = _slow_loris(door, sid=slow_sid, n_tokens=90)
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300.0)
        try:
            slow_sock.close()
        except OSError:
            pass

        # -- acceptance checks ---------------------------------------
        for sid, r in results.items():
            if len(r.tokens) != 8:
                errors.append(f"{sid}: {len(r.tokens)}/8 tokens")
        rejects = [ev for r in results.values() for ev in r.rejects]
        for sid, e in failures.items():
            w = getattr(e, "to_wire", None)
            if w is None:
                errors.append(f"{sid}: untyped failure {e!r}")
            else:
                rejects.append(w())
        for ev in rejects:
            if ev.get("kind") not in ("overloaded", "all_down",
                                      "deadline"):
                errors.append(f"untyped rejection: {ev}")
            if ev.get("retry_after_ms") is None:
                errors.append(f"rejection without retry_after_ms: {ev}")
        if not results:
            errors.append("no client completed")
        shed_stats = shedder.stats()
        if not rejects and not shed_stats.get("shed"):
            errors.append("19 clients against 4 slots never shed — "
                          "the overload leg exercised nothing")
        if not hang_report.get("tripped"):
            errors.append(f"hung replica never tripped: {hang_report}")
        if not hang_report.get("readmitted") or \
                hang_report.get("breaker") != "closed":
            errors.append(f"hung replica never readmitted: "
                          f"{hang_report}")
        states = door.stream_states()
        if states.get(slow_sid) not in ("orphaned", None):
            errors.append(f"slow-loris stream not evicted: "
                          f"{states.get(slow_sid)}")
        slow_evicted = REGISTRY.counter(
            "pt_frontdoor_disconnects_total",
            "client connections dropped").value(reason="slow")
        if slow_evicted < 1:
            errors.append("pt_frontdoor_disconnects_total{reason=slow} "
                          "never moved")

        # capacity reusable after the slow client's eviction
        from paddle_tpu_torch.serving_fabric import FabricClient as FC
        after = FC(door.host, door.port, max_attempts=8,
                   io_timeout_s=300.0).generate(
            _prompts(1, seed=999)[0], 8, tenant="prod",
            request_id="post-wave")
        if len(after.tokens) != 8:
            errors.append("post-wave request did not complete: the "
                          "evicted slow client leaked capacity")

        # admitted p99 TTFT under the frontdoor_rules ceiling — the
        # same ceiling wired into the sentry pack
        lat = fab.latency_stats()
        rules = frontdoor_rules(replicas=["ld0", "ld1"],
                                ttft_p99_ceiling_s=ttft_ceiling_s,
                                breach_for=1)
        sentry = SloSentry(rules)
        fab.publish_metrics()
        sentry.tick()
        ttft_inc = [i for i in sentry.incidents
                    if i.rule == "frontdoor_ttft_p99_ceiling"]
        if lat.get("ttft_p99_s", 0.0) > ttft_ceiling_s:
            errors.append(f"admitted p99 TTFT "
                          f"{lat.get('ttft_p99_s'):.3f}s over the "
                          f"{ttft_ceiling_s}s ceiling")
        if ttft_inc:
            errors.append("frontdoor_ttft_p99_ceiling sentry fired")

        # distributed tracing: the wave must leave complete stitched
        # traces — frontdoor accept through replica prefill/decode to
        # stream drain — with >= 95% of each request's TTFT attributed
        # to NAMED hops
        traces = TRACER.recent_traces()
        named = attributed_shares(traces)
        if not traces:
            errors.append("tracing produced no complete traces")
        else:
            full = max(traces,
                       key=lambda t: len({s["name"].split("::")[0]
                                          for s in t["spans"]}))
            names = {s["name"] for s in full["spans"]}
            for pref in ("frontdoor::request", "frontdoor::submit",
                         "fabric::queue", "replica::queue",
                         "replica::prefill", "replica::decode",
                         "frontdoor::drain"):
                if not any(n.startswith(pref) for n in names):
                    errors.append(f"stitched trace missing {pref} spans")
            low = {t: f for t, f in named.items() if f < NAMED_FLOOR}
            if not named or low:
                errors.append(f"TTFT attribution under {NAMED_FLOOR} "
                              f"named for {len(low)} of {len(named)} "
                              f"traced requests: {low}")
            print(trace_table(traces), file=sys.stderr)

        summary = {
            "ok": not errors,
            "completed": len(results),
            "failed_typed": len(failures),
            "rejects": len(rejects),
            "shed": shed_stats,
            "retries": door.retries,
            "breaker_trips": br.trips,
            "hang": hang_report,
            "ttft_p99_s": round(lat.get("ttft_p99_s", 0.0), 4),
            "ttft_ceiling_s": ttft_ceiling_s,
            "traces": len(traces),
            "trace_ttft_named_frac_min": (round(min(named.values()), 4)
                                          if named else None),
            "errors": errors,
        }
    finally:
        door.stop()
        TRACER.disable()
        REGISTRY.enabled = was_enabled
    return summary


# -- critical path -----------------------------------------------------------

#: the least share of a traced request's TTFT that named hops must own
NAMED_FLOOR = 0.95


def attributed_shares(traces) -> dict:
    """trace id -> the share of its TTFT on named hops (1 - untracked),
    for every trace with a measured TTFT."""
    from paddle_tpu_torch.analysis import critical_path as cp
    out = {}
    for t in traces:
        att = cp.attribute_trace(t)
        if att["ttft_s"]:
            out[att["trace_id"]] = 1.0 - att["ttft_frac"].get(
                "untracked", 0.0)
    return out


def trace_table(traces) -> str:
    """The per-hop TTFT table and the worst trace's span tree."""
    from paddle_tpu_torch.analysis import critical_path as cp
    worst = max(traces, key=lambda t: t["summary"].get("ttft_s") or 0.0)
    return (cp.format_table(cp.aggregate(traces)) + "\n\n"
            + cp.format_span_tree(worst))


def trace_overhead_legs(model, *, rounds: int = 3, n_requests: int = 6,
                        max_new: int = 8, seed: int = 13, **replica_kw
                        ) -> dict:
    """Wall time of one fabric wave with request tracing ON vs OFF,
    interleaved, the minimum of ``rounds`` on the SAME warmed fabric.
    The ratio prices the span machinery end to end — router queue /
    route / submit spans, engine queue / resident / prefill / decode
    spans — against the disabled path's attribute-load-plus-branch
    contract. ``replica_kw`` overrides the replicas' page size, length
    and batch (the tiny model's: 8, 96, 2)."""
    from paddle_tpu_torch.inference.generation import GenerationConfig
    from paddle_tpu_torch.observability.tracing import TRACER
    from paddle_tpu_torch.serving_fabric import (InProcTransport,
                                                 ServingFabric,
                                                 build_replicas)
    kw = {"page_size": 8, "max_len": 96, "max_batch": 2, **replica_kw}
    reps = build_replicas(
        model, 2, names=["tro0", "tro1"],
        generation_config=GenerationConfig(max_new_tokens=max_new,
                                           do_sample=False), **kw)
    fab = ServingFabric(InProcTransport(reps), policy="round-robin")
    prompts = _prompts(n_requests, seed=seed)

    def wave():
        fids = [fab.submit(p, max_new) for p in prompts]
        got = fab.run()
        assert all(len(got[f]) == max_new for f in fids)

    was = TRACER.enabled
    wave()                                    # warm every path once
    legs = {"off": float("inf"), "on": float("inf")}
    n_traces = 0
    try:
        for _ in range(rounds):
            TRACER.disable()
            t0 = time.perf_counter()
            wave()
            legs["off"] = min(legs["off"], time.perf_counter() - t0)
            TRACER.enable()
            t0 = time.perf_counter()
            wave()
            legs["on"] = min(legs["on"], time.perf_counter() - t0)
            n_traces += len(TRACER.take_completed())
    finally:
        TRACER.disable()
        if was:
            TRACER.enable()
    return {"wall_on_s": legs["on"], "wall_off_s": legs["off"],
            "ratio": legs["on"] / max(legs["off"], 1e-9),
            "traces": n_traces}


# -- load legs ---------------------------------------------------------------

def overload_leg(model, *, shed: bool, offered: int = 20,
                 max_new: int = 16, deadline_mult: float = 3.5,
                 deadline_ms=None, rounds: int = 2,
                 seed: int = 5) -> dict:
    """Offered load well beyond pool capacity (2 replicas x 2 slots),
    every request deadline-bound at ``deadline_mult`` x the measured
    UNLOADED request latency, one shot each (no client retries: the
    leg measures the SERVER's admission discipline). The deadline is
    sized so the first couple of scheduling waves meet it and deeper
    queue positions cannot — shed OFF admits those anyway, pays their
    prefill and partial decode, then the deadline cancels them
    (slot-time burned for zero delivered tokens); shed ON refuses them
    at admission with a typed ``Overloaded`` and finishes what it
    admits. Goodput counts only deadline-met tokens. Pass the first
    leg's returned ``deadline_ms`` into the second so the A/B shares
    ONE deadline; best-of-``rounds`` absorbs scheduler jitter."""
    from paddle_tpu_torch.serving_fabric import (FabricClient, LoadShedder,
                                                 TenantFairPolicy)
    shedder = LoadShedder(queue_depth_hi=3, queue_depth_lo=1,
                          queue_cap=4, breach_ticks=1,
                          recover_ticks=3) if shed else None
    tag = "sh" if shed else "un"
    door, fab, _br = build_stack(
        model, shedder=shedder, fair=TenantFairPolicy(),
        door_kwargs=dict(outbox_max=64),
        names=[f"{tag}0", f"{tag}1"])
    door.start()
    try:
        _warmup(door, fab)
        if deadline_ms is None:
            # calibrate: one unloaded request end-to-end
            cal = FabricClient(door.host, door.port, max_attempts=2,
                               io_timeout_s=300.0)
            t0 = time.perf_counter()
            cal.generate(_prompts(1, seed=seed)[0], max_new,
                         request_id=f"cal-{tag}")
            deadline_ms = (deadline_mult
                           * (time.perf_counter() - t0) * 1000.0)

        best = None
        for rnd in range(rounds):
            done, rejected = [], []
            lock = threading.Lock()
            go = threading.Barrier(offered)
            prompts = _prompts(offered, seed=seed + 1)

            def one(i):
                c = FabricClient(door.host, door.port, max_attempts=1,
                                 io_timeout_s=300.0)
                go.wait(timeout=60.0)
                try:
                    r = c.generate(prompts[i], max_new,
                                   deadline_ms=deadline_ms,
                                   request_id=f"ov-{tag}-{rnd}-{i}")
                    with lock:
                        done.append(len(r.tokens))
                except Exception as e:   # noqa: BLE001 — typed/deadline
                    with lock:
                        rejected.append(type(e).__name__)

            ts = [threading.Thread(target=one, args=(i,), daemon=True)
                  for i in range(offered)]
            t1 = time.perf_counter()
            for t in ts:
                t.start()
            for t in ts:
                t.join(timeout=300.0)
            dt = time.perf_counter() - t1
            lat = fab.latency_stats()
            res = {"goodput_tps": sum(done) / max(dt, 1e-9),
                   "completed": len(done), "rejected": len(rejected),
                   "wall_s": dt, "deadline_ms": deadline_ms,
                   "ttft_p99_s": lat.get("ttft_p99_s", 0.0)}
            if best is None or res["goodput_tps"] > best["goodput_tps"]:
                best = res
        return best
    finally:
        door.stop()


def hang_leg(model, *, poll_budget_s: float, n_requests: int = 4,
             max_new: int = 6, seed: int = 11) -> dict:
    """p99 TTFT for requests admitted while one replica is HUNG: with
    a tight poll budget the breaker converts the hang into a fast
    failover; with a loose one every step stalls the full budget
    first. Driven at the router (the layer the breaker guards)."""
    from paddle_tpu_torch.inference.generation import GenerationConfig
    from paddle_tpu_torch.serving_fabric import (BreakerTransport,
                                                 InProcTransport,
                                                 ServingFabric,
                                                 build_replicas)
    from paddle_tpu_torch.testing.chaos import hang_replica, unhang_replica
    tag = f"hg{int(poll_budget_s * 10)}"
    reps = build_replicas(
        model, 2, page_size=8, max_len=96, max_batch=2,
        names=[f"{tag}a", f"{tag}b"],
        generation_config=GenerationConfig(max_new_tokens=max_new,
                                           do_sample=False))
    br = BreakerTransport(InProcTransport(reps),
                          open_cooldown_s=60.0,  # no readmission mid-leg
                          probe_timeout_s=0.2)
    fab = ServingFabric(br, policy="round-robin")
    # warm every bucket incl. the failover re-prefill one, under the
    # LOOSE default budgets (first polls pay allocator and library
    # warm-up); the leg's budget applies only once the hang is armed
    for p in _prompts(4, seed=seed) + _prompts(2, length=14, seed=seed):
        fab.submit(p, max_new)
    fab.run()
    victim = f"{tag}a"
    hang_replica(br, victim)
    br.op_timeouts["poll"] = poll_budget_s
    br.op_timeouts["submit"] = poll_budget_s
    try:
        fab.reset_latency_stats()
        fids = [fab.submit(p, max_new)
                for p in _prompts(n_requests, seed=seed + 1)]
        out = fab.run()
        assert all(len(out[f]) == max_new for f in fids)
        return {"ttft_p99_s": fab.latency_stats()["ttft_p99_s"],
                "trips": br.trips}
    finally:
        unhang_replica(br, victim)


# -- CLI ---------------------------------------------------------------------

def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="acceptance leg (~20 clients, one slow, one "
                         "hang)")
    ap.add_argument("--ttft-ceiling", type=float, default=None,
                    help="frontdoor_rules p99 TTFT ceiling in seconds "
                         "(smoke default 30 on CPU, else 2.0)")
    ap.add_argument("--offered", type=int, default=20,
                    help="concurrent clients for the overload A/B")
    ap.add_argument("--device", default=None,
                    help="torch device of the model and the replicas' "
                         "pools (default: the CUDA card; 'cpu' to run "
                         "without one)")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke(ttft_ceiling_s=args.ttft_ceiling or 30.0,
                     device=args.device)
    model = _tiny_model(args.device)
    legs = {"shed_on": overload_leg(model, shed=True,
                                    offered=args.offered)}
    legs["shed_off"] = overload_leg(
        model, shed=False, offered=args.offered,
        deadline_ms=legs["shed_on"]["deadline_ms"])
    ratio = (legs["shed_on"]["goodput_tps"]
             / max(legs["shed_off"]["goodput_tps"], 1e-9))
    return {"ok": True, "legs": legs,
            "goodput_under_overload": round(ratio, 3)}


if __name__ == "__main__":
    out = main()
    print(json.dumps(out))
    sys.exit(0 if out.get("ok") else 1)
