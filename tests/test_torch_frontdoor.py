"""The port's front door (``FrontDoor``, ``FabricClient``), circuit breaker
(``BreakerTransport``), chaos hooks and the two tools over them, against
the JAX package's, on the CPU over the tiny Llama (weights carried from
the JAX model):

- the JAX package's ``test_frontdoor.py`` and ``test_breaker.py`` cases
  against the port: a torn frame answered with an ``error`` event on a
  connection that lives, ``seq`` gapless; 8 concurrent sampled streams,
  a slow-loris client evicted while the others finish, a disconnect then
  a retry (zero duplicated, zero lost tokens), a replica hung then
  released (trip, replay on the survivor, half-open readmission) — each
  stream equal to a serial port engine under the rseed the door or the
  router recorded (the port's sampling streams are its own, ROADMAP.md
  D8); deadline, overload and all-down refusals typed with
  ``retry_after_ms``;
- greedy streams through the port's door equal the JAX door's on the
  same prompts, each door driven by the other package's client (one
  wire);
- the breaker's lifecycle on a fake clock: the same states, trips,
  retry hints and failures as JAX's ``BreakerTransport`` over one op
  script;
- ``paddle_tpu_torch.tools.serve_fabric``'s JSON summary equals
  ``tools/serve_fabric.py``'s on one trace (timings aside), and
  ``paddle_tpu_torch.tools.load_test --smoke`` passes in process;
- the engine's verbs work from a fresh thread on an engine built under
  ``torch.inference_mode()`` (D12), and the client module imports no
  ``torch``.

Every engine that JAX's is held against runs at ``async_depth=1`` (see
``tests/test_torch_engine_policies.py``)."""

import functools
import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu.models
import paddle_tpu.serving_fabric as jsf
from paddle_tpu.serving_fabric import BreakerTransport as JaxBreaker
from paddle_tpu.serving_fabric.transport import \
    FabricTransport as JaxFabricTransport
from paddle_tpu.serving_fabric.transport import ReplicaDown as JaxReplicaDown
from paddle_tpu.inference import GenerationConfig as JaxGen
import paddle_tpu_torch.serving_fabric as psf
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.serving_fabric import (AllReplicasDown,
                                             BreakerTransport,
                                             DeadlineExceeded, FabricClient,
                                             FrontDoor, InProcTransport,
                                             LoadShedder, ServingFabric,
                                             build_replicas)
from paddle_tpu_torch.serving_fabric.transport import (FabricTransport,
                                                       ReplicaDown)
from paddle_tpu_torch.testing.chaos import (hang_replica, kill_replica,
                                            unhang_replica)
from paddle_tpu_torch.tools import load_test, serve_fabric
from torch_serving_pairs import keep_jax_fns, model_pairs, share_jax_fns

pytestmark = pytest.mark.chaos

PAGE = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT_S = 120.0          # every socket read and thread join has its limit


@pytest.fixture(scope="module")
def models(tiny_llama):
    return model_pairs(tiny_llama, int8=False)["native"]


@pytest.fixture(scope="module")
def model(models):
    return models[1]


@pytest.fixture(scope="module")
def gc():
    return GenerationConfig(max_new_tokens=16, do_sample=True, seed=9)


@pytest.fixture(scope="module")
def door_fab(model, gc):
    reps = build_replicas(model, 2, page_size=PAGE, max_len=96,
                          max_batch=4, generation_config=gc)
    fab = ServingFabric(InProcTransport(reps), policy="round-robin")
    door = FrontDoor(fab).start()
    yield door, fab
    door.stop()


def _reference_streams(model, prompts, gc, max_new, rseeds):
    """A serial port engine under each stream's recorded rseed: the
    stream any placement, batching or failover must reproduce."""
    eng = ContinuousBatchingEngine(model, max_batch=1, page_size=PAGE,
                                   max_len=96, generation_config=gc)
    rids = [eng.submit(p, max_new, rseed=r) for p, r in zip(prompts, rseeds)]
    out = eng.run()
    return [out[r] for r in rids]


def _connect(door, timeout=WAIT_S):
    s = socket.create_connection((door.host, door.port), timeout=5.0)
    s.settimeout(timeout)
    return s, s.makefile("rb")


def _send(sock, msg):
    sock.sendall(json.dumps(msg).encode() + b"\n")


def _recv(f):
    line = f.readline(1 << 20)
    if not line:
        raise ConnectionError("server closed the connection")
    return json.loads(line)


def _rseeds(door, sids):
    with door._flock:
        return [door._streams[s].rseed for s in sids]


def _wait_state(door, sid, want, timeout_s=60.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if door.stream_states().get(sid) == want:
            return
        time.sleep(0.02)
    raise AssertionError(f"stream {sid[:24]!r} never reached {want!r}: "
                         f"{door.stream_states().get(sid)!r}")


def _clients(door, prompts, sids, n_new, client_cls=FabricClient):
    """One client thread a prompt; returns the token lists."""
    results, errs = [None] * len(prompts), []

    def go(i):
        try:
            c = client_cls(door.host, door.port, max_attempts=3,
                           io_timeout_s=WAIT_S)
            results[i] = c.generate(prompts[i], n_new,
                                    request_id=sids[i]).tokens
        except Exception as e:          # noqa: BLE001 — reported below
            errs.append((i, repr(e)))

    ts = [threading.Thread(target=go, args=(i,))
          for i in range(len(prompts))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=2 * WAIT_S)
    assert not any(t.is_alive() for t in ts), "a client never returned"
    assert not errs, f"client failures: {errs}"
    return results


# -- the front door: framing --------------------------------------------------

def test_torn_frame_survives_and_seq_gapless(door_fab):
    door, _ = door_fab
    s, f = _connect(door)
    try:
        s.sendall(b'{"op": "submit", "truncated\n')     # torn JSON
        s.sendall(b'[1, 2, 3]\n')                       # not an object
        _send(s, {"op": "frobnicate"})                  # unknown op
        _send(s, {"op": "submit"})                      # no id
        _send(s, {"op": "ping"})
        evs = [_recv(f) for _ in range(5)]
        assert [e["ev"] for e in evs] == ["error"] * 4 + ["pong"]
        assert "bad frame" in evs[0]["error"]
        assert [e["seq"] for e in evs] == list(range(5))
    finally:
        s.close()


def test_overlong_frame_closes_the_connection(model, gc):
    reps = build_replicas(model, 1, page_size=PAGE, max_len=96,
                          max_batch=1, generation_config=gc)
    door = FrontDoor(ServingFabric(InProcTransport(reps)),
                     max_line_bytes=64).start()
    try:
        s, f = _connect(door)
        s.sendall(b"{" + b" " * 200 + b"}\n")
        assert f.readline() == b""                       # closed
        s.close()
    finally:
        door.stop()


# -- the front door: streams ------------------------------------------------

def test_concurrent_streams_token_identical(model, gc, door_fab):
    door, _ = door_fab
    rs = np.random.RandomState(1)
    prompts = [rs.randint(0, 256, (6,)).astype(np.int32) for _ in range(8)]
    sids = [f"cc-{i}" for i in range(8)]
    got = _clients(door, prompts, sids, 8)
    refs = _reference_streams(model, prompts, gc, 8, _rseeds(door, sids))
    for r, ref in zip(got, refs):
        assert len(r) == 8
        np.testing.assert_array_equal(np.asarray(r), ref)


def test_slow_loris_cancelled_healthy_streams_unharmed(model, gc):
    reps = build_replicas(model, 2, page_size=PAGE, max_len=96,
                          max_batch=2, generation_config=gc)
    fab = ServingFabric(InProcTransport(reps), policy="round-robin")
    door = FrontDoor(fab, outbox_max=64, write_stall_s=0.25,
                     sndbuf=2048).start()
    slow = None
    try:
        # tiny receive window negotiated before connect, a long id so
        # every tok event is fat, a long stream; then never read
        slow = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        slow.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 2048)
        slow.settimeout(5.0)
        slow.connect((door.host, door.port))
        slow_sid = "slow-" + "x" * 8000
        _send(slow, {"op": "submit", "id": slow_sid, "prompt": [1] * 6,
                     "max_new_tokens": 90})
        rs = np.random.RandomState(2)
        prompts = [rs.randint(0, 256, (6,)).astype(np.int32)
                   for _ in range(8)]
        sids = [f"h-{i}" for i in range(8)]
        got = _clients(door, prompts, sids, 8)
        refs = _reference_streams(model, prompts, gc, 8,
                                  _rseeds(door, sids))
        for r, ref in zip(got, refs):
            np.testing.assert_array_equal(np.asarray(r), ref)
        _wait_state(door, slow_sid, "orphaned", timeout_s=90.0)
        # its slot and pages came back: every engine is idle and whole
        for rep in reps:
            assert not rep.engine.has_work()
            rep.engine._check_page_invariants()
        after = FabricClient(door.host, door.port, max_attempts=3,
                             io_timeout_s=WAIT_S).generate(
            prompts[0], 8, request_id="after-loris")
        ref = _reference_streams(model, [prompts[0]], gc, 8,
                                 _rseeds(door, ["after-loris"]))[0]
        np.testing.assert_array_equal(np.asarray(after.tokens), ref)
    finally:
        if slow is not None:
            slow.close()
        door.stop()


def test_disconnect_retry_resumes_zero_dup_zero_loss(model, gc, door_fab):
    door, _ = door_fab
    rs = np.random.RandomState(3)
    prompt = rs.randint(0, 256, (7,)).astype(np.int32)
    sid, n_new = "rt-1", 48     # long enough to cut it mid-stream
    s, f = _connect(door)
    got = []
    try:
        _send(s, {"op": "submit", "id": sid, "prompt": prompt.tolist(),
                  "max_new_tokens": n_new})
        while not got:
            ev = _recv(f)
            if ev.get("ev") == "tok" and ev.get("id") == sid:
                got.extend(int(t) for t in ev["toks"])
            elif ev.get("ev") == "done":
                pytest.fail("stream finished before the disconnect")
        assert 0 < len(got) < n_new
    finally:
        try:
            s.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        f.close()
        s.close()
    _wait_state(door, sid, "orphaned")
    s2, f2 = _connect(door)
    rest = []
    try:
        _send(s2, {"op": "submit", "id": sid, "prompt": prompt.tolist(),
                   "max_new_tokens": n_new, "have": len(got)})
        while True:
            ev = _recv(f2)
            if ev.get("ev") == "tok" and ev.get("id") == sid:
                rest.extend(int(t) for t in ev["toks"])
            elif ev.get("ev") == "done" and ev.get("id") == sid:
                rest.extend(int(t) for t in ev.get("toks", ()))
                assert ev["n"] == len(got) + len(rest)
                break
            elif ev.get("ev") == "reject":
                pytest.fail(f"resume rejected: {ev}")
    finally:
        s2.close()
    total = got + rest
    assert len(total) == n_new
    ref = _reference_streams(model, [prompt], gc, n_new,
                             _rseeds(door, [sid]))[0]
    np.testing.assert_array_equal(np.asarray(total), ref)
    assert door.retries >= 1


# -- the front door: typed refusals -----------------------------------------

def test_deadline_miss_rejected_typed(door_fab):
    door, _ = door_fab
    c = FabricClient(door.host, door.port, max_attempts=2)
    with pytest.raises(DeadlineExceeded) as ei:
        c.generate([1, 2, 3, 4, 5, 6], 8, deadline_ms=0.01,
                   request_id="dl-1")
    assert ei.value.retry_after_ms is not None
    assert ei.value.to_wire()["kind"] == "deadline"


def test_overload_rejected_typed_with_retry_hint(model, gc):
    reps = build_replicas(model, 1, page_size=PAGE, max_len=96,
                          max_batch=1, generation_config=gc)
    shed = LoadShedder(queue_depth_hi=2, queue_depth_lo=0, queue_cap=3,
                       breach_ticks=1, retry_after_ms=123.0)
    fab = ServingFabric(InProcTransport(reps), policy="round-robin",
                        shedder=shed)
    door = FrontDoor(fab).start()
    s = None
    try:
        s, f = _connect(door)
        for i in range(8):
            _send(s, {"op": "submit", "id": f"ov-{i}", "prompt": [1] * 6,
                      "max_new_tokens": 8})
        reject = None
        deadline = time.monotonic() + WAIT_S
        while reject is None and time.monotonic() < deadline:
            ev = _recv(f)
            if ev.get("ev") == "reject":
                reject = ev
        assert reject is not None, "hard queue cap never shed"
        assert reject["kind"] == "overloaded"
        assert reject["retry_after_ms"] == 123.0
        assert shed.stats()["shed"]
    finally:
        if s is not None:
            s.close()
        door.stop()


# -- greedy streams against the JAX front door ------------------------------

def test_greedy_streams_equal_the_jax_front_door(models):
    jm, pm = models
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, 256, (n,)).astype(np.int32)
               for n in (5, 9, 6, 13, 7, 11)]
    kw = dict(page_size=PAGE, max_len=96, max_batch=2, async_depth=1)
    jreps = jsf.build_replicas(jm, 2, generation_config=JaxGen(
        max_new_tokens=8), **kw)
    share_jax_fns([r.engine for r in jreps])
    preps = build_replicas(pm, 2, generation_config=GenerationConfig(
        max_new_tokens=8), **kw)
    streams = {}
    for side, door, client in (
            ("jax", jsf.FrontDoor(jsf.ServingFabric(
                jsf.InProcTransport(jreps), policy="round-robin")),
             FabricClient),
            ("port", FrontDoor(ServingFabric(InProcTransport(preps),
                                             policy="round-robin")),
             jsf.FabricClient)):
        door.start()
        try:
            streams[side] = _clients(door, prompts,
                                     [f"g{i}" for i in range(len(prompts))],
                                     8, client_cls=client)
        finally:
            door.stop()
    keep_jax_fns([r.engine for r in jreps])
    assert streams["port"] == streams["jax"]


# -- the breaker --------------------------------------------------------------

def _stub_cls(base):
    class Stub(base):
        """One fake replica whose poll can be made slower than any
        budget."""

        def __init__(self):
            self.slow = False
            self.polls = 0

        def replica_names(self):
            return ["s0"]

        def status(self, name):
            return {"queued": 0, "running": 0}

        def poll(self, name):
            self.polls += 1
            if self.slow:
                time.sleep(0.3)
            return []

        def submit(self, name, req):
            return 0

        def extract(self, name, tokens):
            return None

        def adopt(self, name, payload):
            return None

        def cancel(self, name, rid):
            return True

        def configure(self, name, knobs):
            return {}
    return Stub


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


SCRIPT = ["poll", "slow", "poll", "poll", "probe", "advance", "poll",
          "fast", "drain", "probe", "probe", "poll", "slow", "poll",
          "advance", "drain", "probe", "advance", "fast", "drain", "probe",
          "probe", "poll"]


def _breaker_states(breaker_cls, base, down_cls):
    tr, clock = _stub_cls(base)(), _Clock()
    br = breaker_cls(tr, op_timeouts={"poll": 0.05}, open_cooldown_s=1.0,
                     probe_successes=2, probe_timeout_s=0.2, clock=clock)
    out = []
    for op in SCRIPT:
        res = None
        if op == "slow":
            tr.slow = True
        elif op == "fast":
            tr.slow = False
        elif op == "advance":
            clock.t += 1.5
        elif op == "drain":
            time.sleep(0.35)          # the stuck worker lets go of the lock
        elif op == "probe":
            res = br.probe("s0")
        else:
            n = tr.polls
            try:
                res = br.poll("s0")
            except down_cls:
                res = "down" + ("" if tr.polls > n else " (fast)")
        ra = br.retry_after_ms("s0")
        out.append((op, res, br.state("s0"), br.trips,
                    None if ra is None else round(ra, 6), br.open_names()))
    return out


def test_breaker_lifecycle_on_a_fake_clock_equals_jax():
    jax_seq = _breaker_states(JaxBreaker, JaxFabricTransport, JaxReplicaDown)
    port_seq = _breaker_states(BreakerTransport, FabricTransport,
                               ReplicaDown)
    assert port_seq == jax_seq
    states = [row[2] for row in port_seq]
    assert {"closed", "open", "half-open"} <= set(states)
    assert port_seq[-1][2] == "closed" and port_seq[-1][3] == 2


def test_probe_failure_reopens():
    tr = _stub_cls(FabricTransport)()
    br = BreakerTransport(tr, op_timeouts={"poll": 0.05},
                          open_cooldown_s=0.05, probe_successes=1,
                          probe_timeout_s=0.1)
    tr.slow = True
    with pytest.raises(ReplicaDown):
        br.poll("s0")
    time.sleep(0.45)
    assert br.probe("s0") is False
    assert br.state("s0") == "open"
    tr.slow = False
    time.sleep(0.45)
    assert br.probe("s0") is True
    assert br.state("s0") == "closed"


def _breaker_pins(breaker_cls, base, down_cls, late):
    """Whether the transport a breaker wraps outlives the breaker, with
    the collector off, after one relayed error: raised at once, or
    (``late``) by an op that answered after the caller gave up."""
    import gc as collector
    import weakref

    class Failing(_stub_cls(base)):
        def poll(self, name):
            if late:
                time.sleep(0.3)
            raise down_cls(name, "injected")

    tr = Failing()
    ref = weakref.ref(tr)
    br = breaker_cls(tr, op_timeouts={"poll": 0.05})
    was_on = collector.isenabled()
    collector.disable()
    try:
        try:
            br.poll("s0")
        except down_cls:
            pass
        else:
            pytest.fail("the breaker relayed no error")
        time.sleep(0.5)           # the late op answers and its thread ends
        del tr, br
        return ref() is not None
    finally:
        if was_on:
            collector.enable()


@pytest.mark.parametrize("late", [False, True])
def test_breaker_errors_pin_no_transport(late):
    """A relayed error leaves no reference cycle (error -> traceback ->
    the worker's or the caller's frame -> error) that would keep the
    wrapped transport, and so its engines and their model on the card,
    alive until a full collection."""
    assert not _breaker_pins(BreakerTransport, FabricTransport, ReplicaDown,
                             late)


def test_hang_trips_breaker_replays_exact_and_readmits(model):
    gc = GenerationConfig(max_new_tokens=10, do_sample=True, seed=9)
    reps = build_replicas(model, 2, page_size=PAGE, max_len=96,
                          max_batch=2, generation_config=gc)
    br = BreakerTransport(InProcTransport(reps), open_cooldown_s=0.3,
                          probe_successes=2, probe_timeout_s=0.5)
    fab = ServingFabric(br, policy="round-robin")
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, 256, (n,)).astype(np.int32) for n in (5, 7)]
    fids = [fab.submit(p, 10) for p in prompts]
    refs = dict(zip(fids, _reference_streams(model, prompts, gc, 10, fids)))
    live = {f: [] for f in fids}
    while min(len(v) for v in live.values()) < 3:
        for f, t in fab.step():
            live[f].append(t)
    victim = fab._reqs[fids[0]].replica
    assert victim is not None
    hang_replica(br, victim)
    try:
        br.op_timeouts["poll"] = 0.6
        br.op_timeouts["submit"] = 0.6
        t0 = time.monotonic()
        while victim not in fab._dead:
            assert time.monotonic() - t0 < 20.0, \
                "hung replica never tripped the breaker"
            for f, t in fab.step():
                live[f].append(t)
        assert time.monotonic() - t0 < 10.0
        assert br.state(victim) in ("open", "half-open") and br.trips >= 1
        br.op_timeouts["poll"] = 30.0
        br.op_timeouts["submit"] = 30.0
        out = fab.run()
        assert fab.stats()["replicas_dead"] == [victim]
        assert fab.readmitted >= 1
        for f in fids:
            np.testing.assert_array_equal(out[f], refs[f])
            np.testing.assert_array_equal(np.asarray(live[f]),
                                          out[f][:len(live[f])])
        unhang_replica(br, victim)
        t0 = time.monotonic()
        while victim in fab._dead:
            assert time.monotonic() - t0 < 15.0, \
                "recovered replica never readmitted"
            fab.probe_recovery()
            time.sleep(0.02)
        assert br.state(victim) == "closed"
    finally:
        unhang_replica(br, victim)


def test_all_breakers_open_submissions_typed(model):
    gc = GenerationConfig(max_new_tokens=4)
    reps = build_replicas(model, 2, page_size=PAGE, max_len=64,
                          max_batch=1, generation_config=gc)
    tr = InProcTransport(reps)
    br = BreakerTransport(tr, open_cooldown_s=5.0)
    fab = ServingFabric(br, policy="round-robin")
    names = list(br.replica_names())
    for n in names:
        kill_replica(br, n)         # passes through to the inner hook
    fab.submit([1, 2, 3], 4)
    with pytest.raises(AllReplicasDown, match="every replica is down"):
        fab.run()
    assert set(br.open_names()) == set(names)
    with pytest.raises(AllReplicasDown) as ei:
        fab.submit([1, 2, 3], 4)
    e = ei.value
    assert isinstance(e, RuntimeError)
    assert e.retry_after_ms is not None and 0.0 < e.retry_after_ms <= 5000.0
    wire = e.to_wire()
    assert wire["kind"] == "all_down"
    assert wire["retry_after_ms"] == e.retry_after_ms


def test_chaos_hooks_refuse_a_transport_without_them():
    class Bare:
        pass
    for fn in (kill_replica, hang_replica, unhang_replica):
        with pytest.raises(TypeError, match="hook"):
            fn(Bare(), "r0")


# -- the tools ----------------------------------------------------------------

TIMING = ("tokens_per_sec", "ttft_p50_s", "ttft_p99_s", "itl_p99_s")


@pytest.mark.parametrize("argv", [
    ["--replicas", "2"],
    ["--replicas", "2", "--prefill-replicas", "1", "--disagg-threshold",
     "40", "--policy", "least-loaded"]], ids=["affinity", "disagg"])
def test_serve_fabric_summary_equals_jax_tool(models, monkeypatch, argv):
    jm, pm = models
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import serve_fabric as jax_tool
    finally:
        sys.path.remove(os.path.join(ROOT, "tools"))
    # both tools build their tiny model from seed 0: conftest's JAX
    # model and its port copy are those weights (built once); the
    # replicas run at depth 1
    monkeypatch.setattr(paddle_tpu.models, "LlamaForCausalLM",
                        lambda cfg: jm)
    jax_br = jsf.build_replicas

    def jax_build(*a, **kw):
        reps = jax_br(*a, async_depth=1, **kw)
        share_jax_fns([r.engine for r in reps])
        return reps
    monkeypatch.setattr(jsf, "build_replicas", jax_build)
    monkeypatch.setattr(serve_fabric, "tiny_model",
                        lambda seed, device=None: pm)
    monkeypatch.setattr(psf.replica, "build_replicas", functools.partial(
        psf.replica.build_replicas, async_depth=1))
    want = jax_tool.main(argv)
    got = serve_fabric.main(argv + ["--device", "cpu"])
    assert got["ok"] and got["tokens"] == 66
    for k in TIMING:
        assert isinstance(got.pop(k), float) and want.pop(k) is not None
    assert got == want


def test_tools_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (serve_fabric.main, load_test.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["--replicas", "1"] if main is serve_fabric.main
                 else ["--smoke"])


def test_load_test_smoke_in_process():
    out = load_test.main(["--smoke", "--device", "cpu"])
    assert out["errors"] == []
    assert out["ok"]
    assert out["completed"] >= 1 and out["rejects"] >= 1
    assert out["shed"]["shed"]
    assert out["breaker_trips"] >= 1
    assert out["hang"]["tripped"] and out["hang"]["readmitted"]
    assert out["hang"]["breaker"] == "closed"
    assert out["ttft_p99_s"] <= out["ttft_ceiling_s"]
    assert out["traces"] > 0


# -- threads (D12) and the client's imports ---------------------------------

def _on_thread(fn):
    box = {}

    def work():
        try:
            box["r"] = fn()
        except BaseException as e:      # noqa: BLE001 — re-raised below
            box["e"] = e
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=WAIT_S)
    assert not t.is_alive()
    if "e" in box:
        raise box["e"]
    return box.get("r")


def test_engine_verbs_work_from_a_fresh_thread(model):
    """An engine built under inference mode holds inference tensors; a
    front door's drive thread or a breaker's worker thread runs in
    normal mode (the mode is thread-local). Each verb sets its own."""
    rs = np.random.RandomState(6)
    prompt = rs.randint(0, 256, (2 * PAGE + 3,)).astype(np.int32)
    kw = dict(max_batch=2, page_size=PAGE, max_len=64, prefix_cache=True,
              generation_config=GenerationConfig(max_new_tokens=6))
    with torch.inference_mode():
        src = ContinuousBatchingEngine(model, **kw)
        dst = ContinuousBatchingEngine(model, **kw)
    assert src.pools[0][0].is_inference()
    rid = _on_thread(lambda: src.submit(prompt))
    got = _on_thread(src.run)[rid]
    pay = _on_thread(lambda: src.serialize_pages(prompt))
    assert pay is not None and pay["kv"].shape[3] == 2
    assert len(_on_thread(lambda: dst.adopt_pages(pay))) == 2
    rid2 = _on_thread(lambda: dst.submit(prompt))
    assert _on_thread(dst.step) is not None
    assert _on_thread(lambda: dst.cancel(rid2)) is True
    rid3 = _on_thread(lambda: dst.submit(prompt))
    again = _on_thread(dst.run)[rid3]
    np.testing.assert_array_equal(again, got)
    assert dst.prefix_stats()["prefix_hit_tokens"] >= 2 * PAGE
    dst._check_page_invariants()


def test_client_module_imports_no_torch():
    code = ("import sys\n"
            "from paddle_tpu_torch.serving_fabric.client import "
            "FabricClient\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "print('OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=WAIT_S)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-2000:]
