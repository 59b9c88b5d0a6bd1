"""The port's serving fabric against the JAX package's, on the CPU over
the tiny Llama (weights carried from the JAX model):

- ``PrefixDigest``, ``TenantFairPolicy``, ``LoadShedder`` and
  ``Backoff`` make the JAX package's decisions on the same inputs;
- the port and JAX fabrics take the same prompts and carry the same
  weights, and the outputs, each submission's replica (with its budget
  and replay length), the handoffs and the router's counters are equal:
  affinity, least-loaded and round-robin routing, disaggregation at
  ``disagg_threshold_tokens``, a tenant quota, a replica killed mid-run
  (failover with ``replay_prefix``), and the port over ``TcpTransport``
  on localhost against the JAX fabric in process;
- the JAX package's parity anchor and its full matrix (greedy/sampled x
  spec_k 0/3 x prefix off/on; ``slow``) against the port: the fabric
  adds routing, never changes decoding.

The engines run at ``async_depth=1`` (see
``tests/test_torch_engine_policies.py``): at depth 2 JAX's early drains
make what a fabric pass delivers depend on timing."""

import itertools
import random

import numpy as np
import pytest

from paddle_tpu.inference import GenerationConfig as JaxGen
from paddle_tpu.inference.prefix_cache import RadixPrefixCache as JaxTree
from paddle_tpu.serving_fabric import Backoff as JaxBackoff
from paddle_tpu.serving_fabric import InProcTransport as JaxInProc
from paddle_tpu.serving_fabric import LoadShedder as JaxShedder
from paddle_tpu.serving_fabric import Overloaded as JaxOverloaded
from paddle_tpu.serving_fabric import PrefixDigest as JaxDigest
from paddle_tpu.serving_fabric import ServingFabric as JaxFabric
from paddle_tpu.serving_fabric import TenantFairPolicy as JaxFair
from paddle_tpu.serving_fabric import TenantSpec as JaxSpec
from paddle_tpu.serving_fabric import build_replicas as jax_build_replicas
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.inference.prefix_cache import RadixPrefixCache
from paddle_tpu_torch.serving_fabric import (Backoff, InProcTransport,
                                             LoadShedder, Overloaded,
                                             PrefixDigest, ServingFabric,
                                             TcpReplicaServer, TcpTransport,
                                             TenantFairPolicy, TenantSpec,
                                             build_replicas)
from torch_serving_pairs import keep_jax_fns, model_pairs, share_jax_fns

PAGE = 8


@pytest.fixture(scope="module")
def models(tiny_llama):
    return model_pairs(tiny_llama, int8=False)["native"]


def _mk(rs, n):
    return rs.randint(0, 512, (n,)).astype(np.int32)


# -- host-only pieces --------------------------------------------------------

def _trees(runs):
    out = []
    for cls in (JaxTree, RadixPrefixCache):
        tree, pages = cls(PAGE), itertools.count(1)
        for toks in runs:
            n = len(toks) // PAGE
            tree.insert(toks[:n * PAGE], [next(pages) for _ in range(n)])
        out.append(tree)
    return out


@pytest.mark.parametrize("cap", [1024, 3])
def test_digest_matches_jax(cap):
    rs = np.random.RandomState(0)
    shared = _mk(rs, PAGE)
    runs = [np.concatenate([shared, _mk(rs, 5 * PAGE)]) for _ in range(3)]
    runs.append(_mk(rs, 2 * PAGE + 3))
    jt, pt_ = _trees(runs)
    jd = JaxDigest.from_cache(jt, max_entries=cap, hit_rate=0.25)
    pd = PrefixDigest.from_cache(pt_, max_entries=cap, hit_rate=0.25)
    assert pd.to_dict() == jd.to_dict()
    fork = runs[0].copy()
    fork[3 * PAGE] += 1
    for q in runs + [fork, runs[1][:2 * PAGE + 1], _mk(rs, 3 * PAGE)]:
        assert pd.match_pages(q) == jd.match_pages(q)
    back = PrefixDigest.from_dict(jd.to_dict())
    assert back.fps == jd.fps and back.hit_rate == 0.25


class _Req:
    def __init__(self, fid, tenant):
        self.fid, self.tenant = fid, tenant


def _fair_trace(fair_cls, spec_cls):
    """Admissions of a scripted queue under weights, a metered tenant
    and a zero-quota tenant: (pick order, admitted, tokens, deferred)."""
    pol = fair_cls({"a": spec_cls(weight=3.0),
                    "b": spec_cls(weight=1.0, rate_per_tick=6.0, burst=12.0),
                    "z": spec_cls(weight=1.0, rate_per_tick=0.0,
                                  burst=0.0)}, starvation_ticks=5)
    rs = np.random.RandomState(3)
    queue = [_Req(i, "abz"[i % 3]) for i in range(30)]
    cost = {r.fid: int(rs.randint(1, 20)) for r in queue}
    order = []
    for _ in range(40):
        pol.tick()
        i = pol.select(queue, lambda r: cost[r.fid])
        if i is None:
            order.append(None)
            continue
        order.append(queue[i].fid)
        pol.note_admitted(queue, i, cost[queue[i].fid])
        del queue[i]
    return order, pol.admitted, pol.admitted_tokens, pol.deferred


def test_tenant_fair_policy_matches_jax():
    want = _fair_trace(JaxFair, JaxSpec)
    assert _fair_trace(TenantFairPolicy, TenantSpec) == want
    assert None in want[0] and want[1]["z"] >= 1


def test_load_shedder_and_backoff_match_jax():
    def trace(shed_cls, over_cls, backoff_cls):
        sh = shed_cls(queue_depth_hi=4, queue_depth_lo=1, queue_cap=9,
                      itl_p99_ceiling_s=0.1, breach_ticks=2,
                      recover_ticks=2)
        out = []
        for depth, itl in ((5, None), (5, None), (0, 0.5), (0, 0.5),
                           (0, 0.01), (0, 0.01), (0, 0.01), (9, None)):
            out.append(sh.observe(depth, {"itl_p99_s": itl}))
            for tenant, w in (("gold", 2.0), ("free", 1.0)):
                try:
                    sh.admit(tenant, w, depth)
                    out.append((tenant, "ok"))
                except over_cls as e:
                    out.append((tenant, e.kind, e.retry_after_ms))
            out.append(sh.defer_cold(300))
        b = backoff_cls(0.05, 1.0, rng=random.Random(4))
        out += [b.delay_s(n, 100.0 if n == 2 else None) for n in range(6)]
        return out, sh.stats()
    assert trace(LoadShedder, Overloaded, Backoff) == trace(
        JaxShedder, JaxOverloaded, JaxBackoff)


# -- the fabric, port against JAX --------------------------------------------

def _logged(cls):
    class Logged(cls):
        """Logs every submission: (replica, fabric id, budget, replay)."""
        log = None

        def submit(self, name, req):
            if self.log is None:
                self.log = []
            self.log.append((name, int(req["rseed"]),
                             int(req["max_new_tokens"]),
                             len(req.get("replay") or ())))
            return super().submit(name, req)
    return Logged


ENGINE_KW = dict(page_size=PAGE, max_len=96, max_batch=2, async_depth=1)


def _fabric(side, model, n=2, roles=None, fair=None, **fab_kw):
    if side == "jax":
        reps = jax_build_replicas(model, n, roles=roles, generation_config=
                                  JaxGen(max_new_tokens=6, do_sample=False),
                                  **ENGINE_KW)
        share_jax_fns([r.engine for r in reps])
        tr = _logged(JaxInProc)(reps)
        fab = JaxFabric(tr, fair=fair and fair(JaxFair, JaxSpec), **fab_kw)
    else:
        reps = build_replicas(model, n, roles=roles, generation_config=
                              GenerationConfig(max_new_tokens=6),
                              **ENGINE_KW)
        tr = _logged(InProcTransport)(reps)
        fab = ServingFabric(tr, fair=fair and fair(TenantFairPolicy,
                                                   TenantSpec), **fab_kw)
    return fab, tr, reps


def _drive(fab, tr, reps, rounds, kill=None):
    """Submit each round's (prompt, tenant) and run it; ``kill`` =
    (replica, passes): that replica dies after so many passes of the
    first round. Returns streams by fabric id, the log, the stats."""
    out = {}
    for i, rnd in enumerate(rounds):
        for p, tenant in rnd:
            fab.submit(p, 6, tenant=tenant)
        if kill is not None and i == 0:
            for _ in range(kill[1]):
                fab.step()
            tr.kill(kill[0])
        out.update({f: np.asarray(v).tolist() for f, v in fab.run().items()})
    engines = [r.engine for r in reps]
    if hasattr(engines[0], "_gather_fn"):
        keep_jax_fns(engines)
    stats = fab.stats()
    stats["pages"] = [(e.pages_exported, e.pages_adopted) for e in engines]
    return out, tr.log, stats


def _family(rs, shared, n):
    return np.concatenate([shared, _mk(rs, n)])


def _rounds(case):
    rs = np.random.RandomState(20)
    shared = _mk(rs, 3 * PAGE)
    if case == "affinity":
        return [[(_family(rs, shared, 4), "default")],
                [(_family(rs, shared, n), "default") for n in (2, 5, 7)]
                + [(_mk(rs, 9), "default")]]
    if case == "disagg":
        return [[(_mk(rs, n), "default") for n in (5, 30, 9, 41, 26)]]
    if case == "tenant_quota":
        return [[(_mk(rs, 6), "capped")]
                + [(_mk(rs, 6 + i), "free") for i in range(3)]]
    return [[(_mk(rs, n), "default") for n in (5, 13, 9, 20, 7)]]


def _quota(fair_cls, spec_cls):
    return fair_cls({"free": spec_cls(weight=1.0),
                     "capped": spec_cls(weight=1.0, rate_per_tick=0.0,
                                        burst=0.0)}, starvation_ticks=4)


CASES = {
    "affinity": dict(policy="affinity"),
    "least-loaded": dict(policy="least-loaded"),
    "round-robin": dict(policy="round-robin"),
    "disagg": dict(policy="affinity", roles=["prefill", "both"],
                   disagg_threshold_tokens=24),
    "tenant_quota": dict(policy="least-loaded", n=1, fair=_quota),
    "failover": dict(policy="least-loaded"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fabric_matches_jax(models, case):
    kill = ("r1", 3) if case == "failover" else None
    got = {side: _drive(*_fabric(side, model, **CASES[case]),
                        _rounds(case), kill)
           for side, model in zip(("jax", "port"), models)}
    assert got["port"] == got["jax"]
    out, log, stats = got["port"]
    assert len(out) == sum(len(r) for r in _rounds(case))
    assert all(len(v) == 6 for v in out.values())
    if case == "affinity":
        assert stats["affinity_hits"] >= 3
    if case == "disagg":
        assert stats["handoffs"] == 3 and stats["handoff_failures"] == 0
        assert stats["pages"] == [(11, 0), (0, 11)]    # 3 + 5 + 3
    if case == "tenant_quota":
        assert stats["tenant_deferred"]["capped"] >= 1
        assert stats["tenant_admitted"] == {"free": 3, "capped": 1}
    if case == "failover":
        assert stats["readmitted"] >= 1
        assert any(replay > 0 for _, _, _, replay in log)
        assert stats["replicas_dead"] == ["r1"]


def test_tcp_fabric_matches_jax_in_process(models):
    """The port's replicas behind TcpReplicaServers on localhost, the
    router over TcpTransport (KV pages cross the JSON wire): the same
    streams, routes and handoffs as the JAX fabric in process."""
    case = CASES["disagg"]
    want = _drive(*_fabric("jax", models[0], **case), _rounds("disagg"))
    reps = build_replicas(models[1], 2, roles=case["roles"],
                          generation_config=GenerationConfig(
                              max_new_tokens=6), **ENGINE_KW)
    servers = [TcpReplicaServer(r).start() for r in reps]
    tr = _logged(TcpTransport)({r.name: (s.host, s.port)
                                for r, s in zip(reps, servers)})
    try:
        fab = ServingFabric(tr, policy=case["policy"],
                            disagg_threshold_tokens=24)
        got = _drive(fab, tr, reps, _rounds("disagg"))
    finally:
        tr.close()
        for s in servers:
            s.stop()
    assert got == want


# -- the parity anchor and matrix (the port's fabric against its engine) ----

def _bare_streams(model, prompts, gc, spec_k=0, prefix_cache=False):
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=PAGE,
                                   max_len=96, generation_config=gc,
                                   spec_k=spec_k, prefix_cache=prefix_cache)
    rids = [eng.submit(p) for p in prompts]
    out = eng.run()
    return [out[r] for r in rids]


def _fabric_streams(model, prompts, gc, spec_k=0, prefix_cache=False):
    reps = build_replicas(model, 1, page_size=PAGE, max_len=96,
                          max_batch=2, generation_config=gc,
                          spec_k=spec_k, prefix_cache=prefix_cache)
    fab = ServingFabric(InProcTransport(reps), policy="round-robin")
    fids = [fab.submit(p, gc.max_new_tokens) for p in prompts]
    out = fab.run()
    return [out[f] for f in fids]


def test_parity_single_replica_passthrough(models):
    rs = np.random.RandomState(10)
    prompts = [_mk(rs, n) for n in (5, 9)]
    gc = GenerationConfig(max_new_tokens=6, do_sample=False, seed=3)
    for b, f in zip(_bare_streams(models[1], prompts, gc),
                    _fabric_streams(models[1], prompts, gc)):
        np.testing.assert_array_equal(b, f)


@pytest.mark.slow
@pytest.mark.parametrize("do_sample", [False, True])
@pytest.mark.parametrize("spec_k", [0, 3])
@pytest.mark.parametrize("prefix_cache", [False, True])
def test_parity_full_matrix(models, do_sample, spec_k, prefix_cache):
    rs = np.random.RandomState(11)
    shared = _mk(rs, PAGE * 2)
    prompts = [np.concatenate([shared, _mk(rs, 4)]), _mk(rs, 9),
               np.concatenate([shared, _mk(rs, 7)])]
    gc = GenerationConfig(max_new_tokens=10, do_sample=do_sample, seed=5)
    for b, f in zip(_bare_streams(models[1], prompts, gc, spec_k,
                                  prefix_cache),
                    _fabric_streams(models[1], prompts, gc, spec_k,
                                    prefix_cache)):
        np.testing.assert_array_equal(b, f)
