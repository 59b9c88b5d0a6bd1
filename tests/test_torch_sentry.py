"""The port's SLO sentry against the JAX package's, on the CPU:

- one scripted series (gauges, a monotonic counter, a histogram, a
  series that goes missing and one that freezes) fed to both packages'
  sentries tick by tick gives the same incidents — rule, kind, value,
  windowed stats and breach windows — for every rule kind (Threshold
  ceiling / floor / delta, EwmaSpike over ``window_mean``, RatioBand,
  Staleness missing and frozen), with hysteresis and cooldown;
- each shipped pack (trainer, serving, fabric, front door, elastic,
  tracing, MoE, default) builds the JAX pack's rules: classes, names,
  metrics, labels, fields, bounds, hysteresis, cooldown, descriptions;
- the engine's tick sites (``step`` and ``run``) and the router's (its
  pass and ``run``) fire the same ITL incident in both packages on one
  tiny greedy run, with the same number of evaluated ticks;
- the port's sentry keeps the JAX contracts: no snapshot with the plane
  off, ``maybe_tick`` a no-op with nothing installed, a rate limit,
  duplicate names refused, a faulty rule skipped, incidents in a JSONL
  that tolerates a torn tail, and a flight dump per incident.

Every engine runs at ``async_depth=1`` (see
``tests/test_torch_engine_policies.py``)."""

import json

import numpy as np
import pytest

import paddle_tpu.observability as jobs
from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference import GenerationConfig as JaxGen
from paddle_tpu.observability import sentry as jsn
from paddle_tpu.observability.metrics import REGISTRY as JREG
from paddle_tpu.serving_fabric import InProcTransport as JaxInProc
from paddle_tpu.serving_fabric import ServingFabric as JaxFabric
from paddle_tpu.serving_fabric import build_replicas as jax_build_replicas
import paddle_tpu_torch.observability as pobs
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.observability import sentry as psn
from paddle_tpu_torch.observability.metrics import REGISTRY as PREG
from paddle_tpu_torch.serving_fabric import (InProcTransport, ServingFabric,
                                             build_replicas)
from torch_serving_pairs import keep_jax_fns, model_pairs, share_jax_fns

PAGE = 8
SIDES = ((jobs, jsn, JREG), (pobs, psn, PREG))


@pytest.fixture(autouse=True)
def _clean():
    for obs, sn, reg in SIDES:
        reg.reset()
        reg.enable()
    yield
    for obs, sn, reg in SIDES:
        sn.uninstall()
        obs.disable()
        reg.reset()
        obs.ledger().reset()


@pytest.fixture(scope="module")
def models(tiny_llama):
    return model_pairs(tiny_llama, int8=False)["native"]


# -- every rule kind on one scripted series ---------------------------------

def _rules(sn):
    return [
        sn.Threshold("ceil", "pt_t_gauge", ceiling=2.0, breach_for=2,
                     cooldown_s=5.0),
        sn.Threshold("floor", "pt_t_gauge", floor=0.5, breach_for=1,
                     cooldown_s=0.0),
        sn.Threshold("rate", "pt_t_count_total", ceiling=3.0, delta=True,
                     breach_for=2, cooldown_s=0.0),
        sn.Threshold("labelled", "pt_t_lab", labels={"k": "b"},
                     ceiling=1.0, breach_for=1, cooldown_s=0.0),
        sn.EwmaSpike("spike", "pt_t_hist_seconds", field="window_mean",
                     spike_ratio=2.0, alpha=0.3, warmup=2, breach_for=2,
                     cooldown_s=0.0),
        sn.RatioBand("band", "pt_t_ratio", baseline=2.0, low=0.5,
                     high=1.5, breach_for=1, cooldown_s=3.0),
        sn.Staleness("missing", "pt_t_sometimes", breach_for=2,
                     cooldown_s=0.0),
        sn.Staleness("frozen", "pt_t_ratio", require_change=True,
                     breach_for=2, cooldown_s=0.0),
        sn.Threshold("p99", "pt_t_hist_seconds", field="p99",
                     ceiling=0.5, breach_for=1, cooldown_s=100.0),
    ]


# (gauge, counter increment, labelled {k: v}, histogram observations,
#  ratio, sometimes present?)
SCRIPT = [
    (1.0, 1, {"a": 5.0, "b": 0.5}, [0.1, 0.1], 2.0, True),
    (3.0, 2, {"a": 5.0, "b": 0.5}, [0.1, 0.12], 2.0, True),
    (3.0, 5, {"a": 0.1, "b": 2.0}, [0.11], 2.5, False),
    (3.0, 9, {"b": 0.2}, [0.1, 0.1, 0.1], 5.0, False),
    (0.2, 13, {"b": 3.0}, [0.5, 0.6], 5.0, False),
    (0.2, 14, {"b": 0.0}, [0.7, 0.9], 5.0, True),
    (2.5, 14, {"b": 4.0}, [], 0.5, True),
    (2.5, 20, {"b": 0.0}, [0.1], 1.0, True),
    (2.6, 30, {"b": 0.0}, [2.0, 2.0], 1.0, False),
    (2.7, 40, {"b": 9.0}, [2.0], 3.0, False),
]


def _drive(sn, reg):
    s = sn.SloSentry(_rules(sn))
    g = reg.gauge("pt_t_gauge", "synthetic")
    c = reg.counter("pt_t_count_total", "synthetic")
    lab = reg.gauge("pt_t_lab", "synthetic")
    h = reg.histogram("pt_t_hist_seconds", "synthetic", "s")
    r = reg.gauge("pt_t_ratio", "synthetic")
    out, prev = [], 0
    for i, (gv, cv, lv, hv, rv, present) in enumerate(SCRIPT):
        g.set(gv)
        c.inc(cv - prev)
        prev = cv
        for k, v in lv.items():
            lab.set(v, k=k)
        for v in hv:
            h.observe(v)
        r.set(rv)
        sm = reg.gauge("pt_t_sometimes", "synthetic")
        if present:
            sm.set(float(i))
        else:
            sm.clear()
        for inc in s.tick(now=float(i)):
            d = inc.to_dict()
            out.append((i, d["rule"], d["kind"], d["metric"], d["labels"],
                        d["severity"], d["value"], d["stats"],
                        d["breach_windows"]))
    return out, s.stats()


def test_scripted_series_same_incidents_for_every_rule_kind():
    jax_out, jax_stats = _drive(jsn, JREG)
    port_out, port_stats = _drive(psn, PREG)
    assert port_out == jax_out
    assert port_stats == jax_stats
    # the script reaches every rule kind
    fired = {row[1] for row in port_out}
    assert fired == {r.name for r in _rules(psn)}, fired


# -- the packs ---------------------------------------------------------------

def _describe(rules):
    return [(type(r).__name__, r.kind, dict(vars(r))) for r in rules]


PACKS = [
    ("trainer_rules", {}),
    ("trainer_rules", {"goodput_floor": 0.7, "drift_band": (0.5, 2.0),
                       "breach_for": 2}),
    ("serving_rules", {}),
    ("serving_rules", {"itl_p99_ceiling_s": 0.1, "ttft_p99_ceiling_s": 5.0,
                       "cooldown_s": 1.0}),
    ("fabric_rules", {}),
    ("fabric_rules", {"replicas": ["r0", "r1"],
                      "replica_itl_p99_ceiling_s": 0.3}),
    ("fabric_rules", {"replicas": ["p", "b"], "replicas_alive_floor": 1.0}),
    ("frontdoor_rules", {}),
    ("frontdoor_rules", {"replicas": ["r0", "r1"],
                         "ttft_p99_ceiling_s": 30.0, "breach_for": 1}),
    ("elastic_rules", {}),
    ("elastic_rules", {"world_size_floor": 4}),
    ("tracing_rules", {}),
    ("moe_rules", {}),
    ("default_rules", {}),
]


@pytest.mark.parametrize("pack,kw", PACKS,
                         ids=[f"{p}-{i}" for i, (p, _) in enumerate(PACKS)])
def test_pack_rules_equal_jax(pack, kw):
    assert _describe(getattr(psn.rules, pack)(**kw)) == \
        _describe(getattr(jsn.rules, pack)(**kw))


def test_rule_validation_matches_jax():
    for sn in (jsn, psn):
        with pytest.raises(ValueError):
            sn.Threshold("x", "m")
        with pytest.raises(ValueError):
            sn.EwmaSpike("x", "m", spike_ratio=1.0)
        with pytest.raises(ValueError):
            sn.RatioBand("x", "m", baseline=1.0, low=2.0, high=1.0)
        with pytest.raises(ValueError):
            sn.Threshold("x", "m", ceiling=1.0, breach_for=0)
        with pytest.raises(ValueError):
            sn.SloSentry([sn.Threshold("x", "m", ceiling=1.0),
                          sn.Threshold("x", "m", floor=1.0)])
        with pytest.raises(TypeError):
            sn.default_rules(itl_p99_ceiling_s=0.1)


# -- the tick sites ----------------------------------------------------------

def _prompts():
    rs = np.random.RandomState(3)
    return [rs.randint(0, 256, (n,)).astype(np.int32) for n in (5, 11, 7)]


def _itl_rule(sn):
    # any inter-token gap breaches: the incident fires at the first tick
    # that sees the engine's ITL p99, once (cooldown)
    return [sn.Threshold("itl", "pt_serving_itl_seconds",
                         labels={"q": "p99"}, ceiling=0.0, breach_for=1,
                         cooldown_s=1e9)]


def test_engine_tick_sites_fire_the_same_itl_incident(models):
    jm, pm = models
    got = {}
    for side, (sn, mk) in {
            "jax": (jsn, lambda: JaxEngine(
                jm, max_batch=2, page_size=PAGE, max_len=64,
                generation_config=JaxGen(max_new_tokens=6),
                async_depth=1)),
            "port": (psn, lambda: ContinuousBatchingEngine(
                pm, max_batch=2, page_size=PAGE, max_len=64,
                generation_config=GenerationConfig(max_new_tokens=6),
                async_depth=1))}.items():
        s = sn.install(sn.SloSentry(_itl_rule(sn)))
        eng = mk()
        if side == "jax":
            share_jax_fns([eng])
        rids = [eng.submit(p) for p in _prompts()]
        out = eng.run()
        if side == "jax":
            keep_jax_fns([eng])
        got[side] = ([out[r].tolist() for r in rids],
                     [(i.rule, i.metric, i.breach_windows)
                      for i in s.incidents], s.ticks)
        sn.uninstall()
    assert got["port"] == got["jax"]
    assert got["port"][1] == [("itl", "pt_serving_itl_seconds", 1)]
    assert got["port"][2] > 1


def test_router_tick_sites_fire_the_same_itl_incident(models):
    jm, pm = models
    got = {}
    for side, (sn, br, inproc, fabric, gen) in {
            "jax": (jsn, jax_build_replicas, JaxInProc, JaxFabric,
                    JaxGen(max_new_tokens=6)),
            "port": (psn, build_replicas, InProcTransport, ServingFabric,
                     GenerationConfig(max_new_tokens=6))}.items():
        reps = br(jm if side == "jax" else pm, 2, page_size=PAGE,
                  max_len=64, max_batch=2, generation_config=gen,
                  async_depth=1)
        if side == "jax":
            share_jax_fns([r.engine for r in reps])
        s = sn.install(sn.SloSentry(sn.fabric_rules(
            replicas=["r0", "r1"], itl_p99_ceiling_s=0.0, breach_for=1,
            cooldown_s=1e9)))
        fab = fabric(inproc(reps), policy="round-robin")
        fids = [fab.submit(p, 6) for p in _prompts()]
        out = fab.run()
        if side == "jax":
            keep_jax_fns([r.engine for r in reps])
        got[side] = ([out[f].tolist() for f in fids],
                     sorted({i.rule for i in s.incidents}), s.ticks)
        sn.uninstall()
    assert got["port"] == got["jax"]
    assert "fabric_itl_p99_ceiling" in got["port"][1]


# -- the port's sentry contracts ---------------------------------------------

def test_disabled_plane_never_snapshots(monkeypatch):
    s = psn.SloSentry([psn.Threshold("r", "pt_t", ceiling=0.0)])
    PREG.disable()
    calls = []
    monkeypatch.setattr(PREG, "collect", lambda: calls.append(1) or [])
    assert s.tick(now=1.0) == [] and psn.maybe_tick() == []
    assert calls == [] and s.ticks == 0


def test_install_maybe_tick_and_rate_limit():
    assert psn.active() is None and psn.maybe_tick() == []
    PREG.gauge("pt_t", "x").set(5.0)
    s = psn.install(psn.SloSentry(
        [psn.Threshold("r", "pt_t", ceiling=1.0, cooldown_s=0.0)],
        min_interval_s=3600.0))
    assert psn.active() is s
    assert [i.rule for i in psn.maybe_tick()] == ["r"]
    assert psn.maybe_tick() == []          # inside the rate limit
    assert s.ticks == 1
    psn.uninstall()
    assert psn.active() is None


def test_faulty_rule_skipped_with_one_warning():
    class Bad(psn.SloRule):
        kind = "bad"

        def check(self, value, state, now):
            raise RuntimeError("boom")
    PREG.gauge("pt_t", "x").set(5.0)
    s = psn.SloSentry([Bad("bad", "pt_t"),
                       psn.Threshold("ok", "pt_t", ceiling=1.0,
                                     cooldown_s=0.0)])
    with pytest.warns(RuntimeWarning, match="bad"):
        assert [i.rule for i in s.tick(now=1.0)] == ["ok"]
    assert [i.rule for i in s.tick(now=2.0)] == ["ok"]


def test_incident_log_torn_tail_and_flight_dump(tmp_path):
    log = tmp_path / "incidents.jsonl"
    pobs.enable(flight_dir=str(tmp_path / "flight"))
    PREG.gauge("pt_t", "x").set(float("nan"))
    PREG.gauge("pt_u", "x").set(5.0)
    s = psn.SloSentry([psn.Threshold("u", "pt_u", ceiling=1.0,
                                     cooldown_s=0.0)],
                      incident_log=str(log), flight_dump=True)
    s.tick(now=1.0)
    s.tick(now=2.0)
    with open(log, "a") as f:
        f.write('{"rule": "torn')
    rows = psn.SloSentry.load_incidents(str(log))
    assert [r["rule"] for r in rows] == ["u", "u"]
    assert all(r["context"]["goodput"] is not None for r in rows)
    dumps = sorted((tmp_path / "flight").glob("flight_*.json"))
    assert len(dumps) == 2
    d = json.loads(dumps[0].read_text())
    assert d["reason"] == "slo_incident:u"
    assert PREG.counter("pt_slo_incidents_total").value(rule="u") == 2.0
