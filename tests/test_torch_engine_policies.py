"""The port engine's dense/paged crossover, admission policies and
observability hooks against the JAX package's, on the CPU over the tiny
Llama (weights carried from the JAX model):

- the dense route (``paged_decode_dense``) against JAX's
  ``paged_decode_xla`` within 1e-5 (the same fp32 attention in another
  summation order), native and int8 pools;
- the crossover cases of ``tests/test_serving_crossover.py`` against the
  port, each with ``attn_path_ticks`` and the tokens equal to the JAX
  engine's over the same run;
- ``SLOAdmissionPolicy`` with latency stats injected on both sides:
  the same deferrals, admission order and victim choices as the JAX
  engine, and the same tokens;
- after the same run, ``publish_metrics()`` of a named port engine has
  the JAX engine's ``pt_serving_*`` / ``pt_spec_*`` series, labels and
  values (wall-clock percentiles excluded), and a traced request yields
  the same span names and parent links.

Every engine here runs at ``async_depth=1``: JAX drains an in-flight
block early when its result has landed, so at depth 2 when a token is
emitted depends on timing on either side."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference import GenerationConfig as JaxGen
from paddle_tpu.inference.admission import \
    SLOAdmissionPolicy as JaxSLOPolicy
from paddle_tpu.observability.metrics import REGISTRY as JAX_REG
from paddle_tpu.observability.tracing import Tracer as JaxTracer
from paddle_tpu.ops.pallas.paged_attention import paged_decode_xla
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.inference.admission import SLOAdmissionPolicy
from paddle_tpu_torch.observability import REGISTRY as PORT_REG
from paddle_tpu_torch.observability import Tracer
from paddle_tpu_torch.ops.attention import (paged_decode_crossover,
                                            paged_decode_dense)
from torch_serving_pairs import keep_jax_fns, model_pairs, share_jax_fns

PAGE = 8
TOL = 1e-5


@pytest.fixture(scope="module")
def models(tiny_llama):
    return model_pairs(tiny_llama)


def _engines(jm, pm, new_tokens, **kw):
    kw.setdefault("async_depth", 1)
    jax_eng = JaxEngine(jm, generation_config=JaxGen(
        max_new_tokens=new_tokens, do_sample=False), **kw)
    share_jax_fns([jax_eng])
    port_eng = ContinuousBatchingEngine(
        pm, generation_config=GenerationConfig(max_new_tokens=new_tokens),
        **kw)
    return jax_eng, port_eng


def _serve(eng, prompts, **submit_kw):
    rids = [eng.submit(p, **submit_kw) for p in prompts]
    out = eng.run()
    if isinstance(eng, JaxEngine):
        keep_jax_fns([eng])
    return [np.asarray(out[r]).tolist() for r in rids]


# -- the dense route and the crossover --------------------------------------

@pytest.mark.parametrize("quant", [False, True])
def test_dense_route_matches_paged_decode_xla(quant):
    rs = np.random.RandomState(0)
    B, H, H_kv, D, P = 3, 8, 2, 32, 12
    q = rs.randn(B, H, D).astype(np.float32)
    kp, vp = (rs.randn(H_kv, P, PAGE, D).astype(np.float32)
              for _ in range(2))
    sc = {}
    if quant:
        kp, vp = (np.clip(np.round(t * 40), -127, 127).astype(np.int8)
                  for t in (kp, vp))
        sc = {"k_scales": rs.rand(P).astype(np.float32) / 50,
              "v_scales": rs.rand(P).astype(np.float32) / 50}
    tables = np.array([[3, 7, 1, 11], [4, 0, 9, 2], [5, 6, 8, 10]],
                      np.int32)
    lens = np.array([0, 13, 31], np.int32)
    want = paged_decode_xla(jnp.asarray(q), jnp.asarray(kp),
                            jnp.asarray(vp), jnp.asarray(tables),
                            jnp.asarray(lens),
                            **{k: jnp.asarray(v) for k, v in sc.items()})
    got = paged_decode_dense(torch.tensor(q), torch.tensor(kp),
                             torch.tensor(vp), torch.tensor(tables),
                             torch.tensor(lens),
                             **{k: torch.tensor(v) for k, v in sc.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _crossover_run(models, crossover, new_tokens=6):
    """Tokens and attn_path_ticks of the JAX and the port engine over the
    crossover tests' three prompts at ``crossover``."""
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32) for n in (5, 9, 4)]
    out = {}
    for side, eng in zip(("jax", "port"), _engines(
            *models["native"], new_tokens, max_batch=2, page_size=PAGE,
            max_len=64, decode_block=2, attn_crossover=crossover)):
        out[side] = (_serve(eng, prompts), dict(eng.attn_path_ticks), eng)
    assert out["port"][:2] == out["jax"][:2]
    return out["port"]


def test_short_context_routes_dense_no_regression(models):
    out_dense, ticks_dense, _ = _crossover_run(models, 10 ** 6)
    out_paged, ticks_paged, _ = _crossover_run(models, 0)
    assert ticks_dense["paged"] == 0 < ticks_dense["dense"]
    assert ticks_paged["dense"] == 0 < ticks_paged["paged"]
    assert out_dense == out_paged


def test_default_crossover_is_the_ports_measured_one(models):
    """With no knob the engine takes ``paged_decode_crossover()``, the
    crossover measured on the H100 (ROADMAP.md A.8.7), and routes by the
    JAX rule: the JAX engine given the same crossover ticks alike."""
    _, ticks, _ = _crossover_run(models, paged_decode_crossover())
    eng = ContinuousBatchingEngine(models["native"][1], max_batch=2,
                                   page_size=PAGE, max_len=64)
    assert eng.attn_crossover == paged_decode_crossover()
    assert sum(ticks.values()) > 0


def test_crossover_flips_mid_request(models):
    out_flip, ticks, eng = _crossover_run(models, 12, new_tokens=8)
    out_paged, _, _ = _crossover_run(models, 0, new_tokens=8)
    assert ticks["dense"] > 0 and ticks["paged"] > 0
    assert eng.stats()["attn_dense_ticks"] == ticks["dense"]
    assert out_flip == out_paged


# -- admission policies ------------------------------------------------------

def _recording(policy_cls):
    class Recording(policy_cls):
        """Logs each decision: ("defer",), ("admit", rid) and
        ("victim", candidates, slot)."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.log = []

        def select(self, queue, uncached_of, lat):
            i = super().select(queue, uncached_of, lat)
            if i is None:
                self.log.append(("defer",))
            return i

        def note_admitted(self, queue, chosen):
            self.log.append(("admit", queue[chosen].rid))
            super().note_admitted(queue, chosen)

        def choose_victim(self, candidates):
            slot = super().choose_victim(candidates)
            self.log.append(("victim", sorted(
                (v.slot, v.rid, v.progress, v.private_pages,
                 v.shared_pages) for v in candidates), slot))
            return slot
    return Recording


def _policy_engines(models, new_tokens, policy_kw, **kw):
    pols = (_recording(JaxSLOPolicy)(**policy_kw),
            _recording(SLOAdmissionPolicy)(**policy_kw))
    engs = _engines(*models["native"], new_tokens, page_size=PAGE,
                    prefix_cache=True, **kw)
    for e, p in zip(engs, pols):
        e._admission = p
    return engs, pols


def test_slo_policy_defers_and_admits_like_jax(models):
    """An ITL breach injected on both sides: cheap prefix hits are
    admitted first, the long cold prompts wait until the starvation
    bound forces them through, in the JAX engine's order."""
    rs = np.random.RandomState(9)
    shared = rs.randint(0, 512, (2 * PAGE,)).astype(np.int32)
    seed = np.concatenate([shared, rs.randint(0, 512, (1,))])
    cold = [rs.randint(0, 512, (3 * PAGE,)).astype(np.int32)
            for _ in range(2)]
    warm = [np.concatenate([shared, rs.randint(0, 512, (n,))]).astype(
        np.int32) for n in (2, 3)]
    engs, pols = _policy_engines(
        models, 4, dict(itl_p99_target_s=0.05, defer_uncached_tokens=8,
                        starvation_ticks=3),
        max_batch=1, max_len=8 * PAGE)
    outs = []
    for e in engs:
        out = _serve(e, [seed])
        e._itl_gaps.extend([0.2] * 64)         # p99 ITL 0.2 s: a breach
        out += _serve(e, [cold[0], warm[0], cold[1], warm[1]])
        e._check_page_invariants()
        outs.append(out)
    assert outs[0] == outs[1]
    assert pols[1].log == pols[0].log
    assert pols[1].deferrals == pols[0].deferrals > 0
    admits = [x[1] for x in pols[1].log if x[0] == "admit"]
    assert admits[:3] == [0, 2, 4]             # seed, then both warm ones


def test_slo_policy_victim_choice_like_jax(models):
    """A pool too small for two long generations over a shared prefix:
    recompute preemption picks the policy's victim, as the JAX engine
    does, and the streams stay equal."""
    rs = np.random.RandomState(10)
    shared = rs.randint(0, 512, (2 * PAGE,)).astype(np.int32)
    prompts = [np.concatenate([shared, rs.randint(0, 512, (n,))]).astype(
        np.int32) for n in (3, 5)]
    engs, pols = _policy_engines(models, 28, {}, max_batch=2,
                                 max_len=8 * PAGE, num_pages=8)
    outs = []
    for e in engs:
        out = _serve(e, [np.concatenate([shared, [1]]).astype(np.int32)],
                     max_new_tokens=4)
        out += _serve(e, prompts)
        e._check_page_invariants()
        outs.append(out)
    assert outs[0] == outs[1]
    assert engs[1].preemptions == engs[0].preemptions > 0
    victims = [x for x in pols[1].log if x[0] == "victim"]
    assert victims and victims == [x for x in pols[0].log
                                   if x[0] == "victim"]
    assert any(c[4] > 0 for v in victims for c in v[1])   # shared pages


# -- metrics and tracing -----------------------------------------------------

WALL_CLOCK = {"pt_serving_ttft_seconds", "pt_serving_latency_seconds",
              "pt_serving_itl_seconds"}


def _series(reg):
    return sorted((e["name"], tuple(sorted(e["labels"].items())),
                   e.get("value")) for e in reg.collect()
                  if e["name"].startswith(("pt_serving_", "pt_spec_"))
                  and e["name"] not in WALL_CLOCK)


@pytest.mark.parametrize("kind", ["native", "int8"])
def test_publish_metrics_series_equal_jax(models, kind):
    rs = np.random.RandomState(11)
    prompts = [rs.randint(0, 512, (n,)).astype(np.int32)
               for n in (2 * PAGE, 11, 7)]
    regs = (JAX_REG, PORT_REG)
    for r in regs:
        r.reset()
        r.enable()
    try:
        engs = _engines(*models[kind], 5, max_batch=2, page_size=PAGE,
                        max_len=64, decode_block=2, prefix_cache=True,
                        name="r7")
        for e in engs:
            _serve(e, prompts)
            _serve(e, prompts[:1])             # a full hit: copy on write
            e.publish_metrics()
        jax_series, port_series = (_series(r) for r in regs)
    finally:
        for r in regs:
            r.disable()
            r.reset()
    assert port_series == jax_series
    names = {s[0] for s in port_series}
    assert {"pt_serving_tokens_total", "pt_serving_requests_total",
            "pt_serving_cow_copies_total", "pt_serving_prefix_hit_rate",
            "pt_serving_free_pages"} <= names
    assert all(dict(s[1]).get("engine") == "r7" for s in port_series)
    assert (kind == "int8") == ("pt_serving_kv_quant_pool_bytes" in names)


def _span_links(trace):
    names = {s["span_id"]: s["name"] for s in trace["spans"]}
    return sorted((s["name"], names.get(s["parent_id"]))
                  for s in trace["spans"])


def test_traced_request_spans_equal_jax(models):
    rs = np.random.RandomState(12)
    prompt = rs.randint(0, 512, (13,)).astype(np.int32)
    links = []
    for eng, tr in zip(_engines(*models["native"], 5, max_batch=2,
                                page_size=PAGE, max_len=64, decode_block=2),
                       (JaxTracer().enable(), Tracer().enable())):
        eng._tracer = tr
        root = tr.start("test::request")
        _serve(eng, [prompt], trace=root.ctx.to_wire())
        root.end()
        links.append(_span_links(tr.completed[-1]))
    assert links[1] == links[0]
    assert ("replica::prefill", "replica::resident") in links[1]
    assert ("replica::queue", "test::request") in links[1]
