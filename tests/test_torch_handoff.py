"""KV-page handoff of the port's engine (``serialize_pages`` /
``adopt_pages``) against the JAX package's, on the CPU over the tiny
Llama (weights carried from the JAX model) and its int8 twin:

- the port's payload against JAX's for the same donated run: tokens,
  shape, dtype and format equal; native kv within 1e-5 of its largest
  value (the same fp32 K/V in another summation order); int8 codes equal
  but for ±1 at no more than 1e-3 of them (a value within 1e-6 of a
  rounding boundary lands on either side); page scales within 1e-6
  relative (each page's absmax / 127);
- the wire in both directions, native and int8: a payload of either
  framework goes through its own ``payload_to_wire`` (and JSON) into the
  other's ``payload_from_wire`` and ``adopt_pages``, and the adopter then
  decodes the tokens the exporter's framework decodes after adopting the
  same payload;
- the JAX package's ``tests/test_fabric_handoff.py`` cases against the
  port: bit-exact round trip, corrupt payloads rejected without
  mutation, wire reject, overflow, the prefix-cache requirement, an
  unknown prefix, the int8 v1/v2 rules, partial coverage, eviction under
  pressure, and adopted pages serving the identical stream."""

import base64
import json

import numpy as np
import pytest
import torch

from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference import GenerationConfig as JaxGen
from paddle_tpu.serving_fabric import payload_from_wire as jax_from_wire
from paddle_tpu.serving_fabric import payload_to_wire as jax_to_wire
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.serving_fabric import (payload_from_wire,
                                             payload_to_wire)
from torch_serving_pairs import keep_jax_fns, model_pairs, share_jax_fns

PAGE = 8
KINDS = ["native", "int8"]


@pytest.fixture(scope="module")
def models(tiny_llama):
    return model_pairs(tiny_llama)


def _port(model, **kw):
    kw.setdefault("max_batch", 2)
    kw.setdefault("max_len", 96)
    kw.setdefault("prefix_cache", True)
    return ContinuousBatchingEngine(
        model, page_size=PAGE,
        generation_config=GenerationConfig(max_new_tokens=4), **kw)


def _jax(model):
    eng = JaxEngine(model, max_batch=2, page_size=PAGE, max_len=96,
                    generation_config=JaxGen(max_new_tokens=4,
                                             do_sample=False),
                    prefix_cache=True)
    share_jax_fns([eng])
    return eng


def _serve(eng, prompt):
    rid = eng.submit(prompt)
    out = eng.run()[rid]
    if isinstance(eng, JaxEngine):
        keep_jax_fns([eng])
    return np.asarray(out).tolist()


def _snapshot(eng):
    return (sorted(eng._free), eng._prefix.num_pages,
            eng._prefix.num_nodes(), eng._prefix.epoch)


def _run(seed, n):
    return np.random.RandomState(seed).randint(0, 512, (n,)).astype(np.int32)


@pytest.fixture(scope="module")
def jax_exporters(models):
    """{kind: (JAX engine holding run 0, run 0)}: one JAX exporter a kind,
    its tree holding a 3-page run and a partial page."""
    run = _run(0, 3 * PAGE + 5)
    out = {}
    for kind in KINDS:
        eng = _jax(models[kind][0])
        _serve(eng, run)
        out[kind] = eng
    return out, run


def _codes_close(port, ref):
    """int8 codes equal but for ±1 at no more than 1e-3 of them."""
    diff = np.abs(port.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3


@pytest.mark.parametrize("kind", KINDS)
def test_serialize_pages_matches_jax(models, jax_exporters, kind):
    exporters, run = jax_exporters
    want = exporters[kind].serialize_pages(run)
    eng = _port(models[kind][1])
    _serve(eng, run)
    got = eng.serialize_pages(run)
    assert got["fmt"] == want["fmt"] == "pt-kv-pages-v2"
    assert got["page_size"] == want["page_size"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    assert got["shape"] == want["shape"] == [2, 2, 2, 3, PAGE, 32]
    assert got["dtype"] == want["dtype"]
    kv, ref = got["kv"].numpy(), np.asarray(want["kv"])
    if kind == "native":
        np.testing.assert_allclose(kv, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
        assert "scales" not in got
    else:
        _codes_close(kv, ref)
        np.testing.assert_allclose(got["scales"].numpy(), want["scales"],
                                   rtol=1e-6, atol=0)
        assert got["scales_shape"] == want["scales_shape"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_framework_wire(models, jax_exporters, kind, direction):
    """A payload crosses the JSON wire into the other framework's engine,
    which then serves the prompt over the adopted pages (a prefix hit)
    and decodes what the exporter's framework decodes after adopting
    the same payload."""
    jm, pm = models[kind]
    exporters, run = jax_exporters
    prompt = np.concatenate([run[:3 * PAGE], _run(5, 6)])
    if direction == "jax_to_port":
        pay = exporters[kind].serialize_pages(run)
        wire = json.loads(json.dumps(jax_to_wire(pay)))
        back = payload_from_wire(wire)
        same, other = _jax(jm), _port(pm)
    else:
        eng = _port(pm)
        _serve(eng, run)
        pay = eng.serialize_pages(run)
        wire = json.loads(json.dumps(payload_to_wire(pay)))
        back = jax_from_wire(wire)
        same, other = _port(pm), _jax(jm)
    assert back["sha256"] == pay["sha256"]
    assert len(other.adopt_pages(back)) == 3
    assert len(same.adopt_pages(pay)) == 3
    assert _serve(other, prompt) == _serve(same, prompt)
    assert other.prefix_hit_tokens == same.prefix_hit_tokens == 3 * PAGE
    other._check_page_invariants()


# -- the JAX package's handoff cases, against the port ---------------------

@pytest.fixture(scope="module")
def exporter(models):
    """A port engine whose tree holds an 8-page run and a disjoint 2-page
    run (payloads below are prefixes of them)."""
    run_long, run2 = _run(10, 8 * PAGE), _run(11, 2 * PAGE + 3)
    A = _port(models["native"][1], num_pages=14, max_batch=1)
    _serve(A, run_long)
    _serve(A, run2)
    return A, run_long, run2


@pytest.fixture(scope="module")
def adopter(models):
    return _port(models["native"][1])


def test_round_trip_bit_exact(exporter, adopter):
    A, run_long, _ = exporter
    B = adopter
    pay = A.serialize_pages(run_long[:3 * PAGE])
    assert pay["kv"].shape[3] == 3 and len(pay["tokens"]) == 3 * PAGE
    donated = B.adopt_pages(pay)
    assert len(donated) == 3 and B.pages_adopted == 3
    assert B._prefix.match(run_long, touch=False) == 3 * PAGE
    assert all(B._prefix._pages[p].ref == 0 for p in donated)
    B._check_page_invariants()
    pay2 = B.serialize_pages(run_long[:3 * PAGE])
    assert pay2["sha256"] == pay["sha256"]
    np.testing.assert_array_equal(pay2["tokens"], pay["tokens"])
    assert torch.equal(pay2["kv"], pay["kv"])
    free_after = sorted(B._free)
    assert B.adopt_pages(pay) == []
    assert sorted(B._free) == free_after
    B._check_page_invariants()


@pytest.mark.parametrize("corruption", [
    "flip_kv", "truncate_kv", "flip_token", "bad_fmt", "bad_page_size",
    "short_tokens", "bad_dtype", "not_an_array"])
def test_corrupt_payload_rejected_without_mutation(exporter, adopter,
                                                   corruption):
    A, run_long, _ = exporter
    B = adopter
    pay = dict(A.serialize_pages(run_long[:3 * PAGE]))
    if corruption == "flip_kv":
        kv = pay["kv"].clone()
        kv.view(-1)[7] += 1
        pay["kv"] = kv
    elif corruption == "truncate_kv":
        pay["kv"] = pay["kv"][:, :, :, :1]
    elif corruption == "flip_token":
        toks = pay["tokens"].copy()
        toks[0] ^= 1
        pay["tokens"] = toks
    elif corruption == "bad_fmt":
        pay["fmt"] = "pt-kv-pages-v999"
    elif corruption == "bad_page_size":
        pay["page_size"] = PAGE * 2
    elif corruption == "short_tokens":
        pay["tokens"] = pay["tokens"][:PAGE + 3]
    elif corruption == "bad_dtype":
        pay["kv"] = pay["kv"].double()
    else:
        pay["kv"] = pay["kv"].tolist()
    before = _snapshot(B)
    with pytest.raises(ValueError):
        B.adopt_pages(pay)
    assert _snapshot(B) == before
    B._check_page_invariants()


def test_wire_codec_round_trip_and_reject(exporter, adopter):
    A, _, run2 = exporter
    B = adopter
    pay = A.serialize_pages(run2)
    assert pay["kv"].shape[3] == 2
    wire = json.loads(json.dumps(payload_to_wire(pay)))
    back = payload_from_wire(wire)
    assert back["sha256"] == pay["sha256"]
    assert len(B.adopt_pages(back)) == 2
    B._check_page_invariants()
    torn = dict(wire)
    torn["kv_b64"] = torn["kv_b64"][:len(torn["kv_b64"]) // 2]
    before = _snapshot(B)
    with pytest.raises(ValueError):
        B.adopt_pages(payload_from_wire(torn))
    assert _snapshot(B) == before


def test_adopt_rejects_pool_overflow_without_corruption(models, exporter):
    A, run_long, _ = exporter
    pay = A.serialize_pages(run_long)
    B = _port(models["native"][1], num_pages=4, max_batch=1)
    with pytest.raises(RuntimeError, match="cannot hold"):
        B.adopt_pages(pay)
    B._check_page_invariants()


def test_serialize_requires_prefix_cache(models):
    eng = _port(models["native"][1], prefix_cache=False, max_len=64)
    with pytest.raises(RuntimeError, match="prefix_cache"):
        eng.serialize_pages(np.arange(PAGE, dtype=np.int32))
    with pytest.raises(RuntimeError, match="prefix_cache"):
        eng.adopt_pages({})


def test_serialize_unknown_prefix_returns_none(exporter):
    A, _, _ = exporter
    assert A.serialize_pages(
        np.arange(2 * PAGE, dtype=np.int32) + 500) is None


@pytest.fixture(scope="module")
def q_exporter(models):
    run = _run(7, 4 * PAGE)
    Q = _port(models["int8"][1], num_pages=14, max_batch=1)
    _serve(Q, run)
    return Q, run


@pytest.fixture(scope="module")
def q_adopter(models):
    return _port(models["int8"][1])


def test_int8_round_trip_bit_exact_with_scales(q_exporter, q_adopter):
    Q, run = q_exporter
    B = q_adopter
    pay = Q.serialize_pages(run[:3 * PAGE])
    assert pay["fmt"] == "pt-kv-pages-v2" and pay["dtype"] == "int8"
    assert list(pay["scales"].shape) == pay["scales_shape"] == [2, 2, 3]
    assert len(B.adopt_pages(pay)) == 3
    assert B._prefix.match(run, touch=False) == 3 * PAGE
    pay2 = B.serialize_pages(run[:3 * PAGE])
    assert pay2["sha256"] == pay["sha256"]
    assert torch.equal(pay2["kv"], pay["kv"])
    assert torch.equal(pay2["scales"], pay["scales"])
    B._check_page_invariants()


def test_int8_wire_codec_carries_scales(q_exporter, q_adopter):
    Q, run = q_exporter
    B = q_adopter
    pay = Q.serialize_pages(run)
    wire = json.loads(json.dumps(payload_to_wire(pay)))
    assert "scales_b64" in wire
    back = payload_from_wire(wire)
    assert torch.equal(back["scales"], pay["scales"])
    assert back["sha256"] == pay["sha256"]
    B.adopt_pages(back)
    assert B._prefix.match(run, touch=False) == 4 * PAGE
    sc = np.frombuffer(base64.b64decode(wire["scales_b64"]),
                       dtype=np.float32).copy()
    sc[0] *= 1.5
    torn = dict(wire, scales_b64=base64.b64encode(sc.tobytes()).decode())
    before = _snapshot(B)
    with pytest.raises(ValueError, match="checksum"):
        B.adopt_pages(payload_from_wire(torn))
    assert _snapshot(B) == before
    B._check_page_invariants()


def test_int8_rejects_v1_and_native_rejects_scales(exporter, adopter,
                                                   q_exporter, q_adopter):
    Q, run = q_exporter
    B = q_adopter
    A, run_long, _ = exporter
    v1 = dict(A.serialize_pages(run_long[:2 * PAGE]), fmt="pt-kv-pages-v1")
    before = _snapshot(B)
    with pytest.raises(ValueError, match="v1"):
        B.adopt_pages(v1)
    assert _snapshot(B) == before
    N = adopter
    before = _snapshot(N)
    with pytest.raises(ValueError):
        N.adopt_pages(Q.serialize_pages(run[:2 * PAGE]))
    assert _snapshot(N) == before
    B._check_page_invariants()
    N._check_page_invariants()


def test_partial_coverage_frees_duplicate_pages(models):
    rs = np.random.RandomState(2)
    head = rs.randint(0, 256, (PAGE,)).astype(np.int32)
    full = np.concatenate([head, rs.randint(0, 256, (2 * PAGE,))
                           .astype(np.int32)])
    A, B = _port(models["native"][1]), _port(models["native"][1])
    _serve(A, full)
    _serve(B, np.concatenate([head, rs.randint(0, 256, (3,))
                              .astype(np.int32)]))
    assert B._prefix.match(full, touch=False) == PAGE
    free0 = len(B._free)
    assert len(B.adopt_pages(A.serialize_pages(full))) == 2
    assert len(B._free) == free0 - 2
    assert B._prefix.match(full, touch=False) == 3 * PAGE
    B._check_page_invariants()


def test_adopt_under_pressure_triggers_tree_eviction(models):
    rs = np.random.RandomState(3)
    B = _port(models["native"][1], num_pages=6, max_batch=1)
    for _ in range(2):
        _serve(B, rs.randint(0, 256, (2 * PAGE,)).astype(np.int32))
    assert B._prefix.num_pages >= 4 and len(B._free) < 3
    run = rs.randint(0, 256, (3 * PAGE,)).astype(np.int32)
    A = _port(models["native"][1])
    _serve(A, run)
    assert len(B.adopt_pages(A.serialize_pages(run))) == 3
    assert B._prefix.match(run, touch=False) == 3 * PAGE
    B._check_page_invariants()


@pytest.mark.parametrize("kind", KINDS)
def test_adopted_pages_serve_identical_stream(models, kind):
    rs = np.random.RandomState(4)
    prompt = rs.randint(0, 256, (3 * PAGE + 5,)).astype(np.int32)
    A, B = _port(models[kind][1]), _port(models[kind][1])
    ref = _serve(A, prompt)
    B.adopt_pages(A.serialize_pages(prompt))
    out = _serve(B, prompt)
    if kind == "native":
        assert out == ref
    assert B.prefix_hit_tokens >= 3 * PAGE - 1
    B._check_page_invariants()
