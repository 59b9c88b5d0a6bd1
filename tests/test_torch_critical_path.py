"""The port's critical-path attribution (``paddle_tpu_torch.analysis.
critical_path``) against the JAX package's on the same trace dicts
(a stdlib module on both sides: the comparison is exact), the tracer's
``pt_trace_ttft_frac`` gauges feeding the sentry's tracing pack, the
``trace_report`` tool, and the load test's smoke leg attributing >= 95%
of each traced request's TTFT to named hops."""

import importlib.util
import json
import os
import time

import pytest

from paddle_tpu.analysis import critical_path as jcp
from paddle_tpu_torch.analysis import critical_path as cp
from paddle_tpu_torch.observability.tracing import TRACER, Tracer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_fixture():
    """``_mk_trace`` of the JAX package's tracing tests: one hand-timed
    trace (TTFT 1.0 s split queue / prefill / decode / admission /
    dispatch)."""
    spec = importlib.util.spec_from_file_location(
        "jax_tracing_fixtures", os.path.join(ROOT, "tests",
                                             "test_tracing.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._mk_trace


_mk_trace = _jax_fixture()


def _fixture_traces():
    tr = Tracer().enable()
    t0 = time.time() - 120.0
    for i, q in enumerate((0.60, 0.30, 0.05)):
        _mk_trace(tr, t0 + 10.0 * i, queue_s=q)
    out = tr.take_completed()
    # a retried request: a second breaker attempt, an unfinished span
    # and an orphan (its parent lost with a replica)
    t = json.loads(json.dumps(out[0]))
    sp = dict(t["spans"][-1], span_id="x1", name="breaker::attempt",
              start=t["spans"][-1]["start"] + 0.1, end=None, tags={})
    orphan = dict(sp, span_id="x2", parent_id="lost",
                  name="replica::decode", end=sp["start"] + 0.05)
    t["spans"] += [sp, orphan]
    return out + [t]


@pytest.fixture(scope="module")
def smoke_traces():
    """The port's own stitched traces: the load test's smoke wave on the
    CPU (front door, fabric, breaker, two replicas)."""
    from paddle_tpu_torch.tools import load_test
    seen = []
    real = load_test.attributed_shares

    def keep(traces):
        seen.extend(traces)
        return real(traces)
    load_test.attributed_shares = keep
    try:
        out = load_test.smoke(device="cpu")
    finally:
        load_test.attributed_shares = real
    return out, seen


def _same(a, b):
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


def test_hops_are_jax_s():
    assert cp.HOPS == jcp.HOPS


@pytest.mark.parametrize("which", ["jax_fixtures", "port_smoke"])
def test_attribution_equals_jax(which, smoke_traces):
    traces = _fixture_traces() if which == "jax_fixtures" \
        else smoke_traces[1]
    assert traces
    for t in traces:
        _same(cp.attribute_trace(t), jcp.attribute_trace(t))
        _same(cp.chrome_trace(t), jcp.chrome_trace(t))
        assert cp.format_span_tree(t) == jcp.format_span_tree(t)
        assert cp.span_depths(t) == jcp.span_depths(t)
    _same(cp.aggregate(traces), jcp.aggregate(traces))
    assert cp.format_table(cp.aggregate(traces)) == \
        jcp.format_table(jcp.aggregate(traces))


def test_fixture_attribution_is_exact():
    t = _fixture_traces()[0]
    att = cp.attribute_trace(t)
    h = att["ttft_hops"]
    assert att["ttft_s"] == pytest.approx(1.0)
    assert h["queue"] == pytest.approx(0.60, abs=1e-6)
    assert h["prefill"] == pytest.approx(0.20, abs=1e-6)
    assert 1.0 - att["ttft_frac"].get("untracked", 0.0) >= 0.95


def test_smoke_attributes_each_request_to_named_hops(smoke_traces):
    out, traces = smoke_traces
    assert out["ok"], out["errors"]
    assert out["trace_ttft_named_frac_min"] >= 0.95
    for t in traces:
        att = cp.attribute_trace(t)
        if att["ttft_s"]:
            assert 1.0 - att["ttft_frac"].get("untracked", 0.0) >= 0.95


def test_gauges_feed_the_tracing_pack():
    """Completing a queue-heavy trace publishes
    pt_trace_ttft_frac{hop=queue}; tracing_rules() breaches on it with
    the worst trace attached (JAX's closed loop)."""
    from paddle_tpu_torch.observability.metrics import REGISTRY
    from paddle_tpu_torch.observability.sentry import SloSentry
    from paddle_tpu_torch.observability.sentry.rules import tracing_rules
    was = REGISTRY.enabled
    REGISTRY.enable()
    TRACER.enable()
    try:
        _mk_trace(TRACER, time.time() - 60.0, queue_s=0.60)
        g = [e for e in REGISTRY.collect()
             if e["name"] == "pt_trace_ttft_frac"
             and e["labels"].get("hop") == "queue"]
        assert g and g[0]["value"] == pytest.approx(0.60, abs=1e-6)
        sentry = SloSentry(tracing_rules(queue_frac_ceiling=0.5,
                                         breach_for=1, cooldown_s=0.0))
        fired = sentry.tick()
        assert [i.rule for i in fired] == ["trace_ttft_frac_queue"]
        att = fired[0].context.get("attached_traces")
        assert att and att[0]["summary"]["ttft_s"] == pytest.approx(1.0)
    finally:
        TRACER.disable()
        REGISTRY.enabled = was


def test_trace_report_cli_and_chrome_export(tmp_path, capsys):
    from paddle_tpu_torch.tools import trace_report
    d = str(tmp_path / "tr")
    tr = Tracer().enable(dir=d)
    t0 = time.time() - 120.0
    _mk_trace(tr, t0, queue_s=0.60)
    _mk_trace(tr, t0 + 10.0, queue_s=0.30)
    assert len(cp.load_trace_dir(d)) == 2
    chrome = str(tmp_path / "worst.json")
    assert trace_report.main([d, "--worst", "1", "--chrome", chrome]) == 0
    txt = capsys.readouterr().out
    assert "queue" in txt and "trace " in txt
    with open(chrome, encoding="utf-8") as f:
        ct = json.load(f)
    assert any(e["cat"] == "queue" for e in ct["traceEvents"])
    assert trace_report.main([d, "--json"]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert rep["n_traces"] == 2
    assert rep["worst"][0]["ttft_frac"]["queue"] == pytest.approx(
        0.60, abs=1e-6)
    assert trace_report.main([str(tmp_path / "none")]) == 1
