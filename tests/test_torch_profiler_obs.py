"""The port's profiler and observability plane against the JAX package's,
on the CPU:

- ``make_scheduler`` gives the JAX state sequence for every schedule;
  the port's ``Profiler`` records its cycles, exports one chrome trace a
  cycle, summarizes under every sort key and times steps as the JAX one
  does; ``trace_device=True`` writes ``torch.profiler``'s chrome trace;
- ``serving_trace`` over the port engine and the JAX engine on one
  greedy workload (prefix cache with a full hit, and chunked prefill)
  records the same span names with the same count per name, each of
  ``SERVING_EVENTS`` among them, and the same tokens;
- the same registry operations render the same Prometheus text and the
  same console table in both packages, and the text parses back;
- ``JSONLExporter``: rotation at ``max_bytes``, the segments kept, a
  torn tail skipped, reload in order, each file loaded equal by both
  packages' loaders; ``PrometheusExporter`` serves ``/metrics``;
- ``GoodputLedger``: buckets that sum to the wall, rollback
  reclassified, both packages on one scripted run;
- a flight-recorder dump has the JAX dump's keys (and its span and
  sample entries theirs), strict JSON with a NaN in it;
- ``observability.enable`` / ``publish`` / ``console`` / ``disable``.

Engines run at ``async_depth=1`` (see
``tests/test_torch_engine_policies.py``)."""

import json
import os
import time
import urllib.request

import numpy as np
import pytest

import paddle_tpu.observability as jobs
from paddle_tpu import profiler as jprof
from paddle_tpu.inference import ContinuousBatchingEngine as JaxEngine
from paddle_tpu.inference import GenerationConfig as JaxGen
from paddle_tpu.observability import exporters as jexp
from paddle_tpu.observability import flight_recorder as jfr
from paddle_tpu.observability.metrics import MetricsRegistry as JaxRegistry
import paddle_tpu_torch.observability as pobs
from paddle_tpu_torch import profiler as pprof
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        GenerationConfig)
from paddle_tpu_torch.observability import exporters as pexp
from paddle_tpu_torch.observability import flight_recorder as pfr
from paddle_tpu_torch.observability.metrics import MetricsRegistry
from torch_serving_pairs import keep_jax_fns, model_pairs, share_jax_fns

PAGE = 8


@pytest.fixture(scope="module")
def models(tiny_llama):
    return model_pairs(tiny_llama, int8=False)["native"]


@pytest.fixture(autouse=True)
def _clean():
    yield
    for obs in (jobs, pobs):
        obs.disable()
        obs.REGISTRY.reset()
        obs.ledger().reset()


# -- the profiler ------------------------------------------------------------

SCHEDULES = [dict(closed=1, ready=1, record=2, repeat=2, skip_first=1),
             dict(closed=0, ready=0, record=1),
             dict(closed=2, ready=0, record=3, repeat=1)]


@pytest.mark.parametrize("kw", SCHEDULES, ids=["skip-repeat", "every",
                                               "once"])
def test_make_scheduler_states_equal_jax(kw):
    js, ps = jprof.make_scheduler(**kw), pprof.make_scheduler(**kw)
    assert [ps(i).name for i in range(14)] == [js(i).name for i in range(14)]
    with pytest.raises(ValueError):
        pprof.make_scheduler(closed=0, ready=0, record=0)


def _cycles(prof, tmp_path):
    """Eight steps with one span each under a closed-1 / record-2 x 2
    schedule: the names each exported cycle holds."""
    exported = []
    p = prof.Profiler(
        scheduler=prof.make_scheduler(closed=1, ready=0, record=2, repeat=2),
        on_trace_ready=lambda pr: exported.append(
            prof.export_chrome_tracing(str(tmp_path))(pr)))
    p.start()
    for step in range(8):
        with prof.RecordEvent(f"op_step{step}"):
            time.sleep(0.001)
        p.step(num_samples=4)
    p.stop()
    out = []
    for path in exported:
        tr = prof.load_profiler_result(path)
        assert all(e["dur"] > 0 and e["ph"] == "X" for e in tr["traceEvents"])
        out.append((sorted(e["name"] for e in tr["traceEvents"]),
                    tr["metadata"]["steps"]))
    return out, p


def test_profiler_cycles_and_chrome_export_equal_jax(tmp_path):
    jax_cycles, _ = _cycles(jprof, tmp_path / "jax")
    port_cycles, p = _cycles(pprof, tmp_path / "port")
    assert port_cycles == jax_cycles
    assert port_cycles[0][0] == ["op_step1", "op_step2"]
    assert "samples/sec" in p.step_info()
    for key in pprof.SortedKeys:
        table = p.summary(sorted_by=key).splitlines()
        assert table[0].startswith("Name") and len(table) == 4


def test_record_event_is_host_only_and_free_when_off():
    assert not pprof._collector.enabled and pprof._flight_sink is None
    with pprof.RecordEvent("nobody_listens"):
        pass
    assert pprof._collector.drain() == []
    ev = pprof.RecordEvent("pair")
    ev.begin()
    ev.end()
    ev.end()                              # a second end is a no-op


def test_trace_device_writes_torch_profiler_chrome_trace(tmp_path):
    import torch
    d = tmp_path / "device"
    p = pprof.Profiler(trace_device=True, device_trace_dir=str(d))
    p.start()
    with pprof.RecordEvent("host_span"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    p.stop()
    files = list(d.glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
    assert [e.name for e in p.result.events] == ["host_span"]
    assert p.result.device_trace_dir == str(d)


def test_benchmark_timer():
    t = pprof.benchmark()
    t.reset()
    assert t.report()["steps"] == 0
    t.begin()
    for _ in range(3):
        time.sleep(0.001)
        t.step(num_samples=2)
    r = t.report()
    assert r["steps"] == 3 and r["ips"] > 0


# -- serving spans -----------------------------------------------------------

def _span_counts(path):
    files = [f for f in os.listdir(path) if f.endswith(".json")]
    assert len(files) == 1, files
    with open(os.path.join(path, files[0])) as f:
        events = json.load(f)["traceEvents"]
    counts = {}
    for e in events:
        counts[e["name"]] = counts.get(e["name"], 0) + 1
    return counts


FEATURES = {"prefix": dict(prefix_cache=True),
            "chunked": dict(chunked_prefill=True, prefill_chunk=16)}


@pytest.mark.parametrize("feat", sorted(FEATURES))
def test_serving_trace_span_counts_equal_jax(models, tmp_path, feat):
    jm, pm = models
    rs = np.random.RandomState(5)
    shared = rs.randint(0, 256, (2 * PAGE,)).astype(np.int32)
    prompts = [np.concatenate([shared, rs.randint(0, 256, (n,)).astype(
        np.int32)]) for n in (3, 9)] + [rs.randint(0, 256, (21,)).astype(
            np.int32)]
    kw = dict(max_batch=2, page_size=PAGE, max_len=64, async_depth=1,
              **FEATURES[feat])
    got = {}
    for side, prof, mk in (
            ("jax", jprof, lambda: JaxEngine(
                jm, generation_config=JaxGen(max_new_tokens=5), **kw)),
            ("port", pprof, lambda: ContinuousBatchingEngine(
                pm, generation_config=GenerationConfig(max_new_tokens=5),
                **kw))):
        eng = mk()
        if side == "jax":
            share_jax_fns([eng])
        with prof.serving_trace(str(tmp_path / side)):
            rids = [eng.submit(p) for p in prompts]
            out = eng.run()
            if feat == "prefix":
                # the first prompt again, whole: a full hit (copy on write)
                again = np.concatenate([prompts[0], out[rids[0]]])
                rids.append(eng.submit(again[:len(again) // PAGE * PAGE]))
                out.update(eng.run())
        if side == "jax":
            keep_jax_fns([eng])
        got[side] = (_span_counts(str(tmp_path / side)),
                     [out[r].tolist() for r in rids])
    assert got["port"] == got["jax"]
    counts = got["port"][0]
    assert set(pprof.SERVING_EVENTS) <= set(counts)
    assert tuple(pprof.SERVING_EVENTS) == tuple(jprof.SERVING_EVENTS)


# -- exporters ---------------------------------------------------------------

def _fill(reg):
    reg.enable()
    reg.counter("t_rt_total", "requests").inc(3, job='a"b', shard="x,y")
    reg.counter("t_rt_total", "requests").inc(2, job="c")
    reg.gauge("t_rt_g", "a gauge", "s").set(2.5)
    reg.gauge("t_rt_g", "a gauge", "s").set(7, replica="r1")
    h = reg.histogram("t_rt_h", "a histogram", "s", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 0.7, 3.0):
        h.observe(v)
    h.observe(0.2, engine="e0")
    reg.histogram("t_rt_empty", "never observed")
    return reg.collect()


def test_prometheus_and_console_text_equal_jax():
    jsnap, psnap = _fill(JaxRegistry()), _fill(MetricsRegistry())
    text = pexp.render_prometheus(psnap)
    assert text == jexp.render_prometheus(jsnap)
    assert pexp.parse_prometheus(text) == jexp.parse_prometheus(text)
    parsed = pexp.parse_prometheus(text)
    assert parsed["t_rt_total"][(("job", 'a"b'), ("shard", "x,y"))] == 3.0
    assert parsed["t_rt_h_count"][()] == 4.0
    assert pexp.ConsoleSummary().export(psnap) == \
        jexp.ConsoleSummary().export(jsnap)


def test_prometheus_http_endpoint():
    reg = MetricsRegistry()
    reg.enable()
    reg.gauge("t_http_g").set(42)
    ex = pexp.PrometheusExporter(http_port=0)
    try:
        ex.export(reg.collect())
        with urllib.request.urlopen(
                f"http://127.0.0.1:{ex.port}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert pexp.parse_prometheus(text)["t_http_g"][()] == 42.0
    finally:
        ex.close()


def _snap(i, n=4):
    return [{"name": f"pt_fake_{j}", "type": "gauge", "unit": "",
             "labels": {}, "value": float(i * 10 + j)} for j in range(n)]


def test_jsonl_rotation_torn_tail_and_reload(tmp_path):
    path = str(tmp_path / "m.jsonl")
    exp = pexp.JSONLExporter(path, max_bytes=1, keep_segments=2)
    for i in range(5):            # every export past the first rotates
        exp.export(_snap(i))
    exp.close()
    with pytest.raises(ValueError):
        exp.export(_snap(9))      # close is final
    assert [os.path.exists(f"{path}{s}") for s in ("", ".1", ".2", ".3")] \
        == [True, True, True, False]
    with open(path, "a") as f:
        f.write('{"torn')
    for seg in (path, path + ".1", path + ".2"):
        recs = pexp.JSONLExporter.load_jsonl(seg)
        assert recs == jexp.JSONLExporter.load_jsonl(seg)
        assert len(recs) == 4
    allr = pexp.JSONLExporter.load_rotated(path)
    assert allr == jexp.JSONLExporter.load_rotated(path)
    assert [r["value"] for r in allr] == \
        [float(i * 10 + j) for i in (2, 3, 4) for j in range(4)]
    # a torn line that is not the tail is corruption
    with open(path, "a") as f:
        f.write('\n{"name": "ok", "value": 1}\n')
    for loader in (pexp.JSONLExporter, jexp.JSONLExporter):
        with pytest.raises(ValueError):
            loader.load_jsonl(path)


def test_jsonl_rotation_keeps_order_and_drops_old_segments(tmp_path):
    path = str(tmp_path / "m.jsonl")
    for k in (5, 6):              # a previous run kept more segments
        with open(f"{path}.{k}", "w") as f:
            f.write("{}\n")
    exp = pexp.JSONLExporter(path, max_bytes=400, keep_segments=3)
    for i in range(12):
        exp.export([{"name": "pt_seq", "type": "counter", "unit": "",
                     "labels": {}, "value": float(i)}])
    exp.close()
    vals = [r["value"] for r in pexp.JSONLExporter.load_rotated(path)]
    assert vals == sorted(vals) and vals[-1] == 11.0
    assert not os.path.exists(f"{path}.5") and not os.path.exists(
        f"{path}.6")


# -- goodput -----------------------------------------------------------------

def _ledger_script(led):
    led.run_start()
    time.sleep(0.01)
    with led.span("compile"):
        time.sleep(0.02)
        with led.span("checkpoint_save"):
            time.sleep(0.01)
    led.note_checkpoint(4)
    time.sleep(0.02)
    led.note_rollback(4)
    with led.span("restore"):
        time.sleep(0.005)
    led.run_end()
    return led.totals()


def test_goodput_buckets_sum_to_wall_and_match_jax():
    jt = _ledger_script(jobs.GoodputLedger())
    led = pobs.GoodputLedger()
    t0 = time.perf_counter()
    pt = _ledger_script(led)
    wall = time.perf_counter() - t0
    assert set(pt) == set(jt)
    buckets = sum(pt[b] for b in pobs.goodput.BUCKETS)
    assert buckets == pytest.approx(pt["total_s"], rel=1e-9)
    assert abs(buckets - wall) <= 0.01 * wall + 0.002
    assert pt["compile"] >= 0.02 and pt["checkpoint_save"] >= 0.01
    assert pt["rollback_wasted"] >= 0.02 - 1e-3 and led.rollbacks == 1
    for b in pobs.goodput.BUCKETS:   # the same attribution, host timing
        assert (pt[b] > 0) == (jt[b] > 0), b
    with pytest.raises(ValueError):
        with led.span("nope"):
            pass


# -- flight recorder ---------------------------------------------------------

def _dump(obs, prof, fr, path):
    obs.REGISTRY.reset()
    rec = fr.FlightRecorder(dir=str(path))
    rec.start()
    try:
        obs.REGISTRY.gauge("pt_loss", "loss").set(float("nan"))
        obs.REGISTRY.counter("pt_steps_total", "steps").inc(3)
        with prof.RecordEvent("flight_span"):
            pass
        out = rec.dump("test", extra={"why": float("inf")})
    finally:
        rec.stop()
    with open(out) as f:
        return json.load(f)        # strict JSON: NaN became a string


def test_flight_dump_has_the_jax_keys(tmp_path):
    jd = _dump(jobs, jprof, jfr, tmp_path / "jax")
    pd = _dump(pobs, pprof, pfr, tmp_path / "port")
    assert set(pd) == set(jd)
    assert pd["reason"] == "test" and pd["extra"] == {"why": "inf"}
    assert set(pd["recent_spans"][0]) == set(jd["recent_spans"][0])
    assert [s["name"] for s in pd["recent_spans"]] == ["flight_span"]
    assert set(pd["recent_samples"][0]) == set(jd["recent_samples"][0])
    assert [(s["name"], s["value"]) for s in pd["recent_samples"]] == \
        [(s["name"], s["value"]) for s in jd["recent_samples"]]
    assert set(pd["goodput"]) == set(jd["goodput"])
    assert pprof._flight_sink is None          # stop detached the sink


def test_maybe_dump_only_when_active(tmp_path):
    assert pfr.maybe_dump("nothing") is None
    pobs.enable(flight_dir=str(tmp_path))
    path = pfr.maybe_dump("now")
    assert path is not None and os.path.dirname(path) == str(tmp_path)
    pobs.disable()
    assert pfr.maybe_dump("off") is None


# -- the plane's surface -----------------------------------------------------

class _TrainMetrics:
    loss, tokens_per_sec, mfu, lr, step_time_s = 2.0, 1000.0, 0.3, 1e-4, 0.1


def test_enable_publish_console_disable(tmp_path):
    jsonl, prom = str(tmp_path / "m.jsonl"), str(tmp_path / "m.prom")
    pobs.enable(jsonl_path=jsonl, prom_path=prom, jsonl_max_bytes=10_000)
    pobs.enable(jsonl_path=jsonl)     # replaces, never stacks
    kinds = sorted(type(e).__name__ for e in pobs.attached_exporters())
    assert kinds == ["JSONLExporter", "PrometheusExporter"]
    pobs.observe_train_metrics(_TrainMetrics())
    snap = pobs.publish()
    names = {e["name"] for e in snap}
    assert {"pt_train_loss", "pt_goodput_fraction"} <= names
    assert "pt_train_loss" in pobs.console()
    assert any(r["name"] == "pt_train_loss"
               for r in pobs.JSONLExporter.load_jsonl(jsonl))
    assert "pt_train_mfu" in pobs.parse_prometheus(open(prom).read())
    pobs.disable()
    assert pobs.attached_exporters() == [] and not pobs.REGISTRY.enabled
