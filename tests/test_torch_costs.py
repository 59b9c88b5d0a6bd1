"""The TuneDB and OpCostDB (``paddle_tpu_torch.ops.kernels.autotune``), the
live cost gauges (``observability.costs.live.CostWatch``), their
publishers (the trainer, the serving engine, ``publish_moe_metrics``)
and the planner's reading of both (the measured floors, ``check_drift``)
against the JAX package's on the CPU: files written by one framework's
classes read the same through the other's, keys and buckets equal, the
gauges' arithmetic equal for the same report numbers, the drift and
calibration verdicts equal.

Tolerances: gauge values and prices exactly, or 1e-12 relative where the
port adds the same terms in another order; the breakdown sums to the
measured step within 1e-12 relative."""

import json
import math
import time

import numpy as np
import pytest
import torch

import paddle_tpu.distributed.auto_parallel.planner as jplanner
import paddle_tpu.observability.metrics as jmetrics
from paddle_tpu.observability.costs import analyzer as janalyzer
from paddle_tpu.observability.costs import live as jlive
from paddle_tpu.ops.pallas import autotune as jtune
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu_torch.distributed.auto_parallel import planner
from paddle_tpu_torch.observability import REGISTRY
from paddle_tpu_torch.observability import costs
from paddle_tpu_torch.ops.kernels import autotune as tune

REL = 1e-12


@pytest.fixture
def registries():
    """Both frameworks' registries, reset and on; off afterwards."""
    regs = (REGISTRY, jmetrics.REGISTRY)
    for r in regs:
        r.reset()
        r.enable()
    yield regs
    for r in regs:
        r.reset()
        r.disable()


def _rows(reg, prefix):
    return {(r["name"], tuple(sorted(r["labels"].items()))): r["value"]
            for r in reg.collect() if r["name"].startswith(prefix)
            and "value" in r}


# -- TuneDB / OpCostDB ---------------------------------------------------------

@pytest.mark.parametrize("n", [1, 127, 128, 129, 4096, 5000])
def test_bucket_and_keys_equal_jax(n):
    assert tune.TuneDB.bucket(n) == jtune.TuneDB.bucket(n)
    kw = dict(sq=n, sk=2 * n, d=128, causal=1)
    assert tune.TuneDB.key("flash_attention", "NVIDIA H100 80GB HBM3",
                           "bfloat16", **kw) == jtune.TuneDB.key(
        "flash_attention", "NVIDIA H100 80GB HBM3", "bfloat16", **kw)
    assert tune.OpCostDB.dot_key(n, 64, 3, "float32", "cpu") == \
        jtune.OpCostDB.dot_key(n, 64, 3, "float32", "cpu")
    assert tune.OpCostDB.graph_key("train_step_k1", "NVIDIA H100") == \
        jtune.OpCostDB.graph_key("train_step_k1", "NVIDIA H100")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_db_files_cross_frameworks(tmp_path, writer):
    """A file one framework's class saves reads the same through the
    other's (TuneDB and OpCostDB), and saving merges over what is
    there."""
    src, dst = (jtune, tune) if writer == "jax" else (tune, jtune)
    path = str(tmp_path / "tune.json")
    db = src.TuneDB(user_path=path)
    key = src.TuneDB.key("paged_decode_crossover", "cpu", "any")
    db.record(key, {"ctx": 640})
    db.save()
    other = src.TuneDB(user_path=path)
    other.record("x|cpu|any|", {"v": 1})
    other.save()
    back = dst.TuneDB(user_path=path)
    assert back.lookup(key) == {"ctx": 640}
    assert back.lookup("x|cpu|any|") == {"v": 1}
    cpath = str(tmp_path / "cost.json")
    cdb = src.OpCostDB(user_path=cpath)
    gk = src.OpCostDB.graph_key("train_step_k1", "cpu")
    cdb.record(gk, {"t_s": 0.5, "dispatch_floor_s": 0.25,
                    "captured_at": "2026-10-18T00:00:00"})
    cdb.save()
    assert dst.OpCostDB(user_path=cpath).lookup(gk)["dispatch_floor_s"] \
        == 0.25
    assert json.load(open(cpath)) == {gk: cdb.lookup(gk)}


def test_corrupt_file_warns_and_env_paths(tmp_path, monkeypatch):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    with pytest.warns(RuntimeWarning, match="corrupt kernel tune DB"):
        assert tune.TuneDB(user_path=str(bad)).lookup("k") is None
    with pytest.warns(RuntimeWarning, match="corrupt op cost DB"):
        assert tune.OpCostDB(user_path=str(bad)).lookup("k") is None
    monkeypatch.setenv("PT_TUNE_DB", str(tmp_path / "t.json"))
    monkeypatch.setenv("PT_OP_COST_DB", str(tmp_path / "c.json"))
    assert tune.get_db().user_path() == str(tmp_path / "t.json")
    assert tune.get_op_cost_db().user_path() == str(tmp_path / "c.json")


def test_no_tpu_entry_ships():
    for name in ("tune_db.json", "op_cost_db.json"):
        with open(f"{tune._HERE}/{name}") as f:
            shipped = json.load(f)
        assert not any("tpu" in k.lower() for k in shipped), name


def test_crossover_reads_the_user_tunedb(tmp_path, monkeypatch):
    """The crossover (the serving engine's default ``attn_crossover``)
    is the TuneDB's ``paged_decode_crossover`` for this device kind,
    else the measured default 0."""
    from paddle_tpu_torch.ops.attention import paged_decode_crossover
    path = str(tmp_path / "tune.json")
    monkeypatch.setenv("PT_TUNE_DB", path)
    tune.get_db().reload()
    try:
        assert paged_decode_crossover() == 0
        db = tune.TuneDB(user_path=path)
        db.record(tune.TuneDB.key("paged_decode_crossover",
                                  costs.current_device_kind(), "any"),
                  {"ctx": 384})
        db.save()
        tune.get_db().reload()
        assert paged_decode_crossover() == 384
        # JAX's lookup reads the same file under its own device kind
        jdb = jtune.TuneDB(user_path=path)
        assert jdb.lookup(jtune.TuneDB.key("paged_decode_crossover", "cpu",
                                           "any")) == {"ctx": 384}
    finally:
        monkeypatch.delenv("PT_TUNE_DB")
        tune.get_db().reload()


def test_block_size_lookups_raise_naming_their_row():
    with pytest.raises(NotImplementedError, match="B.4"):
        tune.flash_attention_config(2048, 2048, 128, "bfloat16", True)
    with pytest.raises(NotImplementedError, match="B.4"):
        tune.fused_vocab_ce_config(8192, 4096, 128256, "bfloat16")


# -- the planner's measured terms ----------------------------------------------

def _cost_db(path, kind, floor=0.004, dots=(), age_days=0.0):
    db = tune.OpCostDB(user_path=str(path))
    cap = time.strftime("%Y-%m-%dT%H:%M:%S",
                        time.localtime(time.time() - age_days * 86400))
    db.record(tune.OpCostDB.graph_key("train_step_k1", kind),
              {"t_s": 2 * floor, "dispatch_floor_s": floor,
               "captured_at": cap})
    for m, k, n, dt, t in dots:
        db.record(tune.OpCostDB.dot_key(m, k, n, dt, kind), {"t_s": t})
    db.save()
    return db


def test_dispatch_floor_and_dot_correction_price_as_jax(tmp_path):
    """price_compiled takes the calibrated dispatch floor and replaces
    each timed matmul shape's analytical time, as JAX's formula does."""
    from paddle_tpu_torch.analysis.collectives import StepCensus
    spec = costs.device_spec()
    db = _cost_db(tmp_path / "c.json", spec.kind, floor=0.004,
                  dots=[(4, 16, 8, "float32", 3e-3)])
    jdb = jtune.OpCostDB(user_path=str(tmp_path / "c.json"))
    assert planner._db_dispatch_floor(db, spec.kind)[0] == \
        jplanner._db_dispatch_floor(jdb, spec.kind)[0] == 0.004
    lin = torch.nn.Linear(16, 8)
    with StepCensus() as c:
        lin(torch.randn(4, 16)).sum().backward()
    plain = planner.price_compiled(c, spec=spec)
    got = planner.price_compiled(c, spec=spec, db=db)
    analytical = 2.0 * 4 * 16 * 8 / spec.peak_flops
    assert got.dispatch_s == 0.004 and plain.dispatch_s == 0.0
    assert got.dot_adjust_s == pytest.approx(3e-3 - analytical, rel=REL)
    want = (max(plain.compute_s + got.dot_adjust_s, 0.0) + plain.comm_s
            + plain.collective_floor_s + 0.004)
    assert got.predicted_step_s == pytest.approx(want, rel=REL)
    assert any("no graph calibration" in n for n in plain.notes) is False
    empty = tune.OpCostDB(user_path=str(tmp_path / "none.json"))
    assert any("no graph calibration" in n for n in
               planner.price_compiled(c, spec=spec, db=empty).notes)


@pytest.mark.parametrize("age_days,ratio", [(0.0, 1.0), (40.0, 1.0),
                                            (0.0, 7.5), (None, 1.0)])
def test_check_drift_equals_jax(tmp_path, registries, age_days, ratio):
    """The drift gauge (as CostWatch publishes it) and the calibration
    age give JAX's verdict."""
    kind = costs.device_spec().kind
    path = tmp_path / "c.json"
    if age_days is not None:
        _cost_db(path, kind, age_days=age_days)
    db = tune.OpCostDB(user_path=str(path))
    jdb = jtune.OpCostDB(user_path=str(path))
    for reg in registries:
        reg.gauge("pt_step_time_predicted_over_measured", "drift").set(
            ratio, component="train")
    got = planner.check_drift(db=db)
    want = jplanner.check_drift(db=jdb)
    assert got["status"] == want["status"]
    assert got["ratios"] == want["ratios"] == {"train": ratio}
    assert len(got["notes"]) == len(want["notes"])


# -- CostWatch -----------------------------------------------------------------

def _reports(flops=3.2e12, nbytes=4.1e10, comm=2.5e9, step=0.061):
    """The same numbers in a JAX CostReport and a port CostReport."""
    jspec = janalyzer.device_spec()
    spec = costs.device_spec()
    kw = dict(total_flops=flops, total_bytes=nbytes,
              total_comm_bytes=comm,
              predicted_compute_s=flops / spec.peak_flops,
              predicted_hbm_s=nbytes / spec.hbm_bw,
              predicted_comm_s=comm / spec.link_bw,
              predicted_step_s=step)
    jrep = janalyzer.CostReport(spec=jspec, ops=[], bound_seconds={},
                                unmodeled={}, **kw)
    return jrep, costs.CostReport(spec=spec, **kw)


@pytest.mark.parametrize("measured,host,k", [
    (0.25, 0.01, 1), (0.25, 0.0, 4), (0.002, 0.0015, 1),
    (0.07, 0.5, 1), (1.5, 0.2, 2)])
def test_costwatch_gauges_equal_jax(registries, measured, host, k):
    jrep, rep = _reports()
    spec = costs.device_spec()
    # the port's device table on both sides: the same arithmetic
    jspec = type(jrep.spec)(**spec.as_dict())
    jw = jlive.CostWatch("train", spec=jspec)
    jw.report = jrep
    w = costs.CostWatch("train", spec=spec)
    w.report = rep
    got = w.publish(measured, host_s=host, steps_per_exec=k)
    want = jw.publish(measured, host_s=host, steps_per_exec=k)
    assert got == want
    assert _rows(registries[0], "pt_") == _rows(registries[1], "pt_")
    b = got["breakdown"]
    assert math.isclose(sum(b.values()), measured, rel_tol=REL)
    assert "pt_exposed_comm_fraction" not in {
        n for n, _ in _rows(registries[0], "pt_")}


def test_costwatch_publishes_nothing_when_off_or_unattached():
    REGISTRY.disable()
    w = costs.CostWatch("serving")
    assert w.publish(0.1) is None and not w.attached
    w.report = _reports()[1]
    assert w.publish(0.1) is None


# -- publishers ----------------------------------------------------------------

def _tiny_trainer():
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.trainer import Trainer
    g = torch.Generator().manual_seed(0)
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu", generator=g)
    return Trainer(m, AdamW(learning_rate=1e-3, parameters=m))


def test_trainer_publishes_step_costs_and_drift(registries):
    tr = _tiny_trainer()
    ids = torch.randint(0, 512, (2, 16), generator=torch.Generator()
                        .manual_seed(1))
    batches = [{"input_ids": ids, "labels": ids}] * 4
    hist = tr.fit(iter(batches), steps=4, log_every=2)
    assert len(hist) == 2
    watch = tr._cost_watch
    assert len(watch._reports) == 1          # one census for one shape
    rows = _rows(REGISTRY, "pt_step_time_breakdown")
    parts = {dict(lb)["bucket"]: v for (_, lb), v in rows.items()
             if dict(lb)["component"] == "train"}
    assert set(parts) == {"compute", "collective", "exposed_comm", "host",
                          "stall"}
    assert math.isclose(sum(parts.values()), hist[-1].step_time_s,
                        rel_tol=REL)
    mfu = _rows(REGISTRY, "pt_model_flops_utilization")
    (key, v), = mfu.items()
    assert dict(key[1]) == {"component": "train"} and v > 0
    assert math.isclose(v, watch.report.total_flops / (
        hist[-1].step_time_s * watch.spec.peak_flops), rel_tol=REL)
    drift = planner.check_drift()
    assert "train" in drift["ratios"] and drift["ratios"]["train"] > 0
    assert _rows(REGISTRY, "pt_cost_census") == {
        ("pt_cost_census_seconds_total", (("component", "train"),)):
        watch.census_s}


def test_trainer_census_window_publishes_nothing(registries):
    """At log_every=1 the census's own window publishes no gauge, so the
    first drift the planner reads is that of a plain step: the census's
    predicted step over the NEXT window's measured step, exactly."""
    tr = _tiny_trainer()
    ids = torch.randint(0, 512, (2, 16), generator=torch.Generator()
                        .manual_seed(1))
    seen = []

    def snap(m):
        seen.append(_rows(REGISTRY, "pt_step_time"))

    hist = tr.fit(iter([{"input_ids": ids, "labels": ids}] * 3), steps=3,
                  log_every=1, on_metrics=snap)
    assert len(hist) == 3 and seen[0] == {}
    key = ("pt_step_time_predicted_over_measured",
           (("component", "train"),))
    pred = tr._cost_watch.report.predicted_step_s
    for i in (1, 2):
        assert seen[i][key] == pred / hist[i].step_time_s
        parts = [v for (n, lb), v in seen[i].items()
                 if n == "pt_step_time_breakdown"]
        assert math.isclose(sum(parts), hist[i].step_time_s, rel_tol=REL)
    assert planner.check_drift()["ratios"]["train"] == seen[2][key]


def test_trainer_takes_no_census_with_the_registry_off():
    REGISTRY.disable()
    tr = _tiny_trainer()
    ids = torch.zeros((2, 16), dtype=torch.long)
    tr.fit(iter([{"input_ids": ids, "labels": ids}] * 2), steps=2,
           log_every=1)
    assert tr._cost_watch is None


def test_engine_publishes_serving_costs(registries, tiny_llama):
    from torch_serving_pairs import feature_engine, model_pairs
    pm = model_pairs(tiny_llama, int8=False)["native"][1]
    eng = feature_engine(pm, decode_block=2)
    rs = np.random.RandomState(4)
    for _ in range(3):
        eng.submit(rs.randint(0, 512, (9,)))
    eng.run()
    assert eng._cost_watch is not None and eng._cost_watch.attached
    assert len(eng._drain_stamps) >= 3
    got = _rows(REGISTRY, "pt_step_time_breakdown")
    parts = [v for (_, lb), v in got.items()
             if dict(lb)["component"] == "serving"]
    assert len(parts) == 5 and all(v >= 0 for v in parts)
    assert ("pt_step_time_predicted_over_measured",
            (("component", "serving"),)) in _rows(REGISTRY, "pt_step")
    watch = eng._cost_watch
    assert watch.censuses == len(watch._reports) >= 1
    assert _rows(REGISTRY, "pt_cost_census")[
        ("pt_cost_census_seconds_total",
         (("component", "serving"),))] == watch.census_s > 0


def test_engine_without_cost_census_takes_none(registries, tiny_llama):
    """cost_census=False: no block runs under a census, so nothing is
    published for the engine's costs and no census seconds count."""
    from torch_serving_pairs import feature_engine, model_pairs
    pm = model_pairs(tiny_llama, int8=False)["native"][1]
    eng = feature_engine(pm, decode_block=2, cost_census=False)
    rs = np.random.RandomState(4)
    for _ in range(3):
        eng.submit(rs.randint(0, 512, (9,)))
    eng.run()
    assert not eng._cost_watch.attached and eng._cost_watch.censuses == 0
    assert len(eng._drain_stamps) >= 3
    assert _rows(REGISTRY, "pt_cost_census") == {}
    assert not any(dict(lb).get("component") == "serving"
                   for (_, lb) in _rows(REGISTRY, "pt_step_time"))


def test_publish_moe_metrics_equals_jax(registries):
    from paddle_tpu_torch.parallel.moe import (publish_moe_metrics,
                                               routing_stats)
    rs = np.random.RandomState(2)
    logits = rs.normal(0, 1, (64, 8)).astype(np.float32)
    aux, z, counts = routing_stats(torch.tensor(logits), 2)
    ja, jz, jc = jmoe.routing_stats(logits, 2)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jc))
    for _ in range(2):       # counters accumulate across publications
        publish_moe_metrics(aux_loss=aux, router_z=z, expert_counts=counts)
        jmoe.publish_moe_metrics(aux_loss=ja, router_z=jz,
                                 expert_counts=jc)
    got, want = _rows(REGISTRY, "pt_moe"), _rows(jmetrics.REGISTRY,
                                                 "pt_moe")
    assert got.keys() == want.keys() and len(got) == 8 + 4
    for key in got:
        assert got[key] == pytest.approx(want[key], rel=1e-6), key


def test_probe_writes_jax_keys_on_the_cpu(tmp_path):
    from paddle_tpu_torch.tools import op_cost_probe
    path = str(tmp_path / "c.json")
    out = op_cost_probe.main(["--calibrate", "--device", "cpu", "--db",
                              path, "--rounds", "1", "--iters", "1"])
    assert out["device_kind"] == "cpu"
    jdb = jtune.OpCostDB(user_path=path)
    rec = jdb.lookup(jtune.OpCostDB.graph_key("train_step_k1", "cpu"))
    assert 0 < rec["dispatch_floor_s"] <= rec["t_s"] and rec["flops"] > 0
    dots = [k for k in out["recorded"] if k.startswith("dot|cpu|float32|")]
    assert len(dots) == 3 and all(jdb.lookup(k)["t_s"] > 0 for k in dots)
    assert planner._db_dispatch_floor(tune.OpCostDB(user_path=path),
                                      "cpu")[0] == rec["dispatch_floor_s"]


_PIN_CHECK = """
import gc, sys, weakref
import torch
gc.disable()
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from paddle_tpu_torch.observability import REGISTRY
from paddle_tpu_torch.optimizer import AdamW
from paddle_tpu_torch.trainer import Trainer
assert "torch._dynamo" not in sys.modules
REGISTRY.enable()
def run():
    m = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    tr = Trainer(m, AdamW(learning_rate=1e-3, parameters=m))
    ids = torch.zeros((2, 16), dtype=torch.long)
    tr.fit(iter([{"input_ids": ids, "labels": ids}] * 2), 2, log_every=1)
    assert tr._cost_watch.attached
    return weakref.ref(m)
ref = run()
print("PINNED" if ref() is not None else "FREED")
"""


def test_first_census_pins_no_caller_frame():
    """The first census of a process imports torch._dynamo, whose import
    leaves a traceback cycle; it must not pin the trainer's frames (and
    so its model) until a full collection. A fresh interpreter with the
    collector off: the model is freed when the trainer goes."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _PIN_CHECK], cwd=root,
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=root))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FREED"
