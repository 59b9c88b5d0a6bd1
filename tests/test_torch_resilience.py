"""The port's resilience layer against the JAX package's, on the CPU: the
checkpoint storage and its async snapshot, the CheckpointManager's
commit protocol (layout, markers, manifest, plan sidecar, retention,
quarantine on every corruption mode, the startup sweep, retries), the
anomaly guard's verdicts on the same loss streams, the preemption guard,
the step watchdog, the chaos helpers, and one real SIGKILL of a training
subprocess resumed bit for bit. Verdicts, step lists, file names and
restored values are compared exactly.
"""

import hashlib
import json
import os
import signal
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu import checkpoint as jckpt
from paddle_tpu.resilience import AnomalyGuard as JaxGuard
from paddle_tpu.resilience import CheckpointManager as JaxManager
from paddle_tpu.testing import chaos as jchaos
from paddle_tpu_torch import checkpoint as ckpt
from paddle_tpu_torch.distributed.watchdog import (StepWatchdog,
                                                   watchdog_from_env)
from paddle_tpu_torch.resilience import (RESUMABLE_EXIT_CODE, AnomalyGuard,
                                         CheckpointManager, DivergenceError,
                                         PreemptionGuard, TrainingPreempted)
from paddle_tpu_torch.resilience import checkpoint_manager as cm
from paddle_tpu_torch.resilience import reshard
from paddle_tpu_torch.testing import chaos


def tree(v=1.0):
    return {"w": torch.full((8, 8), v), "b": torch.arange(8.0) * v,
            "h": {"e": torch.full((3,), v).bfloat16(),
                  "n": np.asarray(int(v), np.int64)}}


def jtree(v=1.0):
    return {"w": jnp.full((8, 8), v, jnp.float32),
            "b": jnp.arange(8, dtype=jnp.float32) * v,
            "h": {"e": jnp.full((3,), v, jnp.bfloat16),
                  "n": np.asarray(int(v), np.int64)}}


def same(a, b):
    assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert torch.equal(a["h"]["e"], b["h"]["e"])
    assert int(a["h"]["n"]) == int(b["h"]["n"])


def held_bytes(w):
    """The bytes the checkpoint writer's snapshot buffers hold."""
    return sum(b.numel() * b.element_size() for b in w._buffers.values())

# -- storage -------------------------------------------------------------------

def test_storage_round_trip_and_digests(tmp_path):
    t = tree(3.0)
    path = str(tmp_path / "s")
    ckpt.save_state_dict(t, path)
    assert ckpt.is_complete_checkpoint(path)
    out = ckpt.load_state_dict(path, tree(0.0))
    same(out, t)
    assert out["h"]["e"].dtype == torch.bfloat16
    assert isinstance(out["h"]["n"], np.ndarray)
    # the writer hashed what it wrote: the digests are the files' sha256
    dig = ckpt.file_digests(path)
    assert set(dig) == set(os.listdir(path))
    for name, d in dig.items():
        with open(os.path.join(path, name), "rb") as f:
            data = f.read()
        assert d == {"size": len(data),
                     "sha256": hashlib.sha256(data).hexdigest()}


def test_async_snapshot_is_taken_before_save_returns(tmp_path):
    """The port updates state in place: an async save must hold the
    values of the moment it was called, not those the next step writes."""
    t = tree(2.0)
    path = str(tmp_path / "a")
    ckpt.save_state_dict(t, path, async_save=True)
    with torch.no_grad():
        t["w"].add_(100.0)            # the next step's in-place update
        t["h"]["e"].mul_(5)
    ckpt.wait_until_finished()
    same(ckpt.load_state_dict(path, tree(0.0)), tree(2.0))


def test_snapshot_buffers_live_only_between_async_saves(tmp_path):
    """An async save keeps its host copy of the state for the next async
    save; a sync save writes from plain host copies and frees them, and
    so does closing a manager: a closed manager leaves no buffers."""
    w = ckpt.writer()
    w.release()
    t = tree(1.0)
    nbytes = sum(x.numel() * x.element_size()
                 for x in (t["w"], t["b"], t["h"]["e"]))
    ckpt.save_state_dict(t, str(tmp_path / "a"), async_save=True)
    assert held_bytes(w) == nbytes
    ckpt.save_state_dict(t, str(tmp_path / "s"))
    assert held_bytes(w) == 0
    same(ckpt.load_state_dict(str(tmp_path / "s"), tree(0.0)), t)
    mgr = CheckpointManager(str(tmp_path / "m"), save_interval_steps=1,
                            async_save=True)
    mgr.save(1, t)
    assert held_bytes(w) == nbytes
    mgr.close()
    assert held_bytes(w) == 0 and mgr.committed_steps() == [1]


def test_storage_refuses_mismatch_and_meshes(tmp_path):
    path = str(tmp_path / "m")
    ckpt.save_state_dict(tree(1.0), path)
    bad = tree(0.0)
    bad["w"] = torch.zeros(4, 8)
    with pytest.raises(ValueError, match="shape or dtype"):
        ckpt.load_state_dict(path, bad)
    with pytest.raises(ValueError, match="missing"):
        ckpt.load_state_dict(path, {**tree(0.0), "x": torch.zeros(1)})
    # a load onto a mesh's sizes reads the slice the spec table gives
    # the rank at coords (a replicated leaf: whole); a manager under a
    # real plan records it in every save
    from paddle_tpu_torch.distributed.auto_parallel import (ParallelConfig,
                                                            plan_for_config)
    from paddle_tpu_torch.models.llama import LlamaConfig
    got = ckpt.load_state_dict(path, tree(0.0), mesh={"dp": 2},
                               spec_tree={"w": (None, None)},
                               coords={"dp": 1})
    for k, v in tree(1.0).items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
    plan = plan_for_config(LlamaConfig.tiny(), ParallelConfig(dp=2))
    mgr = CheckpointManager(str(tmp_path / "r"), plan=plan)
    mgr.save(1, tree(1.0))
    assert reshard.read_plan(mgr.step_dir(1)).as_dict() == plan.as_dict()
    assert mgr.restore(tree(0.0))[0] == 1


def test_async_write_failure_reraised_at_wait(tmp_path, monkeypatch):
    def boom(path, obj):
        raise OSError("disk gone")
    monkeypatch.setattr(ckpt, "_write_file", boom)
    ckpt.save_state_dict(tree(1.0), str(tmp_path / "f"), async_save=True)
    with pytest.raises(OSError, match="disk gone"):
        ckpt.wait_until_finished()
    ckpt.wait_until_finished()          # reported once, then clear


# -- CheckpointManager against the JAX manager ---------------------------------

def _pair(tmp_path, **kw):
    return (CheckpointManager(str(tmp_path / "port"), **kw),
            JaxManager(str(tmp_path / "jax"), **kw))


def test_manager_layout_markers_and_manifest_match_jax(tmp_path):
    ours, theirs = _pair(tmp_path)
    assert ours.save(10, tree(3.0)) and theirs.save(10, jtree(3.0))
    assert not ours.save(10, tree(3.0))   # committed steps are not rewritten
    assert ours.committed_steps() == theirs.committed_steps() == [10]
    mine, jax_files = (set(os.listdir(m.step_dir(10)))
                       for m in (ours, theirs))
    markers = {"_COMMITTED", "_MANIFEST.json", "_PLAN.json"}
    assert markers <= mine and markers <= jax_files
    for m in (ours, theirs):
        with open(os.path.join(m.step_dir(10), "_MANIFEST.json")) as f:
            man = json.load(f)
        with open(os.path.join(m.step_dir(10), "_COMMITTED")) as f:
            marker = json.load(f)
        with open(os.path.join(m.step_dir(10), "_PLAN.json")) as f:
            plan = json.load(f)
        assert set(man) == {"step", "files"} and man["step"] == 10
        assert all(set(v) == {"size", "sha256"} for v in man["files"].values())
        assert "_PLAN.json" in man["files"]
        assert set(marker) == {"step", "ts", "manifest_sha256"}
        assert plan["implicit_single_device"] is True and plan["plan"] is None
        assert m.verify(10)
    assert set(os.listdir(ours.root)) == set(os.listdir(theirs.root))
    step, out = ours.restore(tree(0.0))
    assert step == 10
    same(out, tree(3.0))


@pytest.mark.parametrize("kw,steps", [
    (dict(keep_last_n=2, keep_every_m=4), range(1, 7)),
    (dict(keep_last_n=1), range(1, 4)),
    (dict(keep_last_n=3, keep_every_m=2), range(1, 10))])
def test_manager_retention_matches_jax(tmp_path, kw, steps):
    ours, theirs = _pair(tmp_path, **kw)
    for s in steps:
        ours.save(s, tree(float(s)))
        theirs.save(s, jtree(float(s)))
    assert ours.committed_steps() == theirs.committed_steps()


@pytest.mark.parametrize("mode", ["flip", "truncate", "delete", "manifest"])
def test_restore_quarantines_corruption_like_jax(tmp_path, mode):
    ours, theirs = _pair(tmp_path, keep_last_n=5)
    for m, t in ((ours, tree), (theirs, jtree)):
        m.save(5, t(5.0))
        m.save(9, t(9.0))
        chaos.corrupt_checkpoint(m.step_dir(9), mode=mode)
        assert not m.verify(9)
    step, out = ours.restore(tree(0.0))
    jstep, _ = theirs.restore(jtree(0.0))
    assert step == jstep == 5
    same(out, tree(5.0))
    assert ours.quarantined() == theirs.quarantined() == ["step_9-corrupt"]
    assert ours.committed_steps() == theirs.committed_steps() == [5]


def test_torn_save_swept_and_skipped_like_jax(tmp_path):
    ours, theirs = _pair(tmp_path, keep_last_n=5)
    for m, t, lib, ch in ((ours, tree, ckpt, chaos),
                          (theirs, jtree, jckpt, jchaos)):
        m.save(5, t(5.0))
        torn = ch.kill_mid_save(m, 9, t(9.0))
        assert os.path.isdir(torn) and not lib.is_complete_checkpoint(torn)
        assert lib.latest_step(m.root) == 5
    again = CheckpointManager(ours.root, keep_last_n=5)
    jagain = JaxManager(theirs.root, keep_last_n=5)
    assert again.committed_steps() == jagain.committed_steps() == [5]
    assert again.quarantined() == jagain.quarantined() \
        == ["step_9-uncommitted"]
    assert again.restore(tree(0.0))[0] == 5
    # a writer's tmp dir left by a SIGKILL mid-write is swept as torn
    os.makedirs(os.path.join(ours.root, f"step_12{ckpt.TMP_TAG}99"))
    with open(os.path.join(ours.root, f"step_12{ckpt.TMP_TAG}99", "x"),
              "wb") as f:
        f.write(b"partial")
    with pytest.warns(RuntimeWarning, match="torn"):
        third = CheckpointManager(ours.root, keep_last_n=5)
    assert any(q.startswith("step_12") and "torn" in q
               for q in third.quarantined())


def test_committed_marker_wins_over_orphan_sidecar(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, tree(5.0))
    with open(os.path.join(str(tmp_path), "step_5.PENDING"), "w") as f:
        f.write("{}")
    assert ckpt.is_complete_checkpoint(mgr.step_dir(5))
    assert ckpt.latest_step(str(tmp_path)) == 5
    again = CheckpointManager(str(tmp_path))
    assert again.committed_steps() == [5] and again.quarantined() == []
    assert not os.path.exists(os.path.join(str(tmp_path), "step_5.PENDING"))


def test_async_save_failure_quarantined_at_finalize(tmp_path, monkeypatch):
    mgr = CheckpointManager(str(tmp_path))
    monkeypatch.setattr(ckpt, "_write_file", lambda path, obj: (_ for _ in (
        )).throw(RuntimeError("write failed")))
    mgr.save(7, tree(7.0), async_save=True)
    with pytest.raises(RuntimeError, match="write failed"):
        mgr.finalize()
    assert mgr._pending is None and mgr.committed_steps() == []
    assert not os.path.exists(mgr.step_dir(7) + ".PENDING")


def test_manager_retries_like_jax(tmp_path):
    ours, theirs = _pair(tmp_path, max_retries=3, backoff_base_s=0.001,
                         backoff_max_s=0.002)
    for m in (ours, theirs):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("transient")
            return "ok"
        assert m._with_retries(flaky) == "ok" and calls["n"] == 3
        with pytest.raises(OSError):
            m._with_retries(lambda: (_ for _ in ()).throw(OSError("always")))
    import random
    delays = list(cm.backoff_delays(1.0, 8.0, 7, rng=random.Random(0)))
    from paddle_tpu.distributed.elastic import backoff_delays
    assert delays == list(backoff_delays(1.0, 8.0, 7, rng=random.Random(0)))


def test_wait_ticks_watchdog_then_goes_silent_on_a_hang():
    w = ckpt.writer()
    w._done.clear()

    class WD:
        ticks = 0
        timeout_s = None

        def tick(self):
            self.ticks += 1
    wd = WD()
    t = threading.Thread(target=lambda: (time.sleep(0.3), w._done.set()))
    t.start()
    ckpt.wait_until_finished(watchdog=wd, poll_s=0.05)
    t.join(timeout=5)
    assert wd.ticks >= 2
    # a hung write: past hang_timeout_s the ticks stop, the watchdog fires
    w._done.clear()
    dog = StepWatchdog(timeout_s=0.1, action="log", poll_interval_s=0.02)
    dog.start()
    try:
        dog.tick()
        waiter = threading.Thread(target=lambda: ckpt.wait_until_finished(
            watchdog=dog, poll_s=0.02, hang_timeout_s=0.15), daemon=True)
        waiter.start()
        deadline = time.time() + 5.0
        while not dog.fired and time.time() < deadline:
            time.sleep(0.02)
        assert dog.fired
    finally:
        w._done.set()
        waiter.join(timeout=5)
        dog.stop()
    assert not waiter.is_alive()


def test_plan_sidecar_refuses_real_axes(tmp_path):
    """The sidecar, which refused a plan with real axes, round-trips one:
    the implicit single-device plan reads back as None, a dp2_tp2 plan
    as itself, its effective axes those of size > 1."""
    from paddle_tpu_torch.distributed.auto_parallel import (ParallelConfig,
                                                            plan_for_config)
    from paddle_tpu_torch.models.llama import LlamaConfig
    d = str(tmp_path)
    reshard.write_plan(d, None, 3)
    assert reshard.read_plan(d) is None
    plan = plan_for_config(LlamaConfig.tiny(), ParallelConfig(dp=2, tp=2))
    reshard.write_plan(d, plan, 3)
    with open(os.path.join(d, reshard.PLAN_NAME)) as f:
        payload = json.load(f)
    assert payload["step"] == 3 and not payload["implicit_single_device"]
    back = reshard.read_plan(d)
    assert back.as_dict() == plan.as_dict()
    assert reshard.effective_axes(back) == {"dp": 2, "tp": 2}
    assert reshard.plans_equivalent(back, plan)
    assert not reshard.plans_equivalent(back, None)


# -- AnomalyGuard: the same verdicts as JAX's on the same loss streams --------

def _spike_stream():
    rs = np.random.RandomState(0)
    return [1.0 + 0.01 * rs.randn() for _ in range(30)] + [100.0, 1.0]


STREAMS = {
    "nan_inf_in_warmup": (dict(policy="skip", warmup_steps=5),
                          [float("nan"), float("inf"), 1.0, 1.1]),
    "spike_after_warmup": (dict(policy="rollback", warmup_steps=10),
                           _spike_stream()),
    "warmup_tolerates_spikes": (dict(policy="rollback", warmup_steps=50),
                                [10.0, 1.0, 40.0, 2.0]),
    "plateau_jitter": (dict(policy="abort", warmup_steps=10),
                       [2.0] * 200 + [2.0 + 1e-6, 3.0]),
    "skip_budget": (dict(policy="skip", max_skips=2), [float("nan")] * 4),
    "rollback_budget": (dict(policy="rollback", max_rollbacks=1),
                        [1.0, float("nan"), float("nan")]),
    "abort": (dict(policy="abort"), [1.0, float("nan")]),
    "windowed": (dict(policy="rollback", warmup_steps=3, check_every=4),
                 [1.0, 1.2, 0.9, 1.1, 1.0, 50.0, 1.0]),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_anomaly_verdicts_match_jax(name):
    kw, losses = STREAMS[name]
    ours, theirs = AnomalyGuard(**kw), JaxGuard(**kw)
    assert [ours.check(v) for v in losses] == [theirs.check(v)
                                               for v in losses]
    for attr in ("skips", "rollbacks", "anomalies", "last_reason", "ewma",
                 "check_every"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert np.array_equal(np.asarray(ours.recent_losses),
                          np.asarray(theirs.recent_losses), equal_nan=True)


def test_divergence_error_and_verdict_counter():
    from paddle_tpu_torch.observability import REGISTRY
    g = AnomalyGuard(policy="rollback", max_rollbacks=1)
    before = {v: g._verdict_counter.value(verdict=v)
              for v in ("rollback", "abort")}
    REGISTRY.enable()
    try:
        assert [g.check(float("nan")), g.check(float("nan"))] == [
            "rollback", "abort"]
    finally:
        REGISTRY.disable()
    for v in ("rollback", "abort"):
        assert g._verdict_counter.value(verdict=v) == before[v] + 1
    with pytest.raises(DivergenceError, match="budget exhausted"):
        g.raise_divergence(12, float("nan"))


# -- PreemptionGuard and the watchdog ------------------------------------------

def test_preemption_guard_contract():
    assert RESUMABLE_EXIT_CODE == 75
    exc = TrainingPreempted(42)
    assert isinstance(exc, SystemExit) and exc.code == 75 and "42" in str(exc)
    with PreemptionGuard(signals=(signal.SIGTERM,)) as guard:
        assert guard.installed and not guard.preempted
        os.kill(os.getpid(), signal.SIGTERM)       # latched, not fatal
        deadline = time.time() + 2.0
        while not guard.preempted and time.time() < deadline:
            time.sleep(0.01)
        assert guard.preempted
    assert not guard.installed
    guard.clear()
    assert not guard.preempted
    g = PreemptionGuard()
    g._handler(signal.SIGINT, None)
    with pytest.raises(KeyboardInterrupt):
        g._handler(signal.SIGINT, None)


def test_step_watchdog_fires_on_a_stall_and_reads_the_env(monkeypatch):
    fired = []
    wd = StepWatchdog(timeout_s=0.1, action="log", poll_interval_s=0.02,
                      on_timeout=fired.append).start()
    try:
        wd.tick()
        deadline = time.time() + 5.0
        while not fired and time.time() < deadline:
            time.sleep(0.02)
        assert wd.fired and fired and fired[0] > 0.1
    finally:
        wd.stop()
    monkeypatch.delenv("PT_STEP_TIMEOUT_S", raising=False)
    assert watchdog_from_env() is None
    monkeypatch.setenv("PT_STEP_TIMEOUT_S", "30")
    wd = watchdog_from_env()
    try:
        assert wd.timeout_s == 30.0 and wd.action == "log"
    finally:
        wd.stop()


# -- chaos helpers ---------------------------------------------------------------

def test_nan_batch_on_tensors_and_arrays():
    b = {"x": torch.ones(2, 3), "ids": torch.arange(4),
         "m": np.zeros((2, 2), np.float32), "n": np.arange(3)}
    out = chaos.nan_batch(b)
    assert torch.isnan(out["x"]).all() and torch.equal(out["ids"], b["ids"])
    assert np.isnan(out["m"]).all() and out["n"] is b["n"]
    out = chaos.nan_batch(b, fields=["ids", "n"])
    assert (out["ids"] == -1).all() and (out["n"] == -1).all()
    assert not torch.isnan(out["x"]).any()
    got = list(chaos.nan_injector([b, b, b], at=1, fields=["x"]))
    assert torch.isnan(got[1]["x"]).all() and not torch.isnan(
        got[2]["x"]).any()


# -- the real SIGKILL: a training subprocess killed after an async save ----------

def _chaos_result(proc, timeout=240):
    out, _ = proc.communicate(timeout=timeout)
    for line in out.decode(errors="replace").splitlines():
        if line.startswith("CHAOS_RESULT "):
            return proc.returncode, json.loads(line[len("CHAOS_RESULT "):])
    return proc.returncode, None


def test_subprocess_sigkill_after_async_save_resumes_bit_exact(tmp_path):
    """``spawn_trainer --device cpu``: an uninterrupted run; a run
    SIGKILLed at step 9 once step 8's async save is durable but not
    committed; a fresh process that resumes it. The torn step 8 is
    skipped by latest_step and quarantined, and the resumed run ends on
    the uninterrupted run's parameters bit for bit."""
    args = ["--save-interval", "4", "--async-save", "--device", "cpu"]
    rc, ref = _chaos_result(chaos.spawn_trainer(
        str(tmp_path / "a"), steps=12, extra_args=args))
    assert rc == 0 and ref is not None and ref["step"] == 12
    root = str(tmp_path / "b")
    rc, res = _chaos_result(chaos.spawn_trainer(
        root, steps=12, extra_args=args + ["--hard-exit-at", "9"]))
    assert rc == -signal.SIGKILL and res is None
    assert ckpt.latest_step(root) == 4
    assert not ckpt.is_complete_checkpoint(os.path.join(root, "step_8"))
    rc, res = _chaos_result(chaos.spawn_trainer(root, steps=12,
                                                extra_args=args))
    assert rc == 0 and res["step"] == 12
    assert res["digest"] == ref["digest"]
    assert res["losses"] == ref["losses"][4:]
    assert CheckpointManager(root).quarantined() == ["step_8-uncommitted"]
