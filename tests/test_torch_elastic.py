"""Elastic scale-in over the port's launcher, against the JAX package's
elastic manager and its acceptance flow (JAX's
``tests/test_elastic_reshard.py::test_e2e_elastic_scale_in_bit_exact``,
run port against port on gloo pods): the ``ElasticManager`` over
``torch.distributed.TCPStore`` passes JAX's membership, backoff and
restart-policy scenarios; a dp2_tp2 pod of 4 ranks checkpointed at step
4 and killed at step 6 resumes on a fresh 2-rank pod on the planner's
pick, bit for bit equal to the reference leg that switched meshes under
``run_elastic`` without a kill; ``Trainer.apply_plan`` at dp2_tp2 trains
like ``shard_layer`` of the same layout and like JAX's unsharded step;
``DataLoader(sharding=)`` yields each rank's slice; ``train_epoch_range``
resumes as JAX's does."""

import json
import os
import random
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from torch_dist_workers import run_ranks
from torch_mesh_refs import (check_step, jax_step, tiny_state, uneven_batch,
                             worker_inputs)

LEG_TIMEOUT_S = 240


def test_backoff_delays_equal_jax():
    """The manager's schedule, the checkpoint manager's copy and JAX's
    draw the same full-jitter delays from the same generator, each
    within its capped window."""
    from paddle_tpu.distributed.elastic import backoff_delays as jbd
    from paddle_tpu_torch.distributed.elastic import backoff_delays
    from paddle_tpu_torch.resilience.checkpoint_manager import \
        backoff_delays as mbd
    for seed in range(3):
        want = list(jbd(1.0, 8.0, 7, rng=random.Random(seed)))
        assert list(backoff_delays(1.0, 8.0, 7,
                                   rng=random.Random(seed))) == want
        assert list(mbd(1.0, 8.0, 7, rng=random.Random(seed))) == want
        for k, d in enumerate(want):
            assert 0.0 <= d <= min(2.0 ** k, 8.0)


def test_reregister_backs_off_until_store_returns():
    from paddle_tpu_torch.distributed.elastic import ElasticManager
    mgr = ElasticManager(np=1, reconnect_backoff_base=0.001,
                         reconnect_backoff_cap=0.01,
                         max_reconnect_attempts=8)

    class FlakyStore:
        def __init__(self, inner, failures):
            self.inner, self.failures = inner, failures

        def add(self, *a):
            if self.failures > 0:
                self.failures -= 1
                raise ConnectionError("coordinator restarting")
            return self.inner.add(*a)

        def __getattr__(self, name):
            return getattr(self.inner, name)

    mgr.store = FlakyStore(mgr.store, failures=3)
    assert mgr._reregister() is True
    assert mgr.reconnects == 1
    mgr.store.failures = 99          # exhausted budget: gives up
    assert mgr._reregister() is False
    mgr.exit()


def test_run_policies_preemption_restart_and_membership():
    """``run``: an orderly preemption resumes without spending the
    restart budget and is bounded on its own; failures restart until
    success. ``run_elastic``: a WorldSizeChanged re-enters at the new
    size after one jittered backoff, never spending the restart budget,
    and gives up past its membership budget."""
    from paddle_tpu_torch.distributed.elastic import (ElasticManager,
                                                      WorldSizeChanged)
    from paddle_tpu_torch.resilience import TrainingPreempted
    em = ElasticManager(np=1, max_restarts=0, heartbeat_timeout=60.0)
    calls = []

    def preempted_once(ordinal):
        calls.append(ordinal)
        if len(calls) == 1:
            raise TrainingPreempted(5)
    assert em.run(preempted_once) is True
    assert calls == [0, 1] and em.preemptions == 1 and em.restarts == 0

    def always_preempted(ordinal):
        raise TrainingPreempted(1)
    em2 = ElasticManager(np=1, max_restarts=0)
    assert em2.run(always_preempted, max_preemptions=3) is False
    assert em2.preemptions == 3
    em3 = ElasticManager(np=1, max_restarts=3)
    seen = []

    def flaky(ordinal):
        seen.append(ordinal)
        if ordinal < 2:
            raise RuntimeError("simulated failure")
    assert em3.run(flaky) is True and seen == [0, 1, 2]

    sizes = iter([8, 4])
    cur = [8]

    def ws_fn():
        try:
            cur[0] = next(sizes)
        except StopIteration:
            pass
        return cur[0]
    legs, slept = [], []

    def train(attempt, ws):
        legs.append((attempt, ws))
        if len(legs) == 1:
            raise WorldSizeChanged(8, 4)
    em4 = ElasticManager(np=1, max_restarts=0, heartbeat_timeout=60.0)
    assert em4.run_elastic(train, world_size_fn=ws_fn, sleep=slept.append)
    assert legs == [(0, 8), (1, 4)] and em4.restarts == 0
    assert len(slept) == 1 and slept[0] >= 0.0
    flip = [0]

    def flip_ws():
        flip[0] += 1
        return 8 if flip[0] % 2 else 4

    def always_changes(attempt, ws):
        raise WorldSizeChanged(ws, 12 - ws)
    assert em4.run_elastic(always_changes, world_size_fn=flip_ws,
                           max_membership_changes=3,
                           sleep=lambda _s: None) is False
    for m in (em, em2, em3, em4):
        m.exit()


def test_membership_watch_probe_and_registration_hole():
    """Heartbeats over the TCPStore: ``watch`` holds with every node
    alive and asks for a restart short of them; the probe raises
    WorldSizeChanged on disagreement; a registration that died between
    its slot and its id does not hide later registrants; a pod's exit
    code maps back to the launching process's exceptions."""
    from paddle_tpu_torch.distributed.elastic import (
        WORLD_SIZE_CHANGED_EXIT, ElasticManager, ElasticStatus,
        WorldSizeChanged, raise_for_pod_exit)
    master = ElasticManager(np=2, heartbeat_interval=0.1,
                            heartbeat_timeout=5.0, node_id="n0")
    worker = ElasticManager(f"127.0.0.1:{master.port}", np=2,
                            heartbeat_interval=0.1, heartbeat_timeout=5.0,
                            node_id="n1")
    master.register()
    assert master.watch() == ElasticStatus.RESTART
    master.membership_probe(expected=1)()
    with pytest.raises(WorldSizeChanged) as ei:
        master.membership_probe(expected=2)()
    assert ei.value.old_size == 2 and ei.value.new_size == 1
    worker.register()
    time.sleep(0.3)
    assert sorted(master.alive_nodes()) == ["n0", "n1"]
    assert master.watch() == ElasticStatus.HOLD
    master.store.add("node_count", 1)        # a slot whose id never came
    late = ElasticManager(f"127.0.0.1:{master.port}", np=3,
                          heartbeat_timeout=30.0, node_id="n2")
    late._register_keys()
    assert set(master.alive_nodes()) == {"n0", "n1", "n2"}
    for m in (late, worker, master):
        m.exit()
    raise_for_pod_exit(0, 4)
    with pytest.raises(WorldSizeChanged):
        raise_for_pod_exit(WORLD_SIZE_CHANGED_EXIT, 4, 2)
    with pytest.raises(SystemExit):
        raise_for_pod_exit(75, 4)
    with pytest.raises(RuntimeError):
        raise_for_pod_exit(1, 4)


def _leg(ckpt_dir, devices, extra):
    from paddle_tpu_torch.testing import chaos
    proc = chaos.spawn_elastic(ckpt_dir, steps=8, virtual_devices=devices,
                               extra_args=["--device", "cpu", *extra])
    try:
        out, _ = proc.communicate(timeout=LEG_TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
    text = out.decode()
    result = None
    for line in text.splitlines():
        if line.startswith("ELASTIC_RESULT "):
            result = json.loads(line[len("ELASTIC_RESULT "):])
    return proc.returncode, result, text


def test_e2e_elastic_scale_in_bit_exact(tmp_path):
    """The acceptance flow on gloo pods of the llama-micro config: a
    dp2_tp2 pod of 4 ranks saves at step 4 and dies (exit 137) at step
    6; a fresh 2-rank pod with ``--plan-auto --candidates
    dp1_tp2,dp2_tp1`` takes the planner's pick and resumes from step 4
    through the resharded restore. The reference leg runs the same mesh
    schedule under ``run_elastic`` (4 ranks, then 2 on the pick) with no
    kill. Every post-switch loss and the final digest are equal bit for
    bit."""
    from paddle_tpu_torch.distributed.auto_parallel import (ParallelConfig,
                                                            plan)
    from paddle_tpu_torch.testing._elastic_train import micro_config
    pick = str(plan(micro_config(), n_devices=2, global_batch=8, seq_len=16,
                    drift="ignore", configs=[
                        ParallelConfig.parse("dp1_tp2"),
                        ParallelConfig.parse("dp2_tp1")]).chosen.config)
    ref_dir, chaos_dir = str(tmp_path / "ref"), str(tmp_path / "chaos")
    with ThreadPoolExecutor(2) as ex:
        ref_f = ex.submit(_leg, ref_dir, 4, [
            "--config", "dp2_tp2", "--save-interval", "4", "--switch-at",
            "4", "--switch-config", pick, "--switch-devices", "2"])
        kill_f = ex.submit(_leg, chaos_dir, 4, [
            "--config", "dp2_tp2", "--save-interval", "4",
            "--hard-exit-at", "6"])
        rc, ref, text = ref_f.result()
        assert rc == 0, text
        assert [s["config"] for s in ref["segments"]] == \
            ["dp2_tp2_pp1_sep1", pick]
        rc, res, text = kill_f.result()
    assert rc == 137, text                  # the exit-code contract
    assert res is None                      # died before printing
    assert "step_4" in os.listdir(chaos_dir), os.listdir(chaos_dir)
    rc, res, text = _leg(chaos_dir, 2, ["--save-interval", "4",
                                        "--plan-auto", "--candidates",
                                        "dp1_tp2,dp2_tp1"])
    assert rc == 0, text
    seg = res["segments"][0]
    assert seg["config"] == pick            # the planner's pick
    assert seg["steps"][0] == 5             # resumed from step 4
    assert res["step"] == 8
    ref_post = dict(zip(ref["segments"][1]["steps"],
                        ref["segments"][1]["losses"]))
    assert dict(zip(seg["steps"], seg["losses"])) == ref_post
    assert res["digest"] == ref["digest"]


def test_apply_plan_trains_like_shard_layer_and_jax(tmp_path):
    """4 gloo ranks: ``Trainer.apply_plan`` of the dp2_tp2 plan trains 2
    AdamW steps bit for bit like ``shard_layer`` of the same layout, and
    within 1e-4 of JAX's unsharded steps; ``DataLoader(sharding=)`` with
    the plan and with the MeshPlan yields ``MeshPlan.local_batch``."""
    sd = tiny_state(seed=7)
    batches = [uneven_batch(seed=9), uneven_batch(seed=10)]
    refs = {}
    outs = run_ranks(4, [
        {"fn": "plan_state", "key": "plan",
         "args": {"config": "dp2_tp2", "losses": True, "loader": True}},
        {"fn": "train", "key": "layer",
         "args": {"mesh": {"dp": 2, "tp": 2}, "steps": 2, "grads": False}}],
        worker_inputs(sd, batches), tmp_path,
        during=lambda: refs.update(ref=jax_step(sd, batches, opt="adamw",
                                                lr=1e-3)))
    ref = refs["ref"]
    for o in outs:
        np.testing.assert_array_equal(o["plan/losses"], o["layer/losses"])
        assert bool(o["plan/loader_local"])
    for k in outs[0]:
        if k.startswith("plan/param."):
            np.testing.assert_array_equal(
                outs[0][k], outs[0]["layer/" + k[len("plan/"):]])
    check_step(outs, "plan", ref, grads=False)


def test_train_epoch_range_resumes_as_jax(tmp_path):
    """TrainEpochRange: interrupted after epoch 2 (whose save follows
    its yield, so it is lost), a relaunch resumes at epoch 2 with the
    state of two epochs restored, as JAX's does; GC keeps the last 2."""
    import torch
    from paddle_tpu.checkpoint.auto_checkpoint import TrainEpochRange as JR
    from paddle_tpu_torch.checkpoint.auto_checkpoint import (
        LocalFS, TrainEpochRange, train_epoch_range)

    def run(cls, root, w0):
        state = {"w": w0}

        def make(n):
            return cls(n, "job1", save_dir=root,
                       state_provider=lambda: {"w": state["w"]},
                       state_setter=lambda t: state.update(w=t["w"]),
                       save_checkpoint_inter=1, keep_last=2)
        seen = []
        for epoch in make(5).get():
            state["w"] = state["w"] + 1.0
            seen.append(epoch)
            if epoch == 2:
                break
        state["w"] = w0 * 0
        r = make(5)
        seen2 = list(r.get())
        return seen, seen2, r.restored_from, state["w"]
    got = run(TrainEpochRange, str(tmp_path / "m"), torch.zeros(4))
    want = run(JR, str(tmp_path / "j"), np.zeros(4, np.float32))
    assert got[:3] == want[:3] == ([0, 1, 2], [2, 3, 4], 1)
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))
    fs = LocalFS()
    r = TrainEpochRange(4, "gcjob", save_dir=str(tmp_path / "gc"),
                        state_provider=lambda: {"x": torch.ones(2)},
                        state_setter=lambda t: None, keep_last=2)
    assert list(r.get()) == [0, 1, 2, 3]
    dirs, files = fs.ls_dir(r._run_dir)
    assert len([d for d in dirs if d.startswith("epoch_")]) == 2
    assert "meta.json" in files
    assert list(train_epoch_range(2, "f", save_dir=str(tmp_path / "f"))) \
        == [0, 1]
