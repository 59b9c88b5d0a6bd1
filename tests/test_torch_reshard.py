"""Plan-aware sharded checkpoints and resharding on load, on gloo ranks
against the JAX package (``paddle_tpu.resilience.reshard``, JAX's
``tests/test_elastic_reshard.py``): the plan sidecar's bytes and the
feasibility check equal JAX's; the round trips 4 → 2 → 4 ranks
(dp2_tp2 → dp1_tp2 → dp2_tp2) and across the fsdp boundary (dp2_fsdp2 →
dp4 → dp2_fsdp2) give the same whole-state digest; optimizer slots saved
as os_g chunks reshard; an uneven tp shrink is refused with an
actionable error; a corrupt newest step is quarantined and the restore
falls back; a resharded restore equals ``shard_layer``'s cut of the
gathered state bit for bit; the reshard CLI's dry run, write and exit
codes. Three pods (4, 2 and 4 gloo ranks) run once for the file."""

import json
import os

import numpy as np
import pytest
import torch

from torch_dist_workers import run_ranks
from torch_mesh_refs import tiny_state, uneven_batch, worker_inputs


def _digest(step_dir):
    from paddle_tpu_torch.checkpoint import load_flat
    from paddle_tpu_torch.testing._elastic_train import tree_digest
    return tree_digest(load_flat(step_dir))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from paddle_tpu_torch.testing import chaos
    root = str(tmp_path_factory.mktemp("ckpt"))
    inputs = worker_inputs(tiny_state(seed=7), [uneven_batch(seed=9)])

    def sc(key, **args):
        return {"fn": "plan_state", "key": key, "args": dict(args, root=root)}
    a = run_ranks(4, [
        sc("a", config="dp2_tp2", steps=1, save="a", save_steps=[4, 8]),
        sc("z", config="dp2_fsdp2", steps=1, save="z"),
        sc("z_dp4", config="dp4", restore="z", save="z2"),
        sc("z_back", config="dp2_fsdp2", restore="z2", save="z3"),
        sc("o", mesh={"dp": 2, "fsdp": 2}, level="os_g", steps=1, save="o"),
        sc("o_dp4", config="dp4", restore="o", save="o2"),
        sc("o_back", mesh={"dp": 2, "fsdp": 2}, level="os_g",
           restore="o2")], inputs, tmp_path_factory.mktemp("run_a"))
    # bit-rot in the newest step, found by the scale-in restore
    chaos.corrupt_checkpoint(os.path.join(root, "a", "step_8"), mode="flip")
    b = run_ranks(2, [sc("b", config="dp1_tp2", restore="a", save="b")],
                  inputs, tmp_path_factory.mktemp("run_b"))
    c = run_ranks(4, [sc("c", config="dp2_tp2", restore="b", save="c")],
                  inputs, tmp_path_factory.mktemp("run_c"))
    return root, a, b, c


def test_rank_killed_mid_save_leaves_no_commit(tmp_path):
    """2 gloo ranks: rank 1 dies during an async sharded save of step 8.
    Rank 0 cannot commit (the index waits for every rank's durable
    files), no step_8 appears, and the next manager's startup sweep
    quarantines the torn directory, leaving step 4 the newest."""
    import subprocess
    import sys
    import torch_dist_workers as w
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(w.ROOT), str(w.ROOT / "tests"), os.environ.get("PYTHONPATH",
                                                             "")]))
    procs = [subprocess.Popen([sys.executable, w.__file__, str(tmp_path),
                               "torn", str(r)], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=w.RANK_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert (tmp_path / "torn.json").exists(), logs
    got = json.loads((tmp_path / "torn.json").read_text())
    assert got["finalize"] != "committed", got
    assert not got["step_8_exists"], got
    assert got["committed"] == [4], got
    assert any("step_8" in q for q in got["quarantined"]), got


def test_sidecar_bytes_equal_jax_write_plan(tmp_path):
    """The sidecar of a plan is byte-for-byte the JAX package's for the
    same config and model, and a JAX-written sidecar reads back."""
    import jax
    from paddle_tpu.distributed.auto_parallel import (
        ParallelConfig as JPC, plan_for_config as jplan)
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.resilience import reshard as jrs
    from paddle_tpu_torch.distributed.auto_parallel import (ParallelConfig,
                                                            plan_for_config)
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.resilience import reshard
    for text in ("dp2_tp2", "dp2_fsdp2_tp2", "pp2", "sep2"):
        jp = jplan(JaxConfig.tiny(), JPC.parse(text),
                   devices=jax.devices()[:JPC.parse(text).size])
        mp = plan_for_config(LlamaConfig.tiny(), ParallelConfig.parse(text))
        jd, md = tmp_path / f"j{text}", tmp_path / f"m{text}"
        jd.mkdir()
        md.mkdir()
        jrs.write_plan(str(jd), jp, 4)
        reshard.write_plan(str(md), mp, 4)
        assert (jd / "_PLAN.json").read_bytes() == \
            (md / "_PLAN.json").read_bytes(), text
        back = reshard.read_plan(str(jd))
        assert back.as_dict() == mp.as_dict()
    reshard.write_plan(str(tmp_path), None, 3)
    assert reshard.read_plan(str(tmp_path)) is None


@pytest.mark.parametrize("config,axis", [("dp1_tp3", "tp=3"),
                                         ("dp1_fsdp3", "fsdp=3")])
def test_check_feasible_raises_where_jax_does(config, axis):
    """An axis that does not divide a parameter dim is refused with the
    JAX package's message, naming the axis and the remainder."""
    import jax
    from paddle_tpu.distributed.auto_parallel import (
        ParallelConfig as JPC, plan_for_config as jplan)
    from paddle_tpu.models.llama import LlamaConfig as JaxConfig
    from paddle_tpu.resilience import reshard as jrs
    from paddle_tpu_torch.distributed.auto_parallel import (ParallelConfig,
                                                            plan_for_config)
    from paddle_tpu_torch.models.llama import LlamaConfig, parameter_shapes
    from paddle_tpu_torch.resilience import reshard
    shapes = {k: s for k, (s, _) in parameter_shapes(
        LlamaConfig.tiny()).items()}
    jtree = {"params": {k: np.zeros(s, np.float32)
                        for k, s in shapes.items()}}
    ttree = {"params": {k: torch.zeros(s) for k, s in shapes.items()}}
    jp = jplan(JaxConfig.tiny(), JPC.parse(config),
               devices=jax.devices()[:3])
    mp = plan_for_config(LlamaConfig.tiny(), ParallelConfig.parse(config))
    with pytest.raises(jrs.ReshardError) as je:
        jrs.check_feasible(jtree, jp)
    with pytest.raises(reshard.ReshardError) as me:
        reshard.check_feasible(ttree, mp)
    assert str(me.value) == str(je.value)
    assert axis in str(me.value) and "remainder" in str(me.value)
    ok = plan_for_config(LlamaConfig.tiny(), ParallelConfig.parse("dp2_tp2"))
    reshard.check_feasible(ttree, ok)
    jrs.check_feasible(jtree, jplan(JaxConfig.tiny(), JPC.parse("dp2_tp2"),
                                    devices=jax.devices()[:4]))


def test_round_trip_4_2_4_digest_exact(runs):
    """dp2_tp2 (4 ranks) → dp1_tp2 (2) → dp2_tp2 (4): parameters and
    optimizer state come back with the same whole-state digest, each
    restore at the step saved, the source plan recorded."""
    from paddle_tpu_torch.resilience import reshard
    root, a, b, c = runs
    d0 = _digest(os.path.join(root, "a", "step_4"))
    assert _digest(os.path.join(root, "b", "step_4")) == d0
    assert _digest(os.path.join(root, "c", "step_4")) == d0
    for o in b + c:
        assert int(o[list(o)[0].split("/")[0] + "/restored_step"]) == 4
    assert reshard.read_plan(os.path.join(root, "b", "step_4")) \
        .config_str == "dp1_tp2_pp1_sep1"
    assert str(c[0]["c/config"]) == "dp2_tp2_pp1_sep1"


def test_fsdp_boundary_round_trip_digest_exact(runs):
    """dp2_fsdp2 (FSDP2's row shards of parameters and slots) → dp4 →
    dp2_fsdp2: the same whole-state digest at every hop, and each
    restored rank's shards equal shard_layer's cut."""
    root, a, _, _ = runs
    d0 = _digest(os.path.join(root, "z", "step_4"))
    assert _digest(os.path.join(root, "z2", "step_4")) == d0
    assert _digest(os.path.join(root, "z3", "step_4")) == d0
    for o in a:
        assert bool(o["z_dp4/equal_shard_layer"])
        assert bool(o["z_back/equal_shard_layer"])


def test_opt_slots_under_os_g_reshard(runs):
    """AdamW slots saved as os_g chunks (each fsdp rank a flat chunk of
    its shard) restore under dp4 and back into os_g chunks: the whole
    state's digest holds and every chunk lands where the level cuts it
    (moments of the right shape in the wrong place would not)."""
    root, a, _, _ = runs
    assert _digest(os.path.join(root, "o2", "step_4")) == \
        _digest(os.path.join(root, "o", "step_4"))
    for o in a:
        assert bool(o["o_dp4/equal_shard_layer"])
        assert bool(o["o_back/equal_shard_layer"])


def test_uneven_tp_shrink_rejected_permanently(runs):
    """A tp=3 target (4 heads, 2 KV heads) is refused before any byte
    moves, naming the axis and the remainder, and the manager does not
    fall back to an older step (infeasibility is permanent)."""
    from paddle_tpu_torch.distributed.auto_parallel import (ParallelConfig,
                                                            plan_for_config)
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.resilience import CheckpointManager, reshard
    root = os.path.join(runs[0], "a")
    from paddle_tpu_torch.checkpoint import load_flat, unflatten
    plan3 = plan_for_config(LlamaConfig.tiny(), ParallelConfig(tp=3))
    tree = unflatten(load_flat(os.path.join(root, "step_4")))
    with pytest.raises(reshard.ReshardError) as ei:
        reshard.load_resharded(os.path.join(root, "step_4"), tree, plan3,
                               coords={"tp": 0})
    assert "tp=3" in str(ei.value) and "remainder" in str(ei.value)
    mgr = CheckpointManager(root, plan=plan3)
    with pytest.raises(reshard.ReshardError):
        mgr.restore(tree)
    assert mgr.committed_steps() == [4]


def test_corrupt_shard_mid_reshard_falls_back(runs):
    """Bit-rot in the newest step (step 8) found by the 2-rank restore:
    quarantined, and the previous committed step is resharded instead."""
    _, _, b, _ = runs
    for o in b:
        assert int(o["b/restored_step"]) == 4
    assert any("step_8" in q for q in json.loads(str(b[0]["b/quarantined"])))


def test_resharded_restore_equals_shard_layer(runs):
    """Every rank's restored parameters and AdamW slots under dp1_tp2 are
    ``shard_layer``'s cut of the checkpoint's whole state, bit for bit
    (fused qkv and gate_up per part)."""
    _, _, b, c = runs
    for o in b:
        assert bool(o["b/equal_shard_layer"])
    for o in c:
        assert bool(o["c/equal_shard_layer"])


def test_reshard_cli_dry_run_and_write(runs, tmp_path, capsys):
    """The CLI's dry run reports feasible; a write commits a checkpoint
    laid out for the target's ranks, recording the target plan, that
    restores digest-exact."""
    from paddle_tpu_torch.checkpoint import read_index
    from paddle_tpu_torch.resilience import reshard
    from paddle_tpu_torch.tools import reshard as cli
    src = os.path.join(runs[0], "a")
    assert cli.main(["--from", src, "--step", "4", "--mesh", "2x2",
                     "--dry-run"]) == 0
    assert "feasible" in capsys.readouterr().out
    out = str(tmp_path / "dst")
    assert cli.main(["--from", src, "--step", "4", "--mesh", "1x2",
                     "--out", out]) == 0
    step_dir = os.path.join(out, "step_4")
    assert os.path.isfile(os.path.join(step_dir, "_COMMITTED"))
    rewritten = reshard.read_plan(step_dir)
    assert rewritten.axes["dp"] == 1 and rewritten.axes["tp"] == 2
    idx = read_index(step_dir)
    qkv = idx["params/model.layers.0.self_attn.qkv_proj"]
    assert sorted(p["rank"] for p in qkv["pieces"]) == [0, 1]
    assert _digest(step_dir) == _digest(os.path.join(src, "step_4"))


def test_place_tree_cuts_a_whole_tree_like_the_resharded_read(runs):
    """``place_tree`` (the host-side assembly path) cuts the whole state
    into a rank's slice exactly as the resharded read of the checkpoint
    gives it."""
    from paddle_tpu_torch.checkpoint import _flatten, load_flat, unflatten
    from paddle_tpu_torch.distributed.auto_parallel import (ParallelConfig,
                                                            plan_for_config)
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               sharding_annotations)
    from paddle_tpu_torch.resilience import reshard
    step = os.path.join(runs[0], "a", "step_4")
    whole = unflatten(load_flat(step))
    plan = plan_for_config(LlamaConfig.tiny(), ParallelConfig(tp=2))
    blocks = {k: b for k, (_, b) in sharding_annotations(
        LlamaConfig.tiny()).items()}
    for r in range(2):
        placed = dict(_flatten(reshard.place_tree(
            whole, plan, coords={"tp": r}, blocks=blocks)))
        read = dict(_flatten(reshard.load_resharded(step, whole, plan,
                                                    coords={"tp": r})))
        assert placed.keys() == read.keys()
        for k, v in read.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(placed[k], v), k


def test_reshard_cli_infeasible_target_exits_2(runs, capsys):
    src = os.path.join(runs[0], "a")
    from paddle_tpu_torch.tools import reshard as cli
    assert cli.main(["--from", src, "--step", "4", "--config", "dp1_tp3",
                     "--dry-run"]) == 2
    assert "tp=3" in capsys.readouterr().err
    # more devices than exist is infeasible too
    assert cli.main(["--from", src, "--step", "4", "--mesh", "8x4",
                     "--dry-run", "--available", "8"]) == 2


def test_reshard_cli_refuses_planless_source_exit_2(tmp_path, capsys):
    from paddle_tpu_torch.resilience import CheckpointManager
    from paddle_tpu_torch.tools import reshard as cli
    root = str(tmp_path)
    CheckpointManager(root, save_interval_steps=1).save(
        1, {"w": torch.ones(4, 4)})
    assert cli.main(["--from", root, "--mesh", "2x2", "--dry-run"]) == 2
    assert "no recorded ShardingPlan" in capsys.readouterr().err
