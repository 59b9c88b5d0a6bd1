"""The fsdp axis of the port on 4 gloo ranks: ``group_sharded_parallel``
at each ZeRO level ("os", "os_g", "p_g_os": FSDP2) with fsdp = 4 and
beside dp or tp, the fleet facade (JAX's ``test_fleet_facade``: mp 2 and
sharding 2 here, dp 1), each one step of the tiny Llama held to JAX's
unsharded step (1e-4 in fp32); FSDP2 summing the gradients (its divide
factor at 1: the loss is already the global mean) and the clip counting
every element once, both read off the synced gradients and the global
norm; a sharded save raising naming A.5; a model without a sharding
table or a global-mean loss (a bare Linear) refused at dp 2 and the MoE
LM taken; the mesh-check tool's layouts within its tolerance."""

import json

import numpy as np
import pytest

from torch_dist_workers import run_ranks
from torch_mesh_refs import (check_step, jax_step, tiny_state, uneven_batch,
                             worker_inputs)

WORLD = 4
STEPS = {  # key: (scenario args, optimizer)
    "fsdp4_os": ({"mesh": {"fsdp": 4}, "level": "os"}, "sgd"),
    "fsdp4_os_g": ({"mesh": {"fsdp": 4}, "level": "os_g"}, "sgd"),
    "fsdp4_p_g_os": ({"mesh": {"fsdp": 4}, "level": "p_g_os"}, "sgd"),
    "fsdp4_p_g_os_adamw": ({"mesh": {"fsdp": 4}, "level": "p_g_os",
                            "offload": True}, "adamw"),
    "dp2fsdp2_os_g": ({"mesh": {"dp": 2, "fsdp": 2}, "level": "os_g"},
                      "sgd"),
    "fsdp2tp2_p_g_os": ({"mesh": {"fsdp": 2, "tp": 2}, "level": "p_g_os"},
                        "sgd"),
    "fsdp2tp2_os": ({"mesh": {"fsdp": 2, "tp": 2}, "level": "os"},
                    "adamw"),
    "fleet_mp2_sharding2": ({"fleet": {"mp_degree": 2,
                                       "sharding_degree": 2}}, "adamw"),
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    sd = tiny_state(seed=7)
    batch = uneven_batch(seed=9)
    refs, scen = {}, []
    for key, (args, opt) in STEPS.items():
        lr = 0.1 if opt == "sgd" else 1e-3
        refs[key] = jax_step(sd, [batch], opt=opt, lr=lr)
        scen.append({"fn": "train", "key": key,
                     "args": dict(args, opt=opt, lr=lr)})
    scen.append({"fn": "sharded_save", "key": "save",
                 "args": {"mesh": {"fsdp": 4}}})
    scen.append({"fn": "refused", "key": "refused",
                 "args": {"mesh": {"dp": 2, "tp": 2}}})
    outs = run_ranks(WORLD, scen, worker_inputs(sd, [batch]),
                     tmp_path_factory.mktemp("fsdp"))
    return refs, outs


@pytest.mark.parametrize("key", sorted(STEPS))
def test_sharded_step_matches_jax_unsharded_step(run, key):
    """Losses and every gathered parameter after the step; where the
    gradients are whole on a rank ("os_g" reduce-scatters them), the
    synced gradients and the global norm too."""
    refs, outs = run
    check_step(outs, key, refs[key], grads="os_g" not in key)


def test_fsdp2_sums_gradients_and_the_clip_counts_once(run):
    """FSDP2 at fsdp 4 gives the SUM of the ranks' gradients (an average
    would be a quarter: the loss is the global token mean already), and
    the global norm counts each element once, whether sharded over fsdp,
    over tp or replicated over tp: both equal JAX's, and the SGD step
    (which the clip scales, unlike AdamW's first) lands on JAX's."""
    refs, outs = run
    for key in ("fsdp4_p_g_os", "fsdp2tp2_p_g_os"):
        ref = refs[key]
        assert ref["gnorm"] > 1.0           # the clip acts
        for o in outs:
            np.testing.assert_allclose(o[f"{key}/gnorm"], ref["gnorm"],
                                       rtol=1e-5)
        name = "model.layers.0.self_attn.qkv_proj"
        np.testing.assert_allclose(outs[0][f"{key}/grad.{name}"],
                                   ref["grads"][name], rtol=1e-4, atol=1e-5)


def test_sharded_save_raises_naming_a5(run):
    _, outs = run
    for o in outs:
        msgs = json.loads(str(o["save/msgs"]))
        assert len(msgs) == 3 and all("A.5" in m for m in msgs), msgs


def test_mesh_check_tool_on_four_gloo_ranks(tmp_path):
    """``tools.mesh_check`` (what ``torchrun -m
    paddle_tpu_torch.tools.mesh_check --device cpu`` runs on each rank):
    a tensor-, an fsdp- and a sequence-parallel layout each hold their
    step's loss and updates to one rank's unsharded step within its
    1e-4."""
    outs = run_ranks(WORLD, [{"fn": "mesh_check", "key": "mc", "args": {
        "layouts": ["tp4", "fsdp2tp2", "sep2tp2_ring"], "preset": "tiny",
        "seq": 64}}], {}, tmp_path)
    lines = json.loads(str(outs[0]["mc/results"]))
    assert [x["layout"] for x in lines] == ["tp4", "fsdp2tp2",
                                            "sep2tp2_ring"]
    assert all(x["ok"] and x["world"] == 4 and x["tol"] == 1e-4
               for x in lines), lines


def test_model_without_table_or_global_mean_loss_is_refused(run):
    """A bare Linear (no sharding table, no global-mean loss) is refused
    by ``shard_layer``, ``group_sharded_parallel`` (on a dp 2 x tp 2
    mesh) and ``fleet.distributed_model`` (dp 2, mp 2) before any
    parameter is cut; the tiny MoE LM, which now carries both, is taken
    by ``shard_layer`` and ``fleet.distributed_model`` and cut over tp."""
    _, outs = run
    for o in outs:
        msgs = json.loads(str(o["refused/msgs"]))
        assert len(msgs) == 5, msgs
        assert all("_global_mean_loss" in m and "Linear" in m
                   for m in msgs[:3]), msgs
        assert msgs[3:] == ["no error", "no error"], msgs
        assert bool(o["refused/moe_cut"])
