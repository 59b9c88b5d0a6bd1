"""The four sharded graphs of the port's registry (``tp_fused_ce``,
``planner``, ``train_step_fsdp``, ``train_step_moe_ep``) on 4 gloo
ranks, in one spawn: each holds its contract and the checked-in budgets
on every rank; the vocab-parallel head's census is JAX's pinned
``{"all-reduce[tp]": 3}`` (read from the JAX package's budget file: its
sharded graphs are not rebuilt here); and the planted faults fail: one
more tp all-reduce breaks the exact count, a step emitted through a
drifted plan breaks the planner's priced census. D18: the dropless ep
step reads its exchange's split sizes on the host once a MoE layer,
where JAX's graph makes no host transfer."""

import json
import os

import pytest

from torch_dist_workers import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = run_ranks(4, [{"fn": "graph_contracts", "key": "g"}], {},
                    tmp_path_factory.mktemp("graphs"))
    return [json.loads(str(r["g/results"])) for r in out]


def _jax_budget(name):
    with open(os.path.join(ROOT, "tools", "graph_budgets.json")) as f:
        return json.load(f)["graphs"][name]["budget"]


def test_sharded_graphs_hold_their_budgets_on_every_rank(ranks):
    for r, res in enumerate(ranks):
        assert res["skipped"] == [], r
        assert res["violations"] == [], (r, res["violations"])
        assert sorted(res["snapshots"]) == sorted(
            ["tp_fused_ce", "planner", "train_step_fsdp",
             "train_step_moe_ep"])


def test_tp_fused_ce_census_is_jax_s(ranks):
    want = _jax_budget("tp_fused_ce")["collective_counts"]
    assert want == {"all-reduce[tp]": 3}
    for res in ranks:
        assert res["snapshots"]["tp_fused_ce"]["collective_counts"] == want
        assert res["snapshots"]["tp_fused_ce"][
            "largest_intermediate_bytes"] < 320 * 32 * 4
        assert all(o.startswith("c10d.allreduce") for o in res["tp_ops"])


@pytest.mark.parametrize("name", ["tp_fused_ce", "planner",
                                  "train_step_fsdp", "train_step_moe_ep"])
def test_jax_zero_transfer_graphs_are_zero_here(ranks, name):
    assert _jax_budget(name)["host_transfer_count"] == 0
    for res in ranks:
        assert res["snapshots"][name]["host_transfer_count"] == 0


def test_extra_tp_all_reduce_fails_the_exact_count(ranks):
    for res in ranks:
        rules = dict((r, lines) for r, lines in res["extra_all_reduce"])
        assert rules["collectives.expect"] == [
            "all-reduce[tp]: budget 3 -> actual 4"]


def test_drifted_plan_fails_the_priced_census(ranks):
    for res in ranks:
        rules = dict((r, lines) for r, lines in res["drifted_plan"])
        lines = rules["collectives.expect"]
        assert any(l.startswith("all-reduce[tp]: budget") for l in lines)


def test_dropless_ep_reads_split_sizes_on_the_host(ranks):
    """D18 (port only): one host read a MoE layer forward (the micro
    model has one), at the exchange's split sizes."""
    for res in ranks:
        syncs = res["dropless_syncs"]
        assert len(syncs) == 1, syncs
        assert "parallel/moe.py" in syncs[0] and \
            "_forward_dropless_ep" in syncs[0]
