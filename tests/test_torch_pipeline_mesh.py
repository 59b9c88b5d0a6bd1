"""Pipeline parallelism of the port on 4 gloo ranks: the tiny Llama (4
layers) as ``LlamaForCausalLMPipe`` over a ``pp`` axis, each rank
holding its stage and trading activations and cotangents with its
neighbours, held to JAX's UNSHARDED step (losses, synced gradients,
global norm and every parameter after the step; 1e-4 in fp32) with
uneven ignored labels per data rank and microbatch: 1F1B ``Trainer``
steps at pp4, pp2dp2 and pp2tp2 (SGD with a clip that acts, and AdamW),
the tied embedding summed between the first and the last stage (pp4),
GPipe's FThenB at pp2dp2, and ``PipelineParallel.train_batch`` /
``eval_batch`` at pp4."""

import numpy as np
import pytest

from torch_dist_workers import run_ranks
from torch_mesh_refs import (check_step, jax_step, tiny_state, uneven_batch,
                             worker_inputs)

WORLD = 4
LAYERS = 4
# key: (mesh, schedule, optimizer, tied, PipelineParallel)
CASES = {
    "pp4_1f1b": ({"pp": 4}, "1f1b", "sgd", False, False),
    "pp2dp2_1f1b": ({"pp": 2, "dp": 2}, "1f1b", "sgd", False, False),
    "pp2tp2_1f1b": ({"pp": 2, "tp": 2}, "1f1b", "sgd", False, False),
    "pp2dp2_1f1b_adamw": ({"pp": 2, "dp": 2}, "1f1b", "adamw", False,
                          False),
    "pp4_1f1b_tied": ({"pp": 4}, "1f1b", "sgd", True, False),
    "pp2dp2_gpipe": ({"pp": 2, "dp": 2}, "gpipe", "sgd", False, False),
    "pp4_train_batch": ({"pp": 4}, "1f1b", "sgd", False, True),
}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks, with the JAX references computed while they run."""
    sd = tiny_state(num_hidden_layers=LAYERS)
    sd_tied = tiny_state(num_hidden_layers=LAYERS, tie_word_embeddings=True)
    batches = [uneven_batch(seed=1), uneven_batch(seed=2)]
    scen = []
    for key, (mesh, sched, opt, tied, wrapper) in CASES.items():
        scen.append({"fn": "pipe_train", "key": key, "args": {
            "mesh": mesh, "sched": sched, "opt": opt,
            "lr": 0.1 if opt == "sgd" else 1e-3, "wrapper": wrapper,
            "steps": 2, "sd": "sdt" if tied else "sd",
            "cfg": {"num_hidden_layers": LAYERS,
                    "tie_word_embeddings": tied}}})
    refs = {}

    def references():
        memo = {}
        for key, (_, _, opt, tied, _) in CASES.items():
            if (opt, tied) not in memo:
                memo[opt, tied] = jax_step(
                    sd_tied if tied else sd, batches, opt=opt,
                    lr=0.1 if opt == "sgd" else 1e-3,
                    num_hidden_layers=LAYERS, tie_word_embeddings=tied)
            refs[key] = memo[opt, tied]
    inputs = {**worker_inputs(sd, batches),
              **{"sdt/" + k: v for k, v in sd_tied.items()}}
    outs = run_ranks(WORLD, scen, inputs, tmp_path_factory.mktemp("pp"),
                     during=references)
    return refs, outs


@pytest.mark.parametrize("key", sorted(CASES))
def test_pipeline_step_matches_jax_unsharded_step(run, key):
    """Every rank logs the same loss (the last stage's, broadcast), and
    two steps' losses, the synced gradients, their global norm (each
    stage counted once, the tied copy on the last stage not at all)
    and the gathered parameters equal JAX's unsharded Llama's."""
    refs, outs = run
    check_step(outs, key, refs[key], grads=not CASES[key][4])


def test_1f1b_ranks_hold_at_most_2s_minus_1_microbatches(run):
    """On the mesh a stage holds at most min(M, 2S - 1) microbatches:
    stage s of S min(M, 2(S - s) - 1) (2 microbatches a data rank)."""
    _, outs = run
    for key, (mesh, sched, _, _, wrapper) in CASES.items():
        if sched != "1f1b" or wrapper:
            continue
        S = mesh["pp"]
        stages = WORLD // S
        for r, o in enumerate(outs):
            s = r // stages
            held = list(o[f"{key}/peak_live"])
            assert held[s] == min(2, 2 * (S - s) - 1), (key, r, held)
            assert sum(held) == held[s]       # no other stage's cells


def test_pipeline_parallel_eval_batch(run):
    """``eval_batch(compute_loss=True)`` on the second batch after both
    train_batch steps gives the same loss on every rank, finite and
    below that batch's loss before its step."""
    _, outs = run
    vals = [float(o["pp4_train_batch/eval_loss"]) for o in outs]
    assert len(set(vals)) == 1 and np.isfinite(vals[0])
    assert vals[0] < float(outs[0]["pp4_train_batch/losses"][1])
