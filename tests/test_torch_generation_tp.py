"""One-shot generation on a tensor-parallel mesh (gloo ranks on the CPU)
against the JAX package's unsharded generation: the tiny Llama (2 KV
heads) sharded by ``shard_layer`` over tp4 on 4 ranks (each KV head
shared by two ranks) and over dp2 x tp2, through ``generate``,
``generate_scan`` and ``generate_paged`` (page 8, the decode crossing a
page), as ``tests/test_inference.py`` holds JAX's tp4 mesh to one
device. Inputs come from numpy with a fixed seed, fp32.

Tolerances: greedy tokens exactly (the sharded sums reorder fp32
additions; no near-tie of this seed's logits flips). Sampled tokens are
the port's own streams, so a sharded ``generate_scan`` is held to the
port's unsharded one, exactly."""

import jax.numpy as jnp
import numpy as np
import pytest

from paddle_tpu.inference import generation as jgen
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.inference import generation as gen
from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from torch_dist_workers import run_ranks
from torch_mesh_refs import tiny_state

NEW = 7
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=20, seed=5)
MESHES = {"tp4": {"tp": 4}, "dp2tp2": {"dp": 2, "tp": 2}}
ENTRIES = ("generate", "generate_scan", "generate_paged")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each mesh's rank outputs, and the references: JAX's unsharded
    greedy tokens of every entry and the port's unsharded sampled
    ``generate_scan``."""
    sd = tiny_state(seed=7)
    ids = np.random.RandomState(3).randint(0, 512, (2, 12)).astype(np.int32)
    pm = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")
    pm.load_state_dict(state_dict_from_jax(sd, LlamaConfig.tiny(),
                                           device="cpu"))
    # row 0's first greedy token as EOS: that row finishes at once
    eos = int(gen.generate_scan(pm, ids, gen.GenerationConfig(
        max_new_tokens=1))[0, -1])
    inputs = {"gen_ids": ids, "gen_new": np.asarray(NEW),
              "gen_eos": np.asarray(eos),
              **{f"sd/{k}": v for k, v in sd.items()}}
    refs = {}

    def references():
        jm = JaxLlama(JaxConfig.tiny())
        jm.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
        cfg = jgen.GenerationConfig(max_new_tokens=NEW)
        for name in ENTRIES:
            kw = {"page_size": 8} if name == "generate_paged" else {}
            refs[name] = np.asarray(getattr(jgen, name)(jm, ids, cfg, **kw))
        refs["eos_scan"] = np.asarray(jgen.generate_scan(
            jm, ids, jgen.GenerationConfig(max_new_tokens=NEW,
                                           eos_token_id=eos,
                                           pad_token_id=-1)))
        refs["sampled_scan"] = gen.generate_scan(
            pm, ids, gen.GenerationConfig(max_new_tokens=NEW, **SAMPLED)
        ).numpy()
    scenarios = [{"fn": "generate", "key": name,
                  "args": {"mesh": mesh, "sampled": SAMPLED}}
                 for name, mesh in MESHES.items()]
    scenarios.append({"fn": "mesh_generate", "key": "mesh_check",
                      "args": {"legs": ["generate_tp2", "generate_tp4"]}})
    ranks = run_ranks(4, scenarios, inputs, tmp_path_factory.mktemp("gen"),
                      during=references)
    return ranks, refs


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("entry", ENTRIES)
def test_greedy_tokens_on_a_tp_mesh_equal_jax_unsharded(runs, mesh, entry):
    ranks, refs = runs
    assert refs[entry].shape == (2, 12 + NEW)
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out[f"{mesh}/{entry}"], refs[entry],
                                      err_msg=f"rank {r}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sampled_scan_on_a_tp_mesh_equals_unsharded(runs, mesh):
    ranks, refs = runs
    for out in ranks:
        np.testing.assert_array_equal(out[f"{mesh}/sampled_scan"],
                                      refs["sampled_scan"])


@pytest.mark.parametrize("mesh,heads", [("tp4", 1), ("dp2tp2", 1)])
def test_pools_hold_the_ranks_kv_heads(runs, mesh, heads):
    """2 KV heads over tp4: one head a rank, shared by two ranks; over
    tp2 one each."""
    for out in runs[0]:
        assert int(out[f"{mesh}/pool_heads"]) == heads


def test_int8_model_on_a_mesh_is_refused_naming_its_row(runs):
    for out in runs[0]:
        msg = str(out["tp4/int8_refused"])
        assert "A.10c" in msg and "int8" in msg


def test_pad_fed_back_wraps_into_the_whole_vocabulary(runs):
    """Row 0 ends at its first token (EOS) and feeds its pad, -1, back:
    wrapped into the whole vocabulary (cfg.vocab_size, 511), not into a
    rank's V / tp embedding rows; the tokens equal JAX's with EOS."""
    ranks, refs = runs
    for out in ranks:
        np.testing.assert_array_equal(out["tp4/eos_scan"], refs["eos_scan"])
        assert int(out["tp4/fed_pad"]) == 511


def test_mesh_check_generation_legs_on_four_gloo_ranks(runs):
    """``tools.mesh_check``'s generate_tp2 (dp2 x tp2) and generate_tp4
    legs, tiny Llama: every rank's sharded tokens equal its unsharded
    model's, for both generators."""
    import json
    for out in runs[0]:
        res = json.loads(str(out["mesh_check/results"]))
        assert [r["layout"] for r in res] == ["generate_tp2", "generate_tp4"]
        assert [r["mesh"] for r in res] == [{"dp": 2, "tp": 2},
                                            {"dp": 1, "tp": 4}]
        assert all(r["ok"] and all(r["equal"].values()) for r in res), res
