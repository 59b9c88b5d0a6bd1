"""The port's scale fit, projection and auto-tuner
(``paddle_tpu_torch.parallel.{scale,projection}``,
``paddle_tpu_torch.distributed.auto_tuner``) against the JAX package's
for the same inputs. The models are built on the meta device (shapes
and dtypes only; a 70B model is never materialised), JAX's under
LazyGuard. The projection is held to JAX's arithmetic with JAX's own
hardware constants passed in as the port's ``hw``."""

import json

import numpy as np
import pytest

import paddle_tpu as jpt
from paddle_tpu.distributed import auto_tuner as jat
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaForCausalLMPipe as JaxPipe
from paddle_tpu.models.moe_lm import MoEConfig as JaxMoEConfig
from paddle_tpu.models.moe_lm import MoEForCausalLM as JaxMoE
from paddle_tpu.parallel import projection as jproj
from paddle_tpu.parallel import scale as jscale
from paddle_tpu_torch.distributed import auto_tuner as at
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaForCausalLMPipe)
from paddle_tpu_torch.models.moe_lm import MoEConfig, MoEForCausalLM
from paddle_tpu_torch.parallel import projection, scale

PIPE = dict(num_stages=4, num_microbatches=8, pp_schedule="1f1b")
# (model, mesh, sequence, microbatch, recompute)
CASES = [
    ("llama3_8b", {"fsdp": 8}, 8192, 1, "full"),
    ("llama3_8b", {"fsdp": 2, "tp": 8}, 8192, 2, "full"),
    ("llama3_8b", {"dp": 2, "tp": 4, "sep": 2}, 8192, 1, "selective"),
    ("llama3_8b", {"fsdp": 4}, 4096, 1, "none"),
    ("llama3_70b_pipe", {"pp": 4, "fsdp": 2, "tp": 8}, 8192, 1, "full"),
    ("llama3_70b_pipe", {"pp": 4, "fsdp": 4}, 4096, 1, "none"),
    ("deepseek_moe_16b", {"ep": 8, "tp": 2}, 4096, 1, "full"),
    ("deepseek_moe_16b", {"ep": 4, "fsdp": 4}, 4096, 2, "selective"),
]


@pytest.fixture(scope="module")
def models():
    """name -> (the port's model on meta, JAX's under LazyGuard)."""
    out = {}
    with jpt.LazyGuard():
        out["llama3_8b"] = (
            LlamaForCausalLM(LlamaConfig.llama3_8b(dtype="bfloat16"),
                             device="meta"),
            JaxLlama(JaxConfig.llama3_8b(dtype="bfloat16")))
        out["llama3_70b_pipe"] = (
            LlamaForCausalLMPipe(LlamaConfig.llama3_70b(dtype="bfloat16"),
                                 device="meta", **PIPE),
            JaxPipe(JaxConfig.llama3_70b(dtype="bfloat16"), **PIPE))
        out["deepseek_moe_16b"] = (
            MoEForCausalLM(MoEConfig.deepseek_moe_16b(dtype="bfloat16"),
                           device="meta"),
            JaxMoE(JaxMoEConfig.deepseek_moe_16b(dtype="bfloat16")))
    return out


def _case_id(c):
    axes = ".".join(f"{k}{v}" for k, v in c[1].items())
    return f"{c[0]}-{axes}-{c[4]}"


@pytest.mark.parametrize("name,axes,s,mb,rc", CASES,
                         ids=[_case_id(c) for c in CASES])
def test_train_state_bytes_and_fits_match_jax(models, name, axes, s, mb, rc):
    mine, theirs = models[name]
    assert all(p.is_meta for p in mine.parameters())
    got = scale.train_state_bytes(mine, axes, seq_len=s, microbatch_size=mb,
                                  recompute=rc)
    want = jscale.train_state_bytes(theirs, axes, seq_len=s,
                                    microbatch_size=mb, recompute=rc)
    assert got == want
    ok, br = scale.fits(mine, axes, seq_len=s, microbatch_size=mb,
                        recompute=rc)
    assert br["device"] == "h100" and br["budget_gb"] == 80.0 * 0.85
    assert ok == (want["total"] <= 80e9 * 0.85)


def test_param_plan_shards_match_jax(models):
    """Every parameter's local shard equals JAX's (the pipeline's
    stacked layers: L / pp layers a rank against one stage's layers)."""
    mine, theirs = models["llama3_8b"]
    axes = {"fsdp": 2, "tp": 8}
    got = {n: local for n, _, _, local in scale.param_plan(mine, axes)}
    want = {n: tuple(local)
            for n, _, _, local in jscale.param_plan(theirs, axes)}
    assert got == want
    assert scale.clean_spec(("fsdp", "tp"), {"tp": 4}) == (None, "tp")
    mine, _ = models["llama3_70b_pipe"]
    axes = {"pp": 4, "tp": 8}
    layers = [(n, spec, local) for n, _, spec, local
              in scale.param_plan(mine, axes) if n.startswith("decoder.")]
    assert all(spec[0] == "pp" for _, spec, _ in layers)
    held = {n.split(".")[2] for n, _, local in layers if np.prod(local)}
    assert held == {str(i) for i in range(80 // 4)}
    with pytest.raises(ValueError, match="pipeline"):
        list(scale.param_plan(mine, {"pp": 2}))


def test_counts_match_port_models(models):
    mine, _ = models["llama3_8b"]
    c = projection.llama3_8b_counts(8192)
    assert c["params"] == mine.num_params()
    assert c["flops_per_token"] == mine.flops_per_token(8192)
    assert c == jproj.llama3_8b_counts(8192)
    big = LlamaForCausalLM(LlamaConfig.llama3_70b(dtype="bfloat16"),
                           device="meta")
    c = projection.llama3_70b_counts(4096)
    assert c["params"] == big.num_params()
    assert c["flops_per_token"] == big.flops_per_token(4096)
    assert c == jproj.llama3_70b_counts(4096)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, (int, float)) and not isinstance(tree, bool):
        yield prefix[:-1], float(tree)


def _close(got, want, keys):
    for mine, theirs in keys:
        a, b = dict(_leaves(got[mine])), dict(_leaves(want[theirs]))
        b = {k.replace("_v5p", ""): v for k, v in b.items()}
        assert set(a) == set(b), (mine, set(a) ^ set(b))
        for k in a:
            assert a[k] == pytest.approx(b[k], rel=1e-12, abs=0), (mine, k)


def _jax_hw():
    """JAX's constants as the port's inputs (target, measured-on)."""
    return ({"peak_bf16": jproj.PEAK_BF16["v5p"],
             "hbm_bw": jproj.HBM_BW["v5p"],
             "link_bw": jproj.ICI_AGG["v5p"]},
            {"peak_bf16": jproj.PEAK_BF16["v5e"]})


MEASURED_8B = {"layer_us": 41234.5, "layer_remat_us": 52345.6,
               "head_us_per_token": 1.9375, "embed_us": 312.5}
MEASURED_70B = {"layer_us": 38765.4, "layer_remat_us": 47654.3,
                "layer_seq": 2048, "head_us_per_token": 3.875,
                "embed_us": 120.25}


def test_projection_8b_equals_jax():
    hw, src = _jax_hw()
    got = projection.project_llama3_8b(MEASURED_8B, hw, measured_on=src,
                                       xfer_derate=1.10,
                                       link_efficiency=0.5)
    want = jproj.project_llama3_8b_v5p64(MEASURED_8B)
    _close(got, want, [("counts", "counts"), ("inputs", "inputs"),
                       ("plan_a_fsdp", "plan_a_fsdp64"),
                       ("plan_b_pp_fsdp_1f1b", "plan_b_pp8_fsdp8_1f1b")])
    assert got["north_star"]["meets_target"] == \
        want["north_star"]["meets_target"]


def test_projection_70b_equals_jax():
    hw, src = _jax_hw()
    got = projection.project_llama3_70b(MEASURED_70B, hw, measured_on=src,
                                        xfer_derate=1.10,
                                        link_efficiency=0.5)
    want = jproj.project_llama3_70b_v5p64(MEASURED_70B)
    _close(got, want, [("counts", "counts"), ("inputs", "inputs"),
                       ("plan_fsdp_remat", "plan_fsdp64_remat")])


def test_projection_on_one_card_needs_the_link():
    """Measured on the card it projects for: the ratio is 1 (no
    transfer); the link bandwidth must be given."""
    with pytest.raises(ValueError, match="link_bw"):
        projection.project_llama3_8b(MEASURED_8B)
    hw = dict(projection.H100, link_bw=100e9)
    a = projection.project_llama3_8b(MEASURED_8B, hw, n_chips=4, pp=2)
    assert a["plan_a_fsdp"]["t_layer_s"] == MEASURED_8B["layer_us"] * 1e-6
    assert a["plan_b_pp_fsdp_1f1b"]["mesh"] == {"pp": 2, "fsdp": 2}
    assert a["assumptions"]["target"] == a["assumptions"]["measured_on"]
    json.dumps(a)


# -- the auto-tuner (JAX's tests/test_launch_elastic_tuner.py:125-188) --------

def _cfgs(**kw):
    base = dict(num_devices=8, model_params_b=0.5, hidden_size=1024,
                num_layers=8, seq_len=2048, global_batch_size=32,
                vocab_size=32000, hbm_gb_per_device=16.0)
    base.update(kw)
    return at.TunerConfig(**base), jat.TunerConfig(**base)


def test_tuner_default_memory_is_the_card():
    assert at.TunerConfig().hbm_gb_per_device == 80.0


def test_candidates_and_memory_match_jax():
    cfg, jcfg = _cfgs()
    cands = at.default_candidates(cfg)
    assert cands and cands == jat.default_candidates(jcfg)
    for c in cands:
        assert at.estimate_memory_gb(cfg, c) == jat.estimate_memory_gb(jcfg,
                                                                       c)
    assert at.prune_by_memory(cfg, cands) == jat.prune_by_memory(jcfg,
                                                                 cands)
    tight, jtight = _cfgs(hbm_gb_per_device=0.001)
    assert at.prune_by_memory(tight, at.default_candidates(tight)) == []
    assert jat.prune_by_memory(jtight, jat.default_candidates(jtight)) == []


def test_tuner_finds_best_and_records_failures_as_jax(tmp_path):
    cfg, jcfg = _cfgs()
    tuner, jtuner = at.AutoTuner(cfg), jat.AutoTuner(jcfg)
    assert tuner.candidates == jtuner.candidates

    def run_fn(c):
        if c["mp_degree"] == 4:
            raise MemoryError("simulated OOM")
        return 1000 * c["dp_degree"] - 50 * c["pp_degree"]

    best = tuner.tune(run_fn, log_path=str(tmp_path / "hist.json"))
    assert best == jtuner.tune(run_fn) and best["mp_degree"] != 4
    hist = json.load(open(tmp_path / "hist.json"))
    metrics = [h["metric"] for h in hist["history"] if h["metric"]]
    assert hist["best"]["metric"] == max(metrics)
    assert [h["error"] for h in tuner.recorder.history] == \
        [h["error"] for h in jtuner.recorder.history]


def test_recorder_best_none_when_all_failed():
    r = at.Recorder()
    r.add({"a": 1}, None, error="boom")
    assert r.best() is None
