"""The sharding planner of the port against the JAX package's
(``paddle_tpu.distributed.auto_parallel``): enumeration and legality,
``ParallelConfig`` text, the memory model field for field, emitted plans
byte for byte, and the drift and rank-agreement verdicts all equal
JAX's; the census of one step in a fake world of 4 counts the
collectives the tensor-parallel layers and the gradient sums issue; the
pricing is exact arithmetic over the census; a wrapped op prices its
kernel's counts on the plain route; an infeasible mesh is pruned before
any census; the CLI's exit codes. JAX's own pricing compiles a step,
which is red on this jax (ROADMAP.md Notes): only the green functions
are oracles here."""

import json

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import auto_parallel as ap
from paddle_tpu_torch.distributed.auto_parallel import planner
from paddle_tpu_torch.models.llama import LlamaConfig
from paddle_tpu_torch.models.moe_lm import MoEConfig

BW = {"tp": 1e9, "dp": 2e9, "fsdp": 2e9, "sep": 4e9, "pp": 8e9}

MICRO = dict(vocab_size=320, hidden_size=64, intermediate_size=96,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128)
MOE_MICRO = dict(MICRO, moe_intermediate_size=48, num_experts=4,
                 num_experts_per_tok=2, num_shared_experts=1,
                 first_k_dense_replace=1, capacity_factor=None)


def _pairs():
    """(port config, JAX config) of the tiny Llama, the MoE micro config
    and Llama-3-8B."""
    from paddle_tpu.models import LlamaConfig as JL
    from paddle_tpu.models.moe_lm import MoEConfig as JM
    return [(LlamaConfig.tiny(), JL.tiny()),
            (MoEConfig(**MOE_MICRO), JM(**MOE_MICRO)),
            (LlamaConfig.llama3_8b(), JL.llama3_8b())]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_enumerate_and_legality_equal_jax(which):
    """Every device count 1–16 and three batch/sequence settings: the
    same legal configs in the same order, the same verdict of ``_legal``
    for every factorization, and ``str`` / ``parse`` the JAX text."""
    import itertools
    from paddle_tpu.distributed.auto_parallel import planner as jpl
    mine, theirs = _pairs()[which]
    for n in range(1, 17):
        for gb, sl in ((8, 32), (16, 64), (2, 8192)):
            a = [str(c) for c in ap.enumerate_configs(
                n, mine, global_batch=gb, seq_len=sl)]
            b = [str(c) for c in jpl.enumerate_configs(
                n, theirs, global_batch=gb, seq_len=sl)]
            assert a == b, (n, gb, sl)
            for c in a:
                assert str(ap.ParallelConfig.parse(c)) == c
                assert ap.ParallelConfig.parse(c) .axes() == \
                    jpl.ParallelConfig.parse(c).axes()
        divs = [d for d in range(1, n + 1) if n % d == 0]
        for dp, tp, pp, fsdp, ep in itertools.product(divs, repeat=5):
            if dp * tp * pp * fsdp != n or (ep > 1 and dp % ep):
                continue
            c, jc = (ap.ParallelConfig(dp=dp, tp=tp, pp=pp, fsdp=fsdp,
                                       ep=ep),
                     jpl.ParallelConfig(dp=dp, tp=tp, pp=pp, fsdp=fsdp,
                                        ep=ep))
            assert planner._legal(c, mine, 8, 32) == \
                jpl._legal(jc, theirs, 8, 32), str(c)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_estimate_hbm_equals_jax_field_for_field(which):
    from paddle_tpu.distributed.auto_parallel import (
        ParallelConfig as JPC, estimate_hbm as jest)
    mine, theirs = _pairs()[which]
    for c in ap.enumerate_configs(8, mine, global_batch=8, seq_len=64):
        for budget in (1e6, 80e9 * 0.9):
            a = ap.estimate_hbm(mine, c, global_batch=8, seq_len=64,
                                budget_bytes=budget)
            b = jest(theirs, JPC.parse(str(c)), global_batch=8,
                     seq_len=64, budget_bytes=budget)
            assert a.feasible == b.feasible
            for k, v in b.as_dict().items():
                if isinstance(v, bool):
                    assert a.as_dict()[k] == v
                else:
                    np.testing.assert_allclose(a.as_dict()[k], v,
                                               rtol=1e-12)
            for k, v in b.detail.items():
                np.testing.assert_allclose(a.detail[k], v, rtol=1e-12)
    assert ap.hbm_capacity("NVIDIA H100 80GB HBM3") == 80e9


@pytest.mark.parametrize("text,moe", [("dp4_tp2", False),
                                      ("dp2_fsdp2_tp2", False),
                                      ("pp2", False), ("sep2", False),
                                      ("dp2_ep2_tp2", True)])
def test_plan_as_dict_byte_identical_to_jax(text, moe):
    """``plan_for_config`` (the model on the meta device) emits JAX's
    plan byte for byte, and ``from_dict`` round-trips it."""
    import jax
    from paddle_tpu.distributed.auto_parallel import (
        ParallelConfig as JPC, plan_for_config as jplan)
    from paddle_tpu.models import LlamaConfig as JL
    from paddle_tpu.models.moe_lm import MoEConfig as JM
    jc = JPC.parse(text)
    cfg, jcfg = ((MoEConfig.tiny(), JM.tiny()) if moe
                 else (LlamaConfig.tiny(), JL.tiny()))
    want = json.dumps(jplan(jcfg, jc, devices=jax.devices()[:jc.size])
                      .as_dict(), sort_keys=True)
    got = ap.plan_for_config(cfg, ap.ParallelConfig.parse(text))
    assert json.dumps(got.as_dict(), sort_keys=True) == want
    back = ap.ShardingPlan.from_dict(json.loads(want))
    assert json.dumps(back.as_dict(), sort_keys=True) == want


@pytest.fixture(scope="module")
def micro_records():
    """The census of the micro Llama at dp2_tp2, dp2_fsdp2 and dp2_pp2
    in a fake world of 4 (one call: the children run side by side)."""
    return planner.census_configs(
        LlamaConfig(**MICRO), [ap.ParallelConfig.parse(c) for c in
                               ("dp2_tp2", "dp2_fsdp2", "dp2_pp2")], 4,
        global_batch=4, seq_len=32)


def test_census_counts_tp_layers_and_grad_sums():
    """One dp2_tp2 step of the tiny Llama (3 layers) in a fake world of 4,
    on the meta device. Per axis:
    tp — 4 a layer (the row-parallel sums of o_proj and down_proj in the
    forward, the input-gradient sums of the column-parallel qkv and
    gate_up in the backward), 1 for the vocab-parallel embedding and 4
    for the vocab-parallel fused CE head (``mp_layers``: its input
    gradient, the max, the sum of exponentials, the target logit);
    dp — 1 a parameter (``MeshPlan.sync_grads``), plus the global token
    count and the loss's sum of the global mean."""
    L = 3
    cfg = LlamaConfig.tiny(num_hidden_layers=L)
    rec = planner.census_configs(cfg, [ap.ParallelConfig(dp=2, tp=2)], 4,
                                 global_batch=8, seq_len=32)
    rec = rec["dp2_tp2_pp1_sep1"]
    assert "error" not in rec, rec.get("error")
    n_params = 6 * L + 3
    counts = {}
    for c in rec["collectives"]:
        counts[(c["opcode"], c["axis"])] = counts.get(
            (c["opcode"], c["axis"]), 0) + 1
    assert counts == {("all-reduce", "tp"): 4 * L + 1 + 4,
                      ("all-reduce", "dp"): n_params + 2}
    assert rec["plan"]["axes"]["tp"] == 2
    kernels = {o[0] for o in rec["ops"] if o[3]}
    assert {"rms_norm", "rms_norm_bwd", "fused_rope", "flash_fwd",
            "flash_bwd", "vocab_ce_fwd", "vocab_ce_bwd"} <= kernels


def test_price_compiled_is_exact_arithmetic(micro_records):
    """Priced with synthetic bandwidths: the comm term is each
    collective's bytes over its axis's bandwidth, the compute term each
    op's max(flops ÷ peak, bytes ÷ memory bandwidth), and the prediction
    exactly the sum of its components."""
    from paddle_tpu_torch.observability.costs import device_spec
    spec = device_spec("cpu")
    cfg = LlamaConfig(**MICRO)
    rec = micro_records["dp2_tp2_pp1_sep1"]
    g = ap.price_compiled(rec, spec=spec, bandwidths=BW,
                          dispatch_floor_s=1e-4)
    comm = 0.0
    for c in rec["collectives"]:
        comm += c["bytes"] / float(BW.get(c["axis"], spec.link_bw))
    assert g.comm_s == comm
    compute = 0.0
    for name, fl, nb, _k, count in rec["ops"]:
        for _ in range(count):
            compute += max(fl / spec.peak_flops, nb / spec.hbm_bw)
    assert g.compute_s == pytest.approx(compute, rel=1e-12)
    assert g.predicted_step_s == (max(g.compute_s, 0.0) + g.comm_s
                                  + g.collective_floor_s + g.dispatch_s)
    assert g.collective_floor_s == len(rec["collectives"]) * 2e-6
    pc = ap.price_config(ap.ParallelConfig(dp=2, tp=2), cfg,
                         global_batch=4, seq_len=32, bandwidths=BW,
                         spec=spec, record=rec)
    d = pc.as_dict()
    assert d["config"] == "dp2_tp2_pp1_sep1" and d["memory"]["feasible"]
    assert 0 < d["predicted_mfu"] < 1
    assert d["census_counts"]["all-reduce[tp]"] > 0


def _unit_bytes(cfg):
    """(one decoder layer's parameter bytes, the root unit's: embedding,
    final norm and head), fp32."""
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * cfg.head_dim
    layer = H * (H + 2 * kv) + H * H + H * 2 * I + I * H + 2 * H
    return 4 * layer, 4 * (2 * V * H + H)


def test_census_counts_fsdp_units_on_meta(micro_records):
    """FSDP2 steps on the meta device under the census: each decoder
    layer's unit is gathered twice (forward, and again for the backward
    after its reshard) and its gradient reduce-scattered once, the root
    unit gathered and reduce-scattered once, each gather at the unit's
    unsharded bytes; the dp axis sums each parameter's gradient shard
    (``MeshPlan.sync_grads``) and the data ranks the token count and the
    loss."""
    cfg = LlamaConfig(**MICRO)
    L = cfg.num_hidden_layers
    rec = micro_records["dp2_fsdp2_tp1_pp1_sep1"]
    assert "error" not in rec, rec.get("error")
    layer_b, root_b = _unit_bytes(cfg)
    gathers = sorted(c["bytes"] for c in rec["collectives"]
                     if c["opcode"] == "all-gather")
    assert gathers == sorted([root_b] + [layer_b] * (2 * L))
    counts = {}
    for c in rec["collectives"]:
        key = (c["opcode"], c["axis"])
        counts[key] = counts.get(key, 0) + 1
    assert counts == {("all-gather", "fsdp"): 2 * L + 1,
                      ("reduce-scatter", "fsdp"): L + 1,
                      ("all-reduce", "dp"): 6 * L + 3,
                      ("all-reduce", "dp+fsdp"): 2}


def test_pipeline_priced_over_every_tick(micro_records):
    """A pp config's record holds the census of its first and its last
    stage (the head's kernels run on the last only); its price is the
    slower stage's compute and per-tick collectives times
    (M + S - 1) / M, plus its once-a-step gradient sums over dp, exactly."""
    from paddle_tpu_torch.observability.costs import device_spec
    spec = device_spec("cpu")
    rec = micro_records["dp2_tp1_pp2_sep1"]
    assert "error" not in rec, rec.get("error")
    pipe = rec["pipeline"]
    S, M = pipe["stages"], pipe["microbatches"]
    assert (S, M) == (2, 2)
    heads = [{o[0] for o in st["ops"] if o[3]}
             for st in (rec, pipe["last_stage"])]
    assert "vocab_ce_fwd" not in heads[0] and "vocab_ce_fwd" in heads[1]
    scale = (M + S - 1) / M
    floor = 2e-6
    want = []
    for st in (rec, pipe["last_stage"]):
        compute = 0.0
        for _name, fl, nb, _k, count in st["ops"]:
            for _ in range(count):
                compute += max(fl / spec.peak_flops, nb / spec.hbm_bw)
        tick = once = 0.0
        n_tick = n_once = 0
        for c in st["collectives"]:
            sec = c["bytes"] / float(BW.get(c["axis"], spec.link_bw))
            if c["axis"] == "dp":
                once, n_once = once + sec, n_once + 1
            else:
                tick, n_tick = tick + sec, n_tick + 1
        assert n_tick > 0 and n_once > 0
        want.append(compute * scale + (tick * scale + once)
                    + (n_tick * scale + n_once) * floor + 1e-4)
    g = ap.price_compiled(rec, spec=spec, bandwidths=BW,
                          dispatch_floor_s=1e-4)
    assert g.predicted_step_s == pytest.approx(max(want), rel=1e-12)
    assert want[1] > want[0] and "last stage" in g.notes[-1]


@pytest.mark.parametrize("which", ["llama", "moe"])
def test_plan_prices_every_candidate_it_keeps(which):
    """Every candidate of the micro models on 4 ranks is priced or pruned
    for a stated reason (the memory model, or a composition or width the
    port does not run); none is pruned because its census failed."""
    cfg = (LlamaConfig(**MICRO) if which == "llama"
           else MoEConfig(**MOE_MICRO))
    rep = ap.plan(cfg, n_devices=4, global_batch=4, seq_len=32,
                  drift="ignore")
    reasons = {str(pc.config): pc.reason for pc in rep.pruned}
    assert not [c for c, r in reasons.items()
                if not r.startswith(("HBM infeasible",
                                     "not run by the port"))], reasons
    kept = {str(pc.config) for pc in rep.ranked}
    assert {"dp1_fsdp4_tp1_pp1_sep1", "dp2_tp2_pp1_sep1"} <= kept
    if which == "llama":
        assert "dp2_tp1_pp2_sep1" in kept
        assert reasons["dp1_fsdp2_tp1_pp2_sep1"].startswith(
            "not run by the port: pp with fsdp")
    else:
        assert "dp2_fsdp2_ep2_tp1_pp1_sep1" in kept


def test_grouped_matmul_prices_its_kernel_on_meta():
    """The grouped product reports its kernel's counts under the census
    and runs on the meta device (shapes only: no counts are read), the
    same records as on the CPU."""
    from paddle_tpu_torch.analysis.collectives import StepCensus
    from paddle_tpu_torch.ops.grouped_matmul import grouped_matmul
    m, k, n, g = 12, 8, 5, 3
    rec = {}
    for device in ("cpu", "meta"):
        xs = torch.randn(m, k).to(device).requires_grad_(True)
        w = torch.randn(g, k, n).to(device).requires_grad_(True)
        sizes = torch.tensor([4, 0, 8]).to(device)
        with StepCensus() as c:
            y = grouped_matmul(xs, w, sizes)
            dx, dw = torch.autograd.grad(y.sum(), (xs, w))
        assert (y.shape, dx.shape, dw.shape) == ((m, n), (m, k), (g, k, n))
        rec[device] = [(o.name, o.flops, o.bytes) for o in c.ops
                       if o.kernel]
    assert rec["meta"] == rec["cpu"] == [
        ("grouped_matmul", 2 * m * k * n, 4 * (m * k + g * k * n + m * n)),
        ("grouped_matmul_bwd", 4 * m * k * n,
         4 * (m * n + g * k * n + m * k + m * (k + n) + g * k * n))]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrapped_ops_price_their_kernels_counts(device):
    """Under the census a wrapped op reports its kernel's flops and bytes
    (``PERF.md``'s bound counts) and nothing of the plain route beneath:
    the same records on the CPU and on the meta device."""
    from paddle_tpu_torch.analysis.collectives import StepCensus
    from paddle_tpu_torch.ops import attention, norm, rope, vocab_ce
    b, s, h, hk, d, V = 2, 16, 4, 2, 32, 96
    g = torch.Generator().manual_seed(0)

    def t(*shape, grad=False):
        x = torch.randn(shape, generator=g).to(device)
        return x.requires_grad_(grad)
    x, w = t(b * s, h * d, grad=True), t(h * d, grad=True)
    q, k, v = t(b, s, h, d, grad=True), t(b, s, hk, d, grad=True), \
        t(b, s, hk, d, grad=True)
    cos, sin = rope.rope_freqs(d, 64, device=device)
    hw = t(h * d, V, grad=True)
    labels = torch.randint(0, V, (b * s,), generator=g).to(device)
    with StepCensus() as c:
        y = norm.rms_norm(x, w)
        torch.autograd.grad(y.sum(), (x, w))
        qr, kr = rope.apply_rotary_pos_emb(q, k, cos, sin)
        o = attention.flash_attention(qr, kr, v, causal=True)
        torch.autograd.grad(o.sum(), (q, k, v))
        lse, tgt = vocab_ce.lse_and_target(x, hw, labels)
        torch.autograd.grad((lse - tgt).sum(), (x, hw))
    kern = [(o.name, o.flops, o.bytes) for o in c.ops if o.kernel]
    R, D = b * s, h * d
    pairs = b * h * s * (s + 1) // 2
    qb, kvb, rowb = b * s * h * d * 4, b * s * hk * d * 4, b * h * s * 4
    N, H = b * s, h * d
    rope_cost = (3 * b * s * (h + hk) * d,
                 2 * b * s * (h + hk) * d * 4 + 2 * b * s * d * 4)
    assert kern == [
        ("rms_norm", 4 * R * D, 2 * R * D * 4 + D * 4 + R * 4),
        ("rms_norm_bwd", 9 * R * D, 3 * R * D * 4 + R * 4 + 2 * D * 4),
        ("fused_rope", *rope_cost),
        ("flash_fwd", 4 * d * pairs, 2 * qb + 2 * kvb + rowb),
        ("flash_bwd", 10 * d * pairs, 3 * qb + 4 * kvb + 2 * rowb),
        ("fused_rope", *rope_cost),
        ("vocab_ce_fwd", 2 * N * H * V, N * H * 4 + H * V * 4 + 3 * N * 4),
        ("vocab_ce_bwd", 6 * N * H * V,
         2 * N * H * 4 + 2 * H * V * 4 + 4 * N * 4)]
    # the plain route's own products never reach the census
    assert not any(o.name in ("aten.mm", "aten.bmm", "aten.einsum")
                   and o.flops >= 2 * N * H * V for o in c.ops)


def test_hbm_pruning_at_tiny_budget_takes_no_census(monkeypatch):
    """An infeasible config is pruned before any census child starts,
    with the budget arithmetic in its reason; when everything is pruned
    ``plan`` raises InfeasibleMeshError, as JAX's does."""
    from paddle_tpu.distributed.auto_parallel import (
        InfeasibleMeshError as JInf, plan as jplan)
    from paddle_tpu.models import LlamaConfig as JL

    def boom(*a, **k):
        raise AssertionError("a census was taken for a pruned config")
    monkeypatch.setattr(planner, "census_configs", boom)
    pc = ap.price_config(ap.ParallelConfig(dp=2, tp=2),
                         LlamaConfig(**MICRO), global_batch=4, seq_len=32,
                         hbm_budget_bytes=10_000)
    assert not pc.feasible and pc.graph is None
    assert "HBM infeasible" in pc.reason
    assert pc.memory.total_bytes > 10_000
    with pytest.raises(ap.InfeasibleMeshError):
        ap.plan(LlamaConfig(**MICRO), n_devices=4, global_batch=4,
                seq_len=32, hbm_budget_bytes=10_000, drift="ignore")
    with pytest.raises(JInf):
        jplan(JL(**MICRO), n_devices=4, global_batch=4, seq_len=32,
              hbm_budget_bytes=10_000, drift="ignore")
    with pytest.raises(ap.InfeasibleMeshError, match="only 8 exist"):
        ap.plan(LlamaConfig(**MICRO), n_devices=32,
                devices=list(range(8)), drift="ignore")
    with pytest.raises(ap.InfeasibleMeshError):
        ap.plan(LlamaConfig(**MICRO), n_devices=4, drift="ignore",
                configs=[ap.ParallelConfig(dp=8)])


@pytest.fixture
def drifted():
    """The same out-of-band gauge in both frameworks' registries."""
    import paddle_tpu.observability as jobs
    import paddle_tpu_torch.observability as obs
    for reg in (jobs.REGISTRY, obs.REGISTRY):
        reg.enable()
        reg.gauge("pt_step_time_predicted_over_measured", "test").set(
            50.0, component="trainer")
    yield
    for reg in (jobs.REGISTRY, obs.REGISTRY):
        reg.gauge("pt_step_time_predicted_over_measured", "test").clear(
            component="trainer")
        reg.disable()


def test_drift_warn_and_refuse(drifted):
    from paddle_tpu.distributed.auto_parallel import check_drift as jcd
    verdict = ap.check_drift()
    assert verdict == jcd()
    assert verdict["status"] == "stale"
    assert verdict["ratios"]["trainer"] == 50.0
    with pytest.raises(ap.StaleCostModelError):
        ap.plan(LlamaConfig(**MICRO), n_devices=4, drift="refuse")
    with pytest.warns(RuntimeWarning, match="recalibrate"):
        with pytest.raises(ap.InfeasibleMeshError):
            ap.plan(LlamaConfig(**MICRO), n_devices=4, drift="warn",
                    configs=[ap.ParallelConfig(dp=8)])


def test_drift_ok_and_rank_agreement_equal_jax():
    from paddle_tpu.distributed.auto_parallel import (check_drift as jcd,
                                                      rank_agreement as jra)
    assert ap.check_drift() == jcd() and ap.check_drift()["status"] == "ok"
    rs = np.random.RandomState(3)
    for _ in range(20):
        p, m = rs.rand(6).tolist(), rs.rand(6).tolist()
        assert ap.rank_agreement(p, m) == jra(p, m)
    assert ap.rank_agreement([1, 2, 3], [30, 20, 10]) == 0.0
    assert ap.ep_imbalance([4, 0, 0, 0], 2) == 2.0


def test_plan_cli_exit_codes_and_micro_smoke(capsys):
    from paddle_tpu_torch.tools import plan as cli
    assert cli.main(["--mesh", "8x4", "--available", "8"]) == 2
    assert "InfeasibleMeshError" in capsys.readouterr().err
    assert cli.main(["--mesh", "2x2", "--model", "llama-micro", "--batch",
                     "4", "--seq", "32", "--config", "dp2_tp2",
                     "--json"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["chosen"] == "dp2_tp2_pp1_sep1"
    assert out["ranked"][0]["plan"]["axes"]["tp"] == 2
    assert out["ranked"][0]["predicted_step_s"] > 0
