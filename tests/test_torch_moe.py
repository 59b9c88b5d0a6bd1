"""The port's Mixture-of-Experts slice against the JAX package's, on the
CPU.

The grouped matmul's plain version against ``xla_grouped_matmul`` and the
Pallas kernel in interpret mode, its autograd Function against
``jax.grad`` of the JAX ``grouped_matmul``; the routing functions,
``MoELayer`` (capacity and dropless) and the tiny ``MoEForCausalLM``
against their JAX counterparts with the same weights; four ``Trainer``
steps of the dropless tiny model against ``paddle_tpu.trainer.Trainer``.
Inputs come from numpy with fixed seeds. fp32 throughout but for one
bf16 grouped-matmul case; tolerance 1e-5 for single ops (the same fp32
formula in another summation order; 2e-2 in bf16, as
``tests/test_moe_ep.py`` holds the Pallas kernel), 1e-4 where a layer or
a model is compared; routing integers exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.llama import fused_loss_enabled as jax_fused_enabled
from paddle_tpu.models.moe_lm import MoEConfig as JaxMoEConfig
from paddle_tpu.models.moe_lm import MoEForCausalLM as JaxMoE
from paddle_tpu.ops.pallas import grouped_matmul as jgm
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.parallel import moe as jmoe
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.models.llama import fused_loss_enabled
from paddle_tpu_torch.models.moe_lm import (MoEConfig, MoEForCausalLM,
                                            parameter_shapes)
from paddle_tpu_torch.ops import grouped_matmul as gmm
from paddle_tpu_torch.optimizer import AdamW, clip
from paddle_tpu_torch.parallel import moe
from paddle_tpu_torch.trainer import Trainer

TOL = 1e-5
COUNTS = ([12, 12, 12, 12], [10, 0, 25, 13], [0, 0, 48, 0])


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _t(a):
    return torch.tensor(np.asarray(a))


# -- the grouped matmul ------------------------------------------------------

def _gmm_inputs(seed=0, m=48, k=16, n=24, g=4):
    rs = np.random.RandomState(seed)
    return (rs.randn(m, k).astype(np.float32),
            (0.1 * rs.randn(g, k, n)).astype(np.float32),
            rs.randn(m, n).astype(np.float32))


@pytest.mark.parametrize("counts", COUNTS, ids=str)
def test_grouped_matmul_plain_matches_xla_and_pallas(counts):
    xs, w, _ = _gmm_inputs()
    gs = np.asarray(counts, np.int32)
    got = gmm.grouped_matmul_plain(_t(xs), _t(w), _t(gs))
    assert got.dtype == torch.float32
    _close(got, jgm.xla_grouped_matmul(xs, w, gs))
    _close(got, jgm.grouped_matmul_pallas(
        jnp.asarray(xs), jnp.asarray(w), jnp.asarray(gs), block_m=8,
        block_n=8, block_k=8, interpret=True))


def test_grouped_matmul_plain_bf16_matches_xla_and_pallas():
    xs, w, _ = _gmm_inputs()
    gs = np.asarray(COUNTS[1], np.int32)
    xb, wb = jnp.asarray(xs, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    got = gmm.grouped_matmul_plain(
        _t(np.asarray(xb, np.float32)).bfloat16(),
        _t(np.asarray(wb, np.float32)).bfloat16(), _t(gs))
    _close(got, jgm.xla_grouped_matmul(xb, wb, jnp.asarray(gs)), 2e-2)
    _close(got, jgm.grouped_matmul_pallas(xb, wb, jnp.asarray(gs),
                                          block_m=8, block_n=8, block_k=8,
                                          interpret=True), 2e-2)


def _bf16_ulp_close(got, want):
    """Each entry within 2**-8 of its magnitude (under one bf16 step) of
    the bf16 rounding of the fp32 result: the two sides sum the same
    exact products in another order before one rounding."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    bad = np.abs(got - want) > 2.0 ** -8 * np.abs(want)
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


@pytest.mark.parametrize(
    "counts,dtype", [(c, "float32") for c in COUNTS]
    + [(c, "bfloat16") for c in COUNTS],
    ids=[str(c) for c in COUNTS] + [f"bf16-{c}" for c in COUNTS])
def test_grouped_matmul_grads_match_jax_grad(counts, dtype):
    """dx and dw of the autograd Function against jax.grad of the JAX
    dispatcher (whose custom vjp is ragged_dot's): an empty group's dw is
    exactly zero, and rows past the groups' sum get zero output and
    gradient. The bf16 cases take bf16 operands and an fp32 cotangent
    (the loss weights r are fp32), which the JAX backward keeps fp32:
    dx and dw are the bf16 roundings of fp32 sums of exact products."""
    xs, w, r = _gmm_inputs(seed=1)
    gs = np.asarray(counts, np.int32)
    if dtype == "bfloat16":
        xs = np.asarray(jnp.asarray(xs, jnp.bfloat16), np.float32)
        w = np.asarray(jnp.asarray(w, jnp.bfloat16), np.float32)

    def jloss(x, ww):
        return jnp.sum(jgm.grouped_matmul(x, ww, jnp.asarray(gs)) * r)
    jdx, jdw = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(xs, dtype), jnp.asarray(w, dtype))
    tdt = getattr(torch, dtype)
    tx = _t(xs).to(tdt).requires_grad_()
    tw = _t(w).to(tdt).requires_grad_()
    (gmm.grouped_matmul(tx, tw, _t(gs)) * _t(r)).sum().backward()
    assert tx.grad.dtype == tw.grad.dtype == tdt
    if dtype == "float32":
        _close(tx.grad, jdx)
        _close(tw.grad, jdw)
    else:
        _bf16_ulp_close(tx.grad.float(), np.asarray(jdx, np.float32))
        _bf16_ulp_close(tw.grad.float(), np.asarray(jdw, np.float32))
    for i, c in enumerate(counts):
        if c == 0:
            assert torch.count_nonzero(tw.grad[i]) == 0


def test_grouped_matmul_rows_past_the_groups_are_zero():
    xs, w, _ = _gmm_inputs()
    gs = np.asarray([10, 0, 20, 6], np.int32)          # sums to 36 of 48
    tx = _t(xs).requires_grad_()
    y = gmm.grouped_matmul(tx, _t(w), _t(gs))
    _close(y.detach(), jgm.xla_grouped_matmul(xs, w, gs))
    assert torch.count_nonzero(y[36:]) == 0
    y.sum().backward()
    assert torch.count_nonzero(tx.grad[36:]) == 0


# -- routing -----------------------------------------------------------------

def _logits(seed=2, t=24, e=6):
    return np.random.RandomState(seed).randn(t, e).astype(np.float32)


@pytest.mark.parametrize("k,capacity", [(1, 3), (2, 5), (2, 100)])
def test_routing_dispatch_and_combine_match_jax(k, capacity):
    """top_k_routing's slots (exact), gates and aux loss; dispatch_tokens
    and combine_tokens over them; the one-hot oracle top_k_gating; and
    routing_stats — all equal to the JAX functions'."""
    logits = _logits()
    rs = np.random.RandomState(3)
    t, e = logits.shape
    flat = rs.randn(t, 8).astype(np.float32)
    ye = rs.randn(e, capacity, 8).astype(np.float32)
    js, jg, ja = jax.jit(jmoe.top_k_routing, static_argnums=(1, 2))(
        jnp.asarray(logits), k, capacity)
    ts, tg, ta = moe.top_k_routing(_t(logits), k, capacity)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close(tg, jg)
    _close(ta, ja)
    _close(moe.dispatch_tokens(_t(flat), ts, e, capacity),
           jmoe.dispatch_tokens(jnp.asarray(flat), js, e, capacity))
    for renorm in (False, True):
        _close(moe.combine_tokens(_t(ye), ts, tg, renorm),
               jmoe.combine_tokens(jnp.asarray(ye), js, jg, renorm))
    jd, jc, jax_aux = jax.jit(jmoe.top_k_gating, static_argnums=(1, 2))(
        jnp.asarray(logits), k, capacity)
    td, tc, taux = moe.top_k_gating(_t(logits), k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _close(tc, jc)
    _close(taux, jax_aux)
    jz = jmoe.routing_stats(jnp.asarray(logits), k)
    tz = moe.routing_stats(_t(logits), k)
    _close(tz[0], jz[0])
    _close(tz[1], jz[1])
    assert tz[2].dtype == torch.int32
    np.testing.assert_array_equal(tz[2].numpy(), np.asarray(jz[2]))


def test_routing_jitter_draws_from_the_generator():
    """Jitter needs both eps > 0 and a generator (the JAX key); the same
    seed draws the same noise."""
    logits = _logits(seed=4)
    plain = moe.top_k_routing(_t(logits), 2, 6)[0]
    assert torch.equal(moe.top_k_routing(_t(logits), 2, 6, 0.5)[0], plain)
    a, b = (moe.top_k_routing(_t(logits), 2, 6, 0.5,
                              torch.Generator().manual_seed(7))[1]
            for _ in range(2))
    assert torch.equal(a, b)
    assert not torch.equal(a, moe.top_k_routing(_t(logits), 2, 6)[1])


# -- the layer ----------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [1.25, None])
def test_moe_layer_forward_and_grads_match_jax(capacity_factor):
    """MoELayer(128, 64, 4 experts, top-2) with the JAX layer's weights:
    output, aux loss and the gradients of sum(out * r) + aux in x and in
    every parameter, within 1e-4. At 1.25 some assignments drop."""
    import paddle_tpu as pt
    pt.seed(11)
    jl = jmoe.MoELayer(128, 64, 4, top_k=2, capacity_factor=capacity_factor)
    params = {k: np.asarray(v) for k, v in jl.raw_parameters().items()}
    tl = moe.MoELayer(128, 64, 4, top_k=2, capacity_factor=capacity_factor,
                      device="cpu")
    tl.load_state_dict({k: _t(v) for k, v in params.items()})
    rs = np.random.RandomState(12)
    x = rs.randn(2, 16, 128).astype(np.float32)
    r = rs.randn(2, 16, 128).astype(np.float32)

    def jloss(p, xx):
        out, aux = jl.functional_call(p, xx)
        return jnp.sum(out * r) + aux, (out, aux)
    (_, jv), (jgp, jgx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    tx = _t(x).requires_grad_()
    out, aux = tl(tx)
    _close(out.detach(), jv[0], 1e-4)
    _close(aux.detach(), jv[1], 1e-4)
    ((out * _t(r)).sum() + aux).backward()
    _close(tx.grad, jgx, 1e-4)
    for name, p in tl.named_parameters():
        _close(p.grad, jgp[name], 1e-4)
    np.testing.assert_array_equal(
        tl.routing_histogram(_t(x)).numpy(),
        np.asarray(jl.routing_histogram(jnp.asarray(x))))


def test_expert_parallel_paths_refuse_without_a_mesh():
    layer = moe.MoELayer(16, 8, 4, device="cpu")
    for fn in (layer._forward_capacity_ep, layer._forward_dropless_ep):
        with pytest.raises(NotImplementedError, match="A.4"):
            fn(torch.zeros(4, 16), None, 2)


# -- the model ----------------------------------------------------------------

def _pair(seed, **kw):
    """The JAX tiny MoE model with ``kw`` on its config, and the port's
    twin with the same weights."""
    import paddle_tpu as pt
    pt.seed(seed)
    jm = JaxMoE(JaxMoEConfig.tiny(**kw))
    cfg = MoEConfig.tiny(**kw)
    tm = MoEForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}, cfg,
        device="cpu"))
    return jm, tm


def _batch(cfg, seed, b=2, s=32):
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (b, s + 1))
    labels = ids[:, 1:].copy()
    labels[0, 5] = -100
    return {"input_ids": ids[:, :-1], "labels": labels}


def _jax_outputs(jm, batch):
    """The JAX model under one jit: its logits without labels, (loss,
    logits) with them, and the loss's gradients."""
    params = dict(jm.raw_parameters())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def run(p):
        loss, logits = jm.functional_call(p, **jb)
        return loss, (logits, jm.functional_call(p, jb["input_ids"]))
    (loss, (logits, plain)), grads = jax.jit(jax.value_and_grad(
        run, has_aux=True))(params)
    return loss, logits, plain, {k: np.asarray(v) for k, v in grads.items()}


def _torch_loss_and_grads(tm, batch):
    tm.zero_grad(set_to_none=True)
    loss = tm(**{k: _t(v) for k, v in batch.items()}, return_logits=False)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in
                           tm.named_parameters()}


@pytest.mark.parametrize("capacity_factor,loss_impl,gated", [
    (None, "fused", False), (None, "naive", True), (1.25, "fused", True)])
def test_model_logits_loss_and_grads_match_jax(capacity_factor, loss_impl,
                                               gated, monkeypatch):
    """The tiny MoE model with the JAX model's weights: logits without
    labels, (loss, logits) with them, and every gradient, within 1e-4;
    both loss heads (the naive one through PT_NAIVE_LOSS_HEAD, as the
    JAX switch), Qwen2-MoE's shared-expert gate, both routings."""
    if loss_impl == "naive":
        monkeypatch.setenv("PT_NAIVE_LOSS_HEAD", "1")
    jm, tm = _pair(13, capacity_factor=capacity_factor,
                   shared_expert_gate=gated)
    assert fused_loss_enabled(tm.cfg) == (loss_impl == "fused")
    batch = _batch(tm.cfg, 14)
    jl, jlog, jplain, jg = _jax_outputs(jm, batch)
    _close(tm(_t(batch["input_ids"])).detach(), jplain, 1e-4)
    tl, tlog = tm(**{k: _t(v) for k, v in batch.items()})
    _close(tl.detach(), jl, 1e-4)
    _close(tlog.detach(), jlog, 1e-4)
    tl, tg = _torch_loss_and_grads(tm, batch)
    _close(tl, jl, 1e-4)
    assert set(tg) == set(jg)
    for name in jg:
        _close(tg[name], jg[name], 1e-4)


def test_recompute_full_matches_none_and_jax():
    """recompute="full" gives the gradients without it within 1e-6 and
    the JAX model's within 1e-4 (dropless routing)."""
    jm, tm = _pair(15, capacity_factor=None, recompute="full")
    batch = _batch(tm.cfg, 16)
    tl, tg = _torch_loss_and_grads(tm, batch)
    tm.cfg.recompute = "none"
    try:
        nl, ng = _torch_loss_and_grads(tm, batch)
    finally:
        tm.cfg.recompute = "full"
    _close(tl, nl, 1e-6)
    jl, _, _, jg = _jax_outputs(jm, batch)
    _close(tl, jl, 1e-4)
    for name in jg:
        _close(tg[name], ng[name], 1e-6)
        _close(tg[name], jg[name], 1e-4)


def test_trainer_four_dropless_steps_match_jax_trainer():
    """Four Trainer steps of the dropless tiny model (AdamW(1e-3,
    weight_decay=0.01), global-norm clip 1.0) against four of
    ``paddle_tpu.trainer.Trainer``: every loss and every final parameter
    within 1e-4. (Adam divides each element's gradient by its own
    magnitude, so an element whose gradient is near zero moves by up to
    the learning rate on rounding alone; the seed is one without such an
    element.)"""
    jm, tm = _pair(23, capacity_factor=None)
    ours = Trainer(tm, AdamW(learning_rate=1e-3, parameters=tm,
                             weight_decay=0.01,
                             grad_clip=clip.ClipGradByGlobalNorm(1.0)))
    theirs = JaxTrainer(jm, JaxAdamW(learning_rate=1e-3, parameters=jm,
                                     weight_decay=0.01,
                                     grad_clip=jclip.ClipGradByGlobalNorm(
                                         1.0)), donate=False)
    for step in range(4):
        batch = _batch(tm.cfg, 20 + step)
        tl = ours.train_step({k: _t(v) for k, v in batch.items()})
        jl = theirs.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        _close(tl, jl, 1e-4)
    final = tm.state_dict()
    for name, val in theirs.params.items():
        _close(final[name], val, 1e-4)


@pytest.mark.parametrize("preset", ["deepseek_moe_16b", "qwen2_moe_a14b",
                                    "tiny"])
def test_presets_and_size_accounting_match_jax(preset):
    """Every preset's fields equal the JAX preset's; the parameter count,
    activated parameters and flops_per_token equal the JAX model's (the
    tiny model, built), or follow from parameter_shapes (the full
    presets, counted from shapes)."""
    import dataclasses
    jcfg = getattr(JaxMoEConfig, preset)(capacity_factor=None)
    cfg = getattr(MoEConfig, preset)(capacity_factor=None)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    n = sum(int(np.prod(s)) for s, _ in parameter_shapes(cfg).values())
    if preset == "tiny":
        jm, tm = _pair(18, capacity_factor=None)
        assert tm.num_params() == jm.num_params() == n
        assert tm.num_activated_params() == jm.num_activated_params()
        assert tm.flops_per_token(32) == jm.flops_per_token(32)
    else:
        # the DeepSeekMoE-16B preset has 16.4 B parameters
        assert preset != "deepseek_moe_16b" or 16.3e9 < n < 16.5e9


def test_state_dict_from_jax_checks_moe_keys():
    import paddle_tpu as pt
    pt.seed(19)
    jm = JaxMoE(JaxMoEConfig.tiny(shared_expert_gate=True))
    cfg = MoEConfig.tiny(shared_expert_gate=True)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    out = state_dict_from_jax(sd, cfg, device="cpu", dtype="bfloat16")
    assert out["layers.1.moe.experts.w_gate_up"].dtype == torch.bfloat16
    assert out["layers.1.moe.gate_weight"].dtype == torch.float32
    assert out["layers.1.shared_experts.gate"].dtype == torch.float32
    bad = dict(sd)
    bad["layers.1.moe.gate"] = bad.pop("layers.1.moe.gate_weight")
    with pytest.raises(ValueError, match="MoEConfig.*missing=.*gate_weight"
                       ".*extra=.*moe.gate"):
        state_dict_from_jax(bad, cfg, device="cpu")
    bad = dict(sd)
    bad["layers.1.moe.experts.w_down"] = np.zeros((4, 128, 64), np.float32)
    with pytest.raises(ValueError, match="wrong_shape=.*w_down"):
        state_dict_from_jax(bad, cfg, device="cpu")


def test_a_config_without_loss_impl_takes_the_fused_head():
    """MoEConfig has no loss_impl field; the JAX function reads it with a
    default of "fused", and so does the port's (it raised AttributeError
    before)."""
    assert not hasattr(MoEConfig.tiny(), "loss_impl")
    assert fused_loss_enabled(MoEConfig.tiny())
    assert jax_fused_enabled(JaxMoEConfig.tiny())
