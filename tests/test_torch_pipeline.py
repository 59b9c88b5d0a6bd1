"""Pipeline parallelism of the port in one process (every stage virtual)
against the JAX package on the CPU: ``pipeline_1f1b`` (loss, stage and
head gradients, dx; remat on and off; mean and weighted losses) for
S in {2, 4} and M in {1, 4, 8}, the GPipe and interleaved forwards and
their gradients, the bounded live set of 1F1B (microbatches held per
stage at the peak), the tick counts, ``LlamaForCausalLMPipe``'s fused
step and forward against JAX's (GPipe, 1F1B with remat on and off,
interleaved, tied embeddings, uneven padding across microbatches), the
weight carry from JAX's stacked leaves, the layer descriptors and
segmentation, and ``recompute_sequential`` / ``recompute_hybrid``
against no recompute. fp32: 1e-5 (relative and absolute) on the
synthetic stages, 1e-4 on the model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import LlamaForCausalLMPipe as JaxPipe
from paddle_tpu.parallel import pipeline as jpipe
from paddle_tpu.parallel import schedules as jsched
from paddle_tpu_torch.distributed import (recompute_hybrid,
                                          recompute_sequential)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           LlamaForCausalLMPipe, pipe_name)
from paddle_tpu_torch.parallel import pipeline as ppipe
from paddle_tpu_torch.parallel import schedules as psched

D = 8


def _stage_inputs(S, M, seed=0):
    rs = np.random.RandomState(seed)
    f = lambda *s: rs.randn(*s).astype(np.float32)
    mask = (rs.rand(M, 3, 4) > 0.3).astype(np.float32)
    mask[0] = 0.0 if M > 1 else mask[0]      # an all-ignored microbatch
    return {"w": f(S, D, D) * 0.4, "b": f(S, D) * 0.1, "x": f(M, 3, 4, D),
            "wh": f(D, 5) * 0.5, "tgt": f(M, 3, 4, 5), "mask": mask}


def _jax_1f1b(a, S, remat, weighted):
    def stage(p, h):
        return jnp.tanh(h @ p["w"] + p["b"])

    def head(hp, h, tgt):
        err = jnp.square(h @ hp["wh"] - tgt[..., :5])
        if not weighted:
            return jnp.mean(err)
        m = tgt[..., 5]
        return jnp.sum(err * m[..., None]), jnp.sum(m)
    tgt = np.concatenate([a["tgt"], a["mask"][..., None]], -1)
    fn = jax.jit(lambda P, x, H: jsched.pipeline_1f1b(
        stage, P, x, jnp.asarray(tgt), head, H, num_stages=S, remat=remat,
        return_dx=True, weighted_loss=weighted))
    loss, gs, gh, dx = fn({"w": a["w"], "b": a["b"]}, a["x"],
                          {"wh": a["wh"]})
    return (float(loss), np.asarray(gs["w"]), np.asarray(gs["b"]),
            np.asarray(gh["wh"]), np.asarray(dx))


def _torch_stages(a):
    w = torch.nn.Parameter(torch.tensor(a["w"]))
    b = torch.nn.Parameter(torch.tensor(a["b"]))
    wh = torch.nn.Parameter(torch.tensor(a["wh"]))
    return w, b, wh, (lambda s, h: torch.tanh(h @ w[s] + b[s]))


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "saved"])
@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("S", [2, 4])
def test_pipeline_1f1b_matches_jax(S, M, remat):
    """Loss, stage gradients, head gradients and dx of the fused 1F1B
    step, mean loss (M in {1, 8}) or weighted by a mask with an
    all-ignored microbatch (M = 4), against JAX's ``pipeline_1f1b``;
    the stages hold at most min(M, 2S - 1) microbatches."""
    weighted = M == 4
    a = _stage_inputs(S, M, seed=S * 10 + M)
    ref = _jax_1f1b(a, S, remat, weighted)
    w, b, wh, fn = _torch_stages(a)
    mask = torch.tensor(a["mask"])
    tgt = torch.cat([torch.tensor(a["tgt"]), mask[..., None]], -1)

    def head(h, t):
        err = torch.square(h @ wh - t[..., :5])
        if not weighted:
            return err.mean()
        return (err * t[..., 5:]).sum(), t[..., 5].sum()
    stats = {}
    loss, dx = psched.pipeline_1f1b(
        fn, torch.tensor(a["x"]), tgt, head, num_stages=S, remat=remat,
        return_dx=True, weighted_loss=weighted,
        total_weight=mask.sum() if weighted else None, stats=stats)
    np.testing.assert_allclose(float(loss), ref[0], rtol=1e-5, atol=1e-5)
    for got, want in zip((w.grad, b.grad, wh.grad, dx), ref[1:]):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert stats["ticks"] == psched.schedule_ticks(S, M)["total"]
    assert max(stats["peak_live"]) == min(M, 2 * S - 1)


@pytest.mark.parametrize("M", [1, 4, 8])
@pytest.mark.parametrize("S", [2, 4])
def test_gpipe_forward_and_grad_match_jax(S, M):
    """``pipeline_gpipe`` (JAX's ``pipeline_spmd``) outputs and the
    gradients of sum(out * g) through autograd."""
    a = _stage_inputs(S, M, seed=7 + S + M)
    g = np.random.RandomState(1).randn(*a["x"].shape).astype(np.float32)

    def jloss(P, x):
        out = jpipe.pipeline_spmd(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                                  P, x, num_stages=S)
        return jnp.sum(out * g), out
    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(
            {"w": a["w"], "b": a["b"]}, a["x"])
    w, b, _, fn = _torch_stages(a)
    x = torch.tensor(a["x"], requires_grad=True)
    got = psched.pipeline_gpipe(fn, x, num_stages=S)
    (got * torch.tensor(g)).sum().backward()
    for t, want in ((got.detach(), out), (w.grad, gp["w"]),
                    (b.grad, gp["b"]), (x.grad, gx)):
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_interleaved_forward_and_grad_match_jax():
    """The circular schedule at S 2, V 2, M 4: chunk v of stage s is
    virtual stage v S + s (JAX's [V, S, ...] leaves); outputs and
    gradients; the tick counts."""
    S, V, M = 2, 2, 4
    a = _stage_inputs(S * V, M, seed=3)
    g = np.random.RandomState(2).randn(*a["x"].shape).astype(np.float32)
    P = {"w": a["w"].reshape(V, S, D, D), "b": a["b"].reshape(V, S, D)}

    def jloss(P, x):
        out = jsched.pipeline_interleaved(
            lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), P, x, num_stages=S,
            num_chunks=V)
        return jnp.sum(out * g), out
    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True))(P, a["x"])
    w, b, _, fn = _torch_stages(a)
    x = torch.tensor(a["x"], requires_grad=True)
    got = psched.pipeline_interleaved(fn, x, num_stages=S, num_chunks=V)
    (got * torch.tensor(g)).sum().backward()
    for t, want in ((got.detach(), out),
                    (w.grad, np.asarray(gp["w"]).reshape(S * V, D, D)),
                    (b.grad, np.asarray(gp["b"]).reshape(S * V, D)),
                    (x.grad, gx)):
        np.testing.assert_allclose(t.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    with pytest.raises(ValueError, match="divisible"):
        psched.pipeline_interleaved(fn, x[:3], num_stages=S, num_chunks=V)


@pytest.mark.parametrize("S,V,M", [(2, 1, 1), (4, 1, 8), (2, 2, 4),
                                   (4, 3, 8)])
def test_tick_counts_match_jax(S, V, M):
    assert psched.schedule_ticks(S, M) == jsched.schedule_ticks(S, M)
    assert psched.interleaved_ticks(S, V, M) == jsched.interleaved_ticks(
        S, V, M)
    # the FThenB timetables: every (virtual stage, microbatch) once, and
    # one op a stage a tick
    ticks = psched.ticks_fthenb(S, V, M)
    assert len(ticks) == 2 * (M * V + S - 1)
    for kind in (0, 1):
        ops = [op for t in ticks for op in t[kind]]
        assert sorted((vs, m) for _, vs, m in ops) == sorted(
            (vs, m) for vs in range(S * V) for m in range(M))
    for f, b in ticks:
        for ops in (f, b):
            stages = [s for s, _, _ in ops]
            assert len(stages) == len(set(stages))


def test_live_set_is_bounded_by_2s_minus_1_where_fthenb_holds_all():
    """The graphs (remat off) a stage holds at the peak: 1F1B at most
    min(M, 2S - 1), stage s exactly min(M, 2(S - s) - 1); every F before
    every B holds all M."""
    S, M = 4, 8
    a = _stage_inputs(S, M)
    _, _, wh, fn = _torch_stages(a)
    head = lambda h, t: torch.square(h @ wh - t).mean()
    x, t = torch.tensor(a["x"]), torch.tensor(a["tgt"])
    one, both = {}, {}
    psched.pipeline_1f1b(fn, x, t, head, num_stages=S, remat=False,
                         stats=one)
    psched.pipeline_fthenb(fn, x, t, head, num_stages=S, remat=False,
                           stats=both)
    assert one["peak_live"] == [min(M, 2 * (S - s) - 1) for s in range(S)]
    assert both["peak_live"] == [M] * S


# -- the pipelined Llama --------------------------------------------------------

LAYERS = 4


def _ids_labels(uneven=True):
    rs = np.random.RandomState(0)
    ids = rs.randint(0, 256, (8, 17))
    labels = ids[:, 1:].copy()
    if uneven:
        # microbatch 0 (rows 0-1 at M = 4) loses most of its labels, row
        # 5 all of them: a per-microbatch mean would differ
        labels[0, :14] = -100
        labels[1, 3:] = -100
        labels[5, :] = -100
    return ids[:, :-1], labels


CASES = {  # name: (S, M, schedule, recompute, tied, V)
    "1f1b_s2_remat": (2, 4, "1f1b", "full", False, 1),
    "1f1b_s4_saved_tied": (4, 4, "1f1b", "none", True, 1),
    "gpipe_s4_m8": (4, 8, "gpipe", "full", False, 1),
    "interleaved_s2_v2": (2, 4, "interleaved", "full", False, 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_llama_pipe_matches_jax(case):
    """The tiny Llama (4 layers) pipelined: the fused step
    (``loss_and_grads``) and the forward's loss through autograd, both
    against JAX's step (its ``loss_and_grads`` for 1F1B, ``jax.grad``
    of the pipelined forward otherwise) with unevenly padded
    microbatches: the global token mean."""
    S, M, sched, rc, tied, V = CASES[case]
    kw = dict(num_hidden_layers=LAYERS, recompute=rc,
              tie_word_embeddings=tied)
    pt.seed(3)
    jm = JaxPipe(JaxConfig.tiny(**kw), num_stages=S, num_microbatches=M,
                 pp_schedule=sched, num_chunks=V)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    ids, labels = _ids_labels()
    params = dict(jm.raw_parameters())
    ji, jl = jnp.asarray(ids), jnp.asarray(labels)
    if sched == "1f1b":
        loss, grads = jax.jit(lambda p: jm.loss_and_grads(p, ji, jl))(params)
    else:
        loss, grads = jax.jit(jax.value_and_grad(lambda p: jm.functional_call(
            p, ji, jl, return_logits=False)))(params)
    m = LlamaForCausalLMPipe(LlamaConfig.tiny(**kw), num_stages=S,
                             num_microbatches=M, pp_schedule=sched,
                             num_chunks=V, device="cpu")
    m.load_jax_state_dict(sd)
    ti, tl = torch.tensor(ids), torch.tensor(labels)
    fused, _ = m.loss_and_grads(ti, tl)
    got = m.jax_state_dict(grads=True)
    m.zero_grad(set_to_none=True)
    plain = m(ti, tl, return_logits=False)
    plain.backward()
    got_plain = m.jax_state_dict(grads=True)
    for val in (float(fused), float(plain.detach())):
        np.testing.assert_allclose(val, float(loss), rtol=1e-5)
    for name, g in grads.items():
        for gg in (got, got_plain):
            np.testing.assert_allclose(gg[name].numpy(), np.asarray(g),
                                       rtol=1e-4, atol=1e-6, err_msg=name)


def test_llama_pipe_weight_carry_from_jax():
    """JAX's stacked leaves ([L, ...], and [V, S, k, ...] interleaved)
    load into the per-layer modules and come back equal;
    ``load_from_unpipelined`` gives JAX's converter's state; the names
    and sizes match JAX's model."""
    kw = dict(num_hidden_layers=LAYERS)
    pt.seed(4)
    jl = JaxLlama(JaxConfig.tiny(**kw))
    for sched, V in (("1f1b", 1), ("interleaved", 2)):
        jp = JaxPipe(JaxConfig.tiny(**kw), num_stages=2, num_microbatches=2,
                     pp_schedule=sched, num_chunks=V)
        jp.load_from_unpipelined(jl)
        want = {k: np.asarray(v) for k, v in jp.state_dict().items()}
        m = LlamaForCausalLMPipe(LlamaConfig.tiny(**kw), num_stages=2,
                                 num_microbatches=2, pp_schedule=sched,
                                 num_chunks=V, device="cpu")
        m.load_jax_state_dict(want)
        got = m.jax_state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert tuple(got[k].shape) == v.shape, k
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        # the same carry from the unpipelined port model
        src = LlamaForCausalLM(LlamaConfig.tiny(**kw), device="cpu")
        from paddle_tpu_torch.convert import state_dict_from_jax
        src.load_state_dict(state_dict_from_jax(
            {k: np.asarray(v) for k, v in jl.state_dict().items()},
            LlamaConfig.tiny(**kw), device="cpu"))
        m2 = LlamaForCausalLMPipe(LlamaConfig.tiny(**kw), num_stages=2,
                                  num_microbatches=2, pp_schedule=sched,
                                  num_chunks=V, device="cpu")
        m2.load_from_unpipelined(src)
        for k, v in m2.jax_state_dict().items():
            np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
        assert m.num_params() == jp.num_params()
        assert m.flops_per_token(16) == jp.flops_per_token(16)
    # every unpipelined name has a pipelined one
    assert {pipe_name(n) for n in src.state_dict()} == set(
        dict(m.named_parameters()))


def test_descs_segments_and_microbatches_match_jax():
    """SegmentLayers ("uniform" and "layer:<class>"), microbatch and
    unmicrobatch, and PipelineLayer pipelining the longest homogeneous
    run of descs (forward equal to the layers in sequence)."""
    import paddle_tpu.nn as jnn
    names = ["Embed"] + ["Block"] * 6 + ["Head"]
    types = {n: type(n, (jnn.Layer,), {}) for n in set(names)}
    ttypes = {n: type(n, (torch.nn.Module,), {}) for n in set(names)}
    for method in ("uniform", "layer:Block"):
        for parts in (2, 3, 4):
            want = jpipe.SegmentLayers(
                [jpipe.LayerDesc(types[n]) for n in names], parts,
                method).do_segment()
            got = ppipe.SegmentLayers(
                [ppipe.LayerDesc(ttypes[n]) for n in names], parts,
                method).do_segment()
            assert got == want, (method, parts)
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    mb = ppipe.microbatch(torch.tensor(x), 3)
    np.testing.assert_array_equal(mb.numpy(), np.asarray(
        jpipe.microbatch(jnp.asarray(x), 3)))
    np.testing.assert_array_equal(ppipe.unmicrobatch(mb).numpy(), x)
    with pytest.raises(ValueError, match="divisible"):
        ppipe.microbatch(torch.tensor(x), 4)
    torch.manual_seed(0)
    descs = ([ppipe.LayerDesc(torch.nn.Linear, 4, 4)]
             + [ppipe.LayerDesc(torch.nn.Linear, 4, 4, bias=False)] * 4
             + [ppipe.LayerDesc(torch.nn.Linear, 4, 2)])
    pl = ppipe.PipelineLayer(descs, num_stages=2, num_microbatches=2)
    assert isinstance(pl.seg_1, ppipe.PipelineStack)
    assert pl.seg_1.num_layers == 4 and len(pl._order) == 3
    h = torch.randn(4, 4)
    seq = pl.seg_0(h)
    for i in range(4):
        seq = pl.seg_1.layers[str(i)](seq)
    np.testing.assert_allclose(pl(h).detach().numpy(),
                               pl.seg_2(seq).detach().numpy(), rtol=1e-6)
    with pytest.raises(TypeError, match="nn.Module"):
        ppipe.LayerDesc(int)


def test_recompute_sequential_and_hybrid_equal_no_recompute():
    """Gradients under ``recompute_sequential`` (1, 2 and 3 segments over
    5 layers) and ``recompute_hybrid`` (a policy that keeps the matrix
    products) equal those without recompute, bit for bit."""
    torch.manual_seed(0)
    layers = torch.nn.Sequential(*[torch.nn.Sequential(
        torch.nn.Linear(6, 6), torch.nn.GELU()) for _ in range(5)])
    x = torch.randn(3, 6)

    def grads(fn):
        layers.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        fn(xi).square().sum().backward()
        return [p.grad.clone() for p in layers.parameters()] + [xi.grad]
    want = grads(layers)
    for seg in (1, 2, 3):
        got = grads(lambda t: recompute_sequential({"segments": seg},
                                                   layers, t))
        assert all(torch.equal(a, b) for a, b in zip(got, want)), seg
    got = grads(lambda t: recompute_hybrid(
        {"policy": "dots_with_no_batch_dims_saveable"}, layers, t))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="single-input"):
        recompute_sequential({}, layers, x, x)
