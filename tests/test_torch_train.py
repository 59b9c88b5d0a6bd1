"""The port's training slice against the JAX package's, on the CPU.

The plain versions behind the flash-attention, RMSNorm-backward and RoPE
kernels are held against the JAX package's Pallas kernels run in
interpret mode (or, for RoPE, the XLA function the CPU runs); each
autograd.Function against torch.autograd of its own plain forward; the
optimizer, clipping and schedules against their JAX counterparts; and
four Trainer steps of the tiny Llama against four steps of
``paddle_tpu.trainer.Trainer``. Inputs come from numpy with fixed seeds.
fp32 throughout; tolerance 1e-5 for single ops (the same fp32 formula in
another summation order), 1e-4 where a whole model is compared.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models.llama import LlamaConfig as JaxConfig
from paddle_tpu.models.llama import LlamaForCausalLM as JaxLlama
from paddle_tpu.models.llama import _token_mean as jax_token_mean
from paddle_tpu.models.llama import fused_loss_enabled as jax_fused_enabled
from paddle_tpu.nn import functional as JF
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.ops.pallas.fused_norm import rms_norm_pallas
from paddle_tpu.ops.rope import apply_rotary_pos_emb as jax_rope
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu.optimizer import clip as jclip
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.trainer import Trainer as JaxTrainer
from paddle_tpu_torch.convert import state_dict_from_jax
from paddle_tpu_torch.distributed.recompute import (recompute,
                                                    recompute_wrapper,
                                                    resolve_policy)
from paddle_tpu_torch.models.llama import (LlamaConfig, LlamaForCausalLM,
                                           _token_mean, fused_loss_enabled)
from paddle_tpu_torch.nn import functional as tF
from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops import norm as norm_ops
from paddle_tpu_torch.ops import rope as rope_ops
from paddle_tpu_torch.optimizer import AdamW, clip, lr
from paddle_tpu_torch.trainer import Trainer

TOL = 1e-5
BLOCK = 32          # the JAX kernels' blocks in interpret mode


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _t(a):
    return torch.tensor(np.asarray(a))


# -- flash attention ----------------------------------------------------------

# (b, sq, sk, h, hk, d, causal, segments, dropout_p)
FLASH_CASES = {
    "causal": (1, 64, 64, 4, 4, 32, True, None, 0.0),
    "full_gqa": (2, 64, 64, 4, 2, 32, False, None, 0.0),
    "causal_gqa_sq_lt_sk": (1, 32, 64, 4, 2, 32, True, None, 0.0),
    "segments_masked_row": (2, 64, 64, 4, 2, 32, False, "masked_row", 0.0),
    "segments_causal": (1, 64, 64, 4, 2, 32, True, "packed", 0.0),
    "dropout": (2, 64, 64, 4, 2, 32, True, None, 0.3),
}


def _flash_inputs(case):
    b, sq, sk, h, hk, d, causal, seg, p = FLASH_CASES[case]
    rs = np.random.RandomState(sorted(FLASH_CASES).index(case))
    q = (0.5 * rs.randn(b, sq, h, d)).astype(np.float32)
    k = (0.5 * rs.randn(b, sk, hk, d)).astype(np.float32)
    v = (0.5 * rs.randn(b, sk, hk, d)).astype(np.float32)
    dout = rs.randn(b, sq, h, d).astype(np.float32)
    q_seg = kv_seg = None
    if seg == "masked_row":
        # query id 7 appears in no key: those rows are fully masked
        q_seg = np.zeros((b, sq), np.int32)
        q_seg[:, 40:] = 7
        q_seg[:, 20:40] = 1
        kv_seg = np.zeros((b, sk), np.int32)
        kv_seg[:, 30:] = 1
    elif seg == "packed":
        q_seg = np.zeros((b, sq), np.int32)
        q_seg[:, 23:] = 1
        q_seg[:, 50:] = 2
        kv_seg = q_seg.copy()
    return q, k, v, dout, q_seg, kv_seg, causal, p


@pytest.fixture(scope="module")
def jax_flash():
    """The JAX kernels' out, lse, dq, dk, dv for every case, in interpret
    mode with 32-row blocks (one run per case, shared by the tests)."""
    out = {}
    for case in FLASH_CASES:
        q, k, v, dout, q_seg, kv_seg, causal, p = _flash_inputs(case)
        scale = 1.0 / np.sqrt(q.shape[-1])
        seed = jnp.asarray([1234], jnp.int32) if p > 0 else None
        js = (None if q_seg is None else jnp.asarray(q_seg),
              None if kv_seg is None else jnp.asarray(kv_seg))
        o, lse = jfa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          js[0], js[1], seed, p, scale, causal, BLOCK, BLOCK,
                          True)
        res = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), js[0], js[1],
               seed, o, lse)
        dq, dk, dv = jfa._bwd(p, scale, causal, BLOCK, BLOCK, True, res,
                              jnp.asarray(dout))[:3]
        out[case] = [np.asarray(x) for x in (o, lse, dq, dk, dv)]
    return out


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas(jax_flash, case):
    """out and lse of the plain forward, and dq, dk, dv of the plain
    backward from the JAX kernel's own out and lse, against the Pallas
    kernels; a fully masked row gives out 0 and lse -1e30 on both."""
    q, k, v, dout, q_seg, kv_seg, causal, p = _flash_inputs(case)
    scale = 1.0 / np.sqrt(q.shape[-1])
    segs = (None if q_seg is None else _t(q_seg),
            None if kv_seg is None else _t(kv_seg))
    jo, jlse, jdq, jdk, jdv = jax_flash[case]
    out, lse = attn_ops._flash_fwd_plain(_t(q), _t(k), _t(v), causal, scale,
                                         *segs, p, 1234)
    _close(out, jo)
    _close(lse, jlse)
    delta = (jo * dout).sum(-1).transpose(0, 2, 1)
    dq, dk, dv = attn_ops._flash_bwd_plain(
        _t(q), _t(k), _t(v), _t(dout), _t(jlse), _t(np.ascontiguousarray(
            delta)), causal, scale, *segs, p, 1234)
    _close(dq, jdq)
    _close(dk, jdk)
    _close(dv, jdv)
    if case == "segments_masked_row":
        assert np.all(np.asarray(out)[:, 40:] == 0)
        assert np.all(np.asarray(lse)[:, :, 40:] == -1e30)


def test_dropout_keep_mask_matches_pallas_bit_for_bit():
    """The plain keep mask equals ``_dropout_keep`` on every cell of
    every (batch, head, block) of a 2 x 3 x 64 x 96 score tensor."""
    b, h, sq, sk, p, seed = 2, 3, 64, 96, 0.3, 987654
    got = attn_ops.dropout_keep_plain(seed, b, h, sq, sk, p, "cpu").numpy()
    sref = jnp.asarray([seed], jnp.int32)
    for bi in range(b):
        for hi in range(h):
            for qi in range(sq // BLOCK):
                for ki in range(sk // BLOCK):
                    want = np.asarray(jfa._dropout_keep(
                        sref, jnp.int32(bi), jnp.int32(hi), jnp.int32(qi),
                        jnp.int32(ki), p, BLOCK, BLOCK, sk))
                    np.testing.assert_array_equal(
                        got[bi, hi, qi * BLOCK:(qi + 1) * BLOCK,
                            ki * BLOCK:(ki + 1) * BLOCK], want)
    assert abs(got.mean() - (1 - p)) < 0.02


@pytest.mark.parametrize("case", ["causal", "segments_masked_row",
                                  "dropout"])
def test_flash_function_matches_autograd_of_plain(case):
    """``flash_attention``'s autograd.Function (saved lse, delta, the
    plain backward on the CPU) against torch.autograd through the plain
    forward."""
    q, k, v, dout, q_seg, kv_seg, causal, p = _flash_inputs(case)
    segs = None if q_seg is None else (_t(q_seg), _t(kv_seg))

    def run(fn):
        ts = [_t(x).requires_grad_() for x in (q, k, v)]
        out = fn(*ts)
        out.backward(_t(dout))
        return [out.detach()] + [t.grad for t in ts]
    got = run(lambda a, b_, c: attn_ops.flash_attention(
        a, b_, c, dropout_p=p, causal=causal, segment_ids=segs,
        dropout_seed=1234 if p else None))
    want = run(lambda a, b_, c: attn_ops._flash_fwd_plain(
        a, b_, c, causal, 1.0 / np.sqrt(q.shape[-1]),
        *(segs or (None, None)), p, 1234)[0])
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("sq,d", [(128, 128), (100, 64), (70, 32)])
def test_flash_dq_workspace_layout_round_trips(sq, d):
    """The bf16 backward's dq workspace: a value the kernel adds for
    (batch, head, 64-row query tile, panel, row, column) lands, after the
    wrapper's permute, at dq[batch, tile * 64 + row, head, panel * PW +
    column]; the pad rows past sq are dropped and the counters follow
    the workspace."""
    from paddle_tpu_torch.ops.kernels import flash_attention as kfa
    b, h = 2, 3
    q = torch.zeros((b, sq, h, d), dtype=torch.bfloat16)
    buf, ws = kfa.dq_workspace(q)
    nq, pw = -(-sq // 64), min(d, 64)
    assert buf.numel() == b * h * nq * (64 * d + 1)
    want = torch.randn((b, nq * 64, h, d))
    flat = buf[:b * h * nq * 64 * d].view(b, h, nq, d // pw, 64, pw)
    for bi in range(b):
        for hi in range(h):
            for t in range(nq):
                for p in range(d // pw):
                    flat[bi, hi, t, p] = want[bi, t * 64:(t + 1) * 64, hi,
                                              p * pw:(p + 1) * pw]
    got = kfa._dq_from_workspace(ws, q)
    assert got.shape == q.shape and got.is_contiguous()
    assert torch.equal(got, want[:, :sq].to(torch.bfloat16))


def test_flash_attention_refuses_what_it_does_not_take():
    """Causal attention with sq > sk (``_sdpa_xla`` gives rows of NaN
    there) and dropout without a seed stay refused, with a dense mask
    too; the dense mask itself is taken (the parity tests below)."""
    q = torch.zeros((1, 8, 2, 32))
    k = torch.zeros((1, 4, 2, 32))
    with pytest.raises(NotImplementedError):
        attn_ops.flash_attention(q, k, k, causal=True)
    with pytest.raises(NotImplementedError):
        attn_ops.flash_attention(q, k, k, causal=True,
                                 attn_mask=torch.ones(8, 4, dtype=bool))
    with pytest.raises(ValueError, match="dropout_seed"):
        attn_ops.flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout_seed"):
        attn_ops.flash_attention(q, q, q, dropout_p=0.1,
                                 attn_mask=torch.ones(8, 8, dtype=bool))


def _dense_mask(kind, b, s, rs):
    """A [b, 1, s, s] mask that keeps the diagonal (no row is fully
    masked): boolean, or additive with random fp32 biases and -inf."""
    keep = rs.rand(b, 1, s, s) < 0.7
    keep |= np.eye(s, dtype=bool)[None, None]
    if kind == "bool":
        return keep
    return np.where(keep, 0.5 * rs.randn(b, 1, s, s),
                    -np.inf).astype(np.float32)


@pytest.mark.parametrize("segments", [False, True])
@pytest.mark.parametrize("kind", ["bool", "additive"])
def test_flash_attention_dense_mask_matches_sdpa_xla(kind, segments):
    """A dense mask, boolean or additive, with and without segment ids,
    causal and GQA: the output and dq, dk, dv of the port's public
    ``flash_attention`` against ``_sdpa_xla`` and ``jax.grad``, 1e-5."""
    from paddle_tpu.ops.attention import _sdpa_xla
    rs = np.random.RandomState(20 + 2 * (kind == "bool") + segments)
    b, s, h, hk, d = 2, 24, 4, 2, 16
    q = (0.5 * rs.randn(b, s, h, d)).astype(np.float32)
    k = (0.5 * rs.randn(b, s, hk, d)).astype(np.float32)
    v = (0.5 * rs.randn(b, s, hk, d)).astype(np.float32)
    dout = rs.randn(b, s, h, d).astype(np.float32)
    mask = _dense_mask(kind, b, s, rs)
    seg = None
    if segments:
        seg = np.zeros((b, s), np.int32)
        seg[:, 9:] = 1
        seg[1, 17:] = 2

    def jloss(q_, k_, v_):
        out = _sdpa_xla(q_, k_, v_, attn_mask=jnp.asarray(mask), causal=True,
                        segment_ids=None if seg is None
                        else jnp.asarray(seg))
        return jnp.sum(out * jnp.asarray(dout)), out
    (_, want), grads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [_t(x).requires_grad_() for x in (q, k, v)]
    got = attn_ops.flash_attention(*ts, attn_mask=_t(mask), causal=True,
                                   segment_ids=None if seg is None
                                   else _t(seg))
    got.backward(_t(dout))
    _close(got.detach(), want)
    for t, gw in zip(ts, grads):
        _close(t.grad, gw)


def test_llama_padding_mask_matches_jax():
    """The tiny (2-layer) Llama under a padding mask [b, 1, 1, s] beside
    segment ids: logits, loss and every gradient of the default head
    against the JAX model with the same weights (``convert``), 1e-5."""
    jm, tm = _jax_pair(seed=11)
    batch = _train_batch(tm.cfg, seed=12)
    s = batch["input_ids"].shape[1]
    mask = np.ones((2, 1, 1, s), bool)
    mask[1, ..., 25:] = False                  # row 1 padded on the right
    batch["attn_mask"] = mask
    with torch.no_grad():
        tlog = tm(_t(batch["input_ids"]), attn_mask=_t(mask),
                  segment_ids=_t(batch["segment_ids"]))
    _close(tlog, jm(jnp.asarray(batch["input_ids"]),
                    attn_mask=jnp.asarray(mask),
                    segment_ids=jnp.asarray(batch["segment_ids"])))
    jl, jg = _jax_loss_and_grads(jm, batch)
    tl, tg = _torch_loss_and_grads(tm, batch)
    _close(tl, jl)
    assert set(tg) == set(jg)
    for name in jg:
        _close(tg[name], jg[name])


def test_sdpa_functional_drops_only_when_training():
    rs = np.random.RandomState(9)
    q = _t(rs.randn(1, 16, 2, 32).astype(np.float32))
    plain = attn_ops._flash_fwd_plain(q, q, q, True, 32 ** -0.5)[0]
    evald = tF.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                            is_causal=True, training=False)
    _close(evald, plain)
    trained = tF.scaled_dot_product_attention(q, q, q, dropout_p=0.5,
                                              is_causal=True, dropout_seed=3)
    assert not torch.allclose(trained, plain)


# -- RMSNorm and RoPE backward ------------------------------------------------

def test_rms_norm_backward_matches_pallas_grad():
    rs = np.random.RandomState(10)
    x = rs.normal(0, 1, (4, 8, 128)).astype(np.float32)
    w = (1 + 0.1 * rs.normal(0, 1, (128,))).astype(np.float32)
    dy = rs.normal(0, 1, (4, 8, 128)).astype(np.float32)
    jdx, jdw = jax.grad(
        lambda a, b: jnp.sum(rms_norm_pallas(a, b, 1e-5, block_r=8,
                                             interpret=True) * dy),
        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    y, rstd = norm_ops._rms_norm_fwd_plain(_t(x), _t(w), 1e-5)
    dx, dw = norm_ops._rms_norm_bwd_plain(_t(x), _t(w), rstd, _t(dy))
    _close(dx, jdx)
    _close(dw, jdw)
    # the autograd.Function route gives the same
    xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
    norm_ops.rms_norm(xt, wt, 1e-5).backward(_t(dy))
    _close(xt.grad, jdx)
    _close(wt.grad, jdw)


def test_rms_norm_function_matches_autograd_of_plain():
    rs = np.random.RandomState(11)
    x = rs.normal(0, 1, (6, 96)).astype(np.float32)
    w = (1 + 0.1 * rs.normal(0, 1, (96,))).astype(np.float32)
    dy = rs.normal(0, 1, (6, 96)).astype(np.float32)
    grads = []
    for fn in (norm_ops.rms_norm, norm_ops._rms_norm_plain):
        xt, wt = _t(x).requires_grad_(), _t(w).requires_grad_()
        y = fn(xt, wt, 1e-5)
        y.backward(_t(dy))
        grads.append((y.detach(), xt.grad, wt.grad))
    for g, w_ in zip(*grads):
        _close(g, w_)
    assert norm_ops.rms_norm(xt, wt, 1e-5).grad_fn is not None


@pytest.mark.parametrize("with_positions", [False, True])
def test_rope_backward_matches_jax_grad(with_positions):
    rs = np.random.RandomState(12 + with_positions)
    b, s, h, hk, d = 2, 16, 4, 2, 32
    q = rs.normal(0, 1, (b, s, h, d)).astype(np.float32)
    k = rs.normal(0, 1, (b, s, hk, d)).astype(np.float32)
    gq = rs.normal(0, 1, (b, s, h, d)).astype(np.float32)
    gk = rs.normal(0, 1, (b, s, hk, d)).astype(np.float32)
    pos = rs.randint(0, 60, (b, s)) if with_positions else None
    cos, sin = rope_ops.rope_freqs(d, 64, 10000.0)
    jc, jsn = jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy())

    def jloss(a, c):
        oq, ok = jax_rope(a, c, jc, jsn,
                          None if pos is None else jnp.asarray(pos))
        return jnp.sum(oq * gq) + jnp.sum(ok * gk)
    jdq, jdk = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(q),
                                               jnp.asarray(k))
    grads = []
    for neg_sin in (None, -sin):
        qt, kt = _t(q).requires_grad_(), _t(k).requires_grad_()
        oq, ok = rope_ops.apply_rotary_pos_emb(
            qt, kt, cos, sin, None if pos is None else _t(pos), neg_sin)
        (torch.sum(oq * _t(gq)) + torch.sum(ok * _t(gk))).backward()
        _close(qt.grad, jdq)
        _close(kt.grad, jdk)
        grads.append(qt.grad)
    # the Function against autograd through the plain rotation
    qt, kt = _t(q).requires_grad_(), _t(k).requires_grad_()
    oq, ok = rope_ops._rope_plain(qt, kt, cos, sin,
                                  None if pos is None else _t(pos))
    (torch.sum(oq * _t(gq)) + torch.sum(ok * _t(gk))).backward()
    _close(grads[0], qt.grad)


# -- loss, optimizer, clipping, schedules -------------------------------------

def test_cross_entropy_matches_jax_and_all_ignored_is_zero():
    rs = np.random.RandomState(13)
    logits = rs.normal(0, 2, (3, 7, 50)).astype(np.float32)
    labels = rs.randint(0, 50, (3, 7))
    labels[0, :3] = -100
    _close(tF.cross_entropy(_t(logits), _t(labels)),
           JF.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
    none = np.full((3, 7), -100)
    got = tF.cross_entropy(_t(logits), _t(none))
    assert float(got) == 0.0
    assert float(JF.cross_entropy(jnp.asarray(logits),
                                  jnp.asarray(none))) == 0.0
    nll = _t(rs.normal(0, 1, (3, 7)).astype(np.float32))
    _close(_token_mean(nll, _t(labels)),
           jax_token_mean(jnp.asarray(nll.numpy()), jnp.asarray(labels)))


def _sched_pair():
    def build(mod):
        return mod.LinearWarmup(mod.CosineAnnealingDecay(1e-3, T_max=10,
                                                         eta_min=1e-5),
                                warmup_steps=3, start_lr=0.0, end_lr=1e-3)
    return build(lr), build(jlr)


def test_lr_of_matches_jax_fp32():
    """The value a step applies: the fp32 ``lr_of`` of the JAX
    schedulers (up to one fp32 rounding of cos between numpy and XLA),
    and get_lr() of both stepped side by side."""
    ours, theirs = _sched_pair()
    for step in range(16):
        want = float(theirs.lr_of(step))
        assert abs(ours.lr_of(step) - want) <= 1e-7 * max(abs(want), 1e-3)
        np.testing.assert_allclose(ours.get_lr(), theirs.get_lr(),
                                   rtol=1e-12)
        ours.step()
        theirs.step()


def test_clips_match_jax():
    rs = np.random.RandomState(14)
    grads = {f"g{i}": rs.normal(0, 1, s).astype(np.float32)
             for i, s in enumerate([(5, 6), (7,), (3, 4, 2)])}
    for ours, theirs in ((clip.ClipGradByGlobalNorm(1.5),
                          jclip.ClipGradByGlobalNorm(1.5)),
                         (clip.ClipGradByNorm(2.0), jclip.ClipGradByNorm(2.0)),
                         (clip.ClipGradByValue(0.7),
                          jclip.ClipGradByValue(0.7))):
        got = ours({k: _t(v) for k, v in grads.items()})
        want = theirs({k: jnp.asarray(v) for k, v in grads.items()})
        for k in grads:
            _close(got[k], want[k])


def test_adamw_steps_match_jax():
    """Three AdamW updates with global-norm clipping, decay on all but the
    norm weight, a bf16 parameter (fp32 master) and fp32 ones."""
    rs = np.random.RandomState(15)
    shapes = {"w": (8, 6), "norm.weight": (6,), "emb": (5, 6)}
    params = {k: rs.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rs.normal(0, 1, s).astype(np.float32)
              for k, s in shapes.items()} for _ in range(3)]
    keep_norm = (lambda n: "norm" not in n)
    kw = dict(learning_rate=1e-2, weight_decay=0.1,
              apply_decay_param_fun=keep_norm)
    ours = AdamW(grad_clip=clip.ClipGradByGlobalNorm(1.0), **kw)
    theirs = JaxAdamW(grad_clip=jclip.ClipGradByGlobalNorm(1.0), **kw)
    tp = {k: _t(v) for k, v in params.items()}
    tp["emb"] = tp["emb"].to(torch.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jp["emb"] = jp["emb"].astype(jnp.bfloat16)
    state = theirs.init_state(jp)
    for g in grads:
        tg = {k: _t(v) for k, v in g.items()}
        tg["emb"] = tg["emb"].to(torch.bfloat16)
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        jg["emb"] = jg["emb"].astype(jnp.bfloat16)
        ours.apply_gradients(tp, tg)
        jp, state = theirs.apply_gradients(jp, jg, state)
    for k in ("w", "norm.weight"):
        _close(tp[k], jp[k])
        _close(ours._state["slots"][k]["v"], state["slots"][k]["v"])
    _close(ours._state["master"]["emb"], state["master"]["emb"])
    assert tp["emb"].dtype == torch.bfloat16
    _close(tp["emb"].float(), jp["emb"].astype(jnp.float32))


# -- the model and the whole step ---------------------------------------------

@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX tiny Llama (naive loss head) and the port's, with the same
    weights."""
    import paddle_tpu as pt
    pt.seed(5)
    jm = JaxLlama(JaxConfig.tiny(loss_impl="naive"))
    cfg = LlamaConfig.tiny(loss_impl="naive")
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    return jm, cfg, sd


def _train_batch(cfg, seed=0, b=2, s=32):
    """Token ids, next-token labels (-100 at each segment's last token)
    and segment ids packing two documents into the first row."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, cfg.vocab_size, (b, s + 1))
    labels = ids[:, 1:].copy()
    seg = np.zeros((b, s), np.int32)
    seg[0, 13:] = 1
    labels[0, 12] = -100
    return {"input_ids": ids[:, :-1], "labels": labels, "segment_ids": seg}


def test_loss_and_size_accounting_match_jax(tiny_pair):
    jm, cfg, sd = tiny_pair
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, cfg, device="cpu"))
    batch = _train_batch(cfg)
    jl, jlog = jm(**{k: jnp.asarray(v) for k, v in batch.items()})
    tl, tlog = tm(**{k: _t(v) for k, v in batch.items()})
    _close(tl.detach(), jl, 1e-4)
    _close(tlog.detach(), jlog, 1e-4)
    assert tm.num_params() == jm.num_params()
    for causal in (False, True):
        assert tm.flops_per_token(32, causal) == jm.flops_per_token(32,
                                                                    causal)


def test_trainer_four_steps_match_jax_trainer(tiny_pair):
    """Four steps of the port's Trainer against four of the JAX Trainer:
    AdamW(weight_decay=0.01), global-norm clip 1.0, LinearWarmup into
    CosineAnnealingDecay, segment ids in the batch. Every step's loss
    within 1e-4 and every final parameter within 1e-4 (fp32, two
    frameworks' matmul orders through two layers and four updates)."""
    jm, cfg, sd = tiny_pair
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(sd, cfg, device="cpu"))
    ours_s, theirs_s = _sched_pair()
    ours = Trainer(tm, AdamW(learning_rate=ours_s, parameters=tm,
                             weight_decay=0.01,
                             grad_clip=clip.ClipGradByGlobalNorm(1.0)))
    import paddle_tpu as pt
    pt.seed(5)
    jm2 = JaxLlama(JaxConfig.tiny(loss_impl="naive"))
    jm2.set_state_dict({k: jnp.asarray(v) for k, v in sd.items()})
    theirs = JaxTrainer(jm2, JaxAdamW(learning_rate=theirs_s, parameters=jm2,
                                      weight_decay=0.01,
                                      grad_clip=jclip.ClipGradByGlobalNorm(
                                          1.0)), donate=False)
    for step in range(4):
        batch = _train_batch(cfg, seed=step)
        tl = ours.train_step({k: _t(v) for k, v in batch.items()})
        jl = theirs.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        _close(tl, jl, 1e-4)
    final = tm.state_dict()
    for name, val in theirs.params.items():
        _close(final[name], val, 1e-4)


def test_training_fields_raise_until_ported():
    """What stays refused: a Trainer seed; sharding plans (apply_plan,
    A.5) and ahead-of-time steps (precompile, B.3.3) raise naming their
    ROADMAP items. ``sequence_parallel=True`` without a mesh trains as
    the plain model does (as JAX's: it acts only over a sep axis), under
    either ``sp_mode``, now accepted; an unknown sp_mode is refused. The
    default head and recompute train; the trainer runtime's arguments of
    fit and offload_opt_state are accepted
    (tests/test_torch_trainer_runtime.py)."""
    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    m = LlamaForCausalLM(cfg, device="cpu")
    ids = torch.zeros((1, 4), dtype=torch.int64)
    assert torch.isfinite(m(ids, labels=ids, return_logits=False))
    rs = np.random.RandomState(17)
    batch = {"input_ids": _t(rs.randint(0, cfg.vocab_size, (2, 16))),
             "labels": _t(rs.randint(0, cfg.vocab_size, (2, 16)))}
    runs = []
    for kw in ({}, {"sequence_parallel": True},
               {"sequence_parallel": True, "sp_mode": "ulysses"}):
        mk = LlamaForCausalLM(LlamaConfig.tiny(num_hidden_layers=1, **kw),
                              device="cpu")
        mk.load_state_dict(m.state_dict())
        tr = Trainer(mk, AdamW(learning_rate=1e-3, parameters=mk))
        runs.append(([float(tr.train_step(batch)) for _ in range(2)],
                     mk.state_dict()))
    for losses, sd in runs[1:]:
        assert losses == runs[0][0]
        for k, v in sd.items():
            assert torch.equal(v, runs[0][1][k]), k
    with pytest.raises(ValueError):
        LlamaConfig.tiny(recompute="offload")
    with pytest.raises(ValueError):
        LlamaConfig.tiny(loss_impl="blockwise")
    with pytest.raises(ValueError):
        LlamaConfig.tiny(sp_mode="context")
    with pytest.raises(NotImplementedError):
        Trainer(m, AdamW(parameters=m), seed=1)
    tr = Trainer(m, AdamW(parameters=m), offload_opt_state=True)
    # apply_plan adopts a planner's plan over the live world (a gloo world
    # of one here) and returns its mesh
    import torch.distributed as dist
    from paddle_tpu_torch.distributed.auto_parallel import (ParallelConfig,
                                                            plan_for_config)
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    ma = LlamaForCausalLM(m.cfg, device="cpu")
    ta = Trainer(ma, AdamW(parameters=ma), offload_opt_state=True)
    init_parallel_env(backend="gloo", device="cpu")
    try:
        hm = ta.apply_plan(plan_for_config(ma.cfg, ParallelConfig()),
                           devices="cpu")
        assert hm.nproc == 1 and ta._plan is not None
        assert ta._plan.mesh is hm and ta.opt_state["slots"]
    finally:
        dist.destroy_process_group()
    with pytest.raises(NotImplementedError, match="B.3.3"):
        tr.precompile({"input_ids": ids, "labels": ids})
    assert tr.fit([{"input_ids": ids, "labels": ids}], 1, log_every=1,
                  steps_per_dispatch=2)[0].step == 1


def test_trainer_accumulation_matches_one_batch():
    """accumulate_steps=2 over two microbatches equals one step over the
    whole batch (loss and parameters), as in the JAX trainer."""
    cfg = LlamaConfig.tiny(loss_impl="naive", num_hidden_layers=1)
    rs = np.random.RandomState(16)
    ids = rs.randint(0, cfg.vocab_size, (4, 17))
    full = {"input_ids": _t(ids[:, :-1]), "labels": _t(ids[:, 1:])}
    micro = {k: v.reshape(2, 2, 16) for k, v in full.items()}
    out = []
    for batch, acc in ((full, 1), (micro, 2)):
        m = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        tr = Trainer(m, AdamW(learning_rate=1e-3, parameters=m),
                     accumulate_steps=acc)
        out.append((tr.train_step(batch), m.state_dict()))
    _close(out[0][0], out[1][0])
    for k, v in out[0][1].items():
        _close(v, out[1][1][k])


def test_optimizer_step_api_and_state_dict_round_trip():
    """The imperative ``step()`` from ``.grad`` equals ``apply_gradients``
    with the same gradients; ``clear_grad`` drops them; a state_dict
    restored into a fresh optimizer continues identically."""
    rs = np.random.RandomState(17)
    w0 = rs.normal(0, 1, (4, 3)).astype(np.float32)
    grads = [rs.normal(0, 1, (4, 3)).astype(np.float32) for _ in range(3)]
    a = {"w": torch.nn.Parameter(_t(w0))}
    b = {"w": _t(w0)}
    opt_a = AdamW(learning_rate=1e-2, parameters=a)
    opt_b = AdamW(learning_rate=1e-2)
    for g in grads[:2]:
        a["w"].grad = _t(g)
        opt_a.step()
        opt_a.clear_grad()
        assert a["w"].grad is None
        opt_b.apply_gradients(b, {"w": _t(g)})
    _close(a["w"].detach(), b["w"])
    opt_c = AdamW(learning_rate=1e-2)
    opt_c.set_state_dict(opt_b.state_dict())
    c = {"w": b["w"].clone()}
    opt_b.apply_gradients(b, {"w": _t(grads[2])})
    opt_c.apply_gradients(c, {"w": _t(grads[2])})
    _close(c["w"], b["w"])


def test_fit_reports_metrics_and_no_mfu_off_the_card():
    cfg = LlamaConfig.tiny(loss_impl="naive", num_hidden_layers=1)
    m = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))
    tr = Trainer(m, AdamW(learning_rate=1e-3, parameters=m))
    ids = np.random.RandomState(18).randint(0, cfg.vocab_size, (2, 17))
    batch = {"input_ids": _t(ids[:, :-1]), "labels": _t(ids[:, 1:])}
    seen = []
    hist = tr.fit(iter([batch] * 5), steps=4, log_every=2,
                  on_metrics=seen.append)
    assert [h.step for h in hist] == [2, 4] and seen == hist
    assert all(h.tokens_per_sec > 0 and np.isnan(h.mfu) for h in hist)
    assert hist[-1].loss < hist[0].loss


# -- the default configuration: fused vocab-CE head, recompute -------------

def _jax_pair(seed=6, **kw):
    """A JAX tiny Llama with the default (fused) head, ``kw`` applied to
    its config, and the port's twin with the same weights."""
    import paddle_tpu as pt
    pt.seed(seed)
    jm = JaxLlama(JaxConfig.tiny(**kw))
    cfg = LlamaConfig.tiny(**kw)
    tm = LlamaForCausalLM(cfg, device="cpu")
    tm.load_state_dict(state_dict_from_jax(
        {k: np.asarray(v) for k, v in jm.state_dict().items()}, cfg,
        device="cpu"))
    return jm, tm


def _jax_loss_and_grads(jm, batch):
    params = dict(jm.raw_parameters())
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_of(p):
        return jm.functional_call(p, return_logits=False, **jb)
    loss, grads = jax.value_and_grad(loss_of)(params)
    return loss, {k: np.asarray(v) for k, v in grads.items()}


def _torch_loss_and_grads(tm, batch):
    tm.zero_grad(set_to_none=True)
    loss = tm(**{k: _t(v) for k, v in batch.items()}, return_logits=False)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in
                           tm.named_parameters()}


@pytest.mark.parametrize("tied", [False, True])
def test_default_head_loss_and_grads_match_jax(tied):
    """The tiny Llama's default (fused) head: loss and every gradient,
    the untied lm_head or the tied embedding (gather plus transposed dW)
    included, against the JAX model's fused head within 1e-4."""
    jm, tm = _jax_pair(tie_word_embeddings=tied)
    assert tm.cfg.loss_impl == "fused" and fused_loss_enabled(tm.cfg)
    batch = _train_batch(tm.cfg, seed=7)
    jl, jg = _jax_loss_and_grads(jm, batch)
    tl, tg = _torch_loss_and_grads(tm, batch)
    _close(tl, jl, 1e-4)
    assert set(tg) == set(jg)
    for name in jg:
        _close(tg[name], jg[name], 1e-4)


def test_trainer_four_steps_default_head_match_jax_trainer():
    """Four Trainer steps with the default (fused) head against four of
    ``paddle_tpu.trainer.Trainer`` with loss_impl="fused": every loss and
    every final parameter within 1e-4."""
    jm, tm = _jax_pair(seed=8)
    ours = Trainer(tm, AdamW(learning_rate=1e-3, parameters=tm,
                             weight_decay=0.01,
                             grad_clip=clip.ClipGradByGlobalNorm(1.0)))
    theirs = JaxTrainer(jm, JaxAdamW(learning_rate=1e-3, parameters=jm,
                                     weight_decay=0.01,
                                     grad_clip=jclip.ClipGradByGlobalNorm(
                                         1.0)), donate=False)
    for step in range(4):
        batch = _train_batch(tm.cfg, seed=10 + step)
        tl = ours.train_step({k: _t(v) for k, v in batch.items()})
        jl = theirs.train_step({k: jnp.asarray(v) for k, v in batch.items()})
        _close(tl, jl, 1e-4)
    final = tm.state_dict()
    for name, val in theirs.params.items():
        _close(final[name], val, 1e-4)


@pytest.mark.parametrize("recompute", ["selective", "full"])
def test_recompute_matches_none_and_jax(recompute):
    """Gradients with activation recompute equal those without it within
    1e-6 (they are equal bit for bit on the CPU), and equal the JAX
    model's under the same recompute within 1e-4."""
    jm, tm = _jax_pair(seed=9, recompute=recompute)
    batch = _train_batch(tm.cfg, seed=11)
    tl, tg = _torch_loss_and_grads(tm, batch)
    tm.cfg.recompute = "none"
    try:
        nl, ng = _torch_loss_and_grads(tm, batch)
    finally:
        tm.cfg.recompute = recompute
    _close(tl, nl, 1e-6)
    for name in ng:
        _close(tg[name], ng[name], 1e-6)
    jl, jg = _jax_loss_and_grads(jm, batch)
    _close(tl, jl, 1e-4)
    for name in jg:
        _close(tg[name], jg[name], 1e-4)


@pytest.mark.parametrize("policy", ["full", "nothing_saveable",
                                    "dots_saveable", "checkpoint_dots",
                                    "dots_with_no_batch_dims_saveable",
                                    "everything_saveable"])
def test_recompute_policies_give_the_plain_gradients(policy):
    """Every policy name of the JAX package's table: the value and the
    gradients of a function with 2-D and batched products, run under
    ``recompute`` and ``recompute_wrapper``, equal the plain call's."""
    rs = np.random.RandomState(19)
    w1, w2, x = (_t(rs.randn(*s).astype(np.float32)).requires_grad_()
                 for s in ((8, 16), (3, 16, 16), (3, 5, 8)))

    def f(x, scale=1.0):
        y = torch.tanh(torch.matmul(x, w1))          # aten.mm
        return (torch.bmm(y, w2).sin() * scale).sum()   # aten.bmm

    def grads(fn):
        out = fn(x, scale=0.5)
        return [out.detach()] + list(torch.autograd.grad(out, (x, w1, w2)))
    want = grads(f)
    for got in (grads(lambda *a, **k: recompute(f, *a, policy=policy, **k)),
                grads(recompute_wrapper(f, policy=policy))):
        for g, w in zip(got, want):
            _close(g, w, 1e-6)


def test_recompute_refuses_an_unknown_policy():
    with pytest.raises(ValueError, match="unknown recompute policy"):
        resolve_policy("offload_dots")
    assert resolve_policy(None) is None
    assert resolve_policy("full") is None


def test_trainer_asks_for_the_loss_alone():
    """With the fused head no step computes the [b, s, vocab] logits:
    Trainer calls forward with return_logits=False (the eager
    counterpart of jit dropping the unread logits)."""
    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    m = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(0))

    def no_logits(hidden):
        raise AssertionError("the training step computed the logits")
    m.logits = no_logits
    tr = Trainer(m, AdamW(learning_rate=1e-3, parameters=m))
    ids = np.random.RandomState(20).randint(0, cfg.vocab_size, (2, 17))
    loss = tr.train_step({"input_ids": _t(ids[:, :-1]),
                          "labels": _t(ids[:, 1:])})
    assert torch.isfinite(loss)


def test_forward_return_logits_and_the_naive_switch(monkeypatch):
    """return_logits None gives (loss, logits) and False the loss alone,
    the same loss; PT_NAIVE_LOSS_HEAD selects the naive head in both
    packages, and the two heads agree within 1e-5."""
    cfg = LlamaConfig.tiny(num_hidden_layers=1)
    m = LlamaForCausalLM(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    ids = _t(np.random.RandomState(21).randint(0, cfg.vocab_size, (2, 9)))
    with torch.no_grad():
        loss, logits = m(ids, labels=ids)
        alone = m(ids, labels=ids, return_logits=False)
        want_logits = m.logits(m.model(ids))
        assert torch.equal(loss, alone) and torch.equal(logits, want_logits)
        monkeypatch.setenv("PT_NAIVE_LOSS_HEAD", "1")
        assert not fused_loss_enabled(cfg)
        assert not jax_fused_enabled(JaxConfig.tiny())
        naive = m(ids, labels=ids, return_logits=False)
    _close(naive, loss)
