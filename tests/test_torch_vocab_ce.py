"""The port's fused vocab-CE head (``paddle_tpu_torch.ops.vocab_ce``)
against the JAX package's, on the CPU.

The same numpy-seeded h [48, 64], W [64, 300] (V not a multiple of the
128-column blocks) and labels (ignored rows included) go through the
port's plain route and through ``paddle_tpu``'s ``lse_and_target`` and
``fused_linear_cross_entropy``: the Pallas kernels in interpret mode
(block_n 8, block_v 128) and the XLA path. fp32 tolerance 1e-5 (the same
formula summed in another order); bf16 is held by the relative Frobenius
error, 1e-2 (both sides round the same fp32 sums once to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_vocab_ce as jce
from paddle_tpu_torch.ops import vocab_ce
from paddle_tpu_torch.ops.kernels import fused_vocab_ce as kce

TOL = 1e-5
N, H, V = 48, 64, 300


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().float().numpy()
    return np.asarray(a, np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol)


def _t(a, requires_grad=False):
    return torch.tensor(np.asarray(a), requires_grad=requires_grad)


def _inputs(seed=0, all_ignored=False):
    """h, W, labels with -100 rows, and cotangents for (lse, tgt)."""
    rs = np.random.RandomState(seed)
    h = rs.randn(N, H).astype(np.float32)
    w = (0.3 * rs.randn(H, V)).astype(np.float32)
    lab = rs.randint(0, V, (N,))
    lab[[0, 7, 30]] = -100
    lab[5] = V - 1                     # in the padded last block
    if all_ignored:
        lab[:] = -100
    g_lse = rs.randn(N).astype(np.float32)
    g_tgt = rs.randn(N).astype(np.float32)
    return h, w, lab, g_lse, g_tgt


def _safe(lab):
    return np.where(lab == -100, -1, lab).astype(np.int32)


def _jax_lse(h, w, lab, impl):
    return lambda hh, ww: jce.lse_and_target(hh, ww, jnp.asarray(lab), 8,
                                             128, impl, impl == "pallas")


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_lse_and_target_matches_jax(impl):
    """lse and tgt of the plain route against the Pallas kernels
    (interpret mode) and the XLA path; ignored rows give tgt 0."""
    h, w, lab, _, _ = _inputs()
    safe = _safe(lab)
    jl, jt = _jax_lse(h, w, safe, impl)(jnp.asarray(h), jnp.asarray(w))
    tl, tt = vocab_ce.lse_and_target(_t(h), _t(w), _t(safe))
    _close(tl, jl)
    _close(tt, jt)
    assert np.all(np.asarray(tt)[lab == -100] == 0.0)


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_lse_and_target_grads_match_jax_vjp(impl):
    """dh and dW of the autograd Function (the plain backward) against
    jax.vjp of the same function for the same cotangents."""
    h, w, lab, g_lse, g_tgt = _inputs(1)
    safe = _safe(lab)
    _, vjp = jax.vjp(_jax_lse(h, w, safe, impl), jnp.asarray(h),
                     jnp.asarray(w))
    jdh, jdw = vjp((jnp.asarray(g_lse), jnp.asarray(g_tgt)))
    th, tw = _t(h, True), _t(w, True)
    tl, tt = vocab_ce.lse_and_target(th, tw, _t(safe))
    torch.autograd.backward((tl, tt), (_t(g_lse), _t(g_tgt)))
    _close(th.grad, jdh)
    _close(tw.grad, jdw)


@pytest.mark.parametrize("tied", [False, True])
@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_fused_linear_cross_entropy_matches_jax(reduction, tied):
    """Loss and the gradients of hidden [2, 24, H] and of W (or, tied,
    of the embedding [V, H] whose transposed view is W) against the JAX
    function on its XLA path."""
    h, w, lab, _, _ = _inputs(2)
    h3, lab3 = h.reshape(2, 24, H), lab.reshape(2, 24)
    wp = np.ascontiguousarray(w.T) if tied else w       # the parameter
    rs = np.random.RandomState(3)
    gout = rs.randn(2, 24).astype(np.float32)

    def jax_loss(hh, pp):
        ww = jnp.swapaxes(pp, 0, 1) if tied else pp
        out = jce.fused_linear_cross_entropy(
            hh, ww, jnp.asarray(lab3), reduction=reduction, block_n=8,
            block_v=128, impl="xla")
        return jnp.sum(out * jnp.asarray(gout)) if reduction == "none" \
            else out
    jl, (jdh, jdp) = jax.value_and_grad(jax_loss, argnums=(0, 1))(
        jnp.asarray(h3), jnp.asarray(wp))
    th, tp = _t(h3, True), _t(wp, True)
    out = vocab_ce.fused_linear_cross_entropy(
        th, tp.t() if tied else tp, _t(lab3), reduction=reduction)
    if reduction == "none":
        assert out.shape == (2, 24)
        out = (out * _t(gout)).sum()
    out.backward()
    _close(out.detach(), jl)
    _close(th.grad, jdh)
    _close(tp.grad, jdp)


def test_all_ignored_rows_give_zero_loss_and_grads():
    h, w, lab, _, _ = _inputs(4, all_ignored=True)
    jl = jce.fused_linear_cross_entropy(jnp.asarray(h), jnp.asarray(w),
                                        jnp.asarray(lab), impl="xla")
    th, tw = _t(h, True), _t(w, True)
    loss = vocab_ce.fused_linear_cross_entropy(th, tw, _t(lab))
    loss.backward()
    assert float(loss.detach()) == 0.0 == float(jl)
    assert not th.grad.any() and not tw.grad.any()


def test_plain_result_does_not_depend_on_the_blocks():
    h, w, lab, g_lse, g_tgt = _inputs(5)
    safe = _t(_safe(lab))
    ref = None
    for bv in (64, 128, 300, 2048):
        lse, tgt = vocab_ce._fwd_plain(_t(h), _t(w), safe, bv)
        dh, dw = vocab_ce._bwd_plain(_t(h), _t(w), safe, lse, _t(g_lse),
                                     _t(g_tgt), bv)
        got = [lse, tgt, dh, dw]
        if ref is None:
            ref = got
        for a, b in zip(got, ref):
            _close(a, b, 1e-6)


def test_bf16_plain_matches_pallas_casts():
    """bf16 h and W: lse/tgt, dh (bf16) and dW (bf16) of the plain route
    against the Pallas kernels in interpret mode, which round dlog to
    bf16 before both products."""
    h, w, lab, g_lse, g_tgt = _inputs(6)
    safe = _safe(lab)
    jh = jnp.asarray(h, jnp.bfloat16)
    jw = jnp.asarray(w, jnp.bfloat16)
    (jl, jt), vjp = jax.vjp(_jax_lse(h, w, safe, "pallas"), jh, jw)
    jdh, jdw = vjp((jnp.asarray(g_lse), jnp.asarray(g_tgt)))
    th = torch.tensor(np.asarray(jh.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    tw = torch.tensor(np.asarray(jw.astype(jnp.float32))).to(
        torch.bfloat16).requires_grad_()
    tl, tt = vocab_ce.lse_and_target(th, tw, _t(safe))
    torch.autograd.backward((tl, tt), (_t(g_lse), _t(g_tgt)))
    _close(tl, jl)
    _close(tt, jt)
    assert th.grad.dtype == tw.grad.dtype == torch.bfloat16
    for got, want in ((th.grad, jdh), (tw.grad, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        err = np.linalg.norm(got.float().numpy() - want) / np.linalg.norm(
            want)
        assert err <= 1e-2, err


def test_kernel_wrappers_refuse_cpu_tensors_and_bad_input():
    h, w, lab, _, _ = _inputs()
    safe = _t(_safe(lab))
    with pytest.raises(ValueError, match="CUDA"):
        kce.vocab_ce_fwd(_t(h), _t(w), safe)
    with pytest.raises(ValueError, match="CUDA"):
        kce.vocab_ce_bwd(_t(h), _t(w), safe, *[torch.zeros(N)] * 3)
    with pytest.raises(ValueError):
        vocab_ce.fused_linear_cross_entropy(_t(h), _t(w), _t(lab),
                                            reduction="max")
    with pytest.raises(ValueError):
        vocab_ce.fused_linear_cross_entropy(_t(h), _t(w), _t(lab),
                                            impl="cuda")


@pytest.mark.parametrize("n,v", [(5, 300), (33, 256), (8, 1001)])
def test_forward_partial_merge_matches_logsumexp(n, v):
    """The bf16 forward's partials, one (m, s, t) a row and 256-column
    tile as its epilogue leaves them (columns past V weigh 0, t from the
    tile holding the label, 0 elsewhere), merged by merge_partials in
    tile order: lse equals torch.logsumexp and tgt the label's logit (0
    for a label outside [0, V)), fp32, 1e-5."""
    rs = np.random.RandomState(n + v)
    logits = torch.tensor((3 * rs.randn(n, v)).astype(np.float32))
    lab = rs.randint(0, v, (n,))
    lab[0], lab[1], lab[-1] = -1, v, v - 1       # outside, and the last
    tiles = -(-v // 256)
    part = torch.zeros((3, tiles, n))
    for j in range(tiles):
        x = logits[:, j * 256:(j + 1) * 256]
        part[0, j] = x.max(1).values
        part[1, j] = torch.exp(x - part[0, j][:, None]).sum(1)
        inside = (lab >= j * 256) & (lab < min(v, (j + 1) * 256))
        for r in np.nonzero(inside)[0]:
            part[2, j, r] = x[r, lab[r] - j * 256]
    lse, tgt = kce.merge_partials(part)
    _close(lse, torch.logsumexp(logits, -1))
    want = torch.tensor([float(logits[r, lab[r]]) if 0 <= lab[r] < v
                         else 0.0 for r in range(n)])
    _close(tgt, want)
    assert kce.route(torch.bfloat16) == "wgmma"
    assert kce.route(torch.float32) == "fma"


@pytest.mark.parametrize("v,chunk", [(300, 8192), (1000, 256), (1001, 512),
                                     (552, 256), (777, 256), (128256, 8192),
                                     (102400, 8192)])
def test_chunk_plan_and_workspace_cover_the_vocabulary_once(v, chunk):
    """The backward's chunks tile [0, V) in order, each column exactly
    once, every chunk fits the workspace, and the workspace's leading
    dimension is the first chunk's width rounded up to a multiple of 64
    (one 128-byte TMA box of bf16)."""
    c = min(chunk, v)
    plan = kce._chunk_plan(v, c)
    ld = kce._workspace_ld(c)
    assert ld % kce.WORKSPACE_ALIGN == 0 and c <= ld < c + 64
    seen = np.zeros(v, np.int64)
    end = 0
    for c0, cw in plan:
        assert c0 == end and 0 < cw <= c
        seen[c0:c0 + cw] += 1
        end = c0 + cw
    assert end == v and np.all(seen == 1)


@pytest.mark.parametrize("v", [300, 1001, 777, 512])
def test_padded_vocab_gives_the_plain_backward_unchanged(v):
    """W padded with zero columns up to a multiple of 8 (as the bf16
    backward reads it) and fed through the plain backward gives the same
    dh and, on the real columns, the same dW as W itself (fp32, within
    1e-6: the longer contraction may be summed in other blocks): the
    padded columns' logits multiply zero weights in dh and their dW
    columns are dropped."""
    rs = np.random.RandomState(v)
    h = torch.tensor(rs.randn(N, H).astype(np.float32))
    w = torch.tensor((0.3 * rs.randn(H, v)).astype(np.float32))
    lab = rs.randint(0, v, (N,)).astype(np.int32)
    lab[::7] = -1
    labels = torch.tensor(lab)
    g_lse = torch.tensor(rs.randn(N).astype(np.float32))
    g_tgt = torch.tensor(rs.randn(N).astype(np.float32))
    wp = kce._pad_vocab(w)
    assert wp.shape == (H, -(-v // 8) * 8) and wp.is_contiguous()
    assert torch.equal(wp[:, :v], w) and not wp[:, v:].any()
    if v % 8 == 0:
        assert wp is w
    lse, _ = vocab_ce._fwd_plain(h, w, labels)
    dh, dw = vocab_ce._bwd_plain(h, w, labels, lse, g_lse, g_tgt)
    dhp, dwp = vocab_ce._bwd_plain(h, wp, labels, lse, g_lse, g_tgt)
    _close(dhp, dh, 1e-6)
    _close(dwp[:, :v], dw, 1e-6)
