"""The port's ops (paddle_tpu_torch.ops) against the JAX package's, on the
CPU: the plain PyTorch versions the CUDA kernels are held to must compute
what the Pallas kernels (run in interpret mode) and their XLA
counterparts compute. Inputs come from numpy with a fixed seed; fp32,
tolerance 1e-5 unless stated."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.inference.generation import _mask_logits_rowwise
from paddle_tpu.ops.attention import _sdpa_xla
from paddle_tpu.ops.norm import _rms_norm_xla
from paddle_tpu.ops.pallas.fused_norm import rms_norm_pallas
from paddle_tpu.ops.pallas.fused_rope import fused_rope_pallas
from paddle_tpu.ops.pallas.paged_attention import (paged_decode_attention,
                                                   paged_decode_xla)
from paddle_tpu.ops.rope import apply_rotary_pos_emb as jax_rope
from paddle_tpu.ops.rope import rope_freqs as jax_rope_freqs
from paddle_tpu_torch.inference.generation import (_unit_open,
                                                   mask_logits_rowwise,
                                                   row_uniforms,
                                                   sample_logits_per_slot)
from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops import norm as norm_ops
from paddle_tpu_torch.ops import rope as rope_ops
from paddle_tpu_torch.ops.kernels import (fused_norm, fused_rope,
                                          paged_attention)

TOL = 1e-5


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def test_rms_norm_plain_matches_pallas_and_xla():
    rs = np.random.RandomState(0)
    x = rs.normal(0, 1, (4, 8, 128)).astype(np.float32)
    w = (1 + 0.1 * rs.normal(0, 1, (128,))).astype(np.float32)
    got = norm_ops.rms_norm(torch.tensor(x), torch.tensor(w), 1e-5)
    _close(got, rms_norm_pallas(jnp.asarray(x), jnp.asarray(w), 1e-5,
                                interpret=True))
    _close(got, _rms_norm_xla(jnp.asarray(x), jnp.asarray(w), 1e-5))


def test_rope_freqs_match():
    cos, sin = rope_ops.rope_freqs(64, 300, 500000.0)
    jc, js = jax_rope_freqs(64, 300, 500000.0)
    _close(cos, jc)
    _close(sin, js)


def _rope_inputs(rs, b=2, s=16, h=4, hk=2, d=128):
    qkv = rs.normal(0, 1, (b, s, (h + 2 * hk) * d)).astype(np.float32)
    q = qkv[..., :h * d].reshape(b, s, h, d)
    k = qkv[..., h * d:(h + hk) * d].reshape(b, s, hk, d)
    return qkv, q, k


def test_rope_contiguous_positions_match_pallas():
    rs = np.random.RandomState(1)
    qkv, q, k = _rope_inputs(rs)
    cos, sin = rope_ops.rope_freqs(128, 64, 10000.0)
    # q and k as strided views of one fused projection, as the model has
    t = torch.tensor(qkv)
    tq = t[..., :4 * 128].view(2, 16, 4, 128)
    tk = t[..., 4 * 128:6 * 128].view(2, 16, 2, 128)
    gq, gk = rope_ops.apply_rotary_pos_emb(tq, tk, cos, sin)
    jq, jk = fused_rope_pallas(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(cos[:16].numpy()),
                               jnp.asarray(sin[:16].numpy()),
                               interpret=True)
    _close(gq, jq)
    _close(gk, jk)


def test_rope_position_ids_match_xla():
    rs = np.random.RandomState(2)
    _, q, k = _rope_inputs(rs, b=3, s=2)
    pos = rs.randint(0, 200, (3, 2))
    cos, sin = rope_ops.rope_freqs(128, 256, 10000.0)
    gq, gk = rope_ops.apply_rotary_pos_emb(torch.tensor(q), torch.tensor(k),
                                           cos, sin, torch.tensor(pos))
    jq, jk = jax_rope(jnp.asarray(q), jnp.asarray(k),
                      jnp.asarray(cos.numpy()), jnp.asarray(sin.numpy()),
                      jnp.asarray(pos))
    _close(gq, jq)
    _close(gk, jk)


def _paged_inputs(rs, H, H_kv, B=3, D=32, page=8, mp=4, num_pages=14):
    q = rs.normal(0, 1, (B, H, D)).astype(np.float32)
    kp = rs.normal(0, 1, (H_kv, num_pages, page, D)).astype(np.float32)
    vp = rs.normal(0, 1, (H_kv, num_pages, page, D)).astype(np.float32)
    tables = rs.permutation(num_pages)[:B * mp].reshape(B, mp)
    # lens crossing page boundaries; unused trailing slots are -1
    lens = np.array([0, page, 2 * page + 3][:B], np.int64)
    for b in range(B):
        tables[b, lens[b] // page + 1:] = -1
    return q, kp, vp, tables.astype(np.int32), lens


# groups 1, 2 and 4, the groups of qwen2_moe_a14b (7) and ernie45_moe
# (5), and a group of 16 (two slices of 8 in the kernel), all at D = 32
@pytest.mark.parametrize("H,H_kv", [(4, 4), (4, 2), (8, 2), (10, 2), (14, 2),
                                    (16, 1)])
def test_paged_decode_plain_matches_pallas_and_xla(H, H_kv):
    rs = np.random.RandomState(H * 10 + H_kv)
    q, kp, vp, tables, lens = _paged_inputs(rs, H, H_kv)
    got = attn_ops.paged_decode_attention(
        torch.tensor(q), torch.tensor(kp), torch.tensor(vp),
        torch.tensor(tables), torch.tensor(lens))
    args = (jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
            jnp.asarray(tables), jnp.asarray(lens.astype(np.int32)))
    _close(got, paged_decode_attention(*args, interpret=True))
    _close(got, paged_decode_xla(*args))


@pytest.mark.parametrize("group", range(1, 21))
def test_paged_decode_group_slices_cover_the_group(group):
    """A group of query rows is held gs rows a block (1, 2, 4 or 8, no
    more than the group needs) in slices that cover it, the last one
    partly."""
    gs, slices = paged_attention.group_slice(group)
    assert gs in (1, 2, 4, 8) and gs < 2 * group
    assert (slices - 1) * gs < group <= slices * gs
    assert slices == 1 or gs == paged_attention.MAX_SLICE


@pytest.mark.parametrize("b,h_kv,slices,max_pages,page,sms", [
    (8, 8, 1, 16, 128, 132),      # the serving run: 16 splits of a page
    (1, 1, 1, 16, 128, 132),      # one sequence: splits capped at 512 tokens
    (4, 2, 2, 48, 8, 132),
    (3, 2, 1, 5, 24, 132),        # a page size that is no power of two
    (64, 8, 1, 4, 16, 132),       # many pairs: one split
    (2, 1, 1, 3, 1024, 132),      # pages longer than a split's cap
    (1, 4, 1, 1000, 16, 8),
    (1, 1, 1, 40000, 8, 132)])    # more pages than MAX_SPLITS x 64
def test_paged_decode_split_plan_covers_every_page_once(
        b, h_kv, slices, max_pages, page, sms):
    """Every page of the table falls in exactly one split; the plan is a
    function of shapes (it is never given the sequence lengths, a device
    tensor); full tables give at least half of BLOCKS_PER_SM blocks an
    SM where the table has pages enough, and a split walks at most
    SPLIT_TOKENS tokens unless one page holds more."""
    import inspect
    assert set(inspect.signature(paged_attention.split_plan).parameters) \
        == {"b", "h_kv", "slices", "max_pages", "page_size", "sms"}
    pps, splits = paged_attention.split_plan(b, h_kv, slices, max_pages,
                                             page, sms)
    seen = np.zeros(max_pages, np.int64)
    for s in range(splits):
        seen[s * pps:min((s + 1) * pps, max_pages)] += 1
    assert np.all(seen == 1) and (splits - 1) * pps < max_pages
    assert splits <= paged_attention.MAX_SPLITS
    assert pps * page <= max(paged_attention.SPLIT_TOKENS, page) or \
        pps == -(-max_pages // paged_attention.MAX_SPLITS)
    pairs = b * h_kv * slices
    assert pairs * splits >= min(paged_attention.BLOCKS_PER_SM * sms // 2,
                                 pairs * max_pages,
                                 pairs * paged_attention.MAX_SPLITS // 2)
    assert paged_attention.split_plan(b, h_kv, slices, max_pages, page,
                                      sms) == (pps, splits)


@pytest.mark.parametrize("H,H_kv,page,pps", [(4, 2, 8, 1), (14, 2, 8, 3),
                                             (8, 8, 24, 2)])
def test_paged_decode_split_merge_matches_one_pass(H, H_kv, page, pps):
    """Each split's (m, l, acc) over its own tokens (a split past the
    sequence has none), merged by merge_splits in split order, equals one
    pass over the whole sequence (paged_decode_plain), fp32, 1e-5."""
    rs = np.random.RandomState(H + page + pps)
    B, D, mp, num_pages = 3, 32, 7, 24
    q, kp, vp, tables, lens = _paged_inputs(rs, H, H_kv, B, D, page, mp,
                                            num_pages)
    lens[:] = [0, 3 * page + 1, mp * page - 1]
    for b in range(B):
        tables[b] = rs.permutation(num_pages)[:mp]
        tables[b, lens[b] // page + 1:] = -1
    args = [torch.tensor(a) for a in (q, kp, vp, tables, lens)]
    want = attn_ops.paged_decode_plain(*args)
    G, splits = H // H_kv, -(-mp // pps)
    safe = np.clip(tables, 0, num_pages - 1)
    scale = 1.0 / np.sqrt(D)
    m = np.full((B, H, splits), -1e30, np.float32)
    l = np.zeros((B, H, splits), np.float32)
    acc = np.zeros((B, H, splits, D), np.float32)
    for b in range(B):
        for h in range(H):
            k = kp[h // G][safe[b]].reshape(-1, D)
            v = vp[h // G][safe[b]].reshape(-1, D)
            sc = (k @ q[b, h]) * scale
            for s in range(splits):
                t0, t1 = s * pps * page, min((s + 1) * pps * page,
                                             int(lens[b]) + 1)
                if t0 >= t1:
                    continue
                m[b, h, s] = sc[t0:t1].max()
                p = np.exp(sc[t0:t1] - m[b, h, s])
                l[b, h, s], acc[b, h, s] = p.sum(), p @ v[t0:t1]
    got = paged_attention.merge_splits(torch.tensor(m), torch.tensor(l),
                                       torch.tensor(acc))
    _close(got, want)


def test_sdpa_plain_matches_xla_causal_gqa():
    rs = np.random.RandomState(3)
    q = rs.normal(0, 1, (2, 7, 4, 16)).astype(np.float32)
    k = rs.normal(0, 1, (2, 7, 2, 16)).astype(np.float32)
    v = rs.normal(0, 1, (2, 7, 2, 16)).astype(np.float32)
    got = attn_ops.sdpa_plain(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v), causal=True)
    _close(got, _sdpa_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True))


def test_mask_logits_rowwise_matches_jax():
    rs = np.random.RandomState(4)
    logits = rs.normal(0, 2, (5, 64)).astype(np.float32)
    logits[4, :8] = logits[4, 0]               # ties at the k-th value
    temp = np.array([1.0, 0.7, 1.3, 0.0, 1.0], np.float32)
    topk = np.array([0, 5, 0, 3, 4], np.int64)
    topp = np.array([1.0, 1.0, 0.8, 0.5, 0.9], np.float32)
    got = mask_logits_rowwise(torch.tensor(logits), torch.tensor(temp),
                              torch.tensor(topk), torch.tensor(topp)).numpy()
    want = np.asarray(_mask_logits_rowwise(
        jnp.asarray(logits), jnp.asarray(temp),
        jnp.asarray(topk.astype(np.int32)), jnp.asarray(topp)))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    kept = ~np.isinf(want)
    _close(got[kept], want[kept])
    # top_p == 1 is a strict no-op on an unfiltered row
    assert not np.isinf(got[0]).any()


def test_row_uniforms_replay_exact_and_uniform():
    rseed = torch.tensor([3, 3, 4])
    idx = torch.tensor([0, 1, 0])
    u = row_uniforms(7, rseed, idx, 20000)
    assert u.dtype == torch.float32 and float(u.min()) > 0 \
        and float(u.max()) < 1
    assert torch.equal(u, row_uniforms(7, rseed, idx, 20000))
    # each counter gives its own stream
    assert not torch.equal(u[0], u[1]) and not torch.equal(u[0], u[2])
    assert not torch.equal(u, row_uniforms(8, rseed, idx, 20000))
    assert abs(float(u.mean()) - 0.5) < 0.01
    # the extreme hash values still map strictly inside (0, 1), so the
    # Gumbel noise -log(-log(u)) is finite for every token
    ends = _unit_open(torch.tensor([0, 1 << 31, (1 << 32) - 1]))
    assert float(ends.min()) > 0 and float(ends.max()) < 1
    assert torch.isfinite(-torch.log(-torch.log(ends))).all()


def test_sample_logits_per_slot_greedy_rows_and_top_k_one():
    rs = np.random.RandomState(5)
    logits = torch.tensor(rs.normal(0, 1, (3, 50)).astype(np.float32))
    tok = sample_logits_per_slot(
        logits, torch.tensor([1.0, 1.0, 1.0]), torch.tensor([0, 1, 0]),
        torch.tensor([1.0, 1.0, 1.0]), torch.tensor([False, True, True]),
        0, torch.tensor([1, 2, 3]), torch.tensor([0, 0, 0]))
    amax = torch.argmax(logits, dim=-1)
    assert int(tok[0]) == int(amax[0]) and int(tok[1]) == int(amax[1])
    assert 0 <= int(tok[2]) < 50


def test_kernel_wrappers_refuse_cpu_tensors():
    """A CUDA wrapper launches its kernel or raises: it never computes a
    CPU tensor itself (the plain versions are chosen by the ops)."""
    x = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_norm.rms_norm_fwd(x, torch.ones(8), 1e-5)
    q = torch.zeros((1, 2, 2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fused_rope.fused_rope(q, q, torch.zeros((4, 8)), torch.zeros((4, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention.paged_decode(
            torch.zeros((1, 2, 64)), torch.zeros((1, 2, 4, 64)),
            torch.zeros((1, 2, 4, 64)), torch.zeros((1, 1), dtype=torch.int32),
            torch.zeros((1,), dtype=torch.int64))
