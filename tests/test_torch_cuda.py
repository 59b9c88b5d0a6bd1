"""The port's CUDA kernels, serving engine and training step on the
card, held against their plain PyTorch versions. Every test needs a CUDA
device and skips without one. The file imports neither JAX nor the JAX
package, so it runs where they are not installed, without the suite's
conftest:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

Tolerances: fp32 1e-5 (the same fp32 arithmetic in another summation
order); bf16 2e-2 (both sides compute in fp32 and round once to bf16,
whose step is 2**-8 relative, so they may land one step apart). The bf16
flash kernels are also held per row (one head's d values) within 2e-2
of the row's norm, as ``chip_smoke.py`` holds them: the elementwise bf16
limit is as large as a typical attention output. The vocab-CE kernels'
lse and tgt are fp32 sums of exact products on both sides and are held
to 1e-4 in bf16; their bf16 dh is held per row (one token's H values)
and dW per column (one vocabulary entry's H values) in the same way.
"""

import copy

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops import attention as attn_ops
from paddle_tpu_torch.ops import norm as norm_ops
from paddle_tpu_torch.ops import rope as rope_ops
from paddle_tpu_torch.ops import vocab_ce
from paddle_tpu_torch.ops.kernels import (_build, flash_attention, fused_norm,
                                          fused_rope, fused_vocab_ce,
                                          paged_attention)

pytestmark = pytest.mark.cuda
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
ROW_TOL = 2e-2     # bf16 flash, per row
DTYPES = ["float32", "bfloat16"]
SERVING_KERNELS = ("rms_norm", "fused_rope", "paged_decode")


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    torch.testing.assert_close(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def _rows_close(got, want, dtype):
    """bf16: each row's |got - want|_2 within ROW_TOL of |want|_2 (plus
    1e-3 of the mean row norm, for rows that are 0). fp32's elementwise
    1e-5 is already far tighter."""
    if dtype != "bfloat16":
        return
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    wn = w.norm(dim=-1)
    err = float(((g - w).norm(dim=-1) / (wn + 1e-3 * wn.mean())).max())
    assert err <= ROW_TOL, (err, ROW_TOL)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,D", [(1, 4096), (5, 256), (3, 100)])
def test_rms_norm_kernel_matches_plain(dev, dtype, R, D):
    """Vector (D % 8 == 0) and scalar paths, fp32 and x-typed weights,
    and the fp32 rstd output."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(R * D)
    x = torch.randn((R, D), generator=g, device=dev).to(dt)
    want_rstd = torch.rsqrt(x.float().pow(2).mean(-1) + 1e-5)
    for wdt in (torch.float32, dt):
        w = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).to(wdt)
        y, rstd = fused_norm.rms_norm_fwd(x, w, 1e-5, return_rstd=True)
        _close(y, norm_ops._rms_norm_plain(x, w, 1e-5), dtype)
        torch.testing.assert_close(rstd, want_rstd, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_kernel_matches_plain(dev, dtype):
    """q and k as strided views of one fused qkv; contiguous positions
    (prefill) and per-row positions (decode), some past the table, which
    both sides clamp."""
    dt = getattr(torch, dtype)
    b, s, h, hk, d = 2, 5, 4, 2, 64
    g = torch.Generator(device=dev).manual_seed(0)
    qkv = torch.randn((b, s, (h + 2 * hk) * d), generator=g,
                      device=dev).to(dt)
    q = qkv[..., :h * d].view(b, s, h, d)
    k = qkv[..., h * d:(h + hk) * d].view(b, s, hk, d)
    cos, sin = rope_ops.rope_freqs(d, 32, device=dev)
    pos = torch.randint(0, 40, (b, s), generator=g, device=dev)
    for p in (None, pos):
        got = fused_rope.fused_rope(q, k, cos, sin, p)
        want = rope_ops._rope_plain(q, k, cos, sin, p)
        for a, w in zip(got, want):
            _close(a, w, dtype)


def _rms_case(dev, R, D, dt, wdt, seed, offset=False):
    """x [R, D] of dt (one element into its buffer when ``offset``: a
    contiguous view whose rows are not 16-byte aligned) and a weight."""
    g = torch.Generator(device=dev).manual_seed(seed)
    buf = torch.randn((R * D + 1,), generator=g, device=dev).to(dt)
    x = (buf[1:] if offset else buf[:-1]).view(R, D)
    w = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).to(wdt)
    return x, w


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("D", [100, 2048, 4096])
@pytest.mark.parametrize("R", [1, 3, 8, 1024, 8197])
def test_rms_norm_forward_routes_match_plain(dev, R, D, dtype):
    """Every route of the forward (row at the widths the models launch;
    scalar at D = 100 and on an offset view), fp32 and x-typed weights,
    with and without rstd: y within the dtype's tolerance and rstd within
    1e-5 of the plain version, on the route the plan names."""
    dt = getattr(torch, dtype)
    for wdt in (torch.float32, dt):
        for offset in (False, True):
            x, w = _rms_case(dev, R, D, dt, wdt, R + D, offset)
            want, want_rstd = norm_ops._rms_norm_fwd_plain(x, w, 1e-5)
            route = fused_norm.plan(
                R, D, not offset and D % 8 == 0, _build.sm_count(dev)).route
            assert route == ("scalar" if offset or D % 8 else
                             "row" if D in fused_norm.ROW_WIDTHS else "vec")
            for with_rstd in (True, False):
                _build.reset_launches()
                y, rstd = fused_norm.rms_norm_fwd(x, w, 1e-5,
                                                  return_rstd=with_rstd)
                assert _build.LAUNCHES[f"rms_norm_{route}"] == 1
                _close(y, want, dtype)
                if with_rstd:
                    torch.testing.assert_close(rstd, want_rstd, rtol=1e-5,
                                               atol=1e-5)
                else:
                    assert rstd is None


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("heads", [(32, 8), (16, 16)])
@pytest.mark.parametrize("b,s", [(8, 1), (1, 300), (2, 64)])
def test_rope_routes_match_plain(dev, b, s, heads, dtype):
    """RoPE at the models' head counts (d = 128) on strided views of one
    fused qkv, at decode (per-row positions, some past the table, which
    both sides clamp), a prefill and a training batch; the vec route, and
    the scalar route on a view one element off. The backward through
    autograd (the same kernel with the neg_sin table) against autograd
    of the plain version."""
    h, hk = heads
    d = 128
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(b * s + h)
    width = (h + 2 * hk) * d
    buf = torch.randn((b * s * width + 1,), generator=g, device=dev).to(dt)
    cos, sin = rope_ops.rope_freqs(d, 320, device=dev)
    pos = (torch.randint(0, 400, (b, s), generator=g, device=dev)
           if s == 1 else None)
    for offset in (False, True):
        qkv = (buf[1:] if offset else buf[:-1]).view(b, s, width)
        q = qkv[..., :h * d].view(b, s, h, d)
        k = qkv[..., h * d:(h + hk) * d].view(b, s, hk, d)
        route = "scalar" if offset else "vec"
        assert fused_rope.vector_aligned(q, k, cos, sin) == (not offset)
        _build.reset_launches()
        got = fused_rope.fused_rope(q, k, cos, sin, pos)
        assert _build.LAUNCHES[f"fused_rope_{route}"] == 1
        want = rope_ops._rope_plain(q, k, cos, sin, pos)
        for a, w_ in zip(got, want):
            _close(a, w_, dtype)
        gq, gk = (torch.randn(t.shape, generator=g, device=dev).to(dt)
                  for t in got)
        grads = []
        for fn in (rope_ops.apply_rotary_pos_emb, rope_ops._rope_plain):
            qq, kk = (t.detach().clone().requires_grad_() for t in (q, k))
            oq, ok = fn(qq, kk, cos, sin, pos)
            torch.autograd.backward((oq, ok), (gq, gk))
            grads.append((qq.grad, kk.grad))
        for a, w_ in zip(*grads):
            _close(a, w_, dtype)


def test_norm_and_rope_are_deterministic_and_never_sync(dev):
    """At the decode and training shapes (Llama widths, bf16), a call
    under set_sync_debug_mode("error") does not sync the host, and two
    runs give the same bits (no atomics on any route)."""
    cos, sin = rope_ops.rope_freqs(128, 8192, 500000.0, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    for R, (b, s) in ((8, (8, 1)), (8192, (2, 4096))):
        x, w = _rms_case(dev, R, 4096, torch.bfloat16, torch.float32, R)
        qkv = torch.randn((b, s, 48 * 128), generator=g, device=dev).to(
            torch.bfloat16)
        q = qkv[..., :4096].view(b, s, 32, 128)
        k = qkv[..., 4096:5120].view(b, s, 8, 128)
        pos = torch.full((b, s), 1023, device=dev) if s == 1 else None

        def run():
            return (*fused_norm.rms_norm_fwd(x, w, 1e-5, return_rstd=True),
                    *fused_rope.fused_rope(q, k, cos, sin, pos))
        first = run()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            again = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert all(torch.equal(a, b_) for a, b_ in zip(first, again))


def _paged_lens(H, H_kv, page, B, mp):
    """Lengths at the first token, at and across a page edge, at and
    across the edge of the kernel's first split (its plan on this card),
    and at the full table."""
    gs, slices = paged_attention.group_slice(H // H_kv)
    pps, _ = paged_attention.split_plan(B, H_kv, slices, mp, page,
                                        _build.sm_count(
                                            torch.device("cuda")))
    edge = min(pps, mp - 1) * page
    return np.array([0, page - 1, page, edge - 1, edge, mp * page - 1],
                    np.int64)


# GQA groups 1-8 (the Llama groups, 3, 5, 6, 7) and 16 (two slices of
# 8), every head dim the kernel takes, pages of 8, 16, 24 and 128
PAGED_SHAPES = [(8, 8, 64, 16), (8, 4, 128, 16), (16, 4, 128, 24),
                (16, 2, 256, 8), (6, 2, 32, 8), (10, 2, 64, 24),
                (12, 2, 128, 128), (14, 2, 32, 16), (8, 1, 128, 8),
                (16, 1, 64, 16), (7, 1, 256, 128)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,H_kv,D,page", PAGED_SHAPES)
def test_paged_decode_kernel_matches_plain(dev, dtype, H, H_kv, D, page):
    """Every group 1-8 and 16, every head dim the kernel takes, pages
    that a warp's chunk spans or splits, lengths at the first token, at
    and across a page edge and a split edge and at the full table;
    unused table slots -1; bf16 also per row."""
    dt = getattr(torch, dtype)
    rs = np.random.RandomState(H + D + page)
    B, mp = 6, 8
    num_pages = B * mp + 1
    q = rs.normal(0, 1, (B, H, D)).astype(np.float32)
    kp = rs.normal(0, 1, (H_kv, num_pages, page, D)).astype(np.float32)
    vp = rs.normal(0, 1, (H_kv, num_pages, page, D)).astype(np.float32)
    tables = rs.permutation(num_pages)[:B * mp].reshape(B, mp)
    lens = _paged_lens(H, H_kv, page, B, mp)
    for i in range(B):
        tables[i, lens[i] // page + 1:] = -1
    args = [torch.tensor(a, device=dev).to(dt) for a in (q, kp, vp)] + [
        torch.tensor(tables.astype(np.int32), device=dev),
        torch.tensor(lens, device=dev)]
    got = paged_attention.paged_decode(*args)
    want = attn_ops.paged_decode_plain(*args)
    _close(got, want, dtype)
    _rows_close(got, want, dtype)


def _paged_case(dev, dt, quant, H, H_kv, D, page, B, mp, seed):
    """Pools (int8 with page scales, one page never written, or of dt),
    full random tables and random lengths up to the table's end."""
    g = torch.Generator(device=dev).manual_seed(seed)
    num_pages = B * mp + 1
    q = torch.randn((B, H, D), generator=g, device=dev).to(dt)
    if quant:
        pools = []
        for _ in range(2):
            f = torch.randn((H_kv, num_pages, page, D), generator=g,
                            device=dev)
            s = f.abs().amax(dim=(0, 2, 3)) / 127.0
            s[3] = 0.0
            pools.append(torch.round(f / s.clamp_min(1e-30)[
                None, :, None, None]).clamp(-127, 127).to(torch.int8))
            pools.append(s)
        kp, ks, vp, vs = pools
        sc = dict(k_scales=ks, v_scales=vs)
    else:
        kp = torch.randn((H_kv, num_pages, page, D), generator=g,
                         device=dev).to(dt)
        vp = torch.randn((H_kv, num_pages, page, D), generator=g,
                         device=dev).to(dt)
        sc = {}
    tables = (torch.randperm(num_pages - 1, generator=g, device=dev)
              [:B * mp] + 1).view(B, mp).to(torch.int32).contiguous()
    tables[0, 0] = 3
    lens = torch.randint(0, mp * page, (B,), generator=g, device=dev)
    return (q, kp, vp, tables, lens), sc


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("blocks_per_sm", [0, 1, 8])
def test_paged_decode_kernel_split_edges(dev, quant, blocks_per_sm,
                                         monkeypatch):
    """Three split plans of a 40-page table on a 132-SM card (one split
    for the whole table; splits of 4 pages; the default's, a page a
    split), lengths at and across a split edge and at the table's end,
    native and int8 pools, bf16 against the plain version."""
    monkeypatch.setattr(paged_attention, "BLOCKS_PER_SM", blocks_per_sm)
    H, H_kv, D, page, B, mp = 16, 2, 128, 8, 6, 40
    args, sc = _paged_case(dev, torch.bfloat16, quant, H, H_kv, D, page, B,
                           mp, blocks_per_sm)
    pps, _ = paged_attention.split_plan(
        B, H_kv, paged_attention.group_slice(H // H_kv)[1], mp, page,
        _build.sm_count(dev))
    edge = pps * page
    args[4][:] = torch.tensor([0, edge - 1, edge, min(2 * edge, mp * page - 1),
                               mp * page - 2, mp * page - 1], device=dev)
    got = paged_attention.paged_decode(*args, **sc)
    want = attn_ops.paged_decode_plain(*args, **sc)
    _close(got, want, "bfloat16")
    _rows_close(got, want, "bfloat16")


@pytest.mark.parametrize("quant", [False, True])
def test_paged_decode_kernel_is_deterministic_and_never_syncs(dev, quant):
    """At the serving shape (B = 8, 32 heads over 8 of 128, 1024-token
    tables of 16-token pages, ragged lengths) a call under
    set_sync_debug_mode("error") does not sync the host, and two runs
    give the same output bit for bit: the splits merge in split order."""
    args, sc = _paged_case(dev, torch.bfloat16, quant, 32, 8, 128, 16, 8,
                           64, 11)
    first = paged_attention.paged_decode(*args, **sc)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = paged_attention.paged_decode(*args, **sc)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(first, again)
    _close(again, attn_ops.paged_decode_plain(*args, **sc), "bfloat16")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R,D", [(70, 4096), (5, 256), (3, 100)])
def test_rms_norm_bwd_kernel_matches_plain(dev, dtype, R, D):
    """Vector and scalar paths, several row blocks, fp32 and x-typed
    weights; dx in x's dtype, dw summed from the per-block partials."""
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(R + D)
    x = torch.randn((R, D), generator=g, device=dev).to(dt)
    dy = torch.randn((R, D), generator=g, device=dev).to(dt)
    for wdt in (torch.float32, dt):
        w = (1 + 0.1 * torch.randn((D,), generator=g, device=dev)).to(wdt)
        _, rstd = fused_norm.rms_norm_fwd(x, w, 1e-5, return_rstd=True)
        dx, dw = fused_norm.rms_norm_bwd(x, w, rstd, dy)
        want_dx, want_dw = norm_ops._rms_norm_bwd_plain(x, w, rstd, dy)
        _close(dx, want_dx, dtype)
        assert dw.dtype == wdt
        torch.testing.assert_close(dw.float(), want_dw.float(),
                                   rtol=TOL[dtype], atol=TOL[dtype])


# (b, sq, sk, h, hk, d, causal, segments, dropout_p)
FLASH_CASES = {
    "causal_d128": (2, 256, 256, 4, 2, 128, True, False, 0.0),
    "full_d64": (1, 192, 192, 4, 4, 64, False, False, 0.0),
    "ragged_sq_lt_sk": (1, 100, 157, 8, 2, 64, True, False, 0.0),
    "segments": (2, 200, 200, 4, 1, 128, False, True, 0.0),
    "dropout_d32": (2, 128, 128, 4, 2, 32, True, False, 0.1),
    # the Hopper kernels' tile edges: 128-row query and key tiles, 64-row
    # backward query tiles, rings of two stages
    "gqa_s4096": (1, 4096, 4096, 8, 2, 128, True, False, 0.0),
    "sq300_sk700_group4": (2, 300, 700, 8, 2, 128, True, False, 0.0),
    "causal_d32": (2, 257, 257, 4, 4, 32, True, False, 0.0),
    "segments_d64": (1, 333, 333, 6, 3, 64, False, True, 0.0),
    "segments_causal": (2, 384, 384, 8, 2, 128, True, True, 0.0),
}


# bf16 only: the Hopper kernels' long case; the fp32 FMA kernels' 1e-5
# holds for rows of up to ~1000 keys, not for a sum over 4096
BF16_ONLY = ("gqa_s4096",)
FLASH_PARAMS = [(c, d) for c in sorted(FLASH_CASES) for d in DTYPES
                if not (c in BF16_ONLY and d == "float32")]


@pytest.mark.parametrize("case,dtype", FLASH_PARAMS,
                         ids=[f"{c}-{d}" for c, d in FLASH_PARAMS])
def test_flash_kernels_match_plain(dev, dtype, case):
    """flash_fwd (out, lse) and flash_bwd (dq, dk, dv) against the plain
    versions: GQA, ragged lengths, sq < sk, segment ids with fully masked
    rows, dropout, head dims 32/64/128; k and v strided views."""
    b, sq, sk, h, hk, d, causal, seg, p = FLASH_CASES[case]
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(sq * 7 + d)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dt)
    kv = torch.randn((b, sk, 2 * hk, d), generator=g, device=dev).to(dt)
    k, v = kv[:, :, :hk], kv[:, :, hk:]
    dout = torch.randn((b, sq, h, d), generator=g, device=dev).to(dt)
    q_seg = kv_seg = None
    if seg:
        q_seg = (torch.arange(sq, device=dev) // 70).to(torch.int32)
        q_seg = q_seg.expand(b, sq).contiguous()
        kv_seg = q_seg.clone()
        q_seg[:, -10:] = 9                      # no key has id 9
    args = (causal, d ** -0.5, q_seg, kv_seg, p, 77)
    out, lse = flash_attention.flash_fwd(q, k, v, *args)
    want_out, want_lse = attn_ops._flash_fwd_plain(q, k, v, *args)
    _close(out, want_out, dtype)
    _rows_close(out, want_out, dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    delta = (want_out.float() * dout.float()).sum(-1).transpose(
        1, 2).contiguous()
    dq, dk, dv = flash_attention.flash_bwd(q, k, v, dout, want_lse, delta,
                                           *args)
    wdq, wdk, wdv = attn_ops._flash_bwd_plain(q, k, v, dout, want_lse, delta,
                                              *args)
    for got, want in ((dq, wdq), (dk, wdk), (dv, wdv)):
        _close(got, want, dtype)
        _rows_close(got, want, dtype)


def _flash_inputs(dev, b, s, h, hk, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    q, dout = (torch.randn((b, s, h, d), generator=g, device=dev).to(
        torch.bfloat16) for _ in range(2))
    kv = torch.randn((b, s, 2 * hk, d), generator=g, device=dev).to(
        torch.bfloat16)
    return q, kv[:, :, :hk], kv[:, :, hk:], dout


def test_bf16_flash_bwd_runs_agree(dev):
    """Two bf16 backward runs on the same inputs are equal to the bit: dk
    and dv (each block sums its own keys in a fixed order) and dq (the key
    tiles add into each query tile in ascending order, ordered by the
    tile's counter), at the training layout's GQA group of 4."""
    q, k, v, dout = _flash_inputs(dev, 2, 1024, 8, 2, 128, 11)
    args = (True, 128 ** -0.5, None, None, 0.0, 0)
    out, lse = flash_attention.flash_fwd(q, k, v, *args)
    delta = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
    a = flash_attention.flash_bwd(q, k, v, dout, lse, delta, *args)
    b = flash_attention.flash_bwd(q, k, v, dout, lse, delta, *args)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# (b, s, h, hk, d, causal, segment ids, dropout p): every route of the
# bf16 backward's ordered dq adds (d <= 64 orders its two warpgroups too)
DQ_RUNS = {
    "d32-causal": (2, 777, 8, 2, 32, True, False, 0.0),
    "d64-causal": (2, 1024, 8, 2, 64, True, False, 0.0),
    "d64-full": (1, 1000, 4, 4, 64, False, False, 0.0),
    "d128-full": (2, 640, 8, 1, 128, False, False, 0.0),
    "d128-segments": (2, 900, 8, 2, 128, True, True, 0.0),
    "d64-dropout": (1, 768, 8, 2, 64, True, False, 0.1),
}


@pytest.mark.parametrize("case", list(DQ_RUNS))
def test_bf16_flash_bwd_dq_is_the_same_every_run(dev, case):
    """Three bf16 backward runs per route give dq, dk and dv equal to the
    bit, and dq still agrees with the plain version."""
    b, s, h, hk, d, causal, seg, p = DQ_RUNS[case]
    q, k, v, dout = _flash_inputs(dev, b, s, h, hk, d, 13)
    q_seg = kv_seg = None
    if seg:
        q_seg = (torch.arange(s, device=dev) // 70).to(torch.int32)
        q_seg = q_seg.expand(b, s).contiguous()
        kv_seg = q_seg.clone()
    args = (causal, d ** -0.5, q_seg, kv_seg, p, 5)
    out, lse = flash_attention.flash_fwd(q, k, v, *args)
    delta = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
    runs = [flash_attention.flash_bwd(q, k, v, dout, lse, delta, *args)
            for _ in range(3)]
    for later in runs[1:]:
        for x, y in zip(runs[0], later):
            assert torch.equal(x, y)
    want = attn_ops._flash_bwd_plain(q, k, v, dout, lse, delta, *args)
    for got, w in zip(runs[0], want):
        _close(got, w, "bfloat16")
        _rows_close(got, w, "bfloat16")


def test_flash_wrappers_refuse_unaligned_bf16_views(dev):
    """The bf16 kernels read by TMA: a view 2 bytes off a 16-byte boundary,
    or with a stride that is not a multiple of 16 bytes, is refused, not
    copied."""
    q, k, v, dout = _flash_inputs(dev, 1, 64, 4, 2, 64, 12)
    args = (True, 0.125)
    buf = torch.zeros((1, 64, 4 * 64 + 1), dtype=torch.bfloat16, device=dev)
    off = buf[:, :, 1:].view(1, 64, 4, 64)          # address + 2 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention.flash_fwd(off, k, v, *args)
    wide = torch.zeros((1, 64, 2, 68), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention.flash_fwd(q, wide[..., :64], v, *args)
    out, lse = flash_attention.flash_fwd(q, k, v, *args)
    base = torch.zeros(4 * 64 + 1, device=dev)
    delta = base[1:].view(1, 4, 64)                 # address + 4 bytes
    with pytest.raises(ValueError, match="16 bytes"):
        flash_attention.flash_bwd(q, k, v, dout, lse, delta, *args)


def test_cuda_routes_carry_gradients(dev):
    """On the card, rms_norm, RoPE and flash attention return tensors with
    a grad_fn, and their backward launches the backward kernels."""
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((2, 16, 128), generator=g, device=dev,
                    requires_grad=True)
    w = torch.ones((128,), device=dev, requires_grad=True)
    cos, sin = rope_ops.rope_freqs(32, 64, device=dev)
    _build.reset_launches()
    y = norm_ops.rms_norm(x, w, 1e-5)
    q, k = rope_ops.apply_rotary_pos_emb(y.view(2, 16, 4, 32),
                                         y.view(2, 16, 4, 32), cos, sin)
    out = attn_ops.flash_attention(q, k, k, causal=True)
    assert all(t.grad_fn is not None for t in (y, q, k, out))
    out.sum().backward()
    assert x.grad is not None and w.grad is not None
    counts = dict(_build.LAUNCHES)
    assert counts["rms_norm"] == 1 and counts["rms_norm_bwd"] == 1, counts
    assert counts["fused_rope"] == 2, counts           # forward + backward
    for name in ("flash_fwd", "flash_bwd"):
        assert counts[name] == 1, counts


def test_training_on_card_matches_cpu(dev):
    """Three AdamW steps of the same seeded tiny Llama (fp32, segment ids
    in the batch) on the card (kernels) and on the CPU (plain versions):
    losses within 1e-4."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer
    cfg = LlamaConfig.tiny(loss_impl="naive")
    rs = np.random.RandomState(1)
    ids = rs.randint(0, cfg.vocab_size, (2, 65))
    seg = np.zeros((2, 64), np.int32)
    seg[0, 30:] = 1
    losses = []
    for device in ("cpu", dev):
        m = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        m = m.to(device)
        tr = Trainer(m, AdamW(learning_rate=1e-3, parameters=m,
                              grad_clip=ClipGradByGlobalNorm(1.0)))
        batch = {"input_ids": torch.tensor(ids[:, :-1], device=device),
                 "labels": torch.tensor(ids[:, 1:], device=device),
                 "segment_ids": torch.tensor(seg, device=device)}
        losses.append([float(tr.train_step(batch)) for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4, atol=1e-4)


def test_bf16_training_step_on_card_matches_cpu(dev):
    """One bf16 forward and backward of the same seeded tiny Llama on the
    card (the flash kernels' Hopper route) and on the CPU (plain
    versions): the loss within 1e-2 and every gradient within 3e-2 in
    relative Frobenius norm (the two sides' GEMMs round bf16 apart)."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(loss_impl="naive", dtype="bfloat16")
    rs = np.random.RandomState(2)
    ids = rs.randint(0, cfg.vocab_size, (2, 129))
    seg = np.zeros((2, 128), np.int32)
    seg[0, 50:] = 1
    side = []
    for device in ("cpu", dev):
        m = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        m = m.to(device)
        loss = m(input_ids=torch.tensor(ids[:, :-1], device=device),
                 labels=torch.tensor(ids[:, 1:], device=device),
                 segment_ids=torch.tensor(seg, device=device))[0]
        loss.backward()
        side.append((float(loss.detach()),
                     {n: p.grad.float().cpu() for n, p in
                      m.named_parameters()}))
    (lp, gp), (lc, gc) = side
    np.testing.assert_allclose(lc, lp, rtol=1e-2)
    for n in gp:
        err = float((gc[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
        assert err <= 3e-2, (n, err)


def test_engine_on_card_matches_cpu(dev):
    """The same seeded model served on the card (kernels) and on the CPU
    (plain versions): greedy and sampled streams agree token for token,
    and every kernel of the serving path launched on the card."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2)          # head_dim 64
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    card = LlamaForCausalLM(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    rs = np.random.RandomState(0)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (5, 13, 8, 20)]
    sampled = GenerationConfig(do_sample=True, temperature=0.8, top_k=40,
                               top_p=0.95)

    def serve(model):
        eng = ContinuousBatchingEngine(model, max_batch=2, page_size=8,
                                       max_len=64, decode_block=4,
                                       async_depth=2)
        rids = [eng.submit(p, max_new_tokens=10,
                           generation_config=sampled if i % 2 else None)
                for i, p in enumerate(prompts)]
        out = eng.run()
        return [out[r] for r in rids]
    want = serve(cpu)
    _build.reset_launches()
    got = serve(card)
    assert all(_build.LAUNCHES[k] > 0 for k in SERVING_KERNELS), \
        _build.LAUNCHES
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_dense_decode_route_on_card_matches_plain(dev, dtype, quant):
    """The dense decode route (gather + fp32 SDPA) on the card against
    the paged kernel's plain version: B = 3 rows of a non-contiguous
    table, one at position 0, over native or int8 pools."""
    g = torch.Generator().manual_seed(5)
    B, H, H_kv, D, P, page = 3, 32, 8, 128, 20, 16
    q = torch.randn(B, H, D, generator=g)
    kp, vp = (torch.randn(H_kv, P, page, D, generator=g) for _ in range(2))
    sc = {}
    if quant:
        sc = {"k_scales": torch.rand(P, generator=g) / 100,
              "v_scales": torch.rand(P, generator=g) / 100}
        kp, vp = ((t * 40).round().clamp(-127, 127).to(torch.int8)
                  for t in (kp, vp))
    tables = torch.tensor([[3, 7, 1, 19], [4, 0, 9, 2], [5, 6, 8, 11]],
                          dtype=torch.int32)
    lens = torch.tensor([0, 37, 63])
    dt = getattr(torch, dtype)
    q = q.to(dt)
    if not quant:
        kp, vp = kp.to(dt), vp.to(dt)
    want = attn_ops.paged_decode_plain(q, kp, vp, tables, lens, **sc)
    on = {k: v.to(dev) for k, v in sc.items()}
    got = attn_ops.paged_decode_dense(q.to(dev), kp.to(dev), vp.to(dev),
                                      tables.to(dev), lens.to(dev), **on)
    _close(got.cpu().float(), want.float(), dtype)


@pytest.mark.parametrize("quant", [False, True])
def test_page_handoff_between_card_engines_is_bit_exact(dev, quant):
    """serialize_pages on one card engine, adopt_pages on another (through
    the wire form as well): the adopter's export of the same run is the
    exporter's bit for bit (kv, scales, sha256; bf16 pages cross the
    wire as raw bytes), and the adopted pages serve the prompt with a
    prefix hit."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    from paddle_tpu_torch.serving_fabric import (payload_from_wire,
                                                 payload_to_wire)
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2, dtype="bfloat16")
    model = LlamaForCausalLM(cfg, device=dev)
    if quant:
        model = quantize_model(model, kv_dtype="int8")
    rs = np.random.RandomState(3)
    prompt = rs.randint(0, cfg.vocab_size, (3 * 8 + 5,))

    def engine():
        return ContinuousBatchingEngine(
            model, max_batch=2, page_size=8, max_len=64, prefix_cache=True,
            generation_config=GenerationConfig(max_new_tokens=4))
    a, b = engine(), engine()
    rid = a.submit(prompt)
    ref = a.run()[rid]
    pay = a.serialize_pages(prompt)
    assert pay["kv"].dtype == (torch.int8 if quant else torch.bfloat16)
    assert len(b.adopt_pages(payload_from_wire(payload_to_wire(pay)))) == 3
    back = b.serialize_pages(prompt)
    assert back["sha256"] == pay["sha256"]
    assert torch.equal(back["kv"], pay["kv"])
    if quant:
        assert torch.equal(back["scales"], pay["scales"])
    b._check_page_invariants()
    rid = b.submit(prompt)
    assert len(b.run()[rid]) == len(ref)
    assert b.prefix_hit_tokens == 3 * 8


def test_crossover_routes_on_card(dev):
    """Above the crossover a CUDA engine launches the paged kernel, at or
    below it the dense route launches none; the tokens agree."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2)
    model = LlamaForCausalLM(cfg, device=dev)
    rs = np.random.RandomState(4)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)) for n in (5, 13)]

    def serve(crossover):
        eng = ContinuousBatchingEngine(
            model, max_batch=2, page_size=8, max_len=64, decode_block=2,
            attn_crossover=crossover,
            generation_config=GenerationConfig(max_new_tokens=6))
        rids = [eng.submit(p) for p in prompts]
        _build.reset_launches()
        out = eng.run()
        return [out[r] for r in rids], dict(_build.LAUNCHES), eng
    paged, launches, eng = serve(0)
    assert launches["paged_decode"] > 0
    assert eng.attn_path_ticks["paged"] > 0 == eng.attn_path_ticks["dense"]
    dense, launches, eng = serve(64)
    assert launches["paged_decode"] == 0
    assert eng.attn_path_ticks["dense"] > 0 == eng.attn_path_ticks["paged"]
    for a, b in zip(paged, dense):
        np.testing.assert_array_equal(a, b)


def _replay_drafts(streams, H, device):
    """A draft provider that proposes the continuation of whichever of
    ``streams`` (prompt, tokens) a row's history starts with: drafts the
    engine accepts, until the stream ends (then the row's last token)."""
    from paddle_tpu_torch.inference import DraftProvider
    seqs = np.full((len(streams), H), -1, np.int64)
    for i, (p, t) in enumerate(streams):
        full = np.concatenate([p, t])[:H]
        seqs[i, :len(full)] = full
    seqs = torch.tensor(seqs, device=device)
    plen = torch.tensor([len(p) for p, _ in streams], device=device)
    in_prompt = torch.arange(H, device=device)[None] < plen[:, None]

    class Replay(DraftProvider):
        def propose(self, history, hist_len, k):
            hist_len = hist_len.long()
            match = (((history[:, None] == seqs[None]) | ~in_prompt[None])
                     .all(-1) & (plen[None] <= hist_len[:, None]))
            seq = seqs[match.long().argmax(1)]
            idx = hist_len[:, None] + torch.arange(k, device=device)[None]
            toks = seq.gather(1, idx.clamp_max(H - 1))
            last = history.gather(1, (hist_len - 1).clamp(0, H - 1)[:, None])
            ok = match.any(1)[:, None] & (idx < H) & (toks >= 0)
            return torch.where(ok, toks, last)
    return Replay()


@pytest.mark.parametrize("quant", [False, True])
def test_engine_features_on_card_match_cpu(dev, quant):
    """Chunked prefill, the prefix cache (a resubmitted prompt takes the
    copy-on-write path) and spec_k = 3 together, at async depth 2: the
    same seeded model (and its int8 twin) on the card and on the CPU give
    the same greedy streams and the same prefix and speculation counts,
    with n-gram drafts and with drafts that replay the CPU's streams (so
    accepted runs commit on the card, eos ending one inside such a run);
    two verify ticks (greedy and sampled) and a prefill chunk then run
    under set_sync_debug_mode("error") without syncing the host."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2)          # head_dim 64
    cpu = LlamaForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    if quant:
        cpu = quantize_model(cpu, kv_dtype="int8")
    card = copy.deepcopy(cpu).to(dev)
    rs = np.random.RandomState(1)
    shared = rs.randint(0, cfg.vocab_size, (19,))
    prompts = [np.concatenate([shared, rs.randint(0, cfg.vocab_size, (n,))])
               for n in (3, 9, 14)] + [rs.randint(0, cfg.vocab_size, (7,))]

    def serve(model, drafts=None, eos=None):
        eng = ContinuousBatchingEngine(
            model, max_batch=2, page_size=8, max_len=64, async_depth=2,
            generation_config=GenerationConfig(max_new_tokens=10,
                                               eos_token_id=eos),
            chunked_prefill=True, prefill_chunk=16, prefix_cache=True,
            spec_k=3, draft_provider=drafts)
        out = []
        for batch in (prompts, prompts[:2]):
            rids = [eng.submit(p) for p in batch]
            got = eng.run()
            out.extend(got[r].tolist() for r in rids)
        eng._check_page_invariants()
        return out, eng
    want, ecpu = serve(cpu)
    got, eng = serve(card)
    assert got == want
    assert eng.prefix_stats() == ecpu.prefix_stats()
    assert eng.spec_stats() == ecpu.spec_stats()
    assert eng.prefix_cow_copies >= 1
    eos = want[0][4]
    want_eos = [w[:w.index(eos) + 1] if eos in w else w for w in want]
    side = {}
    for name, model, d in (("cpu", cpu, "cpu"), ("card", card, dev)):
        side[name] = serve(model, _replay_drafts(list(zip(prompts, want)),
                                                 64, d), eos)
    assert side["card"][0] == side["cpu"][0] == want_eos
    assert side["card"][1].spec_stats() == side["cpu"][1].spec_stats()
    assert side["card"][1].spec_tokens_accepted > 0
    with torch.inference_mode():
        eng.submit(prompts[3])
        eng._admit()
        while not eng._decode_ready(eng._slots[0]):
            eng._prefill_tick()
        eng._tables_dev = eng._to_device(eng.tables)
        ids = eng._to_device(np.zeros((1, 16), np.int64))
        tables1 = eng._to_device(eng.tables[:1])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            eng._spec_tick(False)
            eng._spec_tick(True)
            eng._chunk_step(ids, 16, tables1, 16)
        finally:
            torch.cuda.set_sync_debug_mode(0)


@pytest.mark.parametrize("T", [1, 3, 5])
def test_kv_scatter_tokens_rows_on_card_match_cpu(dev, T):
    """The int8 token write with [b, T] pages and offsets (a verify's
    tokens, several in one page, rows on the garbage page) gives the
    CPU's codes and scales bit for bit."""
    from paddle_tpu_torch.models.llama import _kv_scatter_tokens
    rs = np.random.RandomState(T)
    b, H_kv, P, page, D = 8, 8, 20, 16, 128
    pools = (rs.randint(-127, 128, (H_kv, P, page, D)).astype(np.int8),
             rs.randint(-127, 128, (H_kv, P, page, D)).astype(np.int8),
             rs.uniform(0.01, 0.05, (P,)).astype(np.float32),
             rs.uniform(0.01, 0.05, (P,)).astype(np.float32))
    pos = rs.randint(0, 3 * page, (b,))[:, None] + np.arange(T)[None, :]
    phys = np.where(pos < 2 * page, 1 + 2 * np.arange(b)[:, None]
                    + pos // page, 0)                 # two pages a row
    k = rs.normal(0, 3, (H_kv, b, T, D)).astype(np.float32)
    v = rs.normal(0, 3, (H_kv, b, T, D)).astype(np.float32)
    out = []
    for d in ("cpu", dev):
        got = _kv_scatter_tokens(
            tuple(torch.tensor(a, device=d) for a in pools),
            torch.tensor(phys, device=d), torch.tensor(pos % page, device=d),
            torch.tensor(k, device=d), torch.tensor(v, device=d))
        out.append([t.cpu() for t in got])
    for c, g in zip(*out):
        if c.dim() == 4:                 # the garbage page's codes: any
            c, g = c[:, 1:], g[:, 1:]    # of the writes to a slot may stay
        assert torch.equal(c, g)


def test_int8_scales_on_card_equal_cpu(dev):
    """The int8 page write and weight quantization divide absmax by 127
    as the CPU (and JAX) do, so their scales and codes on the card are
    the CPU's bit for bit."""
    from paddle_tpu_torch.models.llama import _kv_scatter_pages
    from paddle_tpu_torch.nn.quantized_linear import weight_quantize
    rs = np.random.RandomState(5)
    w = rs.normal(0, 0.02, (1040, 272)).astype(np.float32)
    tiles = rs.normal(0, 3, (2, 8, 4, 16, 128)).astype(np.float32)
    phys = np.array([3, 1, 7, 5])
    out = []
    for d in ("cpu", dev):
        pools = (torch.zeros((8, 9, 16, 128), dtype=torch.int8, device=d),
                 torch.zeros((8, 9, 16, 128), dtype=torch.int8, device=d),
                 torch.zeros((9,), device=d), torch.zeros((9,), device=d))
        got = _kv_scatter_pages(pools, torch.tensor(phys, device=d),
                                torch.tensor(tiles[0], device=d),
                                torch.tensor(tiles[1], device=d))
        got += weight_quantize(torch.tensor(w, device=d))
        out.append([t.cpu() for t in got])
    for c, g in zip(*out):
        assert torch.equal(c, g)


@pytest.mark.parametrize("n,k", [(6144, 4096), (4096, 14336)])
def test_int8_matmul_at_verify_rows_matches_plain(dev, n, k):
    """m = 40, a speculative verify at B = 8, spec_k = 4, at Llama-3-8B's
    qkv and down widths: the bf16 wgmma route, elementwise and per row."""
    from paddle_tpu_torch.ops.kernels import int8_matmul
    from paddle_tpu_torch.ops.quant import weight_only_plain
    x, wq, scale = _int8_product_inputs(dev, torch.bfloat16, 40, n, k,
                                        n + k)
    _build.reset_launches()
    got = int8_matmul.int8_matmul(x, wq, scale)
    assert _build.LAUNCHES["int8_matmul_wgmma"] == 1, dict(_build.LAUNCHES)
    want = weight_only_plain(x, wq, scale)
    _close(got, want, "bfloat16")
    _rows_close(got, want, "bfloat16")


# (N, H, V, tied, backward chunk): V not a multiple of the 128-column
# tile, rows not a multiple of the row tile, several backward chunks
# (first, middle and last summed into dh), a V that is not a multiple of
# 8 (element-wise operand loads; the bf16 backward pads W) and a tied
# head's transposed W. The bf16 backward's 128 x 256 tiles reach their
# edges in ragged_rows (N = 300), h320 (H = 320: dh's second column tile
# and dW's third row tile are partly empty), narrow_last_chunk (a last
# chunk of 40 columns, under one 64-deep k-slice of dh) and
# odd_v_narrow_chunk (V = 777: padded W, a last chunk of 9 columns).
CE_CASES = {
    "padded_v_one_chunk": (70, 256, 1000, False, 8192),
    "four_chunks": (130, 128, 1000, False, 256),
    "odd_v": (40, 64, 1001, False, 512),
    "tied_two_chunks": (64, 128, 512, True, 256),
    "ragged_rows": (300, 256, 1024, False, 512),
    "h320": (128, 320, 768, False, 256),
    "narrow_last_chunk": (96, 128, 552, False, 256),
    "odd_v_narrow_chunk": (96, 128, 777, False, 256),
}


def _ce_inputs(dev, dt, n, hd, v, tied):
    g = torch.Generator(device=dev).manual_seed(n * 31 + v)
    h = torch.randn((n, hd), generator=g, device=dev).to(dt)
    w = 0.3 * torch.randn((v, hd) if tied else (hd, v), generator=g,
                          device=dev)
    w = (w.t() if tied else w).to(dt)
    labels = torch.randint(0, v, (n,), generator=g, device=dev).to(
        torch.int32)
    labels[::7] = -1                         # ignored rows
    labels[1] = v - 1                        # in the padded last tile
    g_lse = torch.randn((n,), generator=g, device=dev)
    g_tgt = torch.randn((n,), generator=g, device=dev)
    return h, w, labels, g_lse, g_tgt


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_vocab_ce_kernels_match_plain(dev, dtype, case, monkeypatch):
    """vocab_ce_fwd (lse, tgt) and vocab_ce_bwd (the dlog, dh and dW
    kernels over the chunks) against the plain versions."""
    n, hd, v, tied, chunk = CE_CASES[case]
    monkeypatch.setattr(fused_vocab_ce, "CHUNK", chunk)
    dt = getattr(torch, dtype)
    h, w, labels, g_lse, g_tgt = _ce_inputs(dev, dt, n, hd, v, tied)
    wc = w.contiguous()
    lse, tgt = fused_vocab_ce.vocab_ce_fwd(h, wc, labels)
    want_lse, want_tgt = vocab_ce._fwd_plain(h, w, labels)
    tol = 1e-5 if dtype == "float32" else 1e-4
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    torch.testing.assert_close(tgt, want_tgt, rtol=tol, atol=tol)
    assert not tgt[::7].any()
    _build.reset_launches()
    dh, dw = fused_vocab_ce.vocab_ce_bwd(h, wc, labels, want_lse, g_lse,
                                         g_tgt)
    chunks = -(-v // min(chunk, v))
    for name in ("vocab_ce_dlog", "vocab_ce_dh", "vocab_ce_dw"):
        assert _build.LAUNCHES[name] == chunks, _build.LAUNCHES
    want_dh, want_dw = vocab_ce._bwd_plain(h, w, labels, want_lse, g_lse,
                                           g_tgt)
    assert dh.dtype == dw.dtype == dt
    _close(dh, want_dh, dtype)
    _close(dw, want_dw, dtype)
    _rows_close(dh, want_dh, dtype)
    _rows_close(dw.t(), want_dw.t(), dtype)


def test_bf16_vocab_ce_bwd_is_deterministic(dev, monkeypatch):
    """Two bf16 backward runs over three chunks give bit-identical dh
    and dW: each output tile is summed by one block in a fixed order, dh
    across chunks in chunk order, with no atomics."""
    monkeypatch.setattr(fused_vocab_ce, "CHUNK", 256)
    h, w, labels, g_lse, g_tgt = _ce_inputs(dev, torch.bfloat16, 300, 320,
                                            700, False)
    lse, _ = vocab_ce._fwd_plain(h, w, labels)
    runs = [fused_vocab_ce.vocab_ce_bwd(h, w, labels, lse, g_lse, g_tgt)
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,hd,v", [(300, 128, 1000), (77, 64, 777),
                                    (129, 320, 2304)])
def test_vocab_ce_fwd_kernel_edges_and_determinism(dev, dtype, n, hd, v):
    """The forward alone at a ragged N, at a V that is not a multiple of
    the 256-column tile (777: nor of 8, so bf16 reads a padded W), with
    labels outside [0, V) (-1, V, inside the last tile past V, far past
    it), against the plain version (fp32 1e-5, bf16 1e-4), counted on
    its route, the same bit for bit on a second run; bf16 refuses an H
    that is not a multiple of 8."""
    dt = getattr(torch, dtype)
    h, w, labels, _, _ = _ce_inputs(dev, dt, n, hd, v, False)
    labels[2], labels[3], labels[4] = v, v + 3, 2 ** 30
    _build.reset_launches()
    lse, tgt = fused_vocab_ce.vocab_ce_fwd(h, w, labels)
    route = fused_vocab_ce.route(dt)
    assert _build.LAUNCHES["vocab_ce_fwd"] == 1
    assert _build.LAUNCHES[f"vocab_ce_fwd_{route}"] == 1
    want_lse, want_tgt = vocab_ce._fwd_plain(h, w, labels)
    tol = 1e-5 if dtype == "float32" else 1e-4
    torch.testing.assert_close(lse, want_lse, rtol=tol, atol=tol)
    torch.testing.assert_close(tgt, want_tgt, rtol=tol, atol=tol)
    assert not tgt[::7].any() and not tgt[2:5].any()
    lse2, tgt2 = fused_vocab_ce.vocab_ce_fwd(h, w, labels)
    assert torch.equal(lse, lse2) and torch.equal(tgt, tgt2)
    if dtype == "bfloat16":
        with pytest.raises(ValueError, match="H=60"):
            fused_vocab_ce.vocab_ce_fwd(h[:, :60].contiguous(),
                                        w[:60].contiguous(), labels)


def test_bf16_vocab_ce_wrappers_refuse_what_tma_cannot_read(dev):
    """The bf16 backward kernels raise (no fallback) on an H that is not
    a multiple of 8, on a W or workspace row that is not, and on a base
    that is not 16-byte aligned; vocab_ce_bwd pads W itself."""
    bf = torch.bfloat16
    h, w, labels, g_lse, g_tgt = _ce_inputs(dev, bf, 16, 64, 1001, False)
    lse, _ = vocab_ce._fwd_plain(h, w, labels)
    ws = torch.empty((16, 512), dtype=bf, device=dev)
    with pytest.raises(ValueError, match="V=1001"):
        fused_vocab_ce.vocab_ce_dlog(h, w, labels, lse, g_lse, g_tgt, 0, 512,
                                     ws)
    h2, w2, labels2, gl2, gt2 = _ce_inputs(dev, bf, 16, 60, 512, False)
    lse2, _ = vocab_ce._fwd_plain(h2, w2, labels2)
    with pytest.raises(ValueError, match="H=60"):
        fused_vocab_ce.vocab_ce_bwd(h2, w2, labels2, lse2, gl2, gt2)
    wp = fused_vocab_ce._pad_vocab(w)
    hs = torch.empty((16 * 64 + 1,), dtype=bf, device=dev)[1:].view(16, 64)
    hs.copy_(h)
    with pytest.raises(ValueError, match="a base at"):
        fused_vocab_ce.vocab_ce_dlog(hs, wp, labels, lse, g_lse, g_tgt, 0,
                                     512, ws)
    _build.reset_launches()
    dh, dw = fused_vocab_ce.vocab_ce_bwd(h, w, labels, lse, g_lse, g_tgt)
    assert _build.LAUNCHES["vocab_ce_dw"] == 1 and dw.shape == w.shape


@pytest.mark.parametrize("tied", [False, True])
def test_fused_head_gradients_reach_head_and_hidden(dev, tied):
    """The fused head of a tiny Llama on the card: its autograd Function
    launches the forward kernel once and the backward kernels once a
    chunk, and the loss and every gradient (lm_head, or the tied
    embedding) equal the same model's on the CPU within 1e-4."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    cfg = LlamaConfig.tiny(tie_word_embeddings=tied)
    rs = np.random.RandomState(3)
    ids = rs.randint(0, cfg.vocab_size, (2, 33))
    labels = ids[:, 1:].copy()
    labels[0, :4] = -100
    side = []
    for device in ("cpu", dev):
        m = LlamaForCausalLM(cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
        m = m.to(device)
        _build.reset_launches()
        loss = m(torch.tensor(ids[:, :-1], device=device),
                 labels=torch.tensor(labels, device=device),
                 return_logits=False)
        loss.backward()
        side.append((float(loss.detach()), {
            n: p.grad.float().cpu() for n, p in m.named_parameters()}))
    counts = dict(_build.LAUNCHES)
    assert counts["vocab_ce_fwd"] == 1, counts
    for name in ("vocab_ce_dlog", "vocab_ce_dh", "vocab_ce_dw"):
        assert counts[name] == 1, counts           # vocab 512: one chunk
    (lp, gp), (lc, gc) = side
    np.testing.assert_allclose(lc, lp, rtol=1e-4)
    head = "model.embed_tokens" if tied else "lm_head"
    assert gc[head].abs().max() > 0
    for n in gp:
        torch.testing.assert_close(gc[n], gp[n], rtol=1e-4, atol=1e-4)


def test_default_head_training_on_card_matches_cpu(dev):
    """The default configuration (fused head): three AdamW steps of a
    seeded tiny Llama in fp32, and one bf16 forward and backward, on the
    card and on the CPU (losses 1e-4 and, bf16, 1e-2; bf16 gradients 3e-2
    in relative Frobenius norm)."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer
    rs = np.random.RandomState(4)
    ids = rs.randint(0, 512, (2, 129))
    seg = np.zeros((2, 128), np.int32)
    seg[0, 50:] = 1
    for dtype in ("float32", "bfloat16"):
        cfg = LlamaConfig.tiny(dtype=dtype)
        assert cfg.loss_impl == "fused"
        side = []
        for device in ("cpu", dev):
            m = LlamaForCausalLM(cfg, device="cpu",
                                 generator=torch.Generator().manual_seed(0))
            m = m.to(device)
            batch = {"input_ids": torch.tensor(ids[:, :-1], device=device),
                     "labels": torch.tensor(ids[:, 1:], device=device),
                     "segment_ids": torch.tensor(seg, device=device)}
            if dtype == "float32":
                tr = Trainer(m, AdamW(learning_rate=1e-3, parameters=m,
                                      grad_clip=ClipGradByGlobalNorm(1.0)))
                side.append([float(tr.train_step(batch)) for _ in range(3)])
                continue
            loss = m(**batch, return_logits=False)
            loss.backward()
            side.append((float(loss.detach()), {
                n: p.grad.float().cpu() for n, p in m.named_parameters()}))
        if dtype == "float32":
            np.testing.assert_allclose(side[1], side[0], rtol=1e-4,
                                       atol=1e-4)
            continue
        (lp, gp), (lc, gc) = side
        np.testing.assert_allclose(lc, lp, rtol=1e-2)
        for n in gp:
            err = float((gc[n] - gp[n]).norm()
                        / gp[n].norm().clamp_min(1e-30))
            assert err <= 3e-2, (n, err)


@pytest.mark.parametrize("recompute", ["full", "selective"])
def test_recompute_on_card_gives_the_same_gradients(dev, recompute):
    """fp32 gradients of a tiny Llama with activation recompute equal
    those without it on the card, within 1e-6 of each tensor's largest
    value (the kernels are deterministic, so they are expected equal)."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    rs = np.random.RandomState(5)
    ids = torch.tensor(rs.randint(0, 512, (2, 65)), device=dev)
    grads = []
    for rc in ("none", recompute):
        m = LlamaForCausalLM(LlamaConfig.tiny(recompute=rc), device="cpu",
                             generator=torch.Generator().manual_seed(0))
        m = m.to(dev)
        m(ids[:, :-1], labels=ids[:, 1:], return_logits=False).backward()
        grads.append({n: p.grad for n, p in m.named_parameters()})
    for n, g in grads[0].items():
        assert float((grads[1][n] - g).abs().max()) <= \
            1e-6 * float(g.abs().max()), n


# -- quantized serving: the int8 matrix product and int8 paged decode -------

def _int8_product_inputs(dev, dt, m, n, k, seed):
    from paddle_tpu_torch.nn.quantized_linear import weight_quantize
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=g, device=dev).to(dt)
    wq, scale = weight_quantize(0.02 * torch.randn((k, n), generator=g,
                                                   device=dev))
    return x, wq, scale


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("m", [1, 5, 8, 100])
@pytest.mark.parametrize("n,k", [(48, 80), (272, 1040)])
def test_int8_matmul_kernel_matches_plain(dev, dtype, m, n, k):
    """Both bf16 routes (m <= 16 and m > 16) and the fp32 route, with m
    ragged against every tile, n not a multiple of the 64-channel decode
    tile and k not a multiple of a step; bf16 also per row."""
    from paddle_tpu_torch.ops.kernels import int8_matmul
    from paddle_tpu_torch.ops.quant import weight_only_plain
    x, wq, scale = _int8_product_inputs(dev, getattr(torch, dtype), m, n, k,
                                        m * n + k)
    _build.reset_launches()
    got = int8_matmul.int8_matmul(x, wq, scale)
    assert _build.LAUNCHES["int8_matmul"] == 1
    want = weight_only_plain(x, wq, scale)
    _close(got, want, dtype)
    _rows_close(got, want, dtype)


@pytest.mark.parametrize("m", [17, 100, 129, 300, 1024])
@pytest.mark.parametrize("n", [48, 272])
def test_int8_matmul_wgmma_route_matches_plain(dev, m, n):
    """The bf16 m > 16 route (TMA + register-A wgmma) at each of its token
    tiles (64, 128, 256) and ragged against them, n not a multiple of the
    128-channel tile, k = 1040 not a multiple of the 64-deep slice; per
    row as well."""
    from paddle_tpu_torch.ops.kernels import int8_matmul
    from paddle_tpu_torch.ops.quant import weight_only_plain
    x, wq, scale = _int8_product_inputs(dev, torch.bfloat16, m, n, 1040,
                                        m + n)
    _build.reset_launches()
    got = int8_matmul.int8_matmul(x, wq, scale)
    assert _build.LAUNCHES["int8_matmul_wgmma"] == 1, dict(_build.LAUNCHES)
    want = weight_only_plain(x, wq, scale)
    _close(got, want, "bfloat16")
    _rows_close(got, want, "bfloat16")


@pytest.mark.parametrize("m", [1, 5, 8, 16])
@pytest.mark.parametrize("n,k", [(272, 1040), (4096, 14336), (6144, 4096)])
def test_int8_decode_route_matches_plain(dev, m, n, k):
    """The bf16 m <= 16 route (split over k): n = 272 leaves the last
    64-channel tile one live warp, k = 1040 is not a multiple of the
    64-deep step and splits unevenly, k = 14336 is down's; one launch,
    elementwise and per row."""
    from paddle_tpu_torch.ops.kernels import int8_matmul
    from paddle_tpu_torch.ops.quant import weight_only_plain
    x, wq, scale = _int8_product_inputs(dev, torch.bfloat16, m, n, k,
                                        3 * m + n + k)
    _build.reset_launches()
    got = int8_matmul.int8_matmul(x, wq, scale)
    assert _build.LAUNCHES["int8_matmul_decode"] == 1, dict(_build.LAUNCHES)
    assert _build.LAUNCHES["int8_matmul"] == 1
    want = weight_only_plain(x, wq, scale)
    _close(got, want, "bfloat16")
    _rows_close(got, want, "bfloat16")


@pytest.mark.parametrize("m", [8, 16])
def test_int8_decode_route_is_deterministic_and_never_syncs(dev, m):
    """At down's shape (5 splits at m = 8 and 7 at m = 16 on a 132-SM
    card) a call under set_sync_debug_mode("error") does not sync the
    host, and two runs give the same output bit for bit: the splits add
    in split order."""
    from paddle_tpu_torch.ops.kernels import int8_matmul
    from paddle_tpu_torch.ops.quant import weight_only_plain
    x, wq, scale = _int8_product_inputs(dev, torch.bfloat16, m, 4096,
                                        14336, 5)
    first = int8_matmul.int8_matmul(x, wq, scale)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = int8_matmul.int8_matmul(x, wq, scale)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(first, again)
    _close(again, weight_only_plain(x, wq, scale), "bfloat16")


@pytest.mark.parametrize("blocks_per_sm", [0, 1, 8])
def test_int8_decode_split_plans_back_to_back(dev, blocks_per_sm,
                                              monkeypatch):
    """Shapes whose plans differ (one split; a few; many, uneven), at
    three plan targets, launched back to back on one stream before any
    check: each agrees with the plain version, and the tickets are all
    zero afterwards (every tile's last split reset its own)."""
    from paddle_tpu_torch.ops.kernels import int8_matmul
    from paddle_tpu_torch.ops.quant import weight_only_plain
    monkeypatch.setattr(int8_matmul, "BLOCKS_PER_SM", blocks_per_sm)
    cases = [(8, 4096, 4096), (3, 272, 1040), (16, 1024, 14336),
             (1, 6144, 4096), (12, 160, 2064)]
    ins = [_int8_product_inputs(dev, torch.bfloat16, m, n, k, i)
           for i, (m, n, k) in enumerate(cases)]
    sms = _build.sm_count(dev)
    plans = {int8_matmul.split_plan(m, n, k, sms) for m, n, k in cases}
    assert len(plans) >= 3, plans
    outs = [int8_matmul.int8_matmul(*a) for a in ins]
    outs += [int8_matmul.int8_matmul(*a) for a in ins]
    torch.cuda.synchronize()
    for i, a in enumerate(ins):
        want = weight_only_plain(*a)
        _close(outs[i], want, "bfloat16")
        _rows_close(outs[i], want, "bfloat16")
        assert torch.equal(outs[i], outs[i + len(ins)])
    tickets = _build.tickets(dev, _build.stream_ptr(dev), 1)
    assert int(tickets.abs().sum()) == 0


def test_int8_matmul_wrapper_refuses_what_it_does_not_take(dev):
    from paddle_tpu_torch.ops.kernels import int8_matmul
    x, wq, scale = _int8_product_inputs(dev, torch.bfloat16, 4, 64, 64, 1)
    with pytest.raises(TypeError):                       # fp16 x
        int8_matmul.int8_matmul(x.half(), wq, scale)
    with pytest.raises(ValueError, match="int8"):
        int8_matmul.int8_matmul(x, wq.to(torch.int16), scale)
    with pytest.raises(ValueError, match="contiguous"):
        int8_matmul.int8_matmul(x.t().contiguous().t(), wq, scale)
    with pytest.raises(ValueError, match="multiples of 16"):
        int8_matmul.int8_matmul(x[:, :40].contiguous(),
                                wq[:, :40].contiguous(), scale)
    with pytest.raises(ValueError, match="multiples of 16"):
        int8_matmul.int8_matmul(x, wq[:40].contiguous(), scale[:40])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("H,H_kv,D,page", [(8, 4, 128, 8), (8, 8, 64, 16),
                                           (16, 4, 128, 128),
                                           (16, 2, 256, 8), (6, 2, 32, 8),
                                           (10, 2, 64, 24),
                                           (14, 2, 128, 16), (8, 1, 32, 24),
                                           (12, 2, 256, 128)])
def test_paged_decode_int8_kernel_matches_plain(dev, dtype, H, H_kv, D,
                                                page):
    """Int8 pools with per-page scales of varied magnitude and a page
    never written (scale 0): groups 1-8 (3, 5, 7 among them), every head
    dim, pages that a warp's chunk spans (page 8) or splits (page 128),
    lengths at the first token, at and across a page edge and a split
    edge and at the full table; bf16 also per row."""
    dt = getattr(torch, dtype)
    rs = np.random.RandomState(H + D + page)
    B, mp = 6, 4
    num_pages = B * mp + 1
    q = torch.tensor(rs.normal(0, 1, (B, H, D)), device=dev).to(dt)
    pools = []
    for _ in range(2):
        f = rs.normal(0, 1, (H_kv, num_pages, page, D)) * rs.uniform(
            0.25, 4.0, (1, num_pages, 1, 1))
        s = np.abs(f).max(axis=(0, 2, 3)) / 127.0
        codes = np.clip(np.round(f / s[None, :, None, None]), -127, 127)
        s[3] = 0.0                                      # never written
        pools.append((torch.tensor(codes, device=dev).to(torch.int8),
                      torch.tensor(s, device=dev).float()))
    (kp, ks), (vp, vs) = pools
    tables = rs.permutation(num_pages)[:B * mp].reshape(B, mp)
    tables[3, 0] = 3
    lens = _paged_lens(H, H_kv, page, B, mp)
    for i in range(B):
        tables[i, lens[i] // page + 1:] = -1
    args = (q, kp, vp, torch.tensor(tables.astype(np.int32), device=dev),
            torch.tensor(lens, device=dev))
    _build.reset_launches()
    got = paged_attention.paged_decode(*args, k_scales=ks, v_scales=vs)
    assert _build.LAUNCHES["paged_decode_int8"] == 1
    assert _build.LAUNCHES["paged_decode"] == 0
    want = attn_ops.paged_decode_plain(*args, k_scales=ks, v_scales=vs)
    _close(got, want, dtype)
    _rows_close(got, want, dtype)
    with pytest.raises(ValueError, match="int8"):
        paged_attention.paged_decode(*args)             # int8, no scales
    with pytest.raises(ValueError, match="float32"):
        paged_attention.paged_decode(*args, k_scales=ks.double(),
                                     v_scales=vs)


def test_quantized_decode_routes_through_both_kernels(dev):
    """The same int8-weight, int8-KV tiny Llama on the card (kernels) and
    on the CPU (plain versions): a prefill and four teacher-forced decode
    steps give logits within 2e-3 of their largest magnitude (fp32 in
    other summation orders, 1e-6, plus the K/V codes that land on the
    other side of a rounding boundary: each moves one element by one
    quantization step and a logit by about 2e-4 of the largest here;
    a wrong page, block or scale moves them by 1e-1 or more), and one
    decode step launches int8_matmul 4 x layers + 1 times and
    paged_decode_int8 once a layer."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    cfg = LlamaConfig.tiny(hidden_size=256, num_attention_heads=4,
                           num_key_value_heads=2)          # head_dim 64
    native = LlamaForCausalLM(cfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    cpu = quantize_model(native, kv_dtype="int8")
    card = copy.deepcopy(cpu).to(dev)
    ids = np.random.RandomState(3).randint(0, cfg.vocab_size, (14,))
    L = 10
    logits = []
    with torch.inference_mode():
        for m in (cpu, card):
            d = m.lm_head.device
            pools, tables = m.model.alloc_paged_caches(1, 32, 8)
            h, _ = m.model.prefill_paged(torch.tensor(ids[None, :L],
                                                      device=d),
                                         pools, tables)
            out = [m.logits(h[0, -1])]
            for i in range(L, len(ids)):
                _build.reset_launches()
                h, _ = m.model.decode_step_paged(
                    torch.tensor(ids[i:i + 1], device=d),
                    torch.tensor([i], device=d), pools, tables)
                out.append(m.logits(h[:, 0])[0])
            logits.append(torch.stack(out).float().cpu())
    counts = dict(_build.LAUNCHES)
    assert counts["int8_matmul"] == 4 * cfg.num_hidden_layers + 1, counts
    assert counts["paged_decode_int8"] == cfg.num_hidden_layers, counts
    assert counts["paged_decode"] == 0, counts
    want, got = logits
    assert float((got - want).abs().max()) <= 2e-3 * float(
        want.abs().max()), float((got - want).abs().max())


# -- MoE: the grouped matmul and the dropless layer -------------------------

# (group sizes, m, k, n): an empty group, groups smaller than a tile and
# larger than one, rows past the groups (m above their sum), widths that
# are not multiples of 8 (element-wise tile loads)
GMM_CASES = {
    "ragged": ([37, 0, 5, 300, 1], 343, 96, 80),
    "balanced": ([128, 128, 128, 128], 512, 256, 512),
    "one_group": ([0, 0, 200, 0], 200, 64, 48),
    "rows_past_the_groups": ([10, 20, 0, 30], 100, 48, 40),
    "odd_widths": ([7, 9, 3], 19, 20, 36),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", sorted(GMM_CASES))
def test_grouped_matmul_kernels_match_plain(dev, dtype, case):
    """The forward (fp32 out), dx (the forward kernel reading the weight
    transposed, out in the operands' type) and dW against the plain
    versions; an empty group's dW and rows past the groups are 0. fp32
    dW sums up to 300 rows in another order: its rounding error scales
    with the summands, not with the (often cancelling) result, so it is
    held to 1e-5 of its largest magnitude, as the RMSNorm backward's
    dw."""
    from paddle_tpu_torch.ops import grouped_matmul as gmm
    from paddle_tpu_torch.ops.kernels import grouped_matmul as kgm
    counts, m, k, n = GMM_CASES[case]
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(m * k + n)
    xs = torch.randn((m, k), generator=g, device=dev).to(dt)
    w = (0.1 * torch.randn((len(counts), k, n), generator=g,
                           device=dev)).to(dt)
    gy = torch.randn((m, n), generator=g, device=dev).to(dt)
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    ends = kgm.group_ends(gs)
    _build.reset_launches()
    y = kgm.grouped_matmul(xs, w, ends)
    dx = kgm.grouped_matmul(gy, w, ends, out_dtype=dt, transpose_w=True)
    dw = kgm.grouped_matmul_dw(xs, gy, ends, out_dtype=dt)
    assert _build.LAUNCHES["grouped_matmul"] == 2
    assert _build.LAUNCHES["grouped_matmul_dw"] == 1
    assert y.dtype == torch.float32 and dx.dtype == dw.dtype == dt
    for got, want in (
            (y, gmm.grouped_matmul_plain(xs, w, gs)),
            (dx, gmm.grouped_matmul_plain(gy, w.transpose(1, 2),
                                          gs).to(dt)),
            (dw, gmm.grouped_matmul_dw_plain(xs, gy, gs).to(dt))):
        if got is dw and dtype == "float32":
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max())
        else:
            _close(got, want, dtype)
        _rows_close(got, want, dtype)
    used = sum(counts)
    assert torch.count_nonzero(y[used:]) == 0
    assert torch.count_nonzero(dx[used:]) == 0
    for i, c in enumerate(counts):
        if c == 0:
            assert torch.count_nonzero(dw[i]) == 0


# the edges of the wgmma route (bf16; K and N multiples of 8, not of 64):
# runs shorter than a 64-row slice, runs that start mid-slice, runs one
# row past a 128-row tile or a slice, empty runs, rows past the groups, a
# second 256-column tile, and many groups
GMM_EDGE_CASES = {
    "short_and_mid_slice": ([40, 25, 300, 7], 372, 200, 136),
    "one_row_past": ([129, 65, 1, 193], 388, 136, 264),
    "empty_and_tail": ([0, 150, 0, 90, 0], 300, 72, 40),
    "many_groups": ([(7 * i) % 23 for i in range(70)], 800, 72, 520),
    "300_groups": ([(3 * i) % 7 for i in range(300)], 905, 72, 40),
}


def _gmm_inputs(dev, counts, m, k, n, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    xs = torch.randn((m, k), generator=g, device=dev).bfloat16()
    w = (0.1 * torch.randn((len(counts), k, n), generator=g,
                           device=dev)).bfloat16()
    gy = torch.randn((m, n), generator=g, device=dev).bfloat16()
    gs = torch.tensor(counts, dtype=torch.int32, device=dev)
    return xs, w, gy, gs


@pytest.mark.parametrize("case", sorted(GMM_EDGE_CASES))
def test_grouped_matmul_wgmma_route_edges(dev, case):
    """Forward (fp32 and bf16 out), dx and dW on the wgmma route against
    the plain versions, elementwise and per row; rows past the groups and
    an empty group's dW are 0."""
    from paddle_tpu_torch.ops import grouped_matmul as gmm
    from paddle_tpu_torch.ops.kernels import grouped_matmul as kgm
    counts, m, k, n = GMM_EDGE_CASES[case]
    assert sum(counts) <= m
    xs, w, gy, gs = _gmm_inputs(dev, counts, m, k, n, m * k + n)
    ends = kgm.group_ends(gs)
    _build.reset_launches()
    y = kgm.grouped_matmul(xs, w, ends)
    yb = kgm.grouped_matmul(xs, w, ends, out_dtype=torch.bfloat16)
    dx = kgm.grouped_matmul(gy, w, ends, out_dtype=torch.bfloat16,
                            transpose_w=True)
    dw = kgm.grouped_matmul_dw(xs, gy, ends, out_dtype=torch.bfloat16)
    assert _build.LAUNCHES["grouped_matmul_wgmma"] == 3, \
        dict(_build.LAUNCHES)
    assert _build.LAUNCHES["grouped_matmul_dw_wgmma"] == 1, \
        dict(_build.LAUNCHES)
    want_y = gmm.grouped_matmul_plain(xs, w, gs)
    for got, want in (
            (y, want_y), (yb, want_y.bfloat16()),
            (dx, gmm.grouped_matmul_plain(gy, w.transpose(1, 2),
                                          gs).bfloat16()),
            (dw, gmm.grouped_matmul_dw_plain(xs, gy, gs).bfloat16())):
        _close(got, want, "bfloat16")
        _rows_close(got, want, "bfloat16")
    used = sum(counts)
    for t in (y, yb, dx):
        assert torch.count_nonzero(t[used:]) == 0
    for i, c in enumerate(counts):
        if c == 0:
            assert torch.count_nonzero(dw[i]) == 0


def test_grouped_matmul_wgmma_route_is_deterministic(dev):
    """The forward and dW on the wgmma route give the same bits on a
    second run (one block sums each tile in a fixed order, no
    atomics)."""
    from paddle_tpu_torch.ops.kernels import grouped_matmul as kgm
    counts, m, k, n = GMM_EDGE_CASES["one_row_past"]
    xs, w, gy, gs = _gmm_inputs(dev, counts, m, k, n, 3)
    ends = kgm.group_ends(gs)
    runs = [(kgm.grouped_matmul(xs, w, ends),
             kgm.grouped_matmul(gy, w, ends, out_dtype=torch.bfloat16,
                                transpose_w=True),
             kgm.grouped_matmul_dw(xs, gy, ends, out_dtype=torch.bfloat16))
            for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_moe_widths_take_the_wgmma_route_on_the_card(dev):
    """One bf16 dropless MoELayer at DeepSeekMoE-16B widths (hidden 2048,
    64 experts of 1408, top-6) over 256 tokens, forward and backward:
    all 4 grouped_matmul and 2 grouped_matmul_dw launches take the wgmma
    route."""
    from paddle_tpu_torch.parallel.moe import MoELayer
    layer = MoELayer(2048, 1408, 64, top_k=6, capacity_factor=None,
                     dtype="bfloat16", device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3))
    x = torch.randn((1, 256, 2048), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)
    _build.reset_launches()
    out, aux = layer(x)
    (out.float().square().mean() + aux).backward()
    torch.cuda.synchronize()
    counts = dict(_build.LAUNCHES)
    assert counts["grouped_matmul"] == counts["grouped_matmul_wgmma"] == 4, \
        counts
    assert counts["grouped_matmul_dw"] == counts[
        "grouped_matmul_dw_wgmma"] == 2, counts
    assert bool(torch.isfinite(x.grad).all())


def test_grouped_matmul_keeps_an_fp32_cotangent_on_the_card(dev):
    """bf16 operands under an fp32 cotangent: dx and dw on the card (the
    kernels' fp32 route over widened operands) equal the CPU's (the plain
    fp32 products) within one bf16 step, the rounding of one fp32 sum
    taken in another order. The MoE layer's grouped_matmul_act gives the
    cast product and takes the bf16 kernels."""
    from paddle_tpu_torch.ops import grouped_matmul as gmm
    counts, m, k, n = GMM_CASES["ragged"]
    rs = np.random.RandomState(5)
    xs = torch.tensor(rs.randn(m, k), dtype=torch.float32).bfloat16()
    w = torch.tensor(0.1 * rs.randn(len(counts), k, n),
                     dtype=torch.float32).bfloat16()
    r = torch.tensor(rs.randn(m, n), dtype=torch.float32)
    gs = torch.tensor(counts, dtype=torch.int32)
    grads = []
    for d in (torch.device("cpu"), dev):
        tx = xs.to(d).detach().requires_grad_()
        tw = w.to(d).detach().requires_grad_()
        (gmm.grouped_matmul(tx, tw, gs.to(d)) * r.to(d)).sum().backward()
        assert tx.grad.dtype == tw.grad.dtype == torch.bfloat16
        grads.append((tx.grad.float().cpu(), tw.grad.float().cpu()))
    for want, got in zip(*grads):
        bad = (got - want).abs() > 2.0 ** -7 * want.abs()
        assert not bad.any(), int(bad.sum())
    y = gmm.grouped_matmul_act(xs.to(dev), w.to(dev), gs.to(dev))
    assert y.dtype == torch.bfloat16
    _close(y, gmm.grouped_matmul_plain(xs, w, gs).bfloat16().to(dev),
           "bfloat16")


def test_grouped_matmul_wrappers_refuse_what_they_do_not_take(dev):
    from paddle_tpu_torch.ops.kernels import grouped_matmul as kgm
    xs = torch.zeros((8, 16), device=dev)
    w = torch.zeros((2, 16, 8), device=dev)
    ends = torch.tensor([4, 8], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        kgm.grouped_matmul(xs.cpu(), w.cpu(), ends.cpu())
    with pytest.raises(ValueError, match="share a dtype"):
        kgm.grouped_matmul(xs.bfloat16(), w, ends)
    with pytest.raises(ValueError, match="float32 result"):
        kgm.grouped_matmul(xs, w, ends, out_dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="int32"):
        kgm.grouped_matmul(xs, w, ends.long())
    with pytest.raises(ValueError, match="does not match"):
        kgm.grouped_matmul(xs, w, ends, transpose_w=True)


def test_moe_layer_on_card_matches_cpu_without_host_syncs(dev):
    """The dropless MoELayer (fp32) on the card against the CPU: output,
    aux loss and every gradient within 1e-5 of each tensor's largest;
    the routing is equal. Then a bf16 layer's forward and backward run
    under torch.cuda.set_sync_debug_mode("error"): nothing on the path
    makes the host wait for the device."""
    from paddle_tpu_torch.parallel.moe import MoELayer
    grads = []
    rs = np.random.RandomState(4)
    x0 = rs.randn(2, 48, 256).astype(np.float32)
    r = torch.tensor(rs.randn(2, 48, 256).astype(np.float32))
    for device in ("cpu", dev):
        layer = MoELayer(256, 128, 8, top_k=3, capacity_factor=None,
                         device="cpu",
                         generator=torch.Generator().manual_seed(1)).to(
                             device)
        x = torch.tensor(x0, device=device, requires_grad=True)
        out, aux = layer(x)
        ((out * r.to(device)).sum() + aux).backward()
        grads.append({"out": out.detach(), "aux": aux.detach(), "x": x.grad,
                      "hist": layer.routing_histogram(x.detach()),
                      **{n: p.grad for n, p in layer.named_parameters()}})
    assert torch.equal(grads[0]["hist"], grads[1]["hist"].cpu())
    for n, want in grads[0].items():
        got = grads[1][n].cpu().float()
        assert float((got - want.float()).abs().max()) <= 1e-5 * max(
            float(want.float().abs().max()), 1.0), n
    layer = MoELayer(256, 128, 8, top_k=3, capacity_factor=None,
                     dtype="bfloat16", device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
    x = torch.randn((2, 48, 256), device=dev, dtype=torch.bfloat16,
                    requires_grad=True)

    def step():
        out, aux = layer(x)
        (out.float().sum() + aux).backward()
    step()                              # builds and loads the kernels
    torch.cuda.synchronize()
    _build.reset_launches()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert _build.LAUNCHES["grouped_matmul"] == 4, dict(_build.LAUNCHES)
    assert _build.LAUNCHES["grouped_matmul_dw"] == 2, dict(_build.LAUNCHES)


def test_moe_model_training_on_card_matches_cpu(dev):
    """Three AdamW steps of the same seeded tiny dropless MoE model (fp32,
    shared-expert gate) on the card and on the CPU: losses within
    1e-4."""
    from paddle_tpu_torch.models import MoEConfig, MoEForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer
    cfg = MoEConfig.tiny(capacity_factor=None, shared_expert_gate=True)
    ids = np.random.RandomState(5).randint(0, cfg.vocab_size, (2, 65))
    losses = []
    for device in ("cpu", dev):
        m = MoEForCausalLM(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        m = m.to(device)
        tr = Trainer(m, AdamW(learning_rate=1e-3, parameters=m,
                              grad_clip=ClipGradByGlobalNorm(1.0)))
        batch = {"input_ids": torch.tensor(ids[:, :-1], device=device),
                 "labels": torch.tensor(ids[:, 1:], device=device)}
        losses.append([float(tr.train_step(batch)) for _ in range(3)])
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4, atol=1e-4)


# -- the serving path on other threads, its spans, the front door ----------

def _on_thread(fn):
    """``fn()`` on a fresh thread (normal grad mode, the default stream)
    with the stream it saw; re-raises its exception here."""
    import threading
    box = {}

    def work():
        try:
            box["stream"] = torch.cuda.current_stream()
            box["r"] = fn()
        except BaseException as e:      # noqa: BLE001 — re-raised below
            box["e"] = e
    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive()
    if "e" in box:
        raise box["e"]
    return box["r"], box["stream"]


def _tiny_card_model(dev):
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    return LlamaForCausalLM(LlamaConfig.tiny(), device=dev,
                            generator=pt.generator(0, dev))


def test_engine_verbs_from_fresh_threads_on_the_card(dev):
    """An engine built on the card under inference mode, driven only from
    fresh threads (submit, step, run, cancel, serialize_pages,
    adopt_pages): the tokens and the launches by kernel of an engine
    driven from this thread, into the default stream (D12)."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    model = _tiny_card_model(dev)
    rs = np.random.RandomState(6)
    prompts = [rs.randint(0, 256, (n,)).astype(np.int32) for n in (19, 7)]
    kw = dict(max_batch=2, page_size=8, max_len=64, prefix_cache=True,
              generation_config=GenerationConfig(max_new_tokens=6))
    runs = []
    for threaded in (False, True):
        with torch.inference_mode():
            src = ContinuousBatchingEngine(model, **kw)
            dst = ContinuousBatchingEngine(model, **kw)
        call = _on_thread if threaded else (lambda f: (f(), None))
        torch.cuda.synchronize()
        _build.reset_launches()
        rids = [call(lambda p=p: src.submit(p))[0] for p in prompts]
        out, stream = call(src.run)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        if threaded:
            assert stream == torch.cuda.default_stream(dev)
        pay = call(lambda: src.serialize_pages(prompts[0]))[0]
        assert len(call(lambda: dst.adopt_pages(pay))[0]) == 2
        rid = call(lambda: dst.submit(prompts[0]))[0]
        call(dst.step)
        assert call(lambda: dst.cancel(rid))[0] is True
        rid = call(lambda: dst.submit(prompts[0]))[0]
        again = call(dst.run)[0][rid]
        dst._check_page_invariants()
        runs.append(([out[r].tolist() for r in rids], again.tolist(),
                     launches))
    assert runs[1] == runs[0]
    assert all(runs[1][2][k] > 0 for k in SERVING_KERNELS), runs[1][2]
    assert runs[1][1] == runs[1][0][0]


def test_serving_spans_and_device_trace_of_a_card_run(dev, tmp_path):
    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    model = _tiny_card_model(dev)
    eng = ContinuousBatchingEngine(
        model, max_batch=2, page_size=8, max_len=64, chunked_prefill=True,
        prefill_chunk=8, generation_config=GenerationConfig(max_new_tokens=6))
    rs = np.random.RandomState(7)
    p = profiler.Profiler(
        on_trace_ready=profiler.export_chrome_tracing(str(tmp_path / "host")),
        trace_device=True, device_trace_dir=str(tmp_path / "device"))
    with p:
        for n in (21, 9):
            eng.submit(rs.randint(0, 256, (n,)).astype(np.int32))
        eng.run()
    names = [e.name for e in p.result.events]
    assert set(profiler.SERVING_EVENTS) <= set(names)
    assert names.count("serving::prefill") >= 4      # chunks of 8
    import glob
    import json
    host = glob.glob(str(tmp_path / "host" / "*.json"))
    device = glob.glob(str(tmp_path / "device" / "*.json"))
    assert len(host) == 1 and len(device) == 1
    events = json.load(open(device[0]))["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    assert any("paged" in k for k in kernels), sorted(set(kernels))[:20]


def test_front_door_round_trip_on_the_card(dev):
    """Two replicas of a tiny card model behind a breaker and a front
    door; four greedy clients in this process: the streams of one engine
    on the card, no trip."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.serving_fabric import (BreakerTransport,
                                                 FabricClient, FrontDoor,
                                                 InProcTransport,
                                                 ServingFabric,
                                                 build_replicas)
    import threading
    model = _tiny_card_model(dev)
    gc = GenerationConfig(max_new_tokens=8)
    rs = np.random.RandomState(8)
    prompts = [rs.randint(0, 256, (n,)).astype(np.int32)
               for n in (5, 17, 9, 30)]
    reps = build_replicas(model, 2, roles=["prefill", "both"], page_size=8,
                          max_len=64, max_batch=2, generation_config=gc)
    br = BreakerTransport(InProcTransport(reps))
    door = FrontDoor(ServingFabric(br, disagg_threshold_tokens=16)).start()
    got = [None] * len(prompts)
    try:
        def go(i):
            got[i] = FabricClient(door.host, door.port,
                                  io_timeout_s=120.0).generate(
                prompts[i], 8, request_id=f"c{i}").tokens
        ts = [threading.Thread(target=go, args=(i,))
              for i in range(len(prompts))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=300)
    finally:
        door.stop()
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=8,
                                   max_len=64, generation_config=gc)
    rids = [eng.submit(p) for p in prompts]
    out = eng.run()
    assert got == [out[r].tolist() for r in rids]
    assert br.trips == 0


# -- the trainer runtime on the card ------------------------------------------

def _runtime_trainer(dev, seed, dtype="float32", opt=None, **kw):
    """A tiny Llama's Trainer; ``opt`` (class name, arguments) in place of
    AdamW(1e-3, weight_decay 0.01)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.trainer import Trainer
    m = LlamaForCausalLM(LlamaConfig.tiny(dtype=dtype), device=dev,
                         generator=pt.generator(seed, dev))
    name, args = opt or ("AdamW", {"weight_decay": 0.01})
    return Trainer(m, getattr(topt, name)(
        learning_rate=1e-3, parameters=m,
        grad_clip=topt.ClipGradByGlobalNorm(1.0), **args), **kw)


def _runtime_loader(dev, n=12):
    from paddle_tpu_torch.io import DataLoader, TensorDataset
    ids = np.random.RandomState(4).randint(0, 256, (2 * n, 33))
    return DataLoader(TensorDataset([ids]), batch_size=2,
                      prefetch_to_device=True, device=dev,
                      collate_fn=lambda it: {
                          "input_ids": np.stack([i[0][:-1] for i in it]),
                          "labels": np.stack([i[0][1:] for i in it])})


def test_async_snapshot_precedes_the_in_place_update_on_the_card(dev,
                                                                  tmp_path):
    """An async save of card tensors returns with its host snapshot taken:
    the in-place update enqueued right after it does not reach the file."""
    from paddle_tpu_torch import checkpoint as ckpt
    g = torch.Generator(device=dev).manual_seed(3)
    tree = {"w": torch.randn((1024, 1024), generator=g, device=dev),
            "b": torch.randn((4096,), generator=g,
                             device=dev).to(torch.bfloat16)}
    want = {k: v.to("cpu", copy=True) for k, v in tree.items()}
    ckpt.save_state_dict(tree, str(tmp_path / "s"), async_save=True)
    with torch.no_grad():
        tree["w"].mul_(3.0).add_(1.0)
        tree["b"].zero_()
    ckpt.wait_until_finished()
    got = ckpt.load_state_dict(str(tmp_path / "s"),
                               {k: v.cpu() for k, v in tree.items()})
    for k in want:
        assert torch.equal(got[k], want[k])
    # the async save's host buffers are pinned and kept for the next one;
    # a synchronous save writes from plain host copies and frees them
    assert sorted(ckpt.writer()._buffers) == ["b", "w"]
    assert all(b.is_pinned() for b in ckpt.writer()._buffers.values())
    ckpt.save_state_dict(tree, str(tmp_path / "t"))
    assert not ckpt.writer()._buffers
    got = ckpt.load_state_dict(str(tmp_path / "t"),
                               {k: v.cpu() for k, v in tree.items()})
    for k in tree:
        assert torch.equal(got[k], tree[k].cpu())


def test_restore_copies_into_the_live_tensors_on_the_card(dev, tmp_path):
    """A resume copies into the live tensors: the module's parameters and
    the optimizer's masters and moments keep their storage, and hold the
    committed state bit for bit (bf16 parameters, fp32 masters); the data
    loader prefetches onto the card and resumes at the cursor."""
    from paddle_tpu_torch.resilience import CheckpointManager
    a = _runtime_trainer(dev, 0, "bfloat16")
    a.fit(_runtime_loader(dev), 4, log_every=2,
          checkpoint_manager=CheckpointManager(str(tmp_path),
                                               save_interval_steps=2))
    b = _runtime_trainer(dev, 1, "bfloat16")
    b.fit(_runtime_loader(dev), 1, log_every=1)      # state exists on b
    ptrs = {k: t.data_ptr() for k, t in b._live_tensors()}
    data = _runtime_loader(dev)
    b.fit(data, 4, log_every=1, resume="auto",
          checkpoint_manager=CheckpointManager(str(tmp_path)))
    assert {k: t.data_ptr() for k, t in b._live_tensors()} == ptrs
    assert b._step == 4 and data.state_dict() == {"batches_served": 4}
    assert dict(b.model.named_parameters())["lm_head"].data_ptr() == \
        b.params["lm_head"].data_ptr()
    live = dict(b._live_tensors())
    for key, t in a._live_tensors():
        assert live[key].device == t.device and torch.equal(live[key], t)


@pytest.mark.parametrize("opt", [None, ("RMSProp", {"centered": True}),
                                 ("Rprop", {})],
                         ids=["AdamW", "RMSProp-centered", "Rprop"])
def test_offloaded_update_equals_the_update_on_the_card(dev, opt):
    """One update from the same gradients with the optimizer state in
    pinned host memory (streamed a parameter at a time) and on the card:
    the same parameters, masters and slots bit for bit; the offloaded
    state stays on the host. RMSProp (centered) streams three slots a
    parameter; Rprop's bf16 parameters have no masters (D15)."""
    a = _runtime_trainer(dev, 0, "bfloat16", opt)
    b = _runtime_trainer(dev, 0, "bfloat16", opt, offload_opt_state=True)
    batch = next(iter(_runtime_loader(dev)))
    for _ in range(2):
        for tr in (a, b):
            tr.model.zero_grad(set_to_none=True)
        loss = a._loss(batch)
        loss.backward()
        grads = {k: p.grad.detach().clone() for k, p in a.params.items()}
        for tr in (a, b):
            tr.optimizer.apply_gradients(
                tr.params, {k: g.clone() for k, g in grads.items()},
                lr=1e-3)
    torch.cuda.synchronize(dev)
    live = dict(b._live_tensors())
    for key, t in a._live_tensors():
        assert torch.equal(live[key].to(dev), t), key
        if key[0] != "params":
            assert live[key].device.type == "cpu" and live[key].is_pinned()


# -- the device mesh slice: the flash block entries, the vocab-parallel
# merge over virtual shards, a world-size-1 NCCL mesh ------------------------

@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_block_entries_match_plain(dev, dtype, d):
    """flash_fwd_block / flash_bwd_block (the ring's entries) against
    their plain versions on the same card tensors: a block whose key
    segments start at 1, so the first 64 query rows (segment 0) have no
    key in it and come back at lse = -1e30 and out = 0; the backward
    from a global (out, lse) merged with a second block."""
    g = torch.Generator(device=dev)
    g.manual_seed(70 + d)
    dt = getattr(torch, dtype)
    b, s, h, hk = 2, 256, 8, 2
    mk = lambda n: torch.randn((b, s, n, d), generator=g, device=dev).to(dt)
    q, k, v, dout, k2, v2 = mk(h), mk(hk), mk(hk), mk(h), mk(hk), mk(hk)
    qs = (torch.arange(s, device=dev) // 64).to(torch.int32)[None].repeat(
        b, 1).contiguous()
    ks = (qs + 1).contiguous()
    scale = d ** -0.5
    for causal in (False, True):
        o, l = attn_ops.flash_fwd_block(q, k, v, scale, causal, qs, ks)
        wo, wl = attn_ops._flash_fwd_plain(q, k, v, causal, scale, qs, ks)
        _close(o, wo, dtype)
        _rows_close(o, wo, dtype)
        torch.testing.assert_close(l, wl, rtol=1e-4, atol=1e-4)
        assert bool((l[:, :, :64] == -1e30).all())
        assert bool((o[:, :64] == 0).all())
        o2, l2 = attn_ops.flash_fwd_block(q, k2, v2, scale, False)
        lse = torch.logaddexp(l, l2)
        out = (o.float() * torch.exp(l - lse).transpose(1, 2)[..., None]
               + o2.float() * torch.exp(l2 - lse).transpose(1, 2)[..., None]
               ).to(dt)
        got = attn_ops.flash_bwd_block(q, k, v, out, lse, dout, scale,
                                       causal, qs, ks)
        delta = (out.float() * dout.float()).sum(-1).transpose(
            1, 2).contiguous()
        want = attn_ops._flash_bwd_plain(q, k, v, dout, lse, delta, causal,
                                         scale, qs, ks)
        for a, w in zip(got, want):
            _close(a, w, dtype)
            _rows_close(a, w, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_vocab_parallel_merge_at_two_virtual_shards(dev, dtype):
    """The vocab-parallel CE's per-shard lse_and_target kernels (labels
    shifted by each shard's offset, ignored rows below every shard) and
    the merge (``mp_layers.merge_shard_stats``) against the whole-vocab
    kernels: nll, dh and dW."""
    from paddle_tpu_torch.parallel.mp_layers import merge_shard_stats
    g = torch.Generator(device=dev)
    g.manual_seed(71)
    dt = getattr(torch, dtype)
    N, H, V, n = 300, 320, 1024, 2
    per = V // n
    h0 = torch.randn((N, H), generator=g, device=dev).to(dt)
    w0 = (0.05 * torch.randn((H, V), generator=g, device=dev)).to(dt)
    lab = torch.randint(0, V, (N,), generator=g, device=dev)
    lab[::7] = -100
    valid = lab != -100
    h = h0.clone().requires_grad_()
    ws = [w0[:, i * per:(i + 1) * per].clone().requires_grad_()
          for i in range(n)]
    st = [vocab_ce.lse_and_target(h, ws[i], (torch.where(
        valid, lab, -1) - i * per).to(torch.int32)) for i in range(n)]
    nll = merge_shard_stats([a for a, _ in st], [b for _, b in st], valid)
    nll.sum().backward()
    h2, w2 = h0.clone().requires_grad_(), w0.clone().requires_grad_()
    want = vocab_ce.fused_linear_cross_entropy(h2, w2, lab,
                                               reduction="none")
    want.sum().backward()
    torch.testing.assert_close(nll, want, rtol=1e-4, atol=1e-4)
    dw = torch.cat([w.grad for w in ws], 1)
    _close(h.grad, h2.grad, dtype)
    _rows_close(h.grad, h2.grad, dtype)
    _close(dw, w2.grad, dtype)
    _rows_close(dw.t(), w2.grad.t(), dtype)


def test_world_size_one_nccl_mesh_collectives_are_identities(dev):
    """init_parallel_env brings up NCCL with one rank on the card; the
    mesh has every axis 1 and its collectives, plain and differentiable,
    return their inputs (in a child process: the process group is
    global)."""
    import subprocess
    import sys
    code = """
import socket, torch, torch.distributed as dist
from paddle_tpu_torch.distributed import communication as c
from paddle_tpu_torch.parallel.mesh import init_parallel_env
s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]
s.close()
hm = init_parallel_env(init_method=f"tcp://localhost:{port}", world_size=1,
                       rank=0)
assert dist.get_backend() == "nccl"
assert all(v == 1 for v in hm.shape.values()) and hm.group("tp") is None
x = torch.randn(64, 32, device="cuda")
assert torch.equal(c.all_reduce(x.clone()), x)
assert torch.equal(c.reduce_scatter(None, x.clone()), x)
assert torch.equal(torch.cat(c.all_gather(None, x)), x)
xr = x.clone().requires_grad_()
with hm:
    y = c.reduce_from_group(c.copy_to_group(xr, "tp"), "tp")
y.sum().backward()
assert torch.equal(y, x) and torch.equal(xr.grad, torch.ones_like(x))
w = x.clone()
dist.all_reduce(w)
assert torch.equal(w, x)
dist.destroy_process_group()
print("IDENTITIES OK")
"""
    import pathlib
    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "IDENTITIES OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-3000:]


# -- pipeline and expert parallelism over virtual stages and ranks ---------

@pytest.mark.parametrize("sched", ["1f1b", "gpipe", "interleaved"])
def test_pipe_fused_step_on_card_matches_cpu(dev, sched):
    """The tiny Llama (4 layers, fp32) as LlamaForCausalLMPipe over 2
    virtual stages and 4 microbatches, unevenly padded: the fused step's
    loss and every gradient on the card within 1e-5 of each tensor's
    largest against the same step on the CPU; every training kernel
    launches (1F1B holds at most 2S - 1 = 3 microbatches a stage)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models.llama import (LlamaConfig,
                                               LlamaForCausalLMPipe)
    cfg = LlamaConfig.tiny(num_hidden_layers=4)
    rs = np.random.RandomState(6)
    ids = rs.randint(0, cfg.vocab_size, (8, 65))
    labels = ids[:, 1:].copy()
    labels[0, :50] = -100
    labels[5, :] = -100
    side = []
    for device in ("cpu", dev):
        m = LlamaForCausalLMPipe(cfg, num_stages=2, num_microbatches=4,
                                 pp_schedule=sched, num_chunks=2,
                                 device="cpu",
                                 generator=pt.generator(0, "cpu")).to(device)
        _build.reset_launches()
        loss, grads = m.loss_and_grads(
            torch.tensor(ids[:, :-1], device=device),
            torch.tensor(labels, device=device))
        side.append((float(loss), {n: g.detach().float().cpu()
                                   for n, g in grads.items()},
                     dict(m.pipe_stats)))
    (lc, gc, _), (lg, gg, stats) = side
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert set(gg) == set(gc)
    for n, want in gc.items():
        assert float((gg[n] - want).abs().max()) <= 1e-5 * float(
            want.abs().max()), n
    for k in ("rms_norm", "rms_norm_bwd", "fused_rope", "flash_fwd",
              "flash_bwd", "vocab_ce_fwd", "vocab_ce_dh", "vocab_ce_dw"):
        assert _build.LAUNCHES[k] > 0, k
    if sched == "1f1b":
        assert max(stats["peak_live"]) <= 3


def test_virtual_ep_on_card_matches_the_whole_layer(dev):
    """A bf16 dropless MoELayer (256 wide, 16 experts of 128, top 4) over
    4 virtual ep ranks on the card against the layer on the whole batch:
    outputs, input and weight gradients per row within ROW_TOL; every
    grouped launch on the wgmma route; the forward and backward make
    one host sync (the split sizes' read)."""
    import warnings
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel.moe import EP_HOST_READS, MoELayer
    layer = MoELayer(256, 128, 16, top_k=4, capacity_factor=None,
                     dtype="bfloat16", device=dev,
                     generator=pt.generator(3, dev))
    g = pt.generator(4, dev)
    x = torch.randn((4, 96, 256), device=dev, dtype=torch.bfloat16,
                    generator=g)
    r = torch.randn(x.shape, device=dev, generator=g)

    def run(lanes):
        layer.zero_grad(set_to_none=True)
        xs = [t.clone().requires_grad_(True) for t in x.unbind(0)]
        if lanes:
            outs, aux = layer.forward_virtual_ep([t[None] for t in xs], 4)
            out = torch.cat(outs)
        else:
            out, aux = layer(torch.stack(xs))
        ((out.float() * r).sum() + aux).backward()
        return out, torch.stack([t.grad for t in xs]), {
            n: p.grad for n, p in layer.named_parameters()}
    want = run(False)
    run(True)                              # builds and loads the kernels
    torch.cuda.synchronize()
    _build.reset_launches()
    reads = EP_HOST_READS[0]
    mode = torch.cuda.get_sync_debug_mode()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = run(True)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    torch.cuda.synchronize()
    assert EP_HOST_READS[0] - reads == 1
    assert sum("synchroniz" in str(w.message) for w in caught) == 1
    for k in ("grouped_matmul", "grouped_matmul_dw"):
        assert _build.LAUNCHES[k] > 0
        assert _build.LAUNCHES[k + "_wgmma"] == _build.LAUNCHES[k], k
    _rows_close(got[0], want[0], "bfloat16")
    _rows_close(got[1], want[1], "bfloat16")
    for n, w in want[2].items():
        gn = got[2][n]
        _rows_close(gn if gn.dim() > 1 else gn[None],
                    w if w.dim() > 1 else w[None], "bfloat16")


def test_one_rank_pipe_and_ep_mesh_on_the_card():
    """init_parallel_env brings up NCCL with one rank; the pipe model at
    pp 1 and the MoE LM at ep 1 shard over the one-rank mesh and take a
    Trainer step each equal to the same step without the mesh (in a
    child process: the process group is global)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pathlib
    import subprocess
    import sys
    code = """
import socket, torch
import torch.distributed as dist
import paddle_tpu_torch as pt
from paddle_tpu_torch.models import (LlamaConfig, LlamaForCausalLMPipe,
                                     MoEConfig, MoEForCausalLM)
from paddle_tpu_torch.optimizer import SGD, ClipGradByGlobalNorm
from paddle_tpu_torch.parallel.api import shard_layer
from paddle_tpu_torch.parallel.mesh import init_parallel_env
from paddle_tpu_torch.trainer import Trainer
s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]
s.close()
hm = init_parallel_env(init_method=f"tcp://localhost:{port}", world_size=1,
                       rank=0)
dev = torch.device("cuda")
ids = torch.randint(0, 256, (4, 33), device=dev,
                    generator=pt.generator(1, dev))
batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
makers = (lambda: LlamaForCausalLMPipe(
              LlamaConfig.tiny(num_hidden_layers=2), num_stages=1,
              num_microbatches=2, pp_schedule="1f1b", device=dev,
              generator=pt.generator(0, dev)),
          lambda: MoEForCausalLM(MoEConfig.tiny(capacity_factor=None),
                                 device=dev, generator=pt.generator(0, dev)))
for make in makers:
    losses = []
    for mesh in (None, hm):
        m = make()
        if mesh is not None:
            shard_layer(m, mesh)
        tr = Trainer(m, SGD(learning_rate=0.1, parameters=m,
                            grad_clip=ClipGradByGlobalNorm(0.5)))
        losses.append([float(tr.train_step(batch)) for _ in range(2)])
    assert losses[0] == losses[1], losses
dist.destroy_process_group()
print("ONE RANK OK")
"""
    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "ONE RANK OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-3000:]


# -- the comm/compute overlap's tensor-parallel Function ----------------------

@pytest.mark.parametrize("chunk", [False, True])
def test_overlapped_column_parallel_function_at_world_size_one(dev, chunk):
    """``distributed.overlap``'s overlapped Function with no group (world
    size 1, no all-reduce) at Llama-3-8B's qkv widths, bf16: output and
    gradients equal the plain product's autograd bit for bit, and its
    backward syncs nothing (set_sync_debug_mode("error"))."""
    from paddle_tpu_torch.distributed import overlap
    g = torch.Generator(device=dev).manual_seed(0)
    k = 8192 if chunk else 4096
    x = torch.randn(2, 512, k, device=dev, generator=g).bfloat16()
    w = (torch.randn(4096, 6144, device=dev, generator=g) * 0.02).bfloat16()
    dy = torch.randn(2, 512, 6144, device=dev, generator=g).bfloat16()
    xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
    ya = overlap._CopyMatmul.apply(xa, wa, None, 2 if chunk else 1, 1,
                                   chunk)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ya.backward(dy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
    yb = torch.matmul(xb.chunk(2, dim=-1)[1] if chunk else xb, wb)
    yb.backward(dy)
    for a, b in ((ya, yb), (xa.grad, xb.grad), (wa.grad, wb.grad)):
        assert torch.equal(a, b)


def test_overlapped_function_on_a_one_rank_nccl_group():
    """The same Function over a one-rank NCCL group: dx's all-reduce is
    started asynchronously, dW computed, then the handle waited on (the
    recorded order); the gradients equal the plain path's bit for bit
    and the backward syncs nothing (in a child process: the process
    group is global)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import pathlib
    import subprocess
    import sys
    code = """
import socket, torch, torch.distributed as dist
from paddle_tpu_torch.distributed import overlap
from paddle_tpu_torch.parallel.mesh import init_parallel_env
s = socket.socket(); s.bind(("localhost", 0)); port = s.getsockname()[1]
s.close()
init_parallel_env(init_method=f"tcp://localhost:{port}", world_size=1,
                  rank=0)
g = torch.Generator(device="cuda").manual_seed(1)
x = torch.randn(1024, 4096, device="cuda", generator=g).bfloat16()
w = (torch.randn(4096, 28672, device="cuda", generator=g) * 0.02).bfloat16()
dy = torch.randn(1024, 28672, device="cuda", generator=g).bfloat16()
pg = dist.group.WORLD
warm = torch.ones(8, device="cuda")
dist.all_reduce(warm)
torch.cuda.synchronize()
xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
ya = overlap._CopyMatmul.apply(xa, wa, pg, 1, 0, False)
torch.cuda.synchronize()
with overlap.record_order() as ev:
    torch.cuda.set_sync_debug_mode("error")
    try:
        ya.backward(dy)
    finally:
        torch.cuda.set_sync_debug_mode(0)
assert [e[0] for e in ev] == ["issue", "dw", "wait"], ev
xb, wb = x.clone().requires_grad_(), w.clone().requires_grad_()
torch.matmul(xb, wb).backward(dy)
assert torch.equal(xa.grad, xb.grad) and torch.equal(wa.grad, wb.grad)
dist.destroy_process_group()
print("OVERLAP OK")
"""
    root = pathlib.Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0 and "OVERLAP OK" in r.stdout, \
        r.stdout[-2000:] + r.stderr[-3000:]


def _census_of_wrapped_ops(device):
    """(name, flops, bytes) of each kernel the census records for RMSNorm,
    RoPE, flash attention and the vocab-CE head, forward and backward,
    on ``device`` (fp32, seeded inputs made on the CPU)."""
    from paddle_tpu_torch.analysis.collectives import StepCensus
    b, s, h, hk, d, V = 2, 64, 4, 2, 64, 256
    g = torch.Generator().manual_seed(0)

    def t(*shape):
        return torch.randn(shape, generator=g).to(device).requires_grad_()
    x, w = t(b * s, h * d), t(h * d)
    q, k, v = t(b, s, h, d), t(b, s, hk, d), t(b, s, hk, d)
    cos, sin = rope_ops.rope_freqs(d, 128, device=device)
    hw = t(h * d, V)
    labels = torch.randint(0, V, (b * s,), generator=g).to(device)
    with StepCensus() as c:
        y = norm_ops.rms_norm(x, w)
        torch.autograd.grad(y.sum(), (x, w))
        qr, kr = rope_ops.apply_rotary_pos_emb(q, k, cos, sin)
        o = attn_ops.flash_attention(qr, kr, v, causal=True)
        torch.autograd.grad(o.sum(), (q, k, v))
        lse, tgt = vocab_ce.lse_and_target(x, hw, labels)
        torch.autograd.grad((lse - tgt).sum(), (x, hw))
    return [(o.name, o.flops, o.bytes) for o in c.ops if o.kernel]


def test_census_counts_wrapped_kernels_on_card_as_on_cpu(dev):
    """The planner's census prices a wrapped op by its kernel's counts:
    the same records (and the same kernels) on the card, where the
    kernels launch, as on the CPU, where their plain versions run."""
    _build.reset_launches()
    got = _census_of_wrapped_ops(dev)
    torch.cuda.synchronize(dev)
    assert got == _census_of_wrapped_ops(torch.device("cpu"))
    assert [n for n, *_ in got] == [
        "rms_norm", "rms_norm_bwd", "fused_rope", "flash_fwd", "flash_bwd",
        "fused_rope", "vocab_ce_fwd", "vocab_ce_bwd"]
    for name in ("rms_norm", "rms_norm_bwd", "fused_rope", "flash_fwd",
                 "flash_bwd", "vocab_ce_fwd"):
        assert _build.LAUNCHES[name] > 0, name
