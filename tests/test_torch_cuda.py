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
    """Two bf16 backward runs on the same inputs: dk and dv are equal to
    the bit (each block sums its own keys in a fixed order); dq, summed
    by atomics in an order that varies, agrees within the bf16 tolerance
    elementwise and per row."""
    q, k, v, dout = _flash_inputs(dev, 2, 1024, 8, 2, 128, 11)
    args = (True, 128 ** -0.5, None, None, 0.0, 0)
    out, lse = flash_attention.flash_fwd(q, k, v, *args)
    delta = (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()
    a = flash_attention.flash_bwd(q, k, v, dout, lse, delta, *args)
    b = flash_attention.flash_bwd(q, k, v, dout, lse, delta, *args)
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
    _close(a[0], b[0], "bfloat16")
    _rows_close(a[0], b[0], "bfloat16")


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
