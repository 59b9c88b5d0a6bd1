"""The launch plans of the RMSNorm forward and RoPE kernels
(``ops.kernels.fused_norm.plan``, ``ops.kernels.fused_rope.plan``), on
the CPU. The plans are plain functions of shapes, alignment and the SM
count; ``row_map`` and ``unit_map`` are the kernels' index maps in
plain Python. At the shapes the models launch (RMSNorm D 4096 and 2048
at decode, prefill and training rows; RoPE 32/8 and 16/16 heads of 128)
and at ragged ones, every element must be covered exactly once, and the
scalar route must be taken exactly where the width or the alignment
requires it. Exact integer checks: no tolerance."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import fused_norm, fused_rope

SMS = (132, 114)     # H100 SXM, H100 PCIe


def _once(maps):
    for m in maps:
        np.testing.assert_array_equal(m, np.ones_like(m))


@pytest.mark.parametrize("D", [4096, 2048, 256, 100, 64])
@pytest.mark.parametrize("R", [1, 3, 8, 128, 1024, 1025, 1536, 8192])
def test_norm_plan_covers_every_element_once(R, D):
    for sms in SMS:
        for aligned in (True, False):
            p = fused_norm.plan(R, D, aligned, sms)
            assert (p.route == "scalar") == (D % 8 != 0 or not aligned)
            assert (p.route == "row") == (
                aligned and D in fused_norm.ROW_WIDTHS)
            assert 32 <= p.threads <= 1024 and p.threads % 32 == 0
            if p.route == "row":
                # the shapes the launch accepts (fused_norm.cu
                # launch_row_width)
                assert (p.vpt, p.rows, p.threads) in (
                    (1, 1, D // 8), (4, 256 // (D // 32), 256))
                assert p.blocks <= max(R, sms * fused_norm.BLOCKS_PER_SM)
            else:
                assert p.blocks == R
            _once(fused_norm.row_map(p, R, D))


@pytest.mark.parametrize("sms", SMS)
def test_norm_plan_follows_the_shape(sms):
    """Up to one row an SM (decode, a short prefill) one row a block and
    one 16-byte vector a thread; above it four vectors a thread, several
    rows a block, blocks walking the rows with at most one trip between
    the longest and the shortest walk."""
    for D in fused_norm.ROW_WIDTHS:
        for R in (1, 8, sms):
            assert fused_norm.plan(R, D, True, sms) == ("row", 1, 1, R,
                                                        D // 8)
        for R in (sms + 1, 1024, 8192, 8197):
            p = fused_norm.plan(R, D, True, sms)
            assert (p.route, p.vpt, p.threads) == ("row", 4, 256)
            pieces = -(-R // p.rows)
            trips = -(-pieces // p.blocks)
            assert p.blocks <= sms * fused_norm.BLOCKS_PER_SM
            assert pieces > (trips - 1) * p.blocks
            _once(fused_norm.row_map(p, R, D))


@pytest.mark.parametrize("d", [128, 64])
@pytest.mark.parametrize("heads", [(32, 8), (16, 16)])
@pytest.mark.parametrize("tokens", [1, 3, 8, 128, 1024, 1025, 8192])
def test_rope_plan_covers_every_pair_once(tokens, heads, d):
    h, hk = heads
    for dtype in (torch.bfloat16, torch.float32):
        for aligned in (True, False):
            p = fused_rope.plan(tokens, h, hk, d, dtype, aligned, 132)
            assert (p.route == "scalar") == (not aligned)
            if p.route == "vec":
                # the shapes the launch accepts (fused_rope.cu launch)
                assert p.heads in ((1, 2, 4) if dtype == torch.bfloat16
                                   else (1, 2))
                assert p.heads <= fused_rope.MAX_HEADS[dtype]
                assert p.threads <= 256 and p.threads % (d // 16) == 0
            else:
                assert p.blocks == tokens and 32 <= p.threads <= 256
            _once(fused_rope.unit_map(p, tokens, h, hk, d))


@pytest.mark.parametrize("d", [40, 100, 130])
def test_rope_plan_takes_the_scalar_route_off_the_vector_widths(d):
    p = fused_rope.plan(5, 4, 2, d, torch.bfloat16, True, 132)
    assert p.route == "scalar"
    _once(fused_rope.unit_map(p, 5, 4, 2, d))


def test_rope_plan_spreads_decode_and_groups_training():
    """Decode (8 tokens, 32/8 heads): one head a thread, so that every
    load of the step is in flight at once (8 x 40 x 8 threads); training
    (2 x 4096 tokens): more than one head a thread, at most
    MAX_HEADS."""
    p = fused_rope.plan(8, 32, 8, 128, torch.bfloat16, True, 132)
    assert p.heads == 1 and p.blocks * p.threads == 8 * 40 * 8
    for h, hk in ((32, 8), (16, 16)):
        for dt in (torch.bfloat16, torch.float32):
            heads = fused_rope.plan(8192, h, hk, 128, dt, True, 132).heads
            assert 1 < heads <= fused_rope.MAX_HEADS[dt]


def test_vector_alignment_of_strided_views():
    """q and k as views of a fused qkv projection are aligned when every
    stride and offset is a multiple of 16 bytes; a view one element off,
    or a head stride of an odd width, takes the scalar route."""
    b, s, h, hk, d = 2, 3, 4, 2, 64
    cos = torch.zeros((16, d))
    qkv = torch.zeros((b, s, (h + 2 * hk) * d), dtype=torch.bfloat16)
    q = qkv[..., :h * d].view(b, s, h, d)
    k = qkv[..., h * d:(h + hk) * d].view(b, s, hk, d)
    assert fused_rope.vector_aligned(q, k, cos, cos)
    flat = torch.zeros(b * s * (h + 2 * hk) * d + 1, dtype=torch.bfloat16)
    off = flat[1:].view(b, s, (h + 2 * hk) * d)[..., :h * d].view(b, s, h, d)
    assert not fused_rope.vector_aligned(off, k, cos, cos)
    odd = torch.zeros((b, s, h, d + 4), dtype=torch.bfloat16)[..., :d]
    assert not fused_rope.vector_aligned(odd, k, cos, cos)
    shifted = torch.zeros(16 * d + 1)[1:].view(16, d)
    assert not fused_rope.vector_aligned(q, k, shifted, cos)
