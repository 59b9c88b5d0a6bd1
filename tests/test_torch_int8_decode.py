"""The int8 product's decode route (bf16 x, m <= 16) on the CPU: its split
plan, and its arithmetic emulated in plain PyTorch (fp32 partials a split,
added in split order, the scale applied once to the sum) against the plain
version and the JAX package's XLA path and Pallas kernel (interpret mode).
Inputs come from numpy with a fixed seed.

Tolerances: fp32 1e-5 (the same fp32 arithmetic in another summation
order, as tests/test_torch_quant.py); bf16 one bf16 step (2**-7
relative), since both sides sum exact products in fp32 and round once."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn.quantized_linear import \
    weight_quantize as jax_weight_quantize
from paddle_tpu.ops.pallas.int8_matmul import (int8_matmul_pallas,
                                               xla_weight_only)
from paddle_tpu_torch.ops.kernels import int8_matmul as kmm
from paddle_tpu_torch.ops.quant import weight_only_plain

TOL = 1e-5
BF16_STEP = 2.0 ** -7
# Llama-3-8B's projections of a decode step, (n, k)
PROJECTIONS = {"qkv": (6144, 4096), "o": (4096, 4096),
               "gate_up": (28672, 4096), "down": (4096, 14336),
               "lm_head": (128256, 4096)}
RAGGED = {"ragged_48x80": (48, 80), "ragged_272x1040": (272, 1040),
          "ragged_4112x14352": (4112, 14352)}


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _inputs(seed, m, k, n):
    rs = np.random.RandomState(seed)
    x = rs.normal(0, 1, (m, k)).astype(np.float32)
    wq, scale = jax_weight_quantize(
        jnp.asarray(rs.normal(0, 0.02, (k, n)).astype(np.float32)))
    return x, np.asarray(wq), np.asarray(scale)


@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("m", [1, 8, 16])
@pytest.mark.parametrize("shape", sorted({**PROJECTIONS, **RAGGED}))
def test_split_plan_covers_k_and_channels_once(shape, m, sms):
    """Every k element lies in exactly one split and every channel in
    exactly one 64-channel tile; a split's k is a multiple of the step
    and its x fits the block; at m <= 8, n = 4096 and 6144 get more
    blocks than SMs, on an H100 SXM (132 SMs) all on the card at once
    (one wave)."""
    n, k = {**PROJECTIONS, **RAGGED}[shape]
    kps, splits = kmm.split_plan(m, n, k, sms)
    assert kps % kmm.STEP_K == 0 and splits >= 1
    assert kps <= kmm.SPLIT_K_MAX // (1 if m <= 8 else 2) or splits == 1
    k_hits = np.zeros(k, np.int32)
    for s in range(splits):
        lo, hi = s * kps, min((s + 1) * kps, k)
        assert lo < hi, (s, kps, k)               # no empty split
        k_hits[lo:hi] += 1
    assert (k_hits == 1).all()
    tiles = -(-n // kmm.BLOCK_N)
    n_hits = np.zeros(n, np.int32)
    for t in range(tiles):
        n_hits[t * kmm.BLOCK_N:(t + 1) * kmm.BLOCK_N] += 1
    assert (n_hits == 1).all()
    if shape in ("qkv", "o", "down") and m <= 8:
        fit = kmm.blocks_that_fit(m, kps)
        assert tiles * splits > sms, (tiles, splits)
        assert sms != 132 or tiles * splits <= fit * sms, (splits, fit)
    if shape in ("gate_up", "lm_head") and m <= 8:
        assert splits <= 2          # wide projections fill the card alone


def test_split_plan_refuses_what_the_route_does_not_take():
    for args in ((0, 64, 64, 132), (17, 64, 64, 132), (8, 64, 64, 0)):
        with pytest.raises(ValueError):
            kmm.split_plan(*args)


@pytest.mark.parametrize("m,n,k", [(1, 256, 2048), (8, 272, 1040),
                                   (16, 256, 1024), (8, 4096, 14336)])
def test_decode_arithmetic_matches_plain(m, n, k):
    """The emulation at the plan a 132-SM card gets (several splits each)
    against weight_only_plain, in fp32 and bf16."""
    x, wq, scale = _inputs(m * n + k, m, k, n)
    kps, splits = kmm.split_plan(m, n, k, 132)
    assert splits > 1
    tx, twq, ts = torch.tensor(x), torch.tensor(wq), torch.tensor(scale)
    _close(kmm.decode_splits_plain(tx, twq, ts, kps),
           weight_only_plain(tx, twq, ts))
    got = kmm.decode_splits_plain(tx.bfloat16(), twq, ts, kps).float()
    want = weight_only_plain(tx.bfloat16(), twq, ts).float()
    assert bool((got - want).abs().le(BF16_STEP * want.abs() + 1e-6).all())


def test_decode_arithmetic_matches_xla_at_m8():
    """m = 8: the JAX package sends a bf16 decode batch to XLA
    (``shapes_supported`` takes no bf16 m < 16), so the emulation is held
    to ``xla_weight_only`` in fp32 and bf16."""
    m, n, k = 8, 256, 2048
    x, wq, scale = _inputs(8, m, k, n)
    kps, splits = kmm.split_plan(m, n, k, 132)
    assert splits == 4
    tx, twq, ts = torch.tensor(x), torch.tensor(wq), torch.tensor(scale)
    _close(kmm.decode_splits_plain(tx, twq, ts, kps),
           xla_weight_only(jnp.asarray(x), jnp.asarray(wq),
                           jnp.asarray(scale)))
    got = kmm.decode_splits_plain(tx.bfloat16(), twq, ts, kps)
    want = np.asarray(xla_weight_only(jnp.asarray(x).astype(jnp.bfloat16),
                                      jnp.asarray(wq), jnp.asarray(scale)),
                      np.float32)
    assert np.all(np.abs(got.float().numpy() - want)
                  <= BF16_STEP * np.abs(want) + 1e-6)


def test_decode_arithmetic_matches_pallas_kernel_at_m16():
    """m = 16, the largest decode batch, which the TPU kernel's gate takes
    (block_n = 128): the emulation against the Pallas kernel in interpret
    mode, fp32."""
    m, n, k = 16, 256, 1024
    x, wq, scale = _inputs(16, m, k, n)
    kps, splits = kmm.split_plan(m, n, k, 132)
    assert splits == 2
    got = kmm.decode_splits_plain(torch.tensor(x), torch.tensor(wq),
                                  torch.tensor(scale), kps)
    _close(got, int8_matmul_pallas(jnp.asarray(x), jnp.asarray(wq),
                                   jnp.asarray(scale), block_n=128,
                                   interpret=True))
