"""Launch wrapper of the weight-only int8 matrix product
(``csrc/int8_matmul.cu``).

Replaces ``paddle_tpu/ops/pallas/int8_matmul.py`` ``_kernel``. The plain
version is ``ops.quant.weight_only_plain``; ``ops.quant.quantized_matmul``
chooses between the two by the tensor's device.

The kernel has three routes, which :func:`route` chooses from m and x's
type before the launch: ``"wgmma"`` (bf16 x, m > 16: TMA + register-A
``wgmma``, the prefill products), ``"decode"`` (bf16 x, m <= 16: split
over k, each warp's weight rows streamed by TMA bulk copies, ``mma.sync``
with the operands swapped) and ``"fp32"`` (fp32 x: FMAs). A launch
counts under ``int8_matmul`` and under ``int8_matmul_<route>``.

The decode route cuts k into splits (:func:`split_plan`, a function of
shapes and the SM count alone); the splits' fp32 partials are added on
the device in split order (:func:`decode_splits_plain` is that
arithmetic in plain PyTorch), so a call is one launch and bit-identical
between runs.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/int8_matmul.cu"
REPLACES = "paddle_tpu/ops/pallas/int8_matmul.py:40"
# the C side's route codes
ROUTES = {"fp32": 0, "decode": 1, "wgmma": 2}
DECODE_MAX_M = 16
# the decode kernel's geometry: channels a block (4 warps of 16) and the
# k of a warp's step (a split's k is a multiple of it)
BLOCK_N = 64
STEP_K = 64
# blocks an SM the split plan allows at most: more blocks streaming at
# once slowed the weight's stream (chip_smoke.py's plan sweep)
BLOCKS_PER_SM = 2.5
# fewer splits when a split's k would fall under SPLIT_K_MIN
SPLIT_K_MIN = 512
# k a split at most for m <= 8 (half for m <= 16): a block stages its
# slice of x (8 or 16 rows of bf16) in 64 KB of shared memory
SPLIT_K_MAX = 4096
# a block's shared memory beside its x slice (the four warps' rings of
# 2 stages of 16 rows of 256 + 16 bytes, and their mbarriers), and an
# SM's (Hopper: 228 KB, of which 1 KB is reserved for each block)
RING_BYTES = 4 * 2 * 16 * (256 + 16) + 4 * 2 * 8
SMEM_PER_SM = 228 * 1024
SMEM_RESERVED = 1024
_PLANS: Dict[tuple, Tuple[int, int]] = {}


def route(m: int, dtype: torch.dtype) -> str:
    """The kernel route for m rows of x of ``dtype``."""
    if dtype == torch.float32:
        return "fp32"
    return "decode" if m <= DECODE_MAX_M else "wgmma"


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def blocks_that_fit(m: int, kps: int) -> int:
    """Decode blocks an SM holds at once with splits of ``kps`` k: the
    kernel's shared memory a block (the rings, and x's slice of 8 or 16
    rows, 16 bytes past a multiple of 128 each) against the SM's."""
    rows = 8 if m <= 8 else 16
    smem = RING_BYTES + rows * (_round_up(kps, STEP_K) + 8) * 2
    return SMEM_PER_SM // (smem + SMEM_RESERVED)


def split_plan(m: int, n: int, k: int, sms: int) -> Tuple[int, int]:
    """``(kps, splits)`` of the decode route: k is cut into ``splits``
    slices of ``kps`` (a multiple of :data:`STEP_K`; the last may be
    shorter), each a block for every 64-channel tile, from shapes and the
    SM count alone: the most splits whose blocks all fit on the card at
    once (one wave) and number at most :data:`BLOCKS_PER_SM` an SM, none
    under :data:`SPLIT_K_MIN`; at least as many as keep a split's x within
    :data:`SPLIT_K_MAX`. Wide projections (gate_up, lm_head) have more
    tiles than that and take only the splits the bound asks for."""
    if not (1 <= m <= DECODE_MAX_M and n > 0 and k > 0 and sms > 0):
        raise ValueError(f"no decode plan for m={m}, n={n}, k={k}, "
                         f"sms={sms}")
    key = (m <= 8, n, k, sms, BLOCKS_PER_SM, SPLIT_K_MIN, SPLIT_K_MAX)
    plan = _PLANS.get(key)
    if plan is not None:
        return plan
    tiles = -(-n // BLOCK_N)
    least = -(-k // (SPLIT_K_MAX // (1 if m <= 8 else 2)))
    plan = None
    for splits in range(least, max(least, -(-k // SPLIT_K_MIN)) + 1):
        kps = _round_up(-(-k // splits), STEP_K)
        if -(-k // kps) != splits:
            continue          # rounded to the plan of fewer splits
        if tiles * splits <= min(BLOCKS_PER_SM,
                                 blocks_that_fit(m, kps)) * sms:
            plan = (kps, splits)
    if plan is None:
        kps = _round_up(-(-k // least), STEP_K)
        plan = (kps, -(-k // kps))
    _PLANS[key] = plan
    return plan


def decode_splits_plain(x: torch.Tensor, wq: torch.Tensor,
                        scale: torch.Tensor, kps: int) -> torch.Tensor:
    """The decode route's arithmetic in plain PyTorch: an fp32 partial
    sum over each split of ``kps`` k, the partials added in split order,
    the scale applied once to the sum, rounded once to x's dtype."""
    acc = None
    for k0 in range(0, x.shape[1], kps):
        p = torch.matmul(x[:, k0:k0 + kps].float(),
                         wq[:, k0:k0 + kps].float().t())
        acc = p if acc is None else acc + p
    return (acc * scale.float()).to(x.dtype)


def int8_matmul(x: torch.Tensor, wq: torch.Tensor,
                scale: torch.Tensor) -> torch.Tensor:
    """y[m, n] = (x[m, k] @ wq[n, k]^T) * scale[n] with an fp32 sum, in
    x's dtype (float32 or bfloat16). wq int8 [n, k], scale float32 [n];
    any m >= 1, n and k multiples of 16; all on one CUDA device,
    contiguous and 16-byte aligned."""
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul kernel needs CUDA tensors, got "
                         f"{x.device}")
    if x.dim() != 2 or wq.dim() != 2 or scale.dim() != 1:
        raise ValueError("x must be [m, k], wq [n, k] and scale [n]")
    m, k = x.shape
    n = wq.shape[0]
    if wq.shape[1] != k or scale.shape[0] != n:
        raise ValueError(f"shapes x {tuple(x.shape)}, wq {tuple(wq.shape)}, "
                         f"scale {tuple(scale.shape)} do not match")
    if n % 16 or k % 16 or n == 0 or k == 0:
        raise ValueError(f"int8_matmul kernel needs n and k multiples of 16, "
                         f"got n={n}, k={k}")
    if wq.dtype != torch.int8 or scale.dtype != torch.float32:
        raise ValueError(f"wq must be int8 and scale float32, got "
                         f"{wq.dtype} and {scale.dtype}")
    for t in (wq, scale):
        if t.device != x.device:
            raise ValueError("all inputs must be on one device")
    if not all(t.is_contiguous() for t in (x, wq, scale)):
        raise ValueError("int8_matmul kernel needs contiguous inputs")
    if x.data_ptr() % 16 or wq.data_ptr() % 16:
        raise ValueError("int8_matmul kernel needs 16-byte aligned x and wq")
    _build.dtype_code(x.dtype)
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    way = route(m, x.dtype)
    stream = _build.stream_ptr(x.device)
    part = tickets = None
    kps = 0
    if way == "decode":
        kps, splits = split_plan(m, n, k, _build.sm_count(x.device))
        if splits > 1:
            tiles = -(-n // BLOCK_N)
            part = torch.empty((tiles * splits * 512 * -(-m // 8),),
                               dtype=torch.float32, device=x.device)
            tickets = _build.tickets(x.device, stream, tiles)
    err = _build.lib().pt_int8_matmul(
        x.data_ptr(), wq.data_ptr(), scale.data_ptr(), y.data_ptr(),
        part.data_ptr() if part is not None else None,
        tickets.data_ptr() if tickets is not None else None, m, n, k,
        ROUTES[way], kps, stream)
    _build.check(err, "int8_matmul")
    _build.count_launch("int8_matmul")
    _build.count_launch(f"int8_matmul_{way}")
    return y


__all__ = ["int8_matmul", "route", "split_plan", "decode_splits_plain",
           "ROUTES", "SOURCE", "REPLACES"]
