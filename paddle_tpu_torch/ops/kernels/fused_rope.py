"""Launch wrapper of the fused RoPE kernel (``csrc/fused_rope.cu``).

Replaces ``paddle_tpu/ops/pallas/fused_rope.py`` ``_rope_kernel``. The
plain version is ``ops.rope._rope_plain``; ``ops.rope.
apply_rotary_pos_emb`` chooses between the two by the tensor's device.

The launch is planned from shapes alone (:func:`plan`): the route
("vec" for d a multiple of 16 on 16-byte aligned views, else "scalar"),
the heads a thread rotates, and the blocks. :func:`unit_map` is the
kernels' index map in plain Python, for the tests.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/fused_rope.cu"
REPLACES = "paddle_tpu/ops/pallas/fused_rope.py:37"

ROUTES = {"scalar": 0, "vec": 1}
# most heads a thread of the vec route rotates (the only group sizes the
# kernel is compiled for): its packed x1/x2, the table's 32 fp32 values
# and a pointer a head live in registers (ptxas: 80 registers at 4 bf16
# heads, 155 at 8, which leaves one 256-thread block an SM; 98 at 2 fp32
# heads, 215 at 4)
MAX_HEADS = {torch.bfloat16: 4, torch.float32: 2}
# threads an SM below which the plan keeps one head a thread, so that
# every load is in flight at once (decode)
MIN_THREADS_PER_SM = 1024
THREADS = 256
# blocks an SM that the walking grid holds at most (16: the grid walks
# only past 2,112 blocks; on an H100 80GB HBM3, chip_smoke.py's
# norm_rope_plan_sweep found 4 a few percent slower in training and no
# setting faster overall)
BLOCKS_PER_SM = 16


class RopePlan(NamedTuple):
    route: str
    heads: int      # heads a thread rotates (vec); 0 on the scalar route
    blocks: int
    threads: int


def plan(tokens: int, h: int, hk: int, d: int, dtype: torch.dtype,
         aligned: bool, sms: int) -> RopePlan:
    """The launch for ``tokens`` (b * s) tokens of h query and hk key
    heads of width d (``aligned``: q, k and the tables start at 16-byte
    boundaries and every stride of q and k is a multiple of 16 bytes) on
    a card of ``sms`` SMs. The vec route (d a multiple of 16 up to
    16 x :data:`THREADS`): d / 16 threads share a (token, head group)
    unit; the group is the most heads, up to :data:`MAX_HEADS`, that
    still leave :data:`MIN_THREADS_PER_SM` threads an SM, else one head;
    at most :data:`BLOCKS_PER_SM` blocks an SM, walking the units."""
    if tokens < 1:
        raise ValueError(f"no tokens to rotate: {tokens}")
    if d % 16 or d > 16 * THREADS or not aligned:
        pairs = (h + hk) * (d // 2)
        return RopePlan("scalar", 0, tokens, min(256, -(-pairs // 32) * 32))
    slices = d // 16
    heads = 1
    for g in (4, 2):
        if (g <= MAX_HEADS[dtype] and tokens * -(-(h + hk) // g) * slices
                >= sms * MIN_THREADS_PER_SM):
            heads = g
            break
    upb = THREADS // slices
    units = tokens * -(-(h + hk) // heads)
    return RopePlan("vec", heads,
                    _build.walking_grid(-(-units // upb),
                                        sms * BLOCKS_PER_SM),
                    upb * slices)


def vector_aligned(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor) -> bool:
    """Whether every 16-byte access of the vec route is aligned: q, k
    and the tables start at 16-byte boundaries, and q's and k's batch,
    sequence and head strides are multiples of 16 bytes."""
    e = q.element_size()
    return (all(t.data_ptr() % 16 == 0 for t in (q, k, cos, sin))
            and all(st * e % 16 == 0
                    for st in (*q.stride()[:3], *k.stride()[:3])))


def unit_map(p: RopePlan, tokens: int, h: int, hk: int, d: int
             ) -> Tuple[np.ndarray, np.ndarray]:
    """How often the launch ``p`` rotates each (token, head, column of
    the half width), from the kernels' index map, as two factors: every
    visit of a (token, head) covers the same columns, so the count of
    (t, h, c) is visits[t, h] x cover[h, c], visits [tokens, h + hk]
    and cover [h + hk, d // 2] (the times a column of a head is covered
    in one visit). Scalar: block i takes token i, thread i
    the pairs i, i + threads, ... of its (h + hk) x d/2. Vec: thread i
    of a block takes unit blockIdx * upb + i // slices, walking
    blocks * upb apart, and columns [8 (i % slices), + 8) of the unit's
    heads; unit u is token u // groups, heads (u % groups) * heads +
    [0, heads) below h + hk."""
    nh, half = h + hk, d // 2
    if p.route == "scalar":
        pairs = np.zeros(nh * half, np.int64)
        for i in range(p.threads):
            np.add.at(pairs, np.arange(i, nh * half, p.threads), 1)
        visits = np.zeros(tokens, np.int64)
        np.add.at(visits, np.arange(p.blocks), 1)
        return (np.repeat(visits[:, None], nh, axis=1),
                pairs.reshape(nh, half))
    slices = d // 16
    upb = p.threads // slices
    groups = -(-nh // p.heads)
    units = tokens * groups
    cols = np.zeros(half, np.int64)
    for i in range(slices):                  # the threads of one unit slot
        np.add.at(cols, (i % slices) * 8 + np.arange(8), 1)
    unit_visits = np.zeros(units, np.int64)
    for first in range(p.blocks * upb):      # (block, unit slot) pairs
        np.add.at(unit_visits,
                  np.arange(first, units, p.blocks * upb), 1)
    heads = np.zeros((tokens, nh), np.int64)
    u = np.arange(units)
    for i in range(p.heads):
        hh = (u % groups) * p.heads + i
        ok = hh < nh
        np.add.at(heads, ((u // groups)[ok], hh[ok]), unit_visits[ok])
    return heads, np.tile(cols, (nh, 1))


def fused_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor, positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate q [b, s, h, d] and k [b, s, hk, d] (neox half-split form)
    by the rows of the fp32 tables cos/sin [max_pos, d] at ``positions``
    [b, s] int64 (0..s-1 when None). Returns new contiguous (q, k).

    q and k may be strided views (the split of a fused qkv projection):
    only their last dimension must be contiguous; they are read in place."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_rope kernel needs CUDA tensors, got "
                         f"{q.device}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q and k must be [b, s, heads, d]")
    b, s, h, d = q.shape
    hk = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != d or d % 2:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} must "
                         f"share b, s and an even d")
    if k.dtype != q.dtype or k.device != q.device:
        raise ValueError("q and k must share dtype and device")
    if q.stride(-1) != 1 or k.stride(-1) != 1:
        raise ValueError("q and k need a contiguous last dimension")
    for name, t in (("cos", cos), ("sin", sin)):
        if (t.dtype != torch.float32 or t.device != q.device
                or not t.is_contiguous() or t.dim() != 2
                or t.shape[1] != d):
            raise ValueError(f"{name} must be a contiguous fp32 [max_pos, "
                             f"{d}] table on {q.device}")
    if cos.shape != sin.shape:
        raise ValueError("cos and sin tables differ in shape")
    if positions is not None and (
            positions.dtype != torch.int64 or positions.shape != (b, s)
            or not positions.is_contiguous()
            or positions.device != q.device):
        raise ValueError(f"positions must be contiguous int64 [{b}, {s}] "
                         f"on {q.device}")
    code = _build.dtype_code(q.dtype)
    qo = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    ko = torch.empty((b, s, hk, d), dtype=k.dtype, device=k.device)
    if b * s == 0:
        return qo, ko
    p = plan(b * s, h, hk, d, q.dtype, vector_aligned(q, k, cos, sin),
             _build.sm_count(q.device))
    err = _build.lib().pt_fused_rope(
        q.data_ptr(), k.data_ptr(), qo.data_ptr(), ko.data_ptr(),
        cos.data_ptr(), sin.data_ptr(),
        positions.data_ptr() if positions is not None else None,
        b, s, h, hk, d, q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2), cos.shape[0], code,
        ROUTES[p.route], p.heads, p.blocks, p.threads,
        _build.stream_ptr(q.device))
    _build.check(err, "fused_rope")
    _build.count_launch("fused_rope")
    _build.count_launch(f"fused_rope_{p.route}")
    return qo, ko


__all__ = ["fused_rope", "plan", "unit_map", "vector_aligned", "RopePlan",
           "SOURCE", "REPLACES"]
