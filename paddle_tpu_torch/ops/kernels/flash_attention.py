"""Launch wrappers of the flash-attention kernels
(``csrc/flash_attention.cu``).

Replace ``paddle_tpu/ops/pallas/flash_attention.py`` ``_fwd_kernel``
(:func:`flash_fwd`) and ``_bwd_dq_kernel`` with ``_bwd_dkv_kernel``
(:func:`flash_bwd`). The plain versions are
``ops.attention._flash_fwd_plain`` / ``_flash_bwd_plain``;
``ops.attention.flash_attention`` chooses between the two by the
tensors' device.

q is [b, sq, h, d]; k and v are [b, sk, hk, d] with h a multiple of hk.
They may be strided views (v is a split of the fused qkv projection):
only the last dimension must be contiguous. Outputs are contiguous.

bf16 goes to the Hopper kernels, which read q, k, v and dout by TMA:
their base addresses and strides must be multiples of 16 bytes, and the
wrappers raise where they are not (they never copy). The bf16 backward
is one kernel that adds dq into a zeroed fp32 workspace of contiguous
64-row query tiles (:func:`dq_workspace`), then permuted and cast to
bf16; the adds into each query tile go in ascending key tiles, ordered
by a counter per tile that follows the workspace, so dq is the same
bits in every run. fp32 goes to the FMA kernels (the backward as two
launches, dq and dk/dv). Every route is deterministic.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
REPLACES = {"flash_fwd": "paddle_tpu/ops/pallas/flash_attention.py:141",
            "flash_bwd": "paddle_tpu/ops/pallas/flash_attention.py:291,348"}
HEAD_DIMS = (32, 64, 128)
# a launch returns _MAP_REFUSED + i when cuTensorMapEncodeTiled refuses
# tensor map i
_MAP_REFUSED = 10000
_MAPS = ("q", "k", "v", "dout", "lse and delta")


def dropout_threshold(p: float) -> int:
    """The uint32 keep threshold of ``_dropout_keep``: a cell is kept
    where its hash is >= this."""
    return min(int(p * 4294967296.0), 4294967295)


def _check(q, k, v, causal, q_seg, kv_seg):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash kernel needs CUDA tensors, got {name} "
                             f"on {t.device}")
        if t.dim() != 4 or t.stride(-1) != 1:
            raise ValueError(f"{name} must be [b, s, heads, d] with a "
                             f"contiguous last dimension")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not agree")
    if h % hk:
        raise ValueError(f"{h} query heads are not a multiple of {hk} KV "
                         f"heads")
    if k.dtype != q.dtype or v.dtype != q.dtype or k.device != q.device \
            or v.device != q.device:
        raise ValueError("q, k and v must share dtype and device")
    if d not in HEAD_DIMS:
        raise NotImplementedError(f"flash kernel takes head_dim in "
                                  f"{HEAD_DIMS}, got {d}")
    if causal and sq > sk:
        raise NotImplementedError("causal attention with sq > sk leaves "
                                  "query rows with no key")
    if (q_seg is None) != (kv_seg is None):
        raise ValueError("pass both segment id tensors or neither")
    if q.dtype == torch.bfloat16:
        _check_tma(q=q, k=k, v=v)
    if q_seg is not None:
        for t, s in ((q_seg, sq), (kv_seg, sk)):
            if (t.dtype != torch.int32 or t.shape != (b, s)
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"segment ids must be contiguous int32 "
                                 f"[{b}, {s}] on {q.device}")


def _check_tma(**tensors):
    """TMA reads rows from 16-byte aligned addresses and strides."""
    for name, t in tensors.items():
        if t.data_ptr() % 16 or any(
                st * t.element_size() % 16 for st in t.stride()[:3]):
            raise ValueError(f"bf16 flash kernels read {name} by TMA: its "
                             f"address and strides {tuple(t.stride())} "
                             f"must be multiples of 16 bytes")


def _launch(fn_name: str, q, k, v, dout, q_seg, kv_seg, lse_in, delta,
            outs, causal, scale, dropout_p, seed):
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    out, lse, dq, dk, dv = outs
    keep_div = 1.0 - dropout_p
    err = getattr(_build.lib(), fn_name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(dout), ptr(q_seg),
        ptr(kv_seg), ptr(lse_in), ptr(delta), ptr(out), ptr(lse), ptr(dq),
        ptr(dk), ptr(dv), b, h, hk, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), int(bool(causal)), int(dropout_p > 0.0),
        int(seed) & 0xFFFFFFFF, dropout_threshold(dropout_p), keep_div,
        1.0 / keep_div, _build.dtype_code(q.dtype),
        _build.stream_ptr(q.device))
    if err >= _MAP_REFUSED:
        raise RuntimeError(f"{fn_name}: cuTensorMapEncodeTiled refused the "
                           f"TMA tensor map of {_MAPS[err - _MAP_REFUSED]}")
    _build.check(err, fn_name)


def flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              causal: bool, scale: float,
              q_seg: Optional[torch.Tensor] = None,
              kv_seg: Optional[torch.Tensor] = None,
              dropout_p: float = 0.0, seed: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [b, sq, h, d] in q's dtype, lse [b, h, sq] fp32)``.
    ``q_seg`` [b, sq] / ``kv_seg`` [b, sk] int32 restrict attention to
    equal ids; ``dropout_p`` > 0 drops with the keep mask of ``seed``."""
    _check(q, k, v, causal, q_seg, kv_seg)
    b, sq, h, d = q.shape
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    _launch("pt_flash_fwd", q, k, v, None, q_seg, kv_seg, None, None,
            (out, lse, None, None, None), causal, scale, dropout_p, seed)
    _build.count_launch("flash_fwd")
    return out, lse


def _check_bwd(q, dout, lse, delta):
    b, sq, h, _ = q.shape
    if dout.shape != q.shape or dout.dtype != q.dtype \
            or not dout.is_contiguous() or dout.device != q.device:
        raise ValueError("dout must be contiguous, shaped and typed as q")
    for name, t in (("lse", lse), ("delta", delta)):
        if (t.dtype != torch.float32 or t.shape != (b, h, sq)
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError(f"{name} must be contiguous fp32 [{b}, {h}, "
                             f"{sq}] on {q.device}")


def dq_workspace(q: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 backward's zeroed buffer: the fp32 dq workspace, one
    contiguous [64, PW] block per (batch, head, 64-row query tile, panel
    of PW = 64 columns, 32 at d = 32), then one int32 counter per (batch,
    head, query tile) that orders the adds. Returns (the buffer, the
    workspace viewed as [b, query tile, 64, h, panel, PW], which is dq's
    [b, sq, h, d] order up to the pad rows past sq)."""
    b, sq, h, d = q.shape
    nq, pw = -(-sq // 64), min(d, 64)
    tiles = b * h * nq
    buf = torch.zeros(tiles * 64 * d + tiles, dtype=torch.float32,
                      device=q.device)
    ws = buf[:tiles * 64 * d].view(b, h, nq, d // pw, 64, pw).permute(
        0, 2, 4, 1, 3, 5)                      # [b, nq, 64, h, panel, pw]
    return buf, ws


def _dq_from_workspace(ws: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    b, sq, h, d = q.shape
    nq = ws.shape[1]
    dq = torch.empty((b, nq * 64, h, d), dtype=q.dtype, device=q.device)
    dq.view(ws.shape).copy_(ws)
    return dq if nq * 64 == sq else dq[:, :sq].contiguous()


def flash_bwd(q, k, v, dout, lse, delta, causal: bool, scale: float,
              q_seg=None, kv_seg=None, dropout_p: float = 0.0,
              seed: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(dq [b, sq, h, d], dk, dv [b, sk, hk, d])`` in q's dtype from the
    forward's ``lse`` and ``delta = rowsum(out * dout)`` [b, h, sq] fp32;
    dk and dv summed over each KV head's group of query heads inside the
    kernel. bf16: one launch, dq through an fp32 workspace summed in a
    fixed order (the same bits every run); fp32: the dq
    and dk/dv kernels. Counted as one ``flash_bwd`` launch either way."""
    _check(q, k, v, causal, q_seg, kv_seg)
    _check_bwd(q, dout, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    args = (causal, scale, dropout_p, seed)
    if q.dtype == torch.bfloat16:
        buf, ws = dq_workspace(q)
        if ws.numel() and dk.numel():
            _check_tma(dout=dout)
            if lse.data_ptr() % 16 or delta.data_ptr() % 16:
                raise ValueError("bf16 flash backward reads lse and delta "
                                 "by TMA: their addresses must be "
                                 "multiples of 16 bytes")
            _launch("pt_flash_bwd", q, k, v, dout, q_seg, kv_seg, lse, delta,
                    (None, None, buf, dk, dv), *args)
            _build.count_launch("flash_bwd")
        else:
            dk.zero_()
            dv.zero_()
        return _dq_from_workspace(ws, q), dk, dv
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0 or dk.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    _launch("pt_flash_bwd_dq", q, k, v, dout, q_seg, kv_seg, lse, delta,
            (None, None, dq, None, None), *args)
    _launch("pt_flash_bwd_dkv", q, k, v, dout, q_seg, kv_seg, lse, delta,
            (None, None, None, dk, dv), *args)
    _build.count_launch("flash_bwd")
    return dq, dk, dv


__all__ = ["flash_fwd", "flash_bwd", "dq_workspace",
           "dropout_threshold", "SOURCE", "REPLACES", "HEAD_DIMS"]
