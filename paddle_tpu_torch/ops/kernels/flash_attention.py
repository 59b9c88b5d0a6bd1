"""Launch wrappers of the flash-attention kernels
(``csrc/flash_attention.cu``).

Replace ``paddle_tpu/ops/pallas/flash_attention.py`` ``_fwd_kernel``,
``_bwd_dq_kernel`` and ``_bwd_dkv_kernel``. The plain versions are
``ops.attention._flash_fwd_plain`` / ``_flash_bwd_plain``;
``ops.attention.flash_attention`` chooses between the two by the
tensors' device.

q is [b, sq, h, d]; k and v are [b, sk, hk, d] with h a multiple of hk.
They may be strided views (v is a split of the fused qkv projection):
only the last dimension must be contiguous. Outputs are contiguous.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/flash_attention.cu"
REPLACES = {"flash_fwd": "paddle_tpu/ops/pallas/flash_attention.py:141",
            "flash_bwd_dq": "paddle_tpu/ops/pallas/flash_attention.py:291",
            "flash_bwd_dkv": "paddle_tpu/ops/pallas/flash_attention.py:348"}
HEAD_DIMS = (32, 64, 128)


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
    if q_seg is not None:
        for t, s in ((q_seg, sq), (kv_seg, sk)):
            if (t.dtype != torch.int32 or t.shape != (b, s)
                    or not t.is_contiguous() or t.device != q.device):
                raise ValueError(f"segment ids must be contiguous int32 "
                                 f"[{b}, {s}] on {q.device}")


def _launch(fn_name: str, q, k, v, dout, q_seg, kv_seg, lse_in, delta,
            outs, causal, scale, dropout_p, seed):
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    out, lse, dq, dk, dv = outs
    keep_div = 1.0 - dropout_p
    # rows of q, k, v, dout on 16-byte boundaries: the bf16 kernels copy
    # them 8 elements at a time
    rows = [q, k, v] + ([dout] if dout is not None else [])
    vec = all(t.data_ptr() % 16 == 0
              and all(st % 8 == 0 for st in t.stride()[:3]) for t in rows)
    err = getattr(_build.lib(), fn_name)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(dout), ptr(q_seg),
        ptr(kv_seg), ptr(lse_in), ptr(delta), ptr(out), ptr(lse), ptr(dq),
        ptr(dk), ptr(dv), b, h, hk, sq, sk, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        float(scale), int(bool(causal)), int(dropout_p > 0.0),
        int(seed) & 0xFFFFFFFF, dropout_threshold(dropout_p), keep_div,
        1.0 / keep_div, int(vec), _build.dtype_code(q.dtype),
        _build.stream_ptr(q.device))
    _build.check(err, fn_name)
    _build.count_launch(fn_name[3:])


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


def flash_bwd_dq(q, k, v, dout, lse, delta, causal: bool, scale: float,
                 q_seg=None, kv_seg=None, dropout_p: float = 0.0,
                 seed: int = 0) -> torch.Tensor:
    """dq [b, sq, h, d] in q's dtype from the forward's ``lse`` and
    ``delta = rowsum(out * dout)`` [b, h, sq] fp32."""
    _check(q, k, v, causal, q_seg, kv_seg)
    _check_bwd(q, dout, lse, delta)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    if dq.numel() == 0:
        return dq
    _launch("pt_flash_bwd_dq", q, k, v, dout, q_seg, kv_seg, lse, delta,
            (None, None, dq, None, None), causal, scale, dropout_p, seed)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal: bool, scale: float,
                  q_seg=None, kv_seg=None, dropout_p: float = 0.0,
                  seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) [b, sk, hk, d] in k's dtype, summed over each KV head's
    group of query heads inside the kernel."""
    _check(q, k, v, causal, q_seg, kv_seg)
    _check_bwd(q, dout, lse, delta)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if dk.numel() == 0:
        return dk, dv
    _launch("pt_flash_bwd_dkv", q, k, v, dout, q_seg, kv_seg, lse, delta,
            (None, None, None, dk, dv), causal, scale, dropout_p, seed)
    return dk, dv


__all__ = ["flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
           "dropout_threshold", "SOURCE", "REPLACES", "HEAD_DIMS"]
