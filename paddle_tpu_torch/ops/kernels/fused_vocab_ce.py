"""Launch wrappers of the fused vocabulary-projection + cross-entropy
kernels (``csrc/fused_vocab_ce.cu``).

Replace ``paddle_tpu/ops/pallas/fused_vocab_ce.py`` ``_fwd_kernel``,
``_bwd_dh_kernel`` and ``_bwd_dw_kernel``, whose shared logits
recompute ``_dlog_block`` becomes a kernel of its own (``vocab_ce_dlog``)
that writes dlog once per vocabulary chunk for both products. The plain
versions are ``ops.vocab_ce._fwd_plain`` / ``_bwd_plain``;
``ops.vocab_ce.lse_and_target`` chooses between kernels and plain
versions by the tensors' device.

h is [N, H] and W [H, V], contiguous, one element type (float32 or
bfloat16); labels [N] int32 (a label outside [0, V) has target 0). The
bf16 kernels read their operands by TMA, which needs 16-byte aligned
bases and row strides: H, W's V and the dlog workspace's width a
multiple of 8 (:func:`vocab_ce_fwd` and :func:`vocab_ce_bwd` pad W, the
backward rounds the workspace, and the single-launch backward wrappers
raise).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import _build

SOURCE = "paddle_tpu_torch/csrc/fused_vocab_ce.cu"
REPLACES = {"vocab_ce_fwd": "paddle_tpu/ops/pallas/fused_vocab_ce.py:179",
            "vocab_ce_dlog": "paddle_tpu/ops/pallas/fused_vocab_ce.py:249",
            "vocab_ce_dh": "paddle_tpu/ops/pallas/fused_vocab_ce.py:265",
            "vocab_ce_dw": "paddle_tpu/ops/pallas/fused_vocab_ce.py:287"}
# vocabulary columns per backward chunk: the dlog workspace is [N, CHUNK]
# in the element type (128 MB at N = 8192 in bf16, against 2.1 GB of
# bf16 logits), and the backward launches dlog, dh and dW once a chunk
CHUNK = 8192
# the dlog workspace's width is a multiple of this many columns (one
# 128-byte TMA box of bf16)
WORKSPACE_ALIGN = 64
# the bf16 backward reads W with a row stride of a multiple of this many
# columns (16 bytes)
VOCAB_PAD = 8


def _cuda(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.device.type != "cuda":
            raise ValueError(f"{name} kernel needs CUDA tensors, got "
                             f"{t.device}")


def _check_hw(h: torch.Tensor, w: torch.Tensor) -> int:
    """Shapes, types, device and layout of h [N, H] and W [H, V]; returns
    the element type code."""
    _cuda("vocab_ce", h, w)
    if h.dim() != 2 or w.dim() != 2 or w.shape[0] != h.shape[1]:
        raise ValueError(f"h must be [N, H] and w [H, V], got "
                         f"{tuple(h.shape)} and {tuple(w.shape)}")
    if w.dtype != h.dtype or w.device != h.device:
        raise ValueError("h and w must share dtype and device")
    if not (h.is_contiguous() and w.is_contiguous()):
        raise ValueError("vocab_ce kernels need contiguous h and w")
    return _build.dtype_code(h.dtype)


def _check_rows(n: int, device, **rows: torch.Tensor) -> None:
    for name, (t, dt) in rows.items():
        if (t.dtype != dt or t.shape != (n,) or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{name} must be contiguous {dt} [{n}] on "
                             f"{device}")


def _check_chunk(c0: int, cw: int, C: int, V: int) -> None:
    """Columns c0 .. c0 + cw - 1 lie in the vocabulary and fit a
    workspace of C columns."""
    if not (0 <= c0 and 0 < cw <= C and c0 + cw <= V):
        raise ValueError(f"chunk [{c0}, {c0 + cw}) does not fit V={V} and "
                         f"C={C}")


def _check_tma(name: str, code: int, tensors=(), **extents: int) -> None:
    """bf16: every extent named (a row length or leading dimension) a
    multiple of 8 elements and every base 16-byte aligned, as TMA reads
    them; fp32 takes anything."""
    if code != 1:
        return
    bad = [f"{k}={v}" for k, v in extents.items() if v % 8]
    bad += [f"a base at {t.data_ptr():#x}" for t in tensors
            if t.data_ptr() % 16]
    if bad:
        raise ValueError(f"{name} (bf16, TMA) needs multiples of 8 elements "
                         f"and 16-byte aligned bases, got " + ", ".join(bad))


def _workspace_ld(c: int) -> int:
    """The dlog workspace's leading dimension for chunks of c columns:
    c rounded up to a multiple of :data:`WORKSPACE_ALIGN`."""
    return -(-c // WORKSPACE_ALIGN) * WORKSPACE_ALIGN


def _chunk_plan(v: int, c: int):
    """``[(c0, cw), ...]``: the vocabulary [0, v) in chunks of at most c
    columns, in order."""
    return [(c0, min(c, v - c0)) for c0 in range(0, v, c)]


def _pad_vocab(w: torch.Tensor) -> torch.Tensor:
    """W [H, V] with zero columns appended up to a multiple of
    :data:`VOCAB_PAD` (``paddle_tpu``'s ``_pad_vocab``); W itself when V
    is one already."""
    v = w.shape[1]
    pad = -v % VOCAB_PAD
    if pad == 0:
        return w
    return torch.nn.functional.pad(w, (0, pad))


def route(dtype) -> str:
    """The forward's kernel route: "wgmma" for bfloat16 (the TMA +
    ``wgmma`` mainloop with a row-reducing epilogue, one partial a
    256-column tile), "fma" for float32 (the tile loop's fp32 FMAs, a
    few vocabulary splits a row tile)."""
    return "wgmma" if dtype == torch.bfloat16 else "fma"


def merge_partials(part: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lse, tgt)`` [N] from the forward's partials part [3, P, N]: per
    row, P partial maxima m, sums s of exp(logit - m) and target logits
    t (0 where the label lies elsewhere), merged in partial order. A row
    whose sums are all 0 gets lse = its largest m."""
    m, s, t = part
    top = m.max(0).values
    total = (s * torch.exp(m - top)).sum(0)
    return top + torch.log(torch.where(total == 0.0, 1.0, total)), t.sum(0)


def vocab_ce_fwd(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(lse, tgt)`` fp32 [N]: log-sum-exp over the vocabulary of
    h . W and the logit at each row's label. The kernel leaves (m, s, t)
    partials, one a column tile (bf16) or vocabulary split (fp32); they
    are merged here (:func:`merge_partials`, O(N x partials)). bf16 needs
    H a multiple of 8 and 16-byte aligned bases (TMA); W is read from a
    copy padded to :data:`VOCAB_PAD` columns where V is not a multiple
    of it. Counts its launches under ``vocab_ce_fwd`` and
    ``vocab_ce_fwd_<route>``."""
    code = _check_hw(h, w)
    N, H = h.shape
    V = w.shape[1]
    _check_rows(N, h.device, labels=(labels, torch.int32))
    _check_tma("vocab_ce_fwd", code, (h, w), H=H)
    if N == 0:
        z = torch.zeros((0,), dtype=torch.float32, device=h.device)
        return z, z.clone()
    lib = _build.lib()
    parts = lib.pt_vocab_ce_splits(N, V, code)
    if parts < 1:
        _build.check(-parts, "vocab_ce_fwd")
    wk = _pad_vocab(w) if code == 1 else w
    part = torch.empty((3, parts, N), dtype=torch.float32, device=h.device)
    err = lib.pt_vocab_ce_fwd(
        h.data_ptr(), wk.data_ptr(), labels.data_ptr(), part.data_ptr(), N,
        H, V, wk.shape[1], parts, code, _build.stream_ptr(h.device))
    _build.check(err, "vocab_ce_fwd")
    _build.count_launch("vocab_ce_fwd")
    _build.count_launch(f"vocab_ce_fwd_{route(h.dtype)}")
    return merge_partials(part)


def vocab_ce_dlog(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                  lse: torch.Tensor, g_lse: torch.Tensor,
                  g_tgt: torch.Tensor, c0: int, cw: int,
                  dlog: torch.Tensor) -> torch.Tensor:
    """Fill ``dlog[:, :cw]`` (a [N, C] workspace in h's dtype) with the
    logits cotangent of vocabulary columns c0 .. c0 + cw - 1:
    g_lse * exp(h . W - lse) + g_tgt * onehot(label), rounded to h's
    dtype. Returns ``dlog``."""
    code = _check_hw(h, w)
    N, H = h.shape
    V = w.shape[1]
    f32 = torch.float32
    _check_rows(N, h.device, labels=(labels, torch.int32), lse=(lse, f32),
                g_lse=(g_lse, f32), g_tgt=(g_tgt, f32))
    C = dlog.shape[1] if dlog.dim() == 2 else -1
    if (dlog.shape != (N, C) or dlog.dtype != h.dtype
            or not dlog.is_contiguous() or dlog.device != h.device):
        raise ValueError(f"dlog must be a contiguous {h.dtype} [{N}, C] "
                         f"workspace on {h.device}")
    _check_chunk(c0, cw, C, V)
    _check_tma("vocab_ce_dlog", code, (h, w, dlog), H=H, V=V, C=C)
    err = _build.lib().pt_vocab_ce_dlog(
        h.data_ptr(), w.data_ptr(), labels.data_ptr(), lse.data_ptr(),
        g_lse.data_ptr(), g_tgt.data_ptr(), dlog.data_ptr(), N, H, V, c0, C,
        cw, code, _build.stream_ptr(h.device))
    _build.check(err, "vocab_ce_dlog")
    _build.count_launch("vocab_ce_dlog")
    return dlog


def vocab_ce_dh(dlog: torch.Tensor, w: torch.Tensor, c0: int, cw: int,
                out: torch.Tensor, acc: Optional[torch.Tensor] = None,
                first: bool = True, last: bool = True) -> torch.Tensor:
    """dh of one chunk: ``dlog[:, :cw] . W[:, c0 .. c0 + cw)^T`` added to
    the fp32 sums ``acc`` [N, H] of the earlier chunks (none when
    ``first``); written to ``acc``, or, for the ``last`` chunk, to
    ``out`` [N, H] in W's dtype. ``acc`` may be ``out`` when that is
    fp32. Returns ``out``."""
    _cuda("vocab_ce_dh", dlog, w, out)
    if w.dim() != 2 or dlog.dim() != 2 or not w.is_contiguous():
        raise ValueError("w must be a contiguous [H, V] and dlog [N, C]")
    H, V = w.shape
    N, C = dlog.shape
    code = _build.dtype_code(w.dtype)
    for name, t in (("dlog", dlog), ("out", out)):
        if t.dtype != w.dtype or not t.is_contiguous() \
                or t.device != w.device:
            raise ValueError(f"{name} must be contiguous {w.dtype} on "
                             f"{w.device}")
    if out.shape != (N, H):
        raise ValueError(f"out must be [{N}, {H}], got {tuple(out.shape)}")
    if not (first and last) and (
            acc is None or acc.dtype != torch.float32 or acc.shape != (N, H)
            or not acc.is_contiguous() or acc.device != w.device):
        raise ValueError(f"a chunk that is not both first and last needs "
                         f"a contiguous fp32 [{N}, {H}] acc on {w.device}")
    _check_chunk(c0, cw, C, V)
    _check_tma("vocab_ce_dh", code,
               (dlog, w, out) + ((acc,) if acc is not None else ()),
               H=H, V=V, C=C)
    err = _build.lib().pt_vocab_ce_dh(
        dlog.data_ptr(), w.data_ptr(),
        acc.data_ptr() if acc is not None else None, out.data_ptr(), N, H, V,
        c0, C, cw, int(first), int(last), code, _build.stream_ptr(w.device))
    _build.check(err, "vocab_ce_dh")
    _build.count_launch("vocab_ce_dh")
    return out


def vocab_ce_dw(h: torch.Tensor, dlog: torch.Tensor, c0: int, cw: int,
                out: torch.Tensor) -> torch.Tensor:
    """Write ``out[:, c0 .. c0 + cw) = h^T . dlog[:, :cw]`` (fp32 sums,
    out [H, V] in h's dtype). Returns ``out``."""
    _cuda("vocab_ce_dw", h, dlog, out)
    if h.dim() != 2 or dlog.dim() != 2 or out.dim() != 2:
        raise ValueError("h must be [N, H], dlog [N, C] and out [H, V]")
    N, H = h.shape
    C = dlog.shape[1]
    V = out.shape[1]
    code = _build.dtype_code(h.dtype)
    for name, t in (("h", h), ("dlog", dlog), ("out", out)):
        if t.dtype != h.dtype or not t.is_contiguous() \
                or t.device != h.device:
            raise ValueError(f"{name} must be contiguous {h.dtype} on "
                             f"{h.device}")
    if dlog.shape[0] != N or out.shape[0] != H:
        raise ValueError(f"dlog must be [{N}, C] and out [{H}, V]")
    _check_chunk(c0, cw, C, V)
    _check_tma("vocab_ce_dw", code, (h, dlog, out), H=H, C=C)
    err = _build.lib().pt_vocab_ce_dw(
        h.data_ptr(), dlog.data_ptr(), out.data_ptr(), N, H, V, c0, C, cw,
        code, _build.stream_ptr(h.device))
    _build.check(err, "vocab_ce_dw")
    _build.count_launch("vocab_ce_dw")
    return out


def vocab_ce_bwd(h: torch.Tensor, w: torch.Tensor, labels: torch.Tensor,
                 lse: torch.Tensor, g_lse: torch.Tensor, g_tgt: torch.Tensor,
                 want_dh: bool = True, want_dw: bool = True
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``(dh, dW)`` of ``(lse, tgt)`` for the cotangents g_lse, g_tgt
    (fp32 [N]): per vocabulary chunk of :data:`CHUNK` columns, the dlog
    kernel, then the dh and dW kernels on its workspace. dh [N, H] in h's
    dtype (fp32 sums across chunks), dW [H, V] in W's dtype; either is
    None when not wanted. In bf16 the kernels read a copy of W padded to
    :data:`VOCAB_PAD` columns where V is not a multiple of it."""
    code = _check_hw(h, w)
    N, H = h.shape
    V = w.shape[1]
    if not (want_dh or want_dw):
        return None, None
    dh = torch.empty_like(h) if want_dh else None
    dw = torch.empty_like(w) if want_dw else None
    if N == 0:
        return (dh, dw.zero_() if dw is not None else None)
    plan = _chunk_plan(V, min(CHUNK, V))
    wk = _pad_vocab(w) if code == 1 else w
    dlog = torch.empty((N, _workspace_ld(plan[0][1])), dtype=h.dtype,
                       device=h.device)
    acc = None
    if want_dh and len(plan) > 1:
        acc = dh if h.dtype == torch.float32 else torch.empty(
            (N, H), dtype=torch.float32, device=h.device)
    for i, (c0, cw) in enumerate(plan):
        vocab_ce_dlog(h, wk, labels, lse, g_lse, g_tgt, c0, cw, dlog)
        if want_dh:
            vocab_ce_dh(dlog, wk, c0, cw, dh, acc, first=i == 0,
                        last=i == len(plan) - 1)
        if want_dw:
            vocab_ce_dw(h, dlog, c0, cw, dw)
    return dh, dw


__all__ = ["vocab_ce_fwd", "vocab_ce_dlog", "vocab_ce_dh", "vocab_ce_dw",
           "vocab_ce_bwd", "route", "merge_partials", "SOURCE", "REPLACES",
           "CHUNK", "VOCAB_PAD", "WORKSPACE_ALIGN"]
