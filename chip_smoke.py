#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``paddle_tpu_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

``python3 chip_smoke.py --parent DIR``, with the parent commit's tree
unpacked in DIR, also times the parent's int8 (decode and prefill),
grouped, paged decode, CE, RMSNorm forward and RoPE kernels against this
tree's in turns after phase 3 (the CE backward's outputs must be equal
bit for bit). ``--sweep`` also times the RMSNorm forward and RoPE under
other plan constants in phase 3 (``norm_rope_plan_sweep``, each held
bit for bit to the default plan's output).

Phases, in order; any failure exits non-zero before the result line:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``paddle_tpu_torch/csrc`` and print the
     build seconds;
  3. per kernel: run it and its plain PyTorch version on the serving
     and training paths' shapes, print the errors against the stated
     tolerance (the flash kernels and bf16 paged decode also per row,
     and a planted wrong tile or page must fail that check), and time
     kernel, plain version and library call (CUDA events, L2 flushed and
     the host given a head start before every launch, median of 25 after
     warm-up; 10 for slow plain versions). First the launch floor: an
     empty kernel timed the same way. The RMSNorm and RoPE forwards at
     a decode step (B = 8), a 1024-token prefill and a training step
     (8192 x 4096 and DeepSeekMoE's 8192 x 2048; b = 2, s = 4096 at
     32/8 and 16/16 heads), RMSNorm's rstd held to 1e-5; a row with its
     last vector dropped and decode positions off by one must fail those
     checks; their launches a call and launches x the gap to
     max(bound, floor) read after phase 9 (``norm_rope_gaps``). Training
     kernels: the RMSNorm backward at 8192 x 4096; the flash forward and backward at
     b=2, s=4096, 32 heads over 8 KV heads, d=128, bf16, causal (with
     TFLOP/s; a K/V tile planted in place of another must break out and
     dq, a Q/dO/lse/delta tile dk and dv); flash also in fp32 at s=1024,
     with segment ids (fully masked rows included), with dropout p=0.1
     and at a ragged s=1000; the fused vocab-CE kernels
     (forward, dlog, dh, dW) at 8192 tokens x hidden 4096 x vocabulary
     128256 in bf16 (lse/tgt to 1e-4, dlog, dh and dW per row or column,
     and two planted wrong vocabulary blocks that every check must
     reject; the backward's TFLOP/s and share of the bound), dlog, dh and
     dW of one chunk at the DeepSeekMoE-16B head (hidden 2048,
     vocabulary 102400) beside torch.matmul, and in fp32 at 2048 x 1024 x 20000 with ignored rows and a
     tied, transposed W through the autograd Function;
     Quantized serving: the int8 matrix product at the five projections
     of a Llama-3-8B decode step (m = 8, bf16; each also beside a
     streaming read of its weight's bytes), at gate_up with m = 128
     and m = 1024 (prefills, with TFLOP/s and share of the bound) and in
     fp32 at m = 5, n = 384, k = 256, held per 128 columns of each
     output row in bf16 (a weight with one 64-wide k-block swapped and a
     scale vector with one block of channels shifted must fail that
     check at qkv, at down and at the m = 1024 prefill), beside one
     torch.matmul with the bf16 weight; the int8
     paged decode at B = 8, context 1024, page 128 (bf16 and fp32 q, and
     a ragged case with a page never written), per row, where a page
     read with another page's K or V scale must fail; both paged decode
     kernels also at contexts 128 to 2048 beside a streaming read of the
     same K and V bytes;
     MoE: the grouped matmul at the bf16 dropless DeepSeekMoE-16B
     step's shapes (m = 49152 rows, 64 experts; gate_up k 2048, n 2816
     and down k 1408, n 2048; balanced and skewed counts with a quarter
     of the experts empty): forward, dx (the forward kernel reading the
     weight transposed) and dW, per row, with TFLOP/s and share of the
     bound, beside torch._grouped_mm (or a matmul loop where that is
     missing); a planted wrong tile→group and a planted dW row shift must
     fail, and dW must be the same bit for bit on a second run; fp32 at
     a small ragged shape; with --parent, the parent's int8 and grouped
     kernels against this tree's in turns;
  4. engine equality: Llama-3-8B widths at 2 layers, fp32, seeded random
     weights: greedy tokens of the engine on the card equal those of a
     step-by-step plain-version path on the CPU;
  4b. quantized engine equality: the same widths and depth with int8
     weights and int8 KV, the same seeded weights on the card and on the
     CPU: teacher-forced per-step logits within QUANT_LOGIT_TOL, the
     pools' codes equal but for differences of 1 at no more than
     QUANT_CODE_FRAC of them; the two engines' greedy agreement reported;
  5. the serving run: Llama-3-8B widths, all 32 layers, bf16, seeded
     random weights built on the card; 16 requests (prompts 128-1536
     tokens, 64 new tokens, every 4th sampled) through
     ContinuousBatchingEngine(max_batch=8, page_size=128, max_len=2048,
     decode_block=8, async_depth=2). Kernel launch counts are reset just
     before and read just after; every serving kernel must have launched;
     one decode step profiled, with RMSNorm's and RoPE's device us;
  5b. the quantized serving run: the same model quantized on the card
     (int8 weights and KV, the native model then freed) through the same
     run, side by side with phase 5: tokens/s, TTFT, ITL, one decode
     step, launches, model and KV-pool bytes, peak memory, and the greedy
     agreement with phase 5's streams (reported only); every int8
     product of a prefill must take the kernel's wgmma route;
  6. training equality: Llama-3-8B's attention layout (hidden 4096, 32
     heads, 8 KV heads of 128) at 2 layers with the MLP cut to 1024 and
     the vocabulary to 4096, the default (fused) loss head, the same
     seeded weights and batch (segment ids included) on the card
     (kernels) and on the CPU (plain versions): in fp32, first-step
     gradients and 3 AdamW steps' losses agree; in bf16 (the flash
     kernels' Hopper route), the first step's loss and gradients
     agree; in fp32 with recompute "full" and "selective", the card's
     first-step gradients equal those without recompute within 1e-6;
  7. the training run: Llama-3-8B widths at 4 layers, bf16, the default
     configuration (fused vocab-CE head), AdamW(1e-4, weight_decay=0.01)
     with global-norm clip 1.0, batch 2 x 4096 tokens from a numpy seed,
     the same batch every step: 2 warm-up and 8 timed steps through
     Trainer.fit, launch counts reset just before and read just after;
     tokens/s, step time, MFU, peak memory, the device idle share of one
     step, and launches per step. Every training kernel must launch and
     the loss must be finite and fall. Then 2 + 4 steps each of the
     naive head and of recompute "full" and "selective" on the same
     batch (step time, peak memory); the default run's peak memory must
     lie below the naive head's;
  8. MoE equality: one dropless MoELayer at DeepSeekMoE-16B widths,
     forward and backward, under torch.cuda.set_sync_debug_mode("error");
     then DeepSeekMoE-16B's layout at 2 layers (dense MLP 1024,
     vocabulary 4096), dropless, the same seeded weights and batch on the
     card and on the CPU: tokens whose routing ids differ (none in fp32),
     the first step's loss (fp32 rtol 1e-4, bf16 1e-2) and fp32
     gradients (1e-4 of each tensor's largest);
  9. the MoE training run: DeepSeekMoE-16B widths at 4 layers (1 dense +
     3 MoE), bf16, dropless, as phase 7 (2 warm-up + 8 timed steps,
     launch counts, one profiled step: grouped-matmul ms, routing ops,
     idle share); every training kernel and both grouped-matmul kernels
     must launch, every grouped launch on the wgmma route, and the loss
     must be finite and fall. Then 2 + 4 steps at capacity_factor 1.25
     beside it.
The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import json
import math
import os
import statistics
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
TOL = {"float32": (1e-5, 1e-5),
       # bf16: the kernel and the plain version both compute in fp32 and
       # round once to bf16 (step 2**-8 relative); a different summation
       # order or FMA contraction before that rounding may land one bf16
       # step apart
       "bfloat16": (2e-2, 2e-2)}
# The bf16 flash kernels are held per row as well: a row is one head's
# d values of one query (out, dq) or key (dk, dv), and its error is
# |got - want|_2 / (|want|_2 + 1e-3 * the tensor's mean row norm). The
# elementwise bf16 limit above is as large as a typical flash value at
# s = 4096 (about 1/sqrt(context)), so alone it could pass a kernel that
# reads one K/V or Q tile in place of another; phase 3 plants such tiles
# and fails unless this check rejects them. Sound kernels read at most
# 8.1e-3 and planted tiles 0.35 or more (H100 80GB HBM3, 700 W). fp32
# needs no row check: its elementwise limit is far below any wrong
# tile's change.
ROW_TOL = 2e-2
# The vocab-CE kernels' lse and tgt are fp32 sums of exact products on
# both sides (bf16 or fp32 inputs), apart only in summation order: held
# to CE_FP32_TOL absolute, which sound kernels meet with margin and a
# planted wrong vocabulary block breaks by more than 10x (phase 3 prints
# both readings and fails otherwise). bf16 dh is held per row (one
# token's H values) and dW and dlog per column or row as the flash
# tensors are, with ROW_TOL.
CE_FP32_TOL = 1e-4
# Llama-3-8B's int8 projections of a decode step, (n, k)
DECODE_PROJECTIONS = {"qkv": (6144, 4096), "o": (4096, 4096),
                      "gate_up": (28672, 4096), "down": (4096, 14336),
                      "lm_head": (128256, 4096)}
CE_KERNELS = ("vocab_ce_fwd", "vocab_ce_dlog", "vocab_ce_dh", "vocab_ce_dw")
SERVING_KERNELS = ("rms_norm", "fused_rope", "paged_decode")
QUANT_SERVING_KERNELS = ("rms_norm", "fused_rope", "int8_matmul",
                         "paged_decode_int8")
TRAINING_KERNELS = ("rms_norm", "rms_norm_bwd", "fused_rope", "flash_fwd",
                    "flash_bwd") + CE_KERNELS
RESULTS: dict = {"kernel_cases": []}
FAILED_CASES: list = []


def log(*a):
    print(*a, flush=True)


# device cycles (about 0.3 ms) that the card sleeps between the L2 flush
# and a timed launch, so that the host has enqueued the launch before
# the start event is reached: the events then measure the device alone,
# not a wrapper's host time (which exceeds the short kernels' own)
HOST_LEAD_CYCLES = 500_000


def timed_ms(torch, fn, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` in ms, each launch timed
    alone by CUDA events after the L2 cache was flushed and the host was
    given a head start (HOST_LEAD_CYCLES)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(HOST_LEAD_CYCLES)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def compare(torch, got, want, dtype_name):
    atol, rtol = TOL[dtype_name]
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / w.abs().clamp_min(1e-6)).max())
    ok = bool((diff <= atol + rtol * w.abs()).all()) and bool(
        torch.isfinite(g).all())
    return max_abs, max_rel, ok


def row_err(torch, got, want) -> float:
    """The largest per-row relative L2 error of ``got`` (see ROW_TOL)."""
    g, w = got.float().flatten(0, -2), want.float().flatten(0, -2)
    wn = w.norm(dim=-1)
    return float(((g - w).norm(dim=-1) / (wn + 1e-3 * wn.mean())).max())


def flash_compare(torch, pairs, dtype_name):
    """compare() over (got, want) pairs, combined, and the row check:
    (max_abs, max_rel, ok, row error, elementwise ok, row ok)."""
    errs = [compare(torch, g, w, dtype_name) for g, w in pairs]
    row = max(row_err(torch, g, w) for g, w in pairs)
    elem_ok = all(e[2] for e in errs)
    row_ok = dtype_name != "bfloat16" or row <= ROW_TOL
    return (max(e[0] for e in errs), max(e[1] for e in errs),
            elem_ok and row_ok, row, elem_ok, row_ok)


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def empty_cache(torch, dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()


class DeviceSpan:
    """Milliseconds from construction to :meth:`end`: CUDA events on the
    card (device time), the host clock after the work on the CPU."""

    def __init__(self, torch, dev):
        self.cuda = dev.type == "cuda"
        self.t0 = time.perf_counter()
        if self.cuda:
            self.s = torch.cuda.Event(enable_timing=True)
            self.e = torch.cuda.Event(enable_timing=True)
            self.s.record()

    def end(self) -> float:
        if not self.cuda:
            return (time.perf_counter() - self.t0) * 1e3
        self.e.record()
        self.e.synchronize()
        return self.s.elapsed_time(self.e)


def profile_step(torch, dev, step, top=8, sums=None):
    """Device busy time of one call of ``step`` by kernel name, from
    torch.profiler (CUPTI); None where it reports no device time.
    ``sums`` {label: name fragments}: also the summed device us and
    launches of the kernels whose names hold a fragment."""
    if dev.type != "cuda":
        return None
    from torch.profiler import ProfilerActivity, profile
    sync(torch, dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        sync(torch, dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key, ev.self_device_time_total / 1e3, ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0]
    if not rows:
        return None
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    summed = {label: {"us": sum(r[1] for r in rows if any(
        f in r[0] for f in frags)) * 1e3, "launches": sum(
        r[2] for r in rows if any(f in r[0] for f in frags))}
        for label, frags in (sums or {}).items()}
    return {"wall_ms_under_profiler": wall_ms, "device_busy_ms": busy,
            "sums": summed,
            "device_idle_share": 1.0 - busy / wall_ms,
            "kernels": len(rows),
            "launches": sum(r[2] for r in rows),
            "top": [{"name": k[:90], "ms": ms, "count": n}
                    for k, ms, n in rows[:top]]}   # top=None: every kernel


def bound(bytes_, ops, ops_per_s=FP32_OPS_PER_S):
    tb, to = bytes_ / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def us(ms):
    return "-" if ms is None else f"{ms * 1e3:.1f} us"


def record(kernel, case, dt, err, kms=None, pms=None, lms=None,
           bnd=(None, None), tol=None, copy_ms=None):
    """One checked case; the times are None for a case checked only.
    ``err`` is compare()'s triple, or flash_compare()'s six-tuple;
    ``tol`` overrides the printed elementwise tolerance TOL[dt];
    ``copy_ms`` is a streaming copy of the kernel's bytes (read and
    write), timed the same way, where one is kept."""
    max_abs, max_rel, ok = err[:3]
    tol = TOL[dt] if tol is None else tol
    row = dict(kernel=kernel, case=case, dtype=dt, max_abs_err=max_abs,
               max_rel_err=max_rel, tol=tol, ok=ok, ms=kms,
               plain_ms=pms, library_ms=lms, bound_ms=bnd[0],
               bound_by=bnd[1], copy_ms=copy_ms)
    rows = ""
    if len(err) > 3:
        tol = ROW_TOL if dt == "bfloat16" else None
        row.update(row_err=err[3], row_tol=tol)
        rows = f" row_err={err[3]:.3e} row_tol={tol}"
    RESULTS["kernel_cases"].append(row)
    timing = ("not timed" if kms is None else
              f"kernel {us(kms)}, plain {us(pms)}, library {us(lms)}, "
              f"bound {bnd[0] * 1e3:.2f} us ({bnd[1]})"
              + ("" if copy_ms is None else f", copy {us(copy_ms)}"))
    log(f"kernel {kernel} [{case} {dt}] max_abs_err={max_abs:.3e} "
        f"max_rel_err={max_rel:.3e} tol(atol,rtol)={tol}{rows} "
        f"{'ok' if ok else 'FAIL'} | {timing}")
    if not ok:
        FAILED_CASES.append(f"{kernel}/{case}/{dt}")


# The RMSNorm and RoPE forwards' rows: (case, rows, width) and (case,
# (b, s), (q heads, kv heads)); decode and prefill at Llama-3-8B's
# widths, training at Llama-3-8B's and DeepSeekMoE-16B's (the MoE slice
# trains only)
NORM_CASES = (("prefill_1024", 1024, 4096), ("decode_b8", 8, 4096),
              ("train_8192", 8192, 4096), ("train_8192_moe", 8192, 2048))
ROPE_CASES = (("prefill_1024", (1, 1024), (32, 8)),
              ("decode_b8", (8, 1), (32, 8)),
              ("train_4096", (2, 4096), (32, 8)),
              ("train_4096_moe", (2, 4096), (16, 16)))
# the profiler's kernel names of the RMSNorm forward and RoPE routes
NORM_ROPE_KERNELS = {"rms_norm": ("rms_norm_row_kernel",
                                  "rms_norm_vec_kernel"),
                     "fused_rope": ("rope_vec_kernel", "rope_scalar_kernel")}
# rstd is fp32 on both sides, apart only in summation order
RSTD_TOL = 1e-5


def norm_err(torch, got, want, dtype_name):
    """compare() of the RMSNorm forward's y (the dtype's tolerance) and
    rstd (RSTD_TOL), combined: (max_abs, max_rel, ok)."""
    ey = compare(torch, got[0], want[0], dtype_name)
    diff = (got[1] - want[1]).abs()
    er = (float(diff.max()), float((diff / want[1].abs()).max()),
          bool((diff <= RSTD_TOL * (1 + want[1].abs())).all()))
    return max(ey[0], er[0]), max(ey[1], er[1]), ey[2] and er[2]


def planted_norm_vector(torch, fused_norm, x, w, eps, want):
    """The RMSNorm forward run as if it had dropped the last 16-byte
    vector of row 3 (those 8 inputs zeroed): the row check (y and rstd)
    must reject it. Both readings are kept."""
    bad = x.clone()
    bad[3, -8:] = 0
    got = fused_norm.rms_norm_fwd(bad, w, eps, return_rstd=True)
    y_err = compare(torch, got[0], want[0], "bfloat16")
    rstd_err = float(((got[1] - want[1]).abs() / want[1].abs()).max())
    err = norm_err(torch, got, want, "bfloat16")
    RESULTS["planted_norm_vector"] = {"y_max_abs": y_err[0],
                                      "rstd_max_rel": rstd_err,
                                      "rejected": not err[2]}
    log(f"planted RMSNorm fault (last vector of row 3 dropped): y max abs "
        f"{y_err[0]:.3e}, rstd max rel {rstd_err:.3e} (limit {RSTD_TOL}): "
        f"{'rejected' if not err[2] else 'NOT rejected'}")
    if err[2]:
        FAILED_CASES.append("rms_norm/planted_vector_not_rejected")


def planted_rope_position(torch, fused_rope, q, k, cos, sin, pos, want):
    """RoPE at decode run with every position one too far: the check must
    reject it."""
    got = fused_rope.fused_rope(q, k, cos, sin, pos + 1)
    errs = [compare(torch, a, b, "bfloat16") for a, b in zip(got, want)]
    ok = all(e[2] for e in errs)
    RESULTS["planted_rope_position"] = {
        "max_abs": max(e[0] for e in errs), "rejected": not ok}
    log(f"planted RoPE fault (positions off by one): max abs "
        f"{max(e[0] for e in errs):.3e}: "
        f"{'rejected' if not ok else 'NOT rejected'}")
    if ok:
        FAILED_CASES.append("fused_rope/planted_position_not_rejected")


def norm_rope_plan_sweep(torch, dev, g, cos, sin, flush):
    """With ``--sweep``: the RMSNorm forward and RoPE under other plan
    constants, at phase 3's bf16 shapes, each timed as the rows are (us)
    and held bit for bit to the default plan's output (a plan changes no
    arithmetic)."""
    from paddle_tpu_torch.ops.kernels import fused_norm, fused_rope
    rows = {}

    def sweep(label, mod, settings, fn, want):
        saved = {k: getattr(mod, k) for k in settings}
        try:
            for k, v in settings.items():
                setattr(mod, k, v)
            got = fn()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            us_ = timed_ms(torch, fn, flush) * 1e3
        finally:
            for k, v in saved.items():
                setattr(mod, k, v)
        rows[label] = {"us": us_, "bit_equal": same}
        if not same:
            FAILED_CASES.append(f"plan_sweep/{label}_not_bit_equal")
        return us_
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for case, R, width in NORM_CASES:
        x = torch.randn((R, width), generator=g, device=dev).to(
            torch.bfloat16)
        w = 1 + 0.1 * torch.randn((width,), generator=g, device=dev)

        def norm(x=x, w=w):
            return fused_norm.rms_norm_fwd(x, w, 1e-5, return_rstd=True)
        want = norm()
        for bps in ((2,) if R <= sms else (1, 2, 3, 4)):
            sweep(f"rms_norm/{case}/blocks_per_sm{bps}", fused_norm,
                  {"BLOCKS_PER_SM": bps}, norm, want)
    for case, (b, s), (h, hkv) in ROPE_CASES:
        qkv = torch.randn((b, s, (h + 2 * hkv) * 128), generator=g,
                          device=dev).to(torch.bfloat16)
        q = qkv[..., :h * 128].view(b, s, h, 128)
        k = qkv[..., h * 128:(h + hkv) * 128].view(b, s, hkv, 128)
        pos = (None if s > 1 else torch.randint(
            0, 2048, (b, s), generator=g, device=dev))

        def rope(q=q, k=k, pos=pos):
            return fused_rope.fused_rope(q, k, cos, sin, pos)
        want = rope()
        for threads in (64, 128, 256):
            for min_t in (256, 1024, 4096):
                for bps in (4, 16):
                    sweep(f"fused_rope/{case}/threads{threads}/"
                          f"min_threads{min_t}/blocks_per_sm{bps}",
                          fused_rope, {"THREADS": threads,
                                       "MIN_THREADS_PER_SM": min_t,
                                       "BLOCKS_PER_SM": bps}, rope, want)
    RESULTS["norm_rope_plan_sweep"] = rows
    best = {}
    for label, row in rows.items():
        kernel, case = label.split("/")[:2]
        key = f"{kernel}/{case}"
        if key not in best or row["us"] < best[key][1]:
            best[key] = (label, row["us"])
    for key, (label, us_) in best.items():
        log(f"plan sweep, fastest {key}: {label} {us_:.2f} us")


def phase_kernels(torch, pt):
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops import norm as norm_ops
    from paddle_tpu_torch.ops import rope as rope_ops
    from paddle_tpu_torch.ops.kernels import fused_norm, fused_rope
    from paddle_tpu_torch.ops.kernels import paged_attention
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1234)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    H, HKV, HD = 32, 8, 128
    cos, sin = rope_ops.rope_freqs(HD, 8192, 500000.0, device=dev)

    # -- the launch floor: an empty kernel, timed as every row is --------
    from paddle_tpu_torch.ops.kernels import _build
    stream = _build.stream_ptr(dev)
    floor_ms = timed_ms(torch, lambda: _build.check(
        _build.lib().pt_empty(stream), "empty kernel"), flush)
    RESULTS["launch_floor_us"] = floor_ms * 1e3
    log(f"launch floor (an empty kernel, timed as every row): "
        f"{floor_ms * 1e3:.2f} us")

    # -- RMSNorm: prefill 1024 tokens, decode B=8, a training step's
    # 2 x 4096 tokens at Llama's width and at DeepSeekMoE's, fp32 weight;
    # y within the dtype's tolerance and rstd within 1e-5 -------------------
    for case, R, width in NORM_CASES:
        for dt in ((torch.bfloat16, torch.float32) if R == 1024
                   else (torch.bfloat16,)):
            name = str(dt).split(".")[-1]
            x = torch.randn((R, width), generator=g, device=dev).to(dt)
            w = (1 + 0.1 * torch.randn((width,), generator=g, device=dev))
            eps = 1e-5
            want = norm_ops._rms_norm_fwd_plain(x, w, eps)
            err = norm_err(torch, fused_norm.rms_norm_fwd(
                x, w, eps, return_rstd=True), want, name)
            if case == "decode_b8" and dt == torch.bfloat16:
                planted_norm_vector(torch, fused_norm, x, w, eps, want)
            wl = w.to(dt)
            e = x.element_size()
            dst = torch.empty_like(x)
            record("rms_norm", case, name, err,
                   timed_ms(torch, lambda: fused_norm.rms_norm_fwd(
                       x, w, eps), flush),
                   timed_ms(torch, lambda: norm_ops._rms_norm_plain(
                       x, w, eps), flush),
                   timed_ms(torch, lambda: F.rms_norm(x, (width,), wl,
                                                      eps), flush),
                   bound(2 * R * width * e + width * 4, 4 * R * width),
                   copy_ms=timed_ms(torch, lambda: dst.copy_(x), flush))

    # -- RoPE: prefill and training q/k as views of a fused qkv (Llama's
    # heads, and DeepSeekMoE's 16/16 in training), decode with positions
    # -----------------------------------------------------------------------
    for case, (b, s), (h, hkv) in ROPE_CASES:
        for dt in ((torch.bfloat16, torch.float32) if s == 1024
                   else (torch.bfloat16,)):
            name = str(dt).split(".")[-1]
            qkv = torch.randn((b, s, (h + 2 * hkv) * HD), generator=g,
                              device=dev).to(dt)
            q = qkv[..., :h * HD].view(b, s, h, HD)
            k = qkv[..., h * HD:(h + hkv) * HD].view(b, s, hkv, HD)
            pos = (None if s > 1 else torch.randint(
                0, 2048, (b, s), generator=g, device=dev))
            gq, gk = fused_rope.fused_rope(q, k, cos, sin, pos)
            wq, wk = rope_ops._rope_plain(q, k, cos, sin, pos)
            ea = compare(torch, gq, wq, name)
            eb = compare(torch, gk, wk, name)
            err = (max(ea[0], eb[0]), max(ea[1], eb[1]), ea[2] and eb[2])
            if case == "decode_b8" and dt == torch.bfloat16:
                planted_rope_position(torch, fused_rope, q, k, cos, sin,
                                      pos, (wq, wk))
            e = q.element_size()
            nbytes = 2 * b * s * (h + hkv) * HD * e + 2 * b * s * HD * 4
            src = torch.empty((b, s, h + hkv, HD), dtype=dt, device=dev)
            dst = torch.empty_like(src)
            record("fused_rope", case, name, err,
                   timed_ms(torch, lambda: fused_rope.fused_rope(
                       q, k, cos, sin, pos), flush),
                   timed_ms(torch, lambda: rope_ops._rope_plain(
                       q, k, cos, sin, pos), flush),
                   None, bound(nbytes, 3 * b * s * (h + hkv) * HD),
                   copy_ms=timed_ms(torch, lambda: dst.copy_(src), flush))
    if "--sweep" in sys.argv:
        norm_rope_plan_sweep(torch, dev, g, cos, sin, flush)

    # -- paged decode: B=8, page 128, context 1024 -------------------------
    B, page, ctx = 8, 128, 1024
    mp = 2048 // page
    num_pages = B * mp + 1
    for case in ("ctx1024", "ragged"):
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            q = torch.randn((B, H, HD), generator=g, device=dev).to(dt)
            kp = torch.randn((HKV, num_pages, page, HD), generator=g,
                             device=dev).to(dt)
            vp = torch.randn((HKV, num_pages, page, HD), generator=g,
                             device=dev).to(dt)
            perm = torch.randperm(num_pages - 1, generator=g,
                                  device=dev)[:B * mp] + 1
            tables = perm.view(B, mp).to(torch.int32).contiguous()
            if case == "ctx1024":
                lens = torch.full((B,), ctx - 1, dtype=torch.int64,
                                  device=dev)
            else:
                lens = torch.randint(0, 2048, (B,), generator=g,
                                     device=dev)
                lens[0], lens[1] = 0, page - 1
                used = (lens // page + 1)[:, None]
                col = torch.arange(mp, device=dev)[None, :]
                tables = torch.where(col < used, tables,
                                     torch.full_like(tables, -1))
            got = paged_attention.paged_decode(q, kp, vp, tables, lens)
            want = attn_ops.paged_decode_plain(q, kp, vp, tables, lens)
            err = flash_compare(torch, [(got, want)], name)
            if case != "ctx1024":
                record("paged_decode", case, name, err)
                continue
            if dt == torch.bfloat16:
                planted_page(torch, paged_attention, q, kp, vp, tables,
                             lens, want, name)
                paged_sweep(torch, paged_attention, "paged_decode", q, kp,
                            vp, tables, {}, flush)
            # library yardstick: SDPA over the K/V gathered beforehand
            # (gather not timed; the port never calls SDPA)
            safe = tables.long()[:, :ctx // page]
            kg = kp[:, safe].reshape(HKV, B, ctx, HD).transpose(0, 1)
            vg = vp[:, safe].reshape(HKV, B, ctx, HD).transpose(0, 1)
            kg = kg.repeat_interleave(H // HKV, 1).contiguous()
            vg = vg.repeat_interleave(H // HKV, 1).contiguous()
            q4 = q[:, :, None, :]
            e = q.element_size()
            nbytes = (2 * B * H * HD * e + 2 * B * HKV * ctx * HD * e
                      + tables.numel() * 4 + B * 8)
            record("paged_decode", case, name, err,
                   timed_ms(torch, lambda: paged_attention.paged_decode(
                       q, kp, vp, tables, lens), flush),
                   timed_ms(torch, lambda: attn_ops.paged_decode_plain(
                       q, kp, vp, tables, lens), flush),
                   timed_ms(torch, lambda: F.scaled_dot_product_attention(
                       q4, kg, vg), flush),
                   bound(nbytes, 4 * B * H * ctx * HD))
    del flush
    torch.cuda.synchronize()


def planted_page(torch, paged_attention, q, kp, vp, tables, lens, want,
                 name):
    """Run the native paged decode as if row 0's table read its page 5
    in place of its page 3 (a wrong page lookup) and hold the result
    against the plain version of the true table: the row check must
    reject it (one eighth of the context's K and V is another page's)."""
    bad = tables.clone()
    bad[0, 3] = tables[0, 5]
    e = flash_compare(torch, [(paged_attention.paged_decode(
        q, kp, vp, bad, lens), want)], name)
    RESULTS.setdefault("planted_paged", {})["paged_decode/page"] = {
        "row_err": e[3], "row_caught": not e[5], "max_abs_err": e[0]}
    log(f"planted page in paged_decode (row 0 reads its page 5 as page 3): "
        f"max_abs_err={e[0]:.3e}, row_err={e[3]:.3e} vs row_tol {ROW_TOL} "
        f"(row check {'rejects' if not e[5] else 'MISSES'} it)")
    if e[5]:
        FAILED_CASES.append("paged_decode/planted_page_missed")


def paged_sweep(torch, paged_attention, kernel, q, kp, vp, tables, sc,
                flush):
    """The paged decode kernel's time at contexts 128, 512, 1024 and 2048
    (B = 8, the ctx1024 case's pools and tables), each beside one
    streaming read of as many bytes as its K and V (one torch sum over
    an fp32 buffer of that size, under the same L2 flush): the yardstick
    of what reading those bytes costs in this timing."""
    B, HD = q.shape[0], q.shape[2]
    HKV = kp.shape[0]
    ctxs = (128, 512, 1024, 2048)
    per_tok = 2 * B * HKV * HD * kp.element_size()   # K and V bytes a token
    buf = torch.zeros((per_tok * ctxs[-1] // 4,), dtype=torch.float32,
                      device=q.device)
    rows = {}
    for ctx in ctxs:
        lens = torch.full((B,), ctx - 1, dtype=torch.int64, device=q.device)
        n = per_tok * ctx
        flat = buf[:n // 4]
        rows[ctx] = {
            "kernel_ms": timed_ms(torch, lambda: paged_attention.paged_decode(
                q, kp, vp, tables, lens, **sc), flush),
            "stream_read_ms": timed_ms(torch, lambda: flat.sum(), flush),
            "kv_bytes": n}
        log(f"kernel {kernel} sweep [ctx {ctx}]: {us(rows[ctx]['kernel_ms'])}"
            f", a streaming read of its {n / 1e6:.1f} MB "
            f"{us(rows[ctx]['stream_read_ms'])}")
    RESULTS.setdefault("paged_decode_sweep", {})[kernel] = rows


def seg_err(torch, got, want) -> float:
    """row_err() over 128-wide segments of each output row: a row of the
    int8 product is n columns (up to 128256), where one wrong block of
    64 would hide, so each token's output is held 128 columns at a time,
    the length of a flash row."""
    return row_err(torch, got.float().reshape(-1, 128),
                   want.float().reshape(-1, 128))


def int8_compare(torch, got, want, dtype_name):
    """flash_compare()'s six-tuple for the int8 product: elementwise, and
    for bf16 the 128-column segment check (seg_err) against ROW_TOL."""
    e = compare(torch, got, want, dtype_name)
    seg = seg_err(torch, got, want)
    row_ok = dtype_name != "bfloat16" or seg <= ROW_TOL
    return e[0], e[1], e[2] and row_ok, seg, e[2], row_ok


def int8_decode_plan_sweep(torch, g, dev, flush):
    """The int8 decode route at the five projections (m = 8, bf16) under
    other split plans than the default: the plan's cap on blocks an SM
    (BLOCKS_PER_SM) and on a split's k (SPLIT_K_MAX), each plan's output
    held to the plain version, its time as phase 3's."""
    from paddle_tpu_torch.nn.quantized_linear import weight_quantize
    from paddle_tpu_torch.ops import quant as quant_ops
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import int8_matmul as kmm
    default = (kmm.BLOCKS_PER_SM, kmm.SPLIT_K_MAX)
    sms = _build.sm_count(dev)
    rows = {}
    for proj, (n, k) in DECODE_PROJECTIONS.items():
        wq, scale = weight_quantize(0.02 * torch.randn(
            (k, n), generator=g, device=dev))
        x = torch.randn((8, k), generator=g, device=dev).to(torch.bfloat16)
        want = quant_ops.weight_only_plain(x, wq, scale)
        for bps in (1.5, 2.5, 4):
            for kmax in (2048, 4096):
                kmm.BLOCKS_PER_SM, kmm.SPLIT_K_MAX = bps, kmax
                try:
                    err = int8_compare(torch, kmm.int8_matmul(x, wq, scale),
                                       want, "bfloat16")
                    ms = timed_ms(torch, lambda: kmm.int8_matmul(
                        x, wq, scale), flush)
                    plan = kmm.split_plan(8, n, k, sms)
                finally:
                    kmm.BLOCKS_PER_SM, kmm.SPLIT_K_MAX = default
                rows[f"{proj}/bps{bps}/kmax{kmax}"] = {
                    "us": ms * 1e3, "kps": plan[0], "splits": plan[1],
                    "ok": err[2]}
                log(f"int8 decode plan [{proj}, {bps} blocks an SM, splits "
                    f"of at most {kmax} k]: kps {plan[0]}, {plan[1]} "
                    f"splits, {ms * 1e3:.1f} us, "
                    f"{'ok' if err[2] else 'FAIL'}")
                if not err[2]:
                    FAILED_CASES.append(f"int8_matmul/plan_{proj}_{bps}_"
                                        f"{kmax}")
        del wq, scale, x, want
    RESULTS["int8_decode_plan_sweep"] = rows
    torch.cuda.synchronize()


def quant_pages(torch, g, dev, hkv, num_pages, page, hd):
    """Int8 page pools as the model writes them: float pages of varied
    magnitudes (a factor from 0.25 to 4 a page), one absmax scale a
    page, round-half-to-even codes. Returns (codes, scales)."""
    f = torch.randn((hkv, num_pages, page, hd), generator=g, device=dev)
    f *= 0.25 * 16 ** torch.rand((1, num_pages, 1, 1), generator=g,
                                 device=dev)
    s = f.abs().amax(dim=(0, 2, 3)) / 127.0
    codes = torch.round(f / s[None, :, None, None]).clamp_(-127, 127)
    return codes.to(torch.int8), s


def phase_quant_kernels(torch, pt):
    """Phase 3, the quantized-serving kernels. int8_matmul at the five
    projections of a Llama-3-8B decode step (m = 8, bf16; each beside a
    streaming read of its weight's bytes), at gate_up with m = 128 and
    1024 (prefills) and in fp32 at a small ragged shape (m = 5, n = 384,
    k = 256), with planted faults at qkv, at down (k split) and at the
    prefill, and the decode route's plan sweep; the int8 paged decode at
    B = 8, context 1024, page 128 (bf16 and fp32 q, and a ragged case),
    with planted page scales."""
    from paddle_tpu_torch.nn.quantized_linear import weight_quantize
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops import quant as quant_ops
    from paddle_tpu_torch.ops.kernels import int8_matmul as kmm
    from paddle_tpu_torch.ops.kernels import paged_attention
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(2468)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    planted = {}

    def mm_case(case, m, n, k, dt, timed=True, plant=False, read=None):
        name = str(dt).split(".")[-1]
        wq, scale = weight_quantize(0.02 * torch.randn(
            (k, n), generator=g, device=dev))
        x = torch.randn((m, k), generator=g, device=dev).to(dt)
        got = kmm.int8_matmul(x, wq, scale)
        want = quant_ops.weight_only_plain(x, wq, scale)
        err = int8_compare(torch, got, want, name)
        t = (None, None, None)
        bnd = (None, None)
        if timed:
            # the yardstick: one torch.matmul with the bf16 weight of the
            # same [k, n] shape, as the native model runs (twice the
            # weight bytes of the int8 product)
            wbf = (wq.float() * scale[:, None]).t().contiguous().to(dt)
            t = (timed_ms(torch, lambda: kmm.int8_matmul(x, wq, scale),
                          flush),
                 timed_ms(torch, lambda: quant_ops.weight_only_plain(
                     x, wq, scale), flush, reps=10),
                 timed_ms(torch, lambda: torch.matmul(x, wbf), flush))
            e = x.element_size()
            bnd = bound(m * k * e + n * k + 4 * n + m * n * e, 2 * m * n * k,
                        BF16_OPS_PER_S if dt == torch.bfloat16
                        else FP32_OPS_PER_S)
            del wbf
        record("int8_matmul", case, name, err, *t, bnd)
        if read is not None:
            # the yardstick of what reading the weight's bytes costs in
            # this timing: one torch sum over an fp32 buffer of n k bytes,
            # under the same L2 flush
            flat = read[:n * k // 4]
            rd = timed_ms(torch, lambda: flat.sum(), flush)
            RESULTS.setdefault("int8_decode_stream_read", {})[case] = {
                "kernel_ms": t[0], "stream_read_ms": rd, "bound_ms": bnd[0],
                "weight_bytes": n * k}
            log(f"kernel int8_matmul [{case}]: {us(t[0])}, a streaming "
                f"read of its {n * k / 1e6:.1f} MB weight {us(rd)}")
        if timed and m > 16:
            product_rate("int8_matmul", case, 2 * m * n * k, bnd, t[0], t[2],
                    key="gemm_rates")
        if plant:
            # (a) the weight's 64-wide k-block 7 swapped with block 8;
            # (b) the scales of channels 1024..1087 taken from the next
            # 64 channels
            w2 = wq.clone()
            w2[:, 448:512], w2[:, 512:576] = wq[:, 512:576], wq[:, 448:512]
            s2 = scale.clone()
            s2[1024:1088] = scale[1088:1152]
            for what, args in (("k_block_swapped", (x, w2, scale)),
                               ("scale_block_shifted", (x, wq, s2))):
                e = int8_compare(torch, kmm.int8_matmul(*args), want,
                                 name)
                planted[f"{case}/{what}"] = {"seg_err": e[3],
                                             "row_caught": not e[5],
                                             "max_abs_err": e[0]}
                log(f"planted fault in int8_matmul [{case}] ({what}): "
                    f"max_abs_err={e[0]:.3e}, row_err={e[3]:.3e} vs row_tol "
                    f"{ROW_TOL} (row check "
                    f"{'rejects' if not e[5] else 'MISSES'} it)")
                if e[5]:
                    FAILED_CASES.append(f"int8_matmul/{case}/{what}_missed")
        torch.cuda.synchronize()

    read = torch.zeros((max(n * k for n, k in DECODE_PROJECTIONS.values())
                        // 4,), dtype=torch.float32, device=dev)
    for proj, (n, k) in DECODE_PROJECTIONS.items():
        mm_case(f"decode_{proj}", 8, n, k, torch.bfloat16,
                plant=proj in ("qkv", "down"), read=read)
    del read
    int8_decode_plan_sweep(torch, g, dev, flush)
    # prefill: the serving run's shortest prompt and a long one
    mm_case("prefill_gate_up_128", 128, 28672, 4096, torch.bfloat16)
    mm_case("prefill_gate_up_1024", 1024, 28672, 4096, torch.bfloat16,
            plant=True)
    mm_case("ragged_5x384x256", 5, 384, 256, torch.float32, timed=False)
    torch.cuda.empty_cache()

    # -- int8 paged decode: B=8, page 128, context 1024 ---------------------
    B, H, HKV, HD, page, ctx = 8, 32, 8, 128, 128, 1024
    mp = 2048 // page
    num_pages = B * mp + 1
    kp, ks = quant_pages(torch, g, dev, HKV, num_pages, page, HD)
    vp, vs = quant_pages(torch, g, dev, HKV, num_pages, page, HD)
    for case in ("ctx1024", "ragged"):
        for dt in (torch.bfloat16, torch.float32):
            name = str(dt).split(".")[-1]
            q = torch.randn((B, H, HD), generator=g, device=dev).to(dt)
            perm = torch.randperm(num_pages - 1, generator=g,
                                  device=dev)[:B * mp] + 1
            tables = perm.view(B, mp).to(torch.int32).contiguous()
            if case == "ctx1024":
                lens = torch.full((B,), ctx - 1, dtype=torch.int64,
                                  device=dev)
            else:
                lens = torch.randint(0, 2048, (B,), generator=g,
                                     device=dev)
                lens[0], lens[1] = 0, page - 1
                used = (lens // page + 1)[:, None]
                col = torch.arange(mp, device=dev)[None, :]
                tables = torch.where(col < used, tables,
                                     torch.full_like(tables, -1))
                ks[tables[2, 0]] = 0.0          # a page never written
            sc = dict(k_scales=ks, v_scales=vs)
            got = paged_attention.paged_decode(q, kp, vp, tables, lens,
                                               **sc)
            want = attn_ops.paged_decode_plain(q, kp, vp, tables, lens,
                                               **sc)
            err = flash_compare(torch, [(got, want)], name)
            if case != "ctx1024" or dt != torch.bfloat16:
                record("paged_decode_int8", case, name, err)
                continue
            # library yardstick: SDPA over K/V dequantized and gathered
            # beforehand (not timed; the port never calls SDPA)
            safe = tables.long()[:, :ctx // page]

            def deq(pages, s):
                x = pages[:, safe].float() * s[safe][None, :, :, None, None]
                x = x.reshape(HKV, B, ctx, HD).transpose(0, 1)
                return x.repeat_interleave(H // HKV, 1).to(dt).contiguous()
            kg, vg = deq(kp, ks), deq(vp, vs)
            q4 = q[:, :, None, :]
            e = q.element_size()
            nbytes = (2 * B * H * HD * e + 2 * B * HKV * ctx * HD
                      + 2 * B * (ctx // page) * 4 + tables.numel() * 4
                      + B * 8)
            record("paged_decode_int8", case, name, err,
                   timed_ms(torch, lambda: paged_attention.paged_decode(
                       q, kp, vp, tables, lens, **sc), flush),
                   timed_ms(torch, lambda: attn_ops.paged_decode_plain(
                       q, kp, vp, tables, lens, **sc), flush),
                   timed_ms(torch, lambda: F.scaled_dot_product_attention(
                       q4, kg, vg), flush),
                   bound(nbytes, 4 * B * H * ctx * HD))
            del kg, vg
            paged_sweep(torch, paged_attention, "paged_decode_int8", q, kp,
                        vp, tables, sc, flush)
            # planted: one page of row 0 read with the scale of the page
            # of row 0 whose scale differs most from its own
            row0 = tables[0, :ctx // page].long()
            p0 = row0[3]
            other = row0[(ks[row0] / ks[p0]).log().abs().argmax()]
            for what, kw in (("k_scale", "k_scales"),
                             ("v_scale", "v_scales")):
                bad = dict(sc)
                bad[kw] = sc[kw].clone()
                bad[kw][p0] = sc[kw][other]
                e2 = flash_compare(torch, [(paged_attention.paged_decode(
                    q, kp, vp, tables, lens, **bad), want)], name)
                planted[f"paged_decode_int8/{what}"] = {
                    "row_err": e2[3], "row_caught": not e2[5],
                    "max_abs_err": e2[0]}
                log(f"planted page scale in paged_decode_int8 ({what} of "
                    f"page {int(p0)} from page {int(other)}): max_abs_err="
                    f"{e2[0]:.3e}, row_err={e2[3]:.3e} vs row_tol {ROW_TOL} "
                    f"(row check {'rejects' if not e2[5] else 'MISSES'} it)")
                if e2[5]:
                    FAILED_CASES.append(f"paged_decode_int8/{what}_missed")
    RESULTS["planted_quant"] = planted
    del flush, kp, vp
    torch.cuda.empty_cache()


def phase_train_kernels(torch, pt):
    """Phase 3, training kernels: the RMSNorm backward, the RoPE
    backward's table and the flash forward and backward against their
    plain versions at the training path's shapes. Runs with autograd on,
    for the library backward calls."""
    from paddle_tpu_torch.ops import attention as attn_ops
    from paddle_tpu_torch.ops import norm as norm_ops
    from paddle_tpu_torch.ops import rope as rope_ops
    from paddle_tpu_torch.ops.kernels import (flash_attention, fused_norm,
                                              fused_rope)
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(4321)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    H, HKV, HD = 32, 8, 128

    # -- RMSNorm backward: 2 x 4096 tokens at hidden 4096, fp32 weight -----
    R, D, eps = 8192, 4096, 1e-5
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt).split(".")[-1]
        x = torch.randn((R, D), generator=g, device=dev).to(dt)
        dy = torch.randn((R, D), generator=g, device=dev).to(dt)
        w = 1 + 0.1 * torch.randn((D,), generator=g, device=dev)
        _, rstd = fused_norm.rms_norm_fwd(x, w, eps, return_rstd=True)
        dx, dw = fused_norm.rms_norm_bwd(x, w, rstd, dy)
        wdx, wdw = norm_ops._rms_norm_bwd_plain(x, w, rstd, dy)
        ex = compare(torch, dx, wdx, name)
        # dw sums 8192 rows in fp32 in another order: the rounding error
        # scales with the summands, not with the (often cancelling)
        # result, so dw is held to 1e-5 of its largest magnitude
        diff = (dw - wdw).abs()
        scale = float(wdw.abs().max())
        ew = (float(diff.max()), float(diff.max()) / scale,
              bool((diff <= 1e-5 * scale).all()))
        err = (max(ex[0], ew[0]), max(ex[1], ew[1]), ex[2] and ew[2])
        xr = x.detach().clone().requires_grad_()
        wr = w.to(dt).requires_grad_()
        yr = F.rms_norm(xr, (D,), wr, eps)
        e = x.element_size()
        record("rms_norm_bwd", "train_8192", name, err,
               timed_ms(torch, lambda: fused_norm.rms_norm_bwd(
                   x, w, rstd, dy), flush),
               timed_ms(torch, lambda: norm_ops._rms_norm_bwd_plain(
                   x, w, rstd, dy), flush),
               timed_ms(torch, lambda: torch.autograd.grad(
                   yr, (xr, wr), dy, retain_graph=True), flush),
               bound(3 * R * D * e + R * 4 + 2 * D * 4, 9 * R * D))
        del x, dy, dx, wdx, xr, yr

    # -- RoPE backward: the forward kernel with the negated sine table ------
    cos, sin = rope_ops.rope_freqs(HD, 8192, 500000.0, device=dev)
    gq = torch.randn((2, 4096, H, HD), generator=g, device=dev).to(
        torch.bfloat16)
    gk = torch.randn((2, 4096, HKV, HD), generator=g, device=dev).to(
        torch.bfloat16)
    got = fused_rope.fused_rope(gq, gk, cos, -sin)
    want = rope_ops._rope_plain(gq, gk, cos, -sin)
    ea, eb = (compare(torch, a, b, "bfloat16") for a, b in zip(got, want))
    record("fused_rope", "train_bwd_4096", "bfloat16",
           (max(ea[0], eb[0]), max(ea[1], eb[1]), ea[2] and eb[2]))
    del gq, gk, got, want

    # -- flash attention -----------------------------------------------------
    def flash_case(case, b, s, dt, seg=False, dropout_p=0.0, timed=False):
        name = str(dt).split(".")[-1]
        q = torch.randn((b, s, H, HD), generator=g, device=dev).to(dt)
        k = torch.randn((b, s, HKV, HD), generator=g, device=dev).to(dt)
        # v a strided view, as the split of the fused qkv projection
        vbuf = torch.randn((b, s, 2 * HKV, HD), generator=g,
                           device=dev).to(dt)
        v = vbuf[:, :, HKV:]
        dout = torch.randn((b, s, H, HD), generator=g, device=dev).to(dt)
        q_seg = kv_seg = None
        if seg:
            q_seg = (torch.arange(s, device=dev) // 300).to(torch.int32)
            q_seg = q_seg.expand(b, s).contiguous()
            kv_seg = q_seg.clone()
            q_seg[:, -40:] = 99                 # no key has id 99
        args = (True, HD ** -0.5, q_seg, kv_seg, dropout_p, 2024)
        out, lse = flash_attention.flash_fwd(q, k, v, *args)
        want_out, want_lse = attn_ops._flash_fwd_plain(q, k, v, *args)
        delta = (want_out.float() * dout.float()).sum(-1).transpose(
            1, 2).contiguous()
        dq, dk, dv = flash_attention.flash_bwd(q, k, v, dout, want_lse,
                                               delta, *args)
        wdq, wdk, wdv = attn_ops._flash_bwd_plain(q, k, v, dout, want_lse,
                                                  delta, *args)
        e = q.element_size()
        peak = BF16_OPS_PER_S if dt == torch.bfloat16 else FP32_OPS_PER_S
        pairs = b * H * s * (s + 1) // 2            # causal (q, k) pairs
        qb, kvb = b * s * H * HD * e, b * s * HKV * HD * e
        rowb = b * H * s * 4                         # lse or delta
        t = {}
        if timed:
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                          for x in (q, k, v))
            lib_out = F.scaled_dot_product_attention(qt, kt, vt,
                                                     is_causal=True,
                                                     enable_gqa=True)
            dot = dout.transpose(1, 2)
            plain_reps = 10 if s > 2048 else 25
            t["flash_fwd"] = (
                timed_ms(torch, lambda: flash_attention.flash_fwd(
                    q, k, v, *args), flush),
                timed_ms(torch, lambda: attn_ops._flash_fwd_plain(
                    q, k, v, *args), flush, reps=plain_reps),
                timed_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), flush))
            lib_bwd = timed_ms(torch, lambda: torch.autograd.grad(
                lib_out, (qt, kt, vt), dot, retain_graph=True), flush)
            plain_bwd = timed_ms(torch, lambda: attn_ops._flash_bwd_plain(
                q, k, v, dout, want_lse, delta, *args), flush,
                reps=plain_reps)
            # the backward's every launch: the workspace's zeroing, the
            # kernel, the cast of dq
            t["flash_bwd"] = (
                timed_ms(torch, lambda: flash_attention.flash_bwd(
                    q, k, v, dout, want_lse, delta, *args), flush),
                plain_bwd, lib_bwd)
            del lib_out, qt, kt, vt
        # operations: the forward's 2 products, the backward's 5 (S, dP,
        # dV, dK, dQ), 2 * HD each per causal (q, k) pair
        ops = {"flash_fwd": 4 * HD * pairs, "flash_bwd": 10 * HD * pairs}
        bounds = {"flash_fwd": bound(qb + 2 * kvb + qb + rowb,
                                     ops["flash_fwd"], peak),
                  "flash_bwd": bound(3 * qb + 4 * kvb + 2 * rowb,
                                     ops["flash_bwd"], peak)}
        eo = flash_compare(torch, [(out, want_out)], name)
        el = compare(torch, lse, want_lse, "float32")
        errs = {"flash_fwd": (max(eo[0], el[0]), max(eo[1], el[1]),
                              eo[2] and el[2], eo[3]),
                "flash_bwd": flash_compare(
                    torch, [(dq, wdq), (dk, wdk), (dv, wdv)], name)}
        for kern in ("flash_fwd", "flash_bwd"):
            kms, pms, lms = t.get(kern, (None, None, None))
            record(kern, case, name, errs[kern], kms, pms, lms,
                   bounds[kern] if timed else (None, None))
            if kms is not None:
                rate = {"tflops": ops[kern] / kms / 1e9,
                        "library_tflops": ops[kern] / lms / 1e9,
                        "bound_share": bounds[kern][0] / kms}
                RESULTS.setdefault("flash_rates", {})[
                    f"{kern}/{case}/{name}"] = rate
                log(f"kernel {kern} [{case} {name}]: {us(kms)} = "
                    f"{rate['tflops']:.1f} TFLOP/s ({ops[kern]:.4g} "
                    f"operations), library {rate['library_tflops']:.1f} "
                    f"TFLOP/s, {rate['bound_share']:.3f} of the bound")
        if timed and dt == torch.bfloat16:
            planted_tile(torch, flash_attention, args, q, k, v, dout,
                         want_lse, delta,
                         {"flash_fwd": [want_out],
                          "flash_bwd/dq": [wdq],
                          "flash_bwd/dk_dv": [wdk, wdv]})
        torch.cuda.synchronize()

    flash_case("train_4096", 2, 4096, torch.bfloat16, timed=True)
    torch.cuda.empty_cache()
    flash_case("s1024", 2, 1024, torch.float32, timed=True)
    flash_case("segments_1024", 2, 1024, torch.bfloat16, seg=True)
    flash_case("dropout_1024", 2, 1024, torch.bfloat16, dropout_p=0.1)
    flash_case("ragged_1000", 2, 1000, torch.bfloat16)
    del flush
    torch.cuda.empty_cache()


def ce_compare(torch, pairs, atol):
    """compare() of fp32 results held to ``atol`` alone: (max_abs,
    max_rel, ok) over the (got, want) pairs."""
    diffs = [((g.float() - w.float()).abs(), w.float()) for g, w in pairs]
    max_abs = max(float(d.max()) for d, _ in diffs)
    max_rel = max(float((d / w.abs().clamp_min(1e-6)).max())
                  for d, w in diffs)
    ok = max_abs <= atol and all(bool(torch.isfinite(g).all())
                                 for g, _ in pairs)
    return max_abs, max_rel, ok


def product_rate(kern, case, ops, bnd, kms, lms, key="ce_rates"):
    """Log and keep a timed bf16 product's rate under RESULTS[key]
    (``ce_rates``, or ``gemm_rates`` for the int8 prefill and grouped
    rows): TFLOP/s of the kernel and of the library call, and the share of
    the bound it reaches."""
    rate = {"tflops": ops / kms / 1e9,
            "library_tflops": ops / lms / 1e9 if lms else None,
            "bound_share": bnd[0] / kms}
    RESULTS.setdefault(key, {})[f"{kern}/{case}"] = rate
    lib = ("-" if lms is None else f"{rate['library_tflops']:.1f} TFLOP/s")
    log(f"kernel {kern} [{case} bfloat16]: {us(kms)} = "
        f"{rate['tflops']:.1f} TFLOP/s ({ops:.4g} operations), library "
        f"{lib}, {rate['bound_share']:.3f} of the bound")


def ce_bwd_rows(torch, kce, vocab_ce, case, h, w, labels, lse, g_lse, g_tgt,
                flush):
    """dlog, dh and dW of one vocabulary chunk (columns 0 .. CHUNK) at the
    shape of h [N, H] and W [H, V], bf16: each kernel launched once and
    held per row (dlog, dh) or per column (dW) against its plain version,
    timed beside the plain version and one torch.matmul of the same
    product (dlog: none), with its rate. dh adds to the fp32 sums of
    earlier chunks in the timed launches, as a middle chunk does."""
    N, H = h.shape
    C, e, bf = kce.CHUNK, 2, torch.bfloat16
    hf, lab = h.float(), labels.long()[:, None]
    dlog = torch.empty((N, C), dtype=bf, device=h.device)
    kce.vocab_ce_dlog(h, w, labels, lse, g_lse, g_tgt, 0, C, dlog)
    want_dlog, wc32 = vocab_ce._dlog_plain(hf, w, lab, lse, g_lse, g_tgt, 0,
                                           C)
    want_dlog = want_dlog.to(bf)
    ops = 2 * N * H * C
    bnd = bound(N * H * e + H * C * e + 4 * N * 4 + N * C * e, ops,
                BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dlog(
        h, w, labels, lse, g_lse, g_tgt, 0, C, dlog), flush)
    record("vocab_ce_dlog", case, "bfloat16",
           flash_compare(torch, [(dlog, want_dlog)], "bfloat16"), kms,
           timed_ms(torch, lambda: vocab_ce._dlog_plain(
               hf, w, lab, lse, g_lse, g_tgt, 0, C)[0].to(bf), flush,
                    reps=10), None, bnd)
    product_rate("vocab_ce_dlog", case, ops, bnd, kms, None)
    del want_dlog

    wc = w[:, :C]
    out_dh = torch.empty_like(h)
    kce.vocab_ce_dh(dlog, w, 0, C, out_dh)
    want_dh = dlog.float() @ wc32.t()
    acc = torch.zeros((N, H), dtype=torch.float32, device=h.device)
    bnd = bound(N * C * e + H * C * e + 2 * N * H * 4, ops, BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dh(
        dlog, w, 0, C, out_dh, acc, first=False, last=False), flush)
    lms = timed_ms(torch, lambda: torch.matmul(dlog, wc.t()), flush)
    record("vocab_ce_dh", case, "bfloat16",
           flash_compare(torch, [(out_dh, want_dh)], "bfloat16"), kms,
           timed_ms(torch, lambda: dlog.float() @ wc32.t(), flush, reps=10),
           lms, bnd)
    product_rate("vocab_ce_dh", case, ops, bnd, kms, lms)
    del out_dh, want_dh, acc

    out_dw = torch.empty_like(w)
    kce.vocab_ce_dw(h, dlog, 0, C, out_dw)
    want_dw = hf.t() @ dlog.float()
    bnd = bound(N * H * e + N * C * e + H * C * e, ops, BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dw(h, dlog, 0, C, out_dw),
                   flush)
    lms = timed_ms(torch, lambda: torch.matmul(h.t(), dlog), flush)
    record("vocab_ce_dw", case, "bfloat16",
           flash_compare(torch, [(out_dw[:, :C].t(), want_dw.t())],
                         "bfloat16"), kms,
           timed_ms(torch, lambda: (hf.t() @ dlog.float()).to(bf), flush,
                    reps=10), lms, bnd)
    product_rate("vocab_ce_dw", case, ops, bnd, kms, lms)
    del out_dw, want_dw, wc32, dlog


def phase_ce_kernels(torch, pt):
    """Phase 3, the fused vocab-CE kernels. At the training shape (2 x
    4096 tokens, hidden 4096, vocabulary 128256, bf16): the forward, the
    dlog of one chunk, and dh and dW of the whole backward against the
    plain versions, timed per launch beside the plain version and the
    PyTorch yardstick, with the backward's TFLOP/s and share of the
    bound, and with planted wrong vocabulary blocks. dlog, dh and dW of
    one chunk again at the DeepSeekMoE-16B head (hidden 2048, vocabulary
    102400), and the whole backward's time at both shapes. In fp32
    at 2048 x 1024 over a vocabulary of 20000 (not a multiple of the
    tile, three backward chunks) with ignored rows and a tied,
    transposed W, through the autograd Function. Runs with autograd
    on."""
    from paddle_tpu_torch.ops import vocab_ce
    from paddle_tpu_torch.ops.kernels import fused_vocab_ce as kce
    F = torch.nn.functional
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(5678)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    N, H, V, C = 8192, 4096, 128256, kce.CHUNK
    bf, i32, e = torch.bfloat16, torch.int32, 2
    h = torch.randn((N, H), generator=g, device=dev).to(bf)
    w = (0.02 * torch.randn((H, V), generator=g, device=dev)).to(bf)
    labels = torch.randint(0, V, (N,), generator=g, device=dev).to(i32)
    labels[::97] = -1                                   # ignored rows
    # the blocks that the planted copies overwrite hold some rows' labels
    plants = {"mid": 500, "late": V // 128 - 2}
    for i, j in enumerate(plants.values()):
        labels[1 + 16 * i:9 + 16 * i] = (j + 1) * 128 + 13 * torch.arange(
            8, device=dev, dtype=i32)
    g_lse = torch.randn((N,), generator=g, device=dev)
    g_tgt = torch.randn((N,), generator=g, device=dev)
    hf, lab = h.float(), labels.long()[:, None]

    lse, tgt = kce.vocab_ce_fwd(h, w, labels)
    want_lse, want_tgt = vocab_ce._fwd_plain(h, w, labels)
    record("vocab_ce_fwd", "train_8192", "bfloat16",
           ce_compare(torch, [(lse, want_lse), (tgt, want_tgt)],
                      CE_FP32_TOL),
           timed_ms(torch, lambda: kce.vocab_ce_fwd(h, w, labels), flush,
                    reps=10),
           timed_ms(torch, lambda: vocab_ce._fwd_plain(h, w, labels), flush,
                    reps=10),
           timed_ms(torch, lambda: torch.logsumexp(
               torch.matmul(h, w).float(), -1), flush, reps=10),
           bound(N * H * e + H * V * e + 3 * N * 4, 2 * N * H * V,
                 BF16_OPS_PER_S), tol=CE_FP32_TOL)
    del lse, tgt

    dlog = torch.empty((N, C), dtype=bf, device=dev)
    kce.vocab_ce_dlog(h, w, labels, want_lse, g_lse, g_tgt, 0, C, dlog)
    want_dlog = vocab_ce._dlog_plain(hf, w, lab, want_lse, g_lse, g_tgt, 0,
                                     C)[0].to(bf)
    ops = 2 * N * H * C          # each of dlog, dh and dW, a chunk
    bnd = bound(N * H * e + H * C * e + 4 * N * 4 + N * C * e, ops,
                BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dlog(
        h, w, labels, want_lse, g_lse, g_tgt, 0, C, dlog), flush)
    record("vocab_ce_dlog", "train_chunk_8192", "bfloat16",
           flash_compare(torch, [(dlog, want_dlog)], "bfloat16"), kms,
           timed_ms(torch, lambda: vocab_ce._dlog_plain(
               hf, w, lab, want_lse, g_lse, g_tgt, 0, C)[0].to(bf), flush,
                    reps=10),
           None, bnd)
    product_rate("vocab_ce_dlog", "train_chunk_8192", ops, bnd, kms, None)
    del want_dlog

    dh, dw = kce.vocab_ce_bwd(h, w, labels, want_lse, g_lse, g_tgt)
    want_dh, want_dw = vocab_ce._bwd_plain(h, w, labels, want_lse, g_lse,
                                           g_tgt, C)
    # per launch at a middle chunk: dh adds to the fp32 sums of the
    # earlier chunks; the yardsticks are the chunk's product in one
    # torch.matmul, the plain versions the plain backward's steps
    acc = torch.empty((N, H), dtype=torch.float32, device=dev)
    out_dh, out_dw = torch.empty_like(h), torch.empty_like(w)
    wc = w[:, :C]
    bnd = bound(N * C * e + H * C * e + 2 * N * H * 4, ops, BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dh(
        dlog, w, 0, C, out_dh, acc, first=False, last=False), flush)
    lms = timed_ms(torch, lambda: torch.matmul(dlog, wc.t()), flush)
    record("vocab_ce_dh", "train_8192", "bfloat16",
           flash_compare(torch, [(dh, want_dh)], "bfloat16"), kms,
           timed_ms(torch, lambda: dlog.float() @ wc.float().t(), flush,
                    reps=10), lms, bnd)
    product_rate("vocab_ce_dh", "train_8192", ops, bnd, kms, lms)
    bnd = bound(N * H * e + N * C * e + H * C * e, ops, BF16_OPS_PER_S)
    kms = timed_ms(torch, lambda: kce.vocab_ce_dw(h, dlog, 0, C, out_dw),
                   flush)
    lms = timed_ms(torch, lambda: torch.matmul(h.t(), dlog), flush)
    record("vocab_ce_dw", "train_8192", "bfloat16",
           flash_compare(torch, [(dw.t(), want_dw.t())], "bfloat16"), kms,
           timed_ms(torch, lambda: (hf.t() @ dlog.float()).to(bf), flush,
                    reps=10), lms, bnd)
    product_rate("vocab_ce_dw", "train_8192", ops, bnd, kms, lms)
    del acc, out_dh, out_dw, dh, dw

    # the whole head: forward + backward of the kernels, of the plain
    # versions, and of the naive head through autograd (logits, fp32 CE)
    hr, wr = h.detach().requires_grad_(), w.detach().requires_grad_()
    naive = F.cross_entropy(torch.matmul(hr, wr).float(), labels.long(),
                            ignore_index=-1)
    head = {
        "kernels_bwd_ms": timed_ms(torch, lambda: kce.vocab_ce_bwd(
            h, w, labels, want_lse, g_lse, g_tgt), flush, reps=5),
        "plain_bwd_ms": timed_ms(torch, lambda: vocab_ce._bwd_plain(
            h, w, labels, want_lse, g_lse, g_tgt, C), flush, reps=3,
                                 warmup=1),
        "naive_autograd_bwd_ms": timed_ms(torch, lambda: torch.autograd.grad(
            naive, (hr, wr), retain_graph=True), flush, reps=10),
        "launches_per_bwd": -(-V // C) * 3,
        "bound_bwd_ms": bound(2 * N * H * e + 2 * H * V * e + 4 * N * 4,
                              6 * N * H * V, BF16_OPS_PER_S)[0]}
    RESULTS["vocab_ce_head"] = head
    log(f"vocab-CE backward at {N} x {H} x {V} bf16: {head}")
    del naive, hr, wr
    torch.cuda.empty_cache()
    planted_vocab_block(torch, kce, vocab_ce, h, w, labels, g_lse, g_tgt,
                        want_lse, want_tgt, want_dh, want_dw, plants)
    del h, w, dlog, want_dh, want_dw
    torch.cuda.empty_cache()

    # the backward at the DeepSeekMoE-16B head's shape (2 x 4096 tokens,
    # hidden 2048, vocabulary 102400: 12 full chunks and one of 4096)
    N3, H3, V3 = 8192, 2048, 102400
    h3 = torch.randn((N3, H3), generator=g, device=dev).to(bf)
    w3 = (0.02 * torch.randn((H3, V3), generator=g, device=dev)).to(bf)
    lab3 = torch.randint(0, V3, (N3,), generator=g, device=dev).to(i32)
    lab3[::97] = -1
    gl3 = torch.randn((N3,), generator=g, device=dev)
    gt3 = torch.randn((N3,), generator=g, device=dev)
    lse3, _ = vocab_ce._fwd_plain(h3, w3, lab3)
    ce_bwd_rows(torch, kce, vocab_ce, "moe_chunk_8192", h3, w3, lab3, lse3,
                gl3, gt3, flush)
    head3 = {
        "kernels_bwd_ms": timed_ms(torch, lambda: kce.vocab_ce_bwd(
            h3, w3, lab3, lse3, gl3, gt3), flush, reps=5),
        "launches_per_bwd": -(-V3 // C) * 3,
        "bound_bwd_ms": bound(2 * N3 * H3 * e + 2 * H3 * V3 * e + 4 * N3 * 4,
                              6 * N3 * H3 * V3, BF16_OPS_PER_S)[0]}
    RESULTS["vocab_ce_head_moe"] = head3
    log(f"vocab-CE backward at {N3} x {H3} x {V3} bf16: {head3}")
    del h3, w3, lab3, gl3, gt3, lse3
    torch.cuda.empty_cache()

    # fp32, tied: W is the transposed view of an embedding [V, H]
    N2, H2, V2 = 2048, 1024, 20000
    hx = torch.randn((N2, H2), generator=g, device=dev)
    emb = 0.05 * torch.randn((V2, H2), generator=g, device=dev)
    lab2 = torch.randint(0, V2, (N2,), generator=g, device=dev).to(i32)
    lab2[::5] = -1
    lab2[1] = V2 - 1                                # in the padded tile
    gl2 = torch.randn((N2,), generator=g, device=dev)
    gt2 = torch.randn((N2,), generator=g, device=dev)
    hr, er = hx.clone().requires_grad_(), emb.clone().requires_grad_()
    lse2, tgt2 = vocab_ce.lse_and_target(hr, er.t(), lab2)
    torch.autograd.backward((lse2, tgt2), (gl2, gt2))
    wl2, wt2 = vocab_ce._fwd_plain(hx, emb.t(), lab2)
    wdh2, wdw2 = vocab_ce._bwd_plain(hx, emb.t(), lab2, wl2, gl2, gt2)
    case = "tied_fp32_v20000"
    ef = [compare(torch, a, b, "float32") for a, b in
          ((lse2, wl2), (tgt2, wt2))]
    record("vocab_ce_fwd", case, "float32",
           (max(x[0] for x in ef), max(x[1] for x in ef),
            all(x[2] for x in ef)))
    record("vocab_ce_dh", case, "float32",
           compare(torch, hr.grad, wdh2, "float32"))
    record("vocab_ce_dw", case, "float32",
           compare(torch, er.grad, wdw2.t(), "float32"))
    if bool((tgt2[::5] != 0).any()):
        FAILED_CASES.append("vocab_ce_fwd/ignored_rows_tgt_not_0")
    del flush
    torch.cuda.empty_cache()


def planted_vocab_block(torch, kce, vocab_ce, h, w, labels, g_lse, g_tgt,
                        want_lse, want_tgt, want_dh, want_dw, plants):
    """Run the CE kernels as if they read vocabulary block j's W in place
    of block j + 1's (both 128 columns; block j + 1 holds 8 rows'
    labels) and hold them against the plain versions of the true W: the
    forward's lse/tgt reading must be at least 10x CE_FP32_TOL, and the
    row checks of the chunk's dlog, of dh and of dW must reject it. A
    failure means the check cannot see a wrong block."""
    N, V, C = h.shape[0], w.shape[1], kce.CHUNK
    hf, lab = h.float(), labels.long()[:, None]
    res = {}
    for where, j in plants.items():
        w2 = w.clone()
        w2[:, (j + 1) * 128:(j + 2) * 128] = w[:, j * 128:(j + 1) * 128]
        lse2, tgt2 = kce.vocab_ce_fwd(h, w2, labels)
        e_lse = ce_compare(torch, [(lse2, want_lse)], CE_FP32_TOL)
        e_tgt = ce_compare(torch, [(tgt2, want_tgt)], CE_FP32_TOL)
        reading = max(e_lse[0], e_tgt[0])
        c0 = (j + 1) * 128 // C * C
        cw = min(C, V - c0)
        dlog = torch.empty((N, C), dtype=h.dtype, device=h.device)
        kce.vocab_ce_dlog(h, w2, labels, want_lse, g_lse, g_tgt, c0, cw,
                          dlog)
        want_dlog = vocab_ce._dlog_plain(hf, w, lab, want_lse, g_lse, g_tgt,
                                         c0, cw)[0].to(h.dtype)
        dh2, dw2 = kce.vocab_ce_bwd(h, w2, labels, want_lse, g_lse, g_tgt)
        checks = {
            "vocab_ce_dlog": flash_compare(
                torch, [(dlog[:, :cw], want_dlog)], "bfloat16"),
            "vocab_ce_dh": flash_compare(torch, [(dh2, want_dh)],
                                         "bfloat16"),
            "vocab_ce_dw": flash_compare(torch, [(dw2.t(), want_dw.t())],
                                         "bfloat16")}
        caught = reading >= 10 * CE_FP32_TOL
        res[f"vocab_ce_fwd/{where}"] = {
            "lse_max_abs": e_lse[0], "tgt_max_abs": e_tgt[0],
            "caught_10x": caught}
        log(f"planted wrong vocabulary block ({where}, block {j} read as "
            f"{j + 1}) in vocab_ce_fwd: lse max_abs_err={e_lse[0]:.3e}, "
            f"tgt max_abs_err={e_tgt[0]:.3e} vs tol {CE_FP32_TOL} "
            f"({'rejected by 10x or more' if caught else 'NOT 10x above'})")
        if not caught:
            FAILED_CASES.append(f"vocab_ce_fwd/planted_block_{where}_missed")
        for kern, e in checks.items():
            res[f"{kern}/{where}"] = {"row_err": e[3], "row_caught": not e[5],
                                      "max_abs_err": e[0]}
            log(f"planted wrong vocabulary block ({where}) in {kern}: "
                f"row_err={e[3]:.3e} vs row_tol {ROW_TOL} (row check "
                f"{'rejects' if not e[5] else 'MISSES'} it)")
            if e[5]:
                FAILED_CASES.append(f"{kern}/planted_block_{where}_missed")
        del w2, dlog, dh2, dw2
    RESULTS["planted_vocab_block"] = res


def planted_tile(torch, fa, args, q, k, v, dout, lse, delta, wants):
    """Run the flash kernels as if they read one tile in place of another
    (tile A's rows of one KV head, or of one query head with its dout,
    lse and delta, copied over tile B, once in the middle of the
    sequence and once at its end) and hold them against the plain
    versions of the true inputs: a K/V plant must break the forward's out
    and the backward's dq, a Q/dO/lse/delta plant the backward's dk and
    dv, and the row check must reject every one. A failure means the
    check cannot see a wrong tile."""
    s = q.shape[1]
    res = {}
    for where, b0 in (("mid", s // 2), ("late", s - 128)):
        A, B = slice(b0 - 64, b0), slice(b0, b0 + 64)

        def plant(t, seq_dim=1):
            t = t.clone()
            if seq_dim == 1:                   # [b, s, heads, d]
                t[:, B, 0] = t[:, A, 0]
            else:                              # lse / delta [b, h, s]
                t[:, 0, B] = t[:, 0, A]
            return t
        k2, v2 = plant(k), plant(v)
        kv_planted = fa.flash_bwd(q, k2, v2, dout, lse, delta, *args)
        q_planted = fa.flash_bwd(plant(q), k, v, plant(dout), plant(lse, 2),
                                 plant(delta, 2), *args)
        got = {"flash_fwd": [fa.flash_fwd(q, k2, v2, *args)[0]],
               "flash_bwd/dq": [kv_planted[0]],
               "flash_bwd/dk_dv": list(q_planted[1:])}
        for kern, outs in got.items():
            e = flash_compare(torch, list(zip(outs, wants[kern])),
                              "bfloat16")
            res[f"{kern}/{where}"] = {
                "row_err": e[3], "row_caught": not e[5],
                "elementwise_caught": not e[4], "max_abs_err": e[0]}
            log(f"planted wrong tile ({where}) in {kern}: max_abs_err="
                f"{e[0]:.3e} (elementwise check "
                f"{'rejects' if not e[4] else 'passes'} it), row_err="
                f"{e[3]:.3e} vs row_tol {ROW_TOL} (row check "
                f"{'rejects' if not e[5] else 'MISSES'} it)")
            if e[5]:
                FAILED_CASES.append(f"{kern}/planted_tile_{where}_missed")
    RESULTS["planted_tile"] = res


def plain_greedy(torch, model, prompt, n_new, page_size):
    """Step-by-step greedy decoding through the paged model functions on
    the model's device (the CPU: plain versions), one request at a
    time, independent of the engine's scheduling."""
    core = model.model
    L = len(prompt)
    pools, tables = core.alloc_paged_caches(1, L + n_new, page_size)
    h, _ = core.prefill_paged(torch.tensor(prompt[None], dtype=torch.int64),
                              pools, tables)
    logits = model.logits(h[0, L - 1])
    out = []
    for i in range(n_new):
        tok = int(torch.argmax(logits.float()))
        out.append(tok)
        if i == n_new - 1:
            break
        h, _ = core.decode_step_paged(torch.tensor([tok]),
                                      torch.tensor([L + i]), pools, tables)
        logits = model.logits(h[0, 0])
    return np.asarray(out, np.int32)


def phase_engine_equality(torch, pt, dev, make_cfg):
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaForCausalLM
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = make_cfg(num_hidden_layers=2, dtype="float32")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(7, dev))
    ref = copy.deepcopy(model).to("cpu")
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (37, 130, 64, 200)]
    n_new = 8
    eng = ContinuousBatchingEngine(
        model, max_batch=2, page_size=128, max_len=512,
        generation_config=GenerationConfig(max_new_tokens=n_new),
        decode_block=4, async_depth=2)
    rids = [eng.submit(p) for p in prompts]
    out = eng.run()
    with torch.inference_mode():
        want = [plain_greedy(torch, ref, p, n_new, 128) for p in prompts]
    same = [bool(np.array_equal(out[r], w)) for r, w in zip(rids, want)]
    log(f"engine equality (llama3_8b widths, 2 layers, fp32): "
        f"{sum(same)}/{len(same)} requests equal, "
        f"{time.perf_counter() - t0:.1f} s")
    RESULTS["engine_equality"] = {"equal": same,
                                  "card": [out[r].tolist() for r in rids],
                                  "plain": [w.tolist() for w in want]}
    del eng, model, ref
    empty_cache(torch, dev)
    if not all(same):
        raise SystemExit("engine tokens differ from the plain path: "
                         f"{RESULTS['engine_equality']}")


# Phase 4b holds the card's int8 model (kernels) to the CPU's (plain
# versions), both fp32 over the same int8 weights. The two compute K/V in
# other summation orders (1e-6 apart), so a code whose value lies within
# that of a rounding boundary lands on the other side: those codes differ
# by exactly 1, at about 1e-4 of the written elements when each
# projection's output is perturbed by 2e-6 relative on the CPU (4096
# wide, 32 heads over 8 KV heads of 128, 2 layers). Each moves one K or V
# element by one quantization step (1/127 of its page's largest value);
# together they moved the logits by 9.4e-4 of their largest magnitude in
# that rehearsal. A wrong page, block or scale moves them by 1e-1 or
# more. The second layer's K/V come from attention over the first
# layer's codes, so the codes that differ there move its page scales
# (a page's absmax / 127) by up to about 1e-4 (1.34e-4 on the card,
# H100 80GB HBM3, 700 W); a scale from a wrong page is off by 1e-2 or
# more.
QUANT_LOGIT_TOL = 5e-3     # max |card - cpu| / max |cpu| over all steps
QUANT_CODE_FRAC = 1e-3     # codes that may differ (by 1) / codes written
QUANT_SCALE_RTOL = 1e-3    # page scales, relative


def phase_quant_engine_equality(torch, pt, dev, make_cfg):
    """Phase 4b: Llama-3-8B widths at 2 layers, fp32 activations, int8
    weights and int8 KV, the same seeded weights on the card and on the
    CPU. Hard limits: teacher-forced per-step logits (a 130-token
    prefill, then 8 decode steps of a fixed history) within
    QUANT_LOGIT_TOL, and the pools' codes equal but for differences of 1
    at no more than QUANT_CODE_FRAC of the written elements, scales
    within QUANT_SCALE_RTOL. Reported only: the greedy-token agreement of
    the two engines (random weights have near-ties)."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    cfg = make_cfg(num_hidden_layers=2, dtype="float32")
    t0 = time.perf_counter()
    native = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(7, dev))
    card = quantize_model(native, kv_dtype="int8")
    del native
    cpu = copy.deepcopy(card).to("cpu")
    hist = np.random.RandomState(11).randint(0, cfg.vocab_size, (139,))
    L = 130
    side = {}
    with torch.inference_mode():
        for name, model in (("card", card), ("cpu", cpu)):
            d = model.lm_head.device
            core = model.model
            pools, tables = core.alloc_paged_caches(1, 256, 128)
            h, _ = core.prefill_paged(torch.tensor(hist[None, :L], device=d),
                                      pools, tables)
            logits = [model.logits(h[0, -1])]
            for i in range(L, len(hist)):
                h, _ = core.decode_step_paged(
                    torch.tensor(hist[i:i + 1], device=d),
                    torch.tensor([i], device=d), pools, tables)
                logits.append(model.logits(h[0, 0]))
            side[name] = (torch.stack(logits).float().cpu(),
                          [[t.cpu() for t in p] for p in pools])
    (lc, pc), (lp, pp) = side["card"], side["cpu"]
    logit_err = float((lc - lp).abs().max() / lp.abs().max())
    written = differ = worst = 0
    scale_err = 0.0
    for layer_c, layer_p in zip(pc, pp):
        for codes_c, codes_p, s_c, s_p in ((layer_c[0], layer_p[0],
                                            layer_c[2], layer_p[2]),
                                           (layer_c[1], layer_p[1],
                                            layer_c[3], layer_p[3])):
            used = s_p > 0
            dc = (codes_c.int() - codes_p.int()).abs()[:, used]
            written += dc.numel()
            differ += int((dc > 0).sum())
            worst = max(worst, int(dc.max()))
            scale_err = max(scale_err, float(
                ((s_c - s_p).abs() / s_p.clamp_min(1e-30))[used].max()))
            if bool((s_c[~used] != 0).any()):
                worst = max(worst, 127)          # a page written on one side
    frac = differ / max(written, 1)
    logits_ok = logit_err <= QUANT_LOGIT_TOL and bool(
        torch.isfinite(lc).all())
    codes_ok = worst <= 1 and frac <= QUANT_CODE_FRAC
    scales_ok = scale_err <= QUANT_SCALE_RTOL
    # the engines, on the card and on the CPU: greedy agreement, reported
    rs = np.random.RandomState(7)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in (37, 130)]
    n_new = 8
    streams = {}
    for name, model in (("card", card), ("cpu", cpu)):
        eng = ContinuousBatchingEngine(
            model, max_batch=2, page_size=128, max_len=512,
            generation_config=GenerationConfig(max_new_tokens=n_new),
            decode_block=4, async_depth=2)
        rids = [eng.submit(p) for p in prompts]
        out = eng.run()
        if not (eng.kv_quant and eng.kv_quant_ticks > 0):
            raise SystemExit("the quantized engine did not decode over "
                             "int8 pools")
        streams[name] = [out[r].tolist() for r in rids]
    agree = float(np.mean([np.mean(np.equal(a, b)) for a, b in
                           zip(streams["card"], streams["cpu"])]))
    res = {"logit_err": logit_err, "logit_tol": QUANT_LOGIT_TOL,
           "max_abs_logit": float(lp.abs().max()),
           "codes_written": written, "codes_differ": differ,
           "codes_differ_frac": frac, "codes_max_diff": worst,
           "code_frac_tol": QUANT_CODE_FRAC, "scale_rel_err": scale_err,
           "scale_rtol": QUANT_SCALE_RTOL, "greedy_agreement": agree,
           "streams": streams}
    RESULTS["quant_engine_equality"] = res
    log(f"quantized engine equality (llama3_8b widths, 2 layers, fp32, int8 "
        f"weights and KV): teacher-forced logits max|card-cpu|/max|cpu| "
        f"{logit_err:.3e} (tol {QUANT_LOGIT_TOL}: "
        f"{'ok' if logits_ok else 'FAIL'}); KV codes differing {differ} of "
        f"{written} written ({frac:.2e}, tol {QUANT_CODE_FRAC}, largest "
        f"difference {worst}: {'ok' if codes_ok else 'FAIL'}); page scales "
        f"rel err {scale_err:.2e} (tol {QUANT_SCALE_RTOL}: "
        f"{'ok' if scales_ok else 'FAIL'}); engines' greedy agreement "
        f"{agree:.3f} (reported only); {time.perf_counter() - t0:.1f} s")
    del card, cpu
    empty_cache(torch, dev)
    if not (logits_ok and codes_ok and scales_ok):
        raise SystemExit("the quantized model on the card differs from the "
                         "plain path")


def serve_run(torch, dev, model, label, kernels):
    """The serving run of phases 5 and 5b over ``model``: a warm-up
    engine, then 16 requests (prompts 128-1536 tokens from numpy seed 8,
    64 new tokens, every 4th sampled) through ContinuousBatchingEngine
    (max_batch=8, page_size=128, max_len=2048, decode_block=8,
    async_depth=2), launch counts reset just before and read just after;
    then per-call launch counts and one decode step at B=8, context 1024
    (device span, host enqueue, profile). Fails unless every kernel of
    ``kernels`` launched, every token is in the vocabulary and the
    logits are finite. Returns the run's numbers and the streams."""
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.ops.kernels import _build
    cfg = model.cfg
    sampled = GenerationConfig(do_sample=True, temperature=0.8, top_k=40,
                               top_p=0.95)
    kw = dict(max_batch=8, page_size=128, max_len=2048, decode_block=8,
              async_depth=2, generation_config=GenerationConfig(seed=0))
    # warm-up (cuBLAS handles, allocator), outside the counted run
    warm = ContinuousBatchingEngine(model, **kw)
    warm.submit(np.arange(128) % cfg.vocab_size, max_new_tokens=4)
    warm.submit(np.arange(300) % cfg.vocab_size, max_new_tokens=4,
                generation_config=sampled)
    warm.run()
    del warm
    sync(torch, dev)
    eng = ContinuousBatchingEngine(model, **kw)
    rs = np.random.RandomState(8)
    lens = rs.randint(128, 1537, size=16)
    prompts = [rs.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]
    n_new = 64
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=n_new,
                       generation_config=sampled if i % 4 == 3 else None)
            for i, p in enumerate(prompts)]
    out = eng.run()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    lat = eng.latency_stats()
    n_tok = sum(len(out[r]) for r in rids)
    logits_ok = bool(torch.isfinite(eng._state["logits"].float()).all())
    tok_ok = all(len(out[r]) == n_new and int(out[r].min()) >= 0
                 and int(out[r].max()) < cfg.vocab_size for r in rids)
    tps = n_tok / wall
    pool_bytes = sum(t.numel() * t.element_size() for p in eng.pools
                     for t in p)
    model_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    log(f"{label}: {len(rids)} requests, prompt tokens {int(lens.sum())}, "
        f"generated {n_tok} in {wall:.3f} s = {tps:.1f} tokens/s; TTFT "
        f"p50 {lat['ttft_p50_s']*1e3:.1f} ms p99 "
        f"{lat['ttft_p99_s']*1e3:.1f} ms; ITL p50 "
        f"{lat.get('itl_p50_s', float('nan'))*1e3:.2f} ms p99 "
        f"{lat.get('itl_p99_s', float('nan'))*1e3:.2f} ms; model bytes "
        f"{model_bytes}, KV-pool bytes {pool_bytes}, peak memory {peak}; "
        f"stats {eng.stats()}")
    log(f"{label} launches: {launches}")
    info = {"requests": len(rids), "prompt_tokens": int(lens.sum()),
            "generated_tokens": n_tok, "wall_s": wall, "tokens_per_s": tps,
            "latency": lat, "stats": eng.stats(), "launches": launches,
            "model_bytes": model_bytes, "kv_pool_bytes": pool_bytes,
            "peak_memory_bytes": peak,
            "kv_quant_ticks": eng.kv_quant_ticks}
    streams = [out[r] for r in rids]
    del eng
    # per-call launch counts and one decode step's time, measured after
    # the counted run
    core = model.model
    pools, tables = core.alloc_paged_caches(8, 2048, 128)
    per = {}
    with torch.inference_mode():
        _build.reset_launches()
        ids = torch.zeros((1, 128), dtype=torch.int64, device=dev)
        core.prefill_paged(ids, pools, tables[:1])
        per["prefill"] = dict(_build.LAUNCHES)
        _build.reset_launches()
        tok = torch.zeros((8,), dtype=torch.int64, device=dev)
        pos = torch.full((8,), 1023, dtype=torch.int64, device=dev)

        def step():
            h, _ = core.decode_step_paged(tok, pos, pools, tables)
            return model.logits(h[:, 0])
        step()
        per["decode_step"] = dict(_build.LAUNCHES)
        host, dev_ms = [], []
        for _ in range(10):
            sync(torch, dev)
            h0 = time.perf_counter()
            span = DeviceSpan(torch, dev)
            step()
            host.append((time.perf_counter() - h0) * 1e3)
            dev_ms.append(span.end())
        prof = profile_step(torch, dev, step, sums=NORM_ROPE_KERNELS)
    weight_bytes = sum(p.numel() * p.element_size()
                       for n, p in model.named_parameters()
                       if n != "model.embed_tokens")
    step_info = {"host_enqueue_ms": statistics.median(host),
                 "device_span_ms": statistics.median(dev_ms),
                 "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S
                 * 1e3, "profile": prof}
    log(f"{label}: launches per prefill {per['prefill']}, per decode step "
        f"{per['decode_step']}; one decode step at B=8 ctx 1024: "
        f"{step_info}")
    if prof is not None:
        log(f"{label}: RMSNorm and RoPE in the profiled decode step: "
            + ", ".join(f"{k} {v['us']:.1f} us in {v['launches']} launches"
                        for k, v in prof["sums"].items()))
    info.update(launches_per_call=per, decode_step=step_info)
    RESULTS[label] = info
    del pools
    empty_cache(torch, dev)
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the {label} path: "
                         f"{missing}")
    if not (tok_ok and logits_ok):
        raise SystemExit(f"{label} output malformed "
                         f"(tokens ok {tok_ok}, logits finite {logits_ok})")
    return info, streams


def phase_serving(torch, pt, dev, make_cfg):
    """Phase 5, the serving run of the seeded bf16 model at Llama-3-8B
    widths (all 32 layers, built on the card), then phase 5b: the same
    model quantized on the card (``quantize_model(model,
    kv_dtype="int8")``, the native model then freed) through the same
    run. Returns both runs' launch counts."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.quantization import quantize_model
    cfg = make_cfg(dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(8, dev))
    sync(torch, dev)
    log(f"serving model: llama3_8b widths, {cfg.num_hidden_layers} layers, "
        f"bf16, built in {time.perf_counter() - t0:.1f} s")
    native, native_streams = serve_run(torch, dev, model, "serving",
                                       SERVING_KERNELS)
    t0 = time.perf_counter()
    qmodel = quantize_model(model, kv_dtype="int8")
    del model
    empty_cache(torch, dev)
    sync(torch, dev)
    log(f"quantized serving model: quantize_model(kv_dtype='int8') on the "
        f"card in {time.perf_counter() - t0:.1f} s")
    quant, quant_streams = serve_run(torch, dev, qmodel,
                                     "quantized_serving",
                                     QUANT_SERVING_KERNELS)
    # greedy requests only (every 4th samples): the share of positions
    # where the quantized stream equals the native one (reported only:
    # random weights have near-ties)
    greedy = [i for i in range(len(native_streams)) if i % 4 != 3]
    agree = float(np.mean([np.mean(np.equal(native_streams[i],
                                            quant_streams[i]))
                           for i in greedy]))
    quant["greedy_agreement_with_native"] = agree
    # every int8 product of a prefill (m = the prompt's tokens) must take
    # the wgmma route, and the counted run's prefills with it
    pre = quant["launches_per_call"]["prefill"]
    run = quant["launches"]
    log(f"quantized serving int8 routes: per prefill of 128 tokens "
        f"{pre['int8_matmul_wgmma']} of {pre['int8_matmul']} on wgmma; in "
        f"the run wgmma {run['int8_matmul_wgmma']}, decode "
        f"{run['int8_matmul_decode']}, fp32 {run['int8_matmul_fp32']}")
    if not (0 < pre["int8_matmul"] == pre["int8_matmul_wgmma"]
            and run["int8_matmul_wgmma"] > 0):
        raise SystemExit("int8 prefill products did not take the wgmma "
                         "route")
    log(f"quantized vs native serving: {quant['tokens_per_s']:.1f} vs "
        f"{native['tokens_per_s']:.1f} tokens/s; TTFT p50 "
        f"{quant['latency']['ttft_p50_s'] * 1e3:.1f} vs "
        f"{native['latency']['ttft_p50_s'] * 1e3:.1f} ms; ITL p50 "
        f"{quant['latency']['itl_p50_s'] * 1e3:.2f} vs "
        f"{native['latency']['itl_p50_s'] * 1e3:.2f} ms; model bytes "
        f"{quant['model_bytes']} vs {native['model_bytes']}; KV-pool bytes "
        f"{quant['kv_pool_bytes']} vs {native['kv_pool_bytes']}; greedy "
        f"agreement with the native streams {agree:.3f}")
    del qmodel
    empty_cache(torch, dev)
    return native["launches"], quant["launches"]


def kernel_category(name: str) -> str:
    """A profiler kernel name → the layer it belongs to, for the training
    step's breakdown."""
    if "flash_" in name:
        return "flash " + ("backward" if "bwd" in name else "forward")
    if "vocab_ce" in name:
        return "fused vocab-CE head kernels"
    if "grouped_matmul" in name or "grouped::" in name:
        return "grouped matmul kernels"
    if any(w in name for w in ("Sort", "sort", "topk", "TopK", "scatter",
                               "index_copy", "indexSelect", "index_select",
                               "index_add", "indexFunc")):
        return "MoE routing (sort, top-k, counts, gathers)"
    if "rms_norm" in name or "rope_" in name:
        return "rms_norm / rope kernels"
    if name.startswith(("nvjet", "sm90_", "cutlass")) or "gemm" in name:
        return "GEMM (cuBLAS)"
    if "SoftMax" in name:
        return "log_softmax (loss head)"
    if "embedding" in name or "index" in name:
        return "embedding / index"
    return "elementwise and reductions (optimizer, clip, casts, MLP)"


def log_step_profile(label, prof):
    """Sum a profiled step's kernels by kernel_category() into
    ``prof["by_category"]`` and print the step's busy and idle time."""
    if prof is None:
        log(f"{label} step profile: no device time reported")
        return
    by = {}
    for row in prof["top"]:
        key = kernel_category(row["name"])
        ms, n = by.get(key, (0.0, 0))
        by[key] = (ms + row["ms"], n + row["count"])
    prof["by_category"] = by
    log(f"{label} step profile: device busy {prof['device_busy_ms']:.1f} ms "
        f"of {prof['wall_ms_under_profiler']:.1f} ms (idle share "
        f"{prof['device_idle_share']:.4f}), {prof['launches']} launches; by "
        f"category (ms, launches): {by}")


def train_batch(torch, vocab, b, s, dev, seed, split=None):
    """Token ids, next-token labels and (with ``split``) segment ids
    packing two documents into row 0, the label at the seam ignored."""
    rs = np.random.RandomState(seed)
    ids = rs.randint(0, vocab, (b, s + 1))
    labels = ids[:, 1:].copy()
    batch = {"input_ids": ids[:, :-1], "labels": labels}
    if split is not None:
        seg = np.zeros((b, s), np.int32)
        seg[0, split:] = 1
        labels[0, split - 1] = -100
        batch["segment_ids"] = seg
    return {k: torch.tensor(v, device=dev) for k, v in batch.items()}


# phase 6 in bf16: the card's cuBLAS GEMMs and the CPU's round their
# bf16 outputs differently, so the first step is held per tensor by the
# relative Frobenius error ||card - cpu|| / ||cpu||, which reads
# 8.3e-3 to 1.54e-2 on every tensor (H100 80GB HBM3, 700 W). This is
# the coarse end-to-end check; phase 3's per-row check is the sharp one.
BF16_GRAD_TOL = 3e-2
BF16_LOSS_RTOL = 1e-2


def phase_train_equality(torch, pt, dev, make_cfg, dtype="float32"):
    """Phase 6: the training step on the card (kernels) against the same
    step on the CPU (plain versions). fp32: first-step gradients and 3
    AdamW steps' losses. bf16 (the dtype of the training run, whose
    flash kernels take the Hopper route): the first step's loss and
    gradients."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer
    # Llama-3-8B's attention layout; MLP 14336 -> 1024 and vocabulary
    # 128256 -> 4096 so that the CPU steps through it in seconds; the
    # default (fused) loss head
    cfg = make_cfg(num_hidden_layers=2, dtype=dtype, intermediate_size=1024,
                   vocab_size=4096)
    fp32 = dtype == "float32"
    t0 = time.perf_counter()
    card = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(9, dev))
    cpu = copy.deepcopy(card).to("cpu")
    side = {}
    for name, model in (("card", card), ("cpu", cpu)):
        d = next(model.parameters()).device
        batch = train_batch(torch, cfg.vocab_size, 2, 256, d, 9, split=100)
        loss = model(**batch, return_logits=False)
        loss.backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in
                 model.named_parameters()}
        losses = [float(loss.detach())]
        if fp32:
            model.zero_grad(set_to_none=True)
            trainer = Trainer(model, AdamW(
                learning_rate=1e-4, parameters=model, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0)))
            losses = [float(trainer.train_step(batch)) for _ in range(3)]
        side[name] = (grads, losses)
    (gc, lc), (gp, lp) = side["card"], side["cpu"]
    if fp32:
        # per tensor: max |card - cpu| over the tensor's largest |cpu|
        grad_err = {n: float((gc[n] - gp[n]).abs().max()
                             / gp[n].abs().max().clamp_min(1e-30))
                    for n in gp}
        measure, grad_tol, loss_rtol = "max|diff|/max|cpu|", 1e-4, 1e-4
    else:
        grad_err = {n: float((gc[n] - gp[n]).norm()
                             / gp[n].norm().clamp_min(1e-30)) for n in gp}
        measure, grad_tol = "||diff||/||cpu||", BF16_GRAD_TOL
        loss_rtol = BF16_LOSS_RTOL
    worst = max(grad_err, key=grad_err.get)
    loss_ok = bool(np.allclose(lc, lp, rtol=loss_rtol, atol=0.0))
    grad_ok = grad_err[worst] <= grad_tol
    log(f"training equality (llama3_8b attention layout, 2 layers, MLP "
        f"1024, vocab 4096, {dtype}, 2 x 256 tokens with segments): losses "
        f"card {lc} cpu {lp} (rtol {loss_rtol}: "
        f"{'ok' if loss_ok else 'FAIL'}); first-step gradients: worst "
        f"{measure} {grad_err[worst]:.2e} at {worst} (tol {grad_tol}: "
        f"{'ok' if grad_ok else 'FAIL'}); {time.perf_counter() - t0:.1f} s")
    RESULTS.setdefault("train_equality", {})[dtype] = {
        "losses_card": lc, "losses_cpu": lp, "grad_err": grad_err,
        "grad_measure": measure}
    del card, cpu
    empty_cache(torch, dev)
    if not (loss_ok and grad_ok):
        raise SystemExit(f"{dtype} training on the card differs from the "
                         f"plain path")
    return gc


def phase_recompute_equality(torch, pt, dev, make_cfg, ref):
    """Phase 6, recompute: the fp32 first-step gradients of the phase-6
    model and batch on the card with recompute="full" and "selective",
    against those of the recompute="none" run (``ref``): within 1e-6 of
    each tensor's largest value, and whether they are equal bit for
    bit."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    out = {}
    for rc in ("full", "selective"):
        cfg = make_cfg(num_hidden_layers=2, dtype="float32",
                       intermediate_size=1024, vocab_size=4096, recompute=rc)
        model = LlamaForCausalLM(cfg, device=dev,
                                 generator=pt.generator(9, dev))
        batch = train_batch(torch, cfg.vocab_size, 2, 256, dev, 9, split=100)
        model(**batch, return_logits=False).backward()
        grads = {n: p.grad.detach().float().cpu() for n, p in
                 model.named_parameters()}
        err = {n: float((grads[n] - ref[n]).abs().max()
                        / ref[n].abs().max().clamp_min(1e-30)) for n in ref}
        worst = max(err, key=err.get)
        equal = all(torch.equal(grads[n], ref[n]) for n in ref)
        out[rc] = {"worst": worst, "err": err[worst], "bit_equal": equal,
                   "ok": err[worst] <= 1e-6}
        log(f"recompute={rc!r} (fp32, phase-6 model): first-step gradients "
            f"vs recompute='none': worst max|diff|/max|none| "
            f"{err[worst]:.2e} at {worst} (tol 1e-6: "
            f"{'ok' if out[rc]['ok'] else 'FAIL'}); equal bit for bit: "
            f"{equal}")
        del model
        empty_cache(torch, dev)
    RESULTS["recompute_equality"] = out
    if not all(v["ok"] for v in out.values()):
        raise SystemExit("gradients under recompute differ from those "
                         "without it")


def train_run(torch, pt, dev, cfg, batch, warm_steps, steps, profile=False,
              model_cls=None):
    """Build ``model_cls(cfg)`` (LlamaForCausalLM by default) and its
    trainer (AdamW(1e-4, weight_decay=0.01), global-norm clip 1.0, seed
    10) on ``dev``, take ``warm_steps`` and then ``steps`` timed steps of
    ``batch`` through Trainer.fit, with the launch counts reset just
    before the timed steps and read just after. Returns the run's
    numbers."""
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer
    t0 = time.perf_counter()
    model = (model_cls or LlamaForCausalLM)(cfg, device=dev,
                                            generator=pt.generator(10, dev))
    trainer = Trainer(model, AdamW(learning_rate=1e-4, parameters=model,
                                   weight_decay=0.01,
                                   grad_clip=ClipGradByGlobalNorm(1.0)))
    sync(torch, dev)
    built_s = time.perf_counter() - t0
    warm = trainer.fit(iter([batch] * warm_steps), warm_steps, log_every=1)
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _build.reset_launches()
    hist = trainer.fit(iter([batch] * steps), steps, log_every=1)
    sync(torch, dev)
    launches = dict(_build.LAUNCHES)
    peak_mem = (torch.cuda.max_memory_allocated(dev)
                if dev.type == "cuda" else None)
    # the step's peak falls in the optimizer update (fp32 temporaries of
    # the largest parameters), where no activation is alive; one more
    # forward and backward alone shows the activations' footprint
    fwd_bwd_peak = None
    if dev.type == "cuda":
        model.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats(dev)
        model(**batch, return_logits=False).backward()
        sync(torch, dev)
        fwd_bwd_peak = torch.cuda.max_memory_allocated(dev)
        model.zero_grad(set_to_none=True)
    b, s = batch["input_ids"].shape
    times = [m.step_time_s for m in hist]
    tps = len(hist) * b * s / sum(times)
    fpt = model.flops_per_token(s)
    info = {"loss_impl": getattr(cfg, "loss_impl", "fused"),
            "recompute": cfg.recompute,
            "layers": cfg.num_hidden_layers, "params": model.num_params(),
            "batch": [b, s], "built_s": built_s,
            "losses": [m.loss for m in warm + hist], "step_times_s": times,
            "median_step_s": statistics.median(times), "tokens_per_s": tps,
            "flops_per_token": fpt,
            "mfu_palm": (tps * fpt / trainer.peak_flops
                         if trainer.peak_flops else None),
            "peak_memory_bytes": peak_mem,
            "fwd_bwd_peak_memory_bytes": fwd_bwd_peak, "launches": launches,
            "launches_per_step": {k: v / len(hist)
                                  for k, v in launches.items()},
            "card": trainer.card}
    if profile:
        info["profile_step"] = profile_step(
            torch, dev, lambda: float(trainer.train_step(batch)), top=None)
    del trainer, model
    empty_cache(torch, dev)
    return info


def phase_train(torch, pt, dev, make_cfg, b=2, s=4096):
    """Phase 7: train 4 layers at Llama-3-8B widths on the card (batch
    b x s tokens) in the default configuration (fused vocab-CE head, no
    recompute): 2 warm-up and 8 timed steps, every training kernel
    counted. Then, on the same batch, 2 + 4 steps each of the naive head
    and of recompute "full" and "selective", for their step time and
    peak memory; the default run's peak must lie below the naive
    head's."""
    cfg = make_cfg(num_hidden_layers=4, dtype="bfloat16")
    batch = train_batch(torch, cfg.vocab_size, b, s, dev, 10)
    info = train_run(torch, pt, dev, cfg, batch, 2, 8, profile=True)
    launches, losses = info["launches"], info["losses"]
    RESULTS["training"] = info
    log(f"training model: llama3_8b widths, {cfg.num_hidden_layers} layers, "
        f"bf16, default head ({cfg.loss_impl}), {info['params'] / 1e9:.3f} "
        f"B parameters, built in {info['built_s']:.1f} s; card "
        f"{info['card']}")
    log(f"training: 8 timed steps of {b} x {s} tokens: "
        f"{info['tokens_per_s']:.1f} tokens/s, median step "
        f"{info['median_step_s']:.4f} s, MFU (PaLM, vs "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16, {info['card']}) "
        f"{info['mfu_palm']}, peak memory {info['peak_memory_bytes']} "
        f"bytes (forward + backward alone "
        f"{info['fwd_bwd_peak_memory_bytes']})")
    log(f"training losses: {losses}")
    log(f"training launches per step: {info['launches_per_step']}")
    log_step_profile("training", info["profile_step"])
    variants = {}
    for name, kw in (("naive_head", dict(loss_impl="naive")),
                     ("recompute_full", dict(recompute="full")),
                     ("recompute_selective", dict(recompute="selective"))):
        v = train_run(torch, pt, dev, make_cfg(num_hidden_layers=4,
                                               dtype="bfloat16", **kw),
                      batch, 2, 4)
        variants[name] = v
        log(f"training variant {name}: 4 timed steps: "
            f"{v['tokens_per_s']:.1f} tokens/s, median step "
            f"{v['median_step_s']:.4f} s, MFU {v['mfu_palm']}, peak memory "
            f"{v['peak_memory_bytes']} bytes (forward + backward alone "
            f"{v['fwd_bwd_peak_memory_bytes']}), losses {v['losses']}")
    RESULTS["training_variants"] = variants
    missing = [k for k in TRAINING_KERNELS if launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the training path: "
                         f"{missing}")
    if launches["vocab_ce_fwd_wgmma"] != launches["vocab_ce_fwd"]:
        raise SystemExit(f"CE forward launches off the wgmma route: "
                         f"{launches['vocab_ce_fwd_wgmma']} of "
                         f"{launches['vocab_ce_fwd']}")
    for name, run in [("default", info)] + list(variants.items()):
        if not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"training loss not finite ({name}): "
                             f"{run['losses']}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"training loss did not fall: {losses}")
    naive_peak = variants["naive_head"]["peak_memory_bytes"]
    if dev.type == "cuda" and not info["peak_memory_bytes"] < naive_peak:
        raise SystemExit(f"the fused head's peak memory "
                         f"{info['peak_memory_bytes']} is not below the "
                         f"naive head's {naive_peak}")
    return launches


# -- MoE: the grouped matmul kernels, equality and the training run -------

def expert_counts(torch, kind, m, e, g):
    """int32 group sizes summing to m over e experts: "balanced" (equal),
    or "skewed": a quarter of the experts empty and the rest drawn from a
    Zipf law (exponent 1.2) in random order."""
    if kind == "balanced":
        return torch.full((e,), m // e, dtype=torch.int32, device="cuda")
    live = e - e // 4
    w = 1.0 / torch.arange(1, live + 1, dtype=torch.float64) ** 1.2
    c = torch.floor(w / w.sum() * m).long()
    c[0] += m - int(c.sum())
    c = torch.cat([c, torch.zeros(e - live, dtype=torch.long)])
    perm = torch.randperm(e, generator=g, device="cuda").cpu()
    return c[perm].to(torch.int32).cuda()


def grouped_library(torch, case, a, b, ends, gs):
    """The yardstick for one grouped product: ``torch._grouped_mm`` (bf16
    out; cumulative ``offs``) where this torch has it and it takes these
    operands, else a loop of torch.matmul over a host-side split (timed
    only; the port calls neither). ``case``: "fwd" a [m, k] · b [g, k, n],
    "dw" a [m, k]^T · b [m, n] per run. Returns (callable, name)."""
    runs = [int(c) for c in gs.tolist()]
    if case == "fwd":
        def loop():
            return [torch.matmul(x, b[i]) for i, x in
                    enumerate(torch.split(a, runs)) if runs[i]]
    else:
        def loop():
            return [torch.matmul(x.t(), y) for x, y in
                    zip(torch.split(a, runs), torch.split(b, runs))]
    fn = getattr(torch, "_grouped_mm", None)
    if fn is not None:
        args = (a, b) if case == "fwd" else (a.t(), b)
        try:
            fn(*args, offs=ends)
            torch.cuda.synchronize()
            return (lambda: fn(*args, offs=ends)), "torch._grouped_mm"
        except (RuntimeError, TypeError, ValueError) as e:
            RESULTS.setdefault("grouped_mm_refused", []).append(
                f"{case}: {str(e)[:200]}")
    return loop, "torch.matmul loop over a host split"


MOE_M, MOE_E = 49152, 64      # 2 x 4096 tokens x top-6; 64 experts


def phase_moe_kernels(torch, pt):
    """Phase 3, the grouped matmul at the bf16 dropless DeepSeekMoE-16B
    step's shapes (m = 49152 rows, 64 experts): the forward at gate_up
    (k 2048, n 2816) and down (k 1408, n 2048), with balanced and skewed
    counts, dx (the forward kernel reading the weight transposed) and dW
    of each, against the plain versions, elementwise and per row, timed
    beside the plain loop and the library call; a planted wrong
    tile→group (every run's offsets taken from the run before it) and a
    planted dW row shift (every run one row later) must fail the row
    check. fp32 at a small ragged shape (an empty group, a group
    smaller than a tile, rows past the groups)."""
    from paddle_tpu_torch.ops import grouped_matmul as gmm
    from paddle_tpu_torch.ops.kernels import grouped_matmul as kgm
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(1357)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    planted = {}
    bf = torch.bfloat16

    def plant(kernel, case, what, got, want):
        e = flash_compare(torch, [(got, want)], "bfloat16")
        planted[f"{kernel}/{case}/{what}"] = {
            "row_err": e[3], "row_caught": not e[5], "max_abs_err": e[0]}
        log(f"planted fault in {kernel} [{case}] ({what}): max_abs_err="
            f"{e[0]:.3e}, row_err={e[3]:.3e} vs row_tol {ROW_TOL} (row check "
            f"{'rejects' if not e[5] else 'MISSES'} it)")
        if e[5]:
            FAILED_CASES.append(f"{kernel}/{case}/{what}_missed")

    for proj, (k, n) in (("gate_up", (2048, 2816)), ("down", (1408, 2048))):
        w = (0.02 * torch.randn((MOE_E, k, n), generator=g,
                                device=dev)).to(bf)
        xs = torch.randn((MOE_M, k), generator=g, device=dev).to(bf)
        gy = torch.randn((MOE_M, n), generator=g, device=dev).to(bf)
        for kind in ("balanced", "skewed"):
            case = f"{proj}_{kind}"
            gs = expert_counts(torch, kind, MOE_M, MOE_E, g)
            ends = kgm.group_ends(gs)
            live = int((gs > 0).sum())
            ops = 2 * MOE_M * k * n
            wbytes = live * k * n * 2
            lib_f, lib_name = grouped_library(torch, "fwd", xs, w, ends, gs)
            lib_dx, _ = grouped_library(torch, "fwd", gy, w.transpose(1, 2),
                                        ends, gs)
            lib_dw, lib_dw_name = grouped_library(torch, "dw", xs, gy, ends,
                                                  gs)
            RESULTS.setdefault("grouped_library", {})[case] = [lib_name,
                                                               lib_dw_name]
            y = kgm.grouped_matmul(xs, w, ends)
            want = gmm.grouped_matmul_plain(xs, w, gs)
            t = (timed_ms(torch, lambda: kgm.grouped_matmul(xs, w, ends),
                          flush),
                 timed_ms(torch, lambda: gmm.grouped_matmul_plain(
                     xs, w, gs), flush, reps=10),
                 timed_ms(torch, lib_f, flush))
            bnd = bound(MOE_M * k * 2 + wbytes + MOE_M * n * 4, ops,
                        BF16_OPS_PER_S)
            record("grouped_matmul", case, "bfloat16",
                   flash_compare(torch, [(y, want)], "bfloat16"), *t, bnd)
            product_rate("grouped_matmul", case, ops, bnd, t[0], t[2],
                    key="gemm_rates")
            # every run's rows taken from the run before: rows multiply
            # the next expert's weight, the last run's rows become 0
            shifted = torch.cat([ends.new_zeros(1), ends[:-1]])
            plant("grouped_matmul", case, "tile_group_shifted",
                  kgm.grouped_matmul(xs, w, shifted), want)
            del y, want
            dx = kgm.grouped_matmul(gy, w, ends, out_dtype=bf,
                                    transpose_w=True)
            want = gmm.grouped_matmul_plain(gy, w.transpose(1, 2),
                                            gs).to(bf)
            t = (timed_ms(torch, lambda: kgm.grouped_matmul(
                     gy, w, ends, out_dtype=bf, transpose_w=True), flush),
                 timed_ms(torch, lambda: gmm.grouped_matmul_plain(
                     gy, w.transpose(1, 2), gs).to(bf), flush, reps=10),
                 timed_ms(torch, lib_dx, flush))
            bnd = bound(MOE_M * n * 2 + wbytes + MOE_M * k * 2, ops,
                        BF16_OPS_PER_S)
            record("grouped_matmul", f"{proj}_dx_{kind}", "bfloat16",
                   flash_compare(torch, [(dx, want)], "bfloat16"), *t, bnd)
            product_rate("grouped_matmul", f"{proj}_dx_{kind}", ops, bnd, t[0],
                    t[2], key="gemm_rates")
            del dx, want
            dw = kgm.grouped_matmul_dw(xs, gy, ends, out_dtype=bf)
            want = gmm.grouped_matmul_dw_plain(xs, gy, gs).to(bf)
            t = (timed_ms(torch, lambda: kgm.grouped_matmul_dw(
                     xs, gy, ends, out_dtype=bf), flush),
                 timed_ms(torch, lambda: gmm.grouped_matmul_dw_plain(
                     xs, gy, gs).to(bf), flush, reps=10),
                 timed_ms(torch, lib_dw, flush))
            bnd = bound(MOE_M * (k + n) * 2 + MOE_E * k * n * 2, ops,
                        BF16_OPS_PER_S)
            record("grouped_matmul_dw", case, "bfloat16",
                   flash_compare(torch, [(dw, want)], "bfloat16"), *t, bnd)
            product_rate("grouped_matmul_dw", case, ops, bnd, t[0], t[2],
                    key="gemm_rates")
            again = kgm.grouped_matmul_dw(xs, gy, ends, out_dtype=bf)
            if not torch.equal(again, dw):
                FAILED_CASES.append(f"grouped_matmul_dw/{case}/"
                                    f"not_bit_identical")
            del again
            empty = gs == 0
            if bool(empty.any()) and int(torch.count_nonzero(dw[empty])):
                FAILED_CASES.append(f"grouped_matmul_dw/{case}/empty_not_0")
            # every run one row later: each run's dW loses its first row
            # and gains the next run's first
            plant("grouped_matmul_dw", case, "row_shift",
                  kgm.grouped_matmul_dw(xs, gy, (ends + 1).clamp_max(MOE_M),
                                        out_dtype=bf), want)
            del dw, want
            torch.cuda.synchronize()
        del w, xs, gy
        torch.cuda.empty_cache()

    # fp32: FMAs, ragged everything, rows past the groups
    counts = torch.tensor([37, 0, 5, 300, 1], dtype=torch.int32, device=dev)
    m, k, n = 400, 96, 80
    xs = torch.randn((m, k), generator=g, device=dev)
    w = 0.1 * torch.randn((5, k, n), generator=g, device=dev)
    gy = torch.randn((m, n), generator=g, device=dev)
    ends = kgm.group_ends(counts)
    for kernel, got, want in (
            ("grouped_matmul", kgm.grouped_matmul(xs, w, ends),
             gmm.grouped_matmul_plain(xs, w, counts)),
            ("grouped_matmul", kgm.grouped_matmul(gy, w, ends,
                                                  transpose_w=True),
             gmm.grouped_matmul_plain(gy, w.transpose(1, 2), counts))):
        record(kernel, "ragged_400", "float32",
               compare(torch, got, want, "float32"))
    # dW sums up to 300 rows in another order: the rounding error scales
    # with the summands, not with the (often cancelling) result, so it is
    # held to 1e-5 of its largest magnitude, as the RMSNorm backward's dw
    dw = kgm.grouped_matmul_dw(xs, gy, ends)
    want = gmm.grouped_matmul_dw_plain(xs, gy, counts)
    diff, scale = float((dw - want).abs().max()), float(want.abs().max())
    record("grouped_matmul_dw", "ragged_400", "float32",
           (diff, diff / scale, diff <= 1e-5 * scale), tol="1e-5 of max")
    RESULTS["planted_moe"] = planted
    del flush
    torch.cuda.empty_cache()


def phase_parent_turns(torch, parent):
    """With ``--parent DIR`` (the parent commit's tree unpacked in DIR):
    the parent's kernels against this tree's on the same inputs, each
    library built from its own tree's sources, timed in turns (parent,
    this, this, parent) as timed_ms times phase 3's rows: the int8
    product at the five decode projections (m = 8) and at gate_up
    (n 28672, k 4096) with m = 128 and 1024, and the grouped forward, dx
    and dW at phase 3's DeepSeekMoE-16B shapes, balanced and skewed,
    through this tree's wrappers (their C interface is unchanged;
    with_library); then paged decode and the CE kernels
    (parent_serving_and_ce_turns), and the RMSNorm forward and RoPE
    through the parent's own C interface (parent_norm_rope_turns). The
    two results' largest difference is kept beside the times."""
    from pathlib import Path
    from paddle_tpu_torch.nn.quantized_linear import weight_quantize
    from paddle_tpu_torch.ops.kernels import _build
    from paddle_tpu_torch.ops.kernels import grouped_matmul as kgm
    from paddle_tpu_torch.ops.kernels import int8_matmul as kmm
    root = Path(parent).resolve()
    build_log = {}
    plib = _build.load(_build.build(root / "paddle_tpu_torch" / "csrc",
                                    root / "build" / "torch_kernels",
                                    build_log))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(97)
    flush = torch.empty(64 * 2**20, dtype=torch.int32, device=dev)
    bf = torch.bfloat16
    rows = {}

    def turns(name, parent_fn, this_fn, exact=False, reps=25):
        """exact: the two trees' outputs must be equal bit for bit."""
        diff = float((parent_fn().float() - this_fn().float()).abs().max())
        t = [timed_ms(torch, f, flush, reps=reps)
             for f in (parent_fn, this_fn, this_fn, parent_fn)]
        rows[name] = {"parent_us": [t[0] * 1e3, t[3] * 1e3],
                      "this_us": [t[1] * 1e3, t[2] * 1e3],
                      "max_abs_diff": diff}
        log(f"parent vs this tree, {name}: parent {t[0] * 1e3:.1f} us, this "
            f"{t[1] * 1e3:.1f} us, this {t[2] * 1e3:.1f} us, parent "
            f"{t[3] * 1e3:.1f} us; max |parent - this| {diff:.3e}")
        if exact and diff != 0.0:
            FAILED_CASES.append(f"parent_turns/{name}_not_bit_equal")

    # the int8 product's C interface is the parent's too (the decode
    # route's workspace, tickets and split are in both trees): both run
    # through this tree's wrapper, the parent's with its library in place
    for case, m, (n, k) in (
            *((f"decode_{p}", 8, nk) for p, nk in DECODE_PROJECTIONS.items()),
            ("prefill_gate_up_128", 128, (28672, 4096)),
            ("prefill_gate_up_1024", 1024, (28672, 4096))):
        wq, scale = weight_quantize(0.02 * torch.randn((k, n), generator=g,
                                                       device=dev))
        x = torch.randn((m, k), generator=g, device=dev).to(bf)

        def this_mm(x=x, wq=wq, scale=scale):
            return kmm.int8_matmul(x, wq, scale)
        turns(f"int8_matmul/{case}", with_library(plib, this_mm), this_mm)
        del wq, scale, x
    torch.cuda.empty_cache()
    for proj, (k, n) in (("gate_up", (2048, 2816)), ("down", (1408, 2048))):
        w = (0.02 * torch.randn((MOE_E, k, n), generator=g,
                                device=dev)).to(bf)
        xs = torch.randn((MOE_M, k), generator=g, device=dev).to(bf)
        gy = torch.randn((MOE_M, n), generator=g, device=dev).to(bf)
        for kind in ("balanced", "skewed"):
            ends = kgm.group_ends(expert_counts(torch, kind, MOE_M, MOE_E,
                                                g))
            for name, fn in (
                    (f"grouped_matmul/{proj}_{kind}",
                     lambda: kgm.grouped_matmul(xs, w, ends)),
                    (f"grouped_matmul/{proj}_dx_{kind}",
                     lambda: kgm.grouped_matmul(gy, w, ends, out_dtype=bf,
                                                transpose_w=True)),
                    (f"grouped_matmul_dw/{proj}_{kind}",
                     lambda: kgm.grouped_matmul_dw(xs, gy, ends,
                                                   out_dtype=bf))):
                turns(name, with_library(plib, fn), fn)
        del w, xs, gy
        torch.cuda.empty_cache()
    parent_serving_and_ce_turns(torch, plib, dev, g, flush, turns)
    parent_norm_rope_turns(torch, plib, dev, g, turns)
    RESULTS["parent_turns"] = {"parent": str(root), "rows": rows,
                               "parent_build_s": build_log.get("seconds")}
    del flush
    torch.cuda.empty_cache()


def parent_norm_rope_turns(torch, plib, dev, g, turns):
    """The parent's RMSNorm forward and RoPE kernels against this tree's
    at phase 3's shapes (decode, prefill and training at Llama's widths
    and training at DeepSeekMoE's), bf16, each through its own tree's C
    interface: the parent's took a vec8 flag for the norm and no
    plan for either, so its argtypes are set here and it is called as
    its own wrapper called it. The decode rows are also profiled as a
    decode step runs them: 65 (RMSNorm) or 32 (RoPE) launches back to
    back, no L2 flush, device time from torch.profiler."""
    import ctypes
    from paddle_tpu_torch.ops import rope as rope_ops
    from paddle_tpu_torch.ops.kernels import _build, fused_norm, fused_rope
    P, I, F, LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    profiled = {}

    def profiled_turns(name, parent_fn, this_fn, n):
        """Device us a launch, as torch.profiler reports it, of n launches
        back to back (a decode step's count), parent / this / this /
        parent."""
        per = []
        for fn in (parent_fn, this_fn, this_fn, parent_fn):
            prof = profile_step(torch, dev, lambda fn=fn: [
                fn() for _ in range(n)], sums={"all": ("",)})
            per.append(prof["sums"]["all"]["us"] / n)
        profiled[name] = {"launches": n, "parent_us": [per[0], per[3]],
                          "this_us": [per[1], per[2]]}
        log(f"profiled, {n} launches back to back, {name}: device us a "
            f"launch: parent {per[0]:.2f}, this {per[1]:.2f}, this "
            f"{per[2]:.2f}, parent {per[3]:.2f}")
    plib.pt_rms_norm_fwd.argtypes = [P, P, P, P, I, I, F, I, I, I, P]
    plib.pt_fused_rope.argtypes = [P] * 7 + [I] * 5 + [LL] * 6 + [I, I, P]
    stream = _build.stream_ptr(dev)
    for case, R, width in NORM_CASES:
        x = torch.randn((R, width), generator=g, device=dev).to(
            torch.bfloat16)
        w = 1 + 0.1 * torch.randn((width,), generator=g, device=dev)
        y = torch.empty_like(x)

        def par_norm(x=x, w=w, y=y, R=R, width=width):
            _build.check(plib.pt_rms_norm_fwd(
                x.data_ptr(), w.data_ptr(), y.data_ptr(), None, R, width,
                1e-5, 1, 0, 1, stream), "parent rms_norm")
            return y
        def this_norm(x=x, w=w):
            return fused_norm.rms_norm_fwd(x, w, 1e-5)[0]
        turns(f"rms_norm/{case}", par_norm, this_norm)
        if case == "decode_b8":
            profiled_turns(f"rms_norm/{case}", par_norm, this_norm, 65)
    cos, sin = rope_ops.rope_freqs(128, 8192, 500000.0, device=dev)
    for case, (b, s), (h, hkv) in ROPE_CASES:
        qkv = torch.randn((b, s, (h + 2 * hkv) * 128), generator=g,
                          device=dev).to(torch.bfloat16)
        q = qkv[..., :h * 128].view(b, s, h, 128)
        k = qkv[..., h * 128:(h + hkv) * 128].view(b, s, hkv, 128)
        pos = (None if s > 1 else torch.randint(
            0, 2048, (b, s), generator=g, device=dev))
        qo = torch.empty((b, s, h, 128), dtype=q.dtype, device=dev)
        ko = torch.empty((b, s, hkv, 128), dtype=q.dtype, device=dev)

        def par_rope(q=q, k=k, qo=qo, ko=ko, pos=pos, b=b, s=s, h=h,
                     hkv=hkv):
            _build.check(plib.pt_fused_rope(
                q.data_ptr(), k.data_ptr(), qo.data_ptr(), ko.data_ptr(),
                cos.data_ptr(), sin.data_ptr(),
                pos.data_ptr() if pos is not None else None, b, s, h, hkv,
                128, *q.stride()[:3], *k.stride()[:3], cos.shape[0], 1,
                stream), "parent fused_rope")
            return qo

        def this_rope(q=q, k=k, pos=pos):
            return fused_rope.fused_rope(q, k, cos, sin, pos)[0]
        # the difference is read on the rotated q (k takes the same path)
        turns(f"fused_rope/{case}", par_rope, this_rope)
        if case == "decode_b8":
            profiled_turns(f"fused_rope/{case}", par_rope, this_rope, 32)
    RESULTS["norm_rope_profiled_decode"] = profiled


def with_library(lib, fn):
    """``fn`` as a call that runs with the kernel library ``lib`` (another
    tree's, of the same C interface) in place of this tree's, so that this
    tree's wrappers launch that tree's kernels."""
    from paddle_tpu_torch.ops.kernels import _build

    def call():
        own, _build._LIB = _build._LIB, lib
        try:
            return fn()
        finally:
            _build._LIB = own
    return call


def parent_serving_and_ce_turns(torch, plib, dev, g, flush, turns):
    """The parent's and this tree's paged decode (native and int8 pools,
    phase 3's ctx1024 shape, bf16) and CE forward (phase 3's train_8192
    shape) in turns, and the CE backward's dlog, dh and dW of one chunk,
    which must be equal bit for bit. These kernels' C interfaces are the
    parent's too, so the parent's run through this tree's wrappers with
    the parent's library in place (``with_library``)."""
    from paddle_tpu_torch.ops.kernels import fused_vocab_ce as kce
    from paddle_tpu_torch.ops.kernels import paged_attention
    on = with_library
    bf = torch.bfloat16
    B, H, HKV, HD, page, ctx = 8, 32, 8, 128, 128, 1024
    mp = 2048 // page
    num_pages = B * mp + 1
    q = torch.randn((B, H, HD), generator=g, device=dev).to(bf)
    tables = (torch.randperm(num_pages - 1, generator=g, device=dev)
              [:B * mp] + 1).view(B, mp).to(torch.int32).contiguous()
    lens = torch.full((B,), ctx - 1, dtype=torch.int64, device=dev)
    native = tuple(torch.randn((HKV, num_pages, page, HD), generator=g,
                               device=dev).to(bf) for _ in range(2))
    quant = (quant_pages(torch, g, dev, HKV, num_pages, page, HD),
             quant_pages(torch, g, dev, HKV, num_pages, page, HD))
    for name, kp, vp, sc in (
            ("paged_decode/ctx1024", *native, {}),
            ("paged_decode_int8/ctx1024", quant[0][0], quant[1][0],
             dict(k_scales=quant[0][1], v_scales=quant[1][1]))):
        def this(kp=kp, vp=vp, sc=sc):
            return paged_attention.paged_decode(q, kp, vp, tables, lens,
                                                **sc)
        turns(name, on(plib, this), this)
    del native, quant, q
    torch.cuda.empty_cache()

    N, Hd, V, C = 8192, 4096, 128256, kce.CHUNK
    h = torch.randn((N, Hd), generator=g, device=dev).to(bf)
    w = (0.02 * torch.randn((Hd, V), generator=g, device=dev)).to(bf)
    labels = torch.randint(0, V, (N,), generator=g, device=dev).to(
        torch.int32)
    labels[::97] = -1

    def fwd():
        return torch.stack(kce.vocab_ce_fwd(h, w, labels))
    turns("vocab_ce_fwd/train_8192", on(plib, fwd), fwd, reps=10)
    lse = fwd()[0].contiguous()
    g_lse = torch.randn((N,), generator=g, device=dev)
    g_tgt = torch.randn((N,), generator=g, device=dev)
    dl_p, dl_t = (torch.empty((N, C), dtype=bf, device=dev)
                  for _ in range(2))
    turns("vocab_ce_dlog/train_chunk_8192",
          on(plib, lambda: kce.vocab_ce_dlog(h, w, labels, lse, g_lse, g_tgt,
                                             0, C, dl_p)),
          lambda: kce.vocab_ce_dlog(h, w, labels, lse, g_lse, g_tgt, 0, C,
                                    dl_t), exact=True)
    dh_p, dh_t = torch.empty_like(h), torch.empty_like(h)
    turns("vocab_ce_dh/train_chunk_8192",
          on(plib, lambda: kce.vocab_ce_dh(dl_t, w, 0, C, dh_p)),
          lambda: kce.vocab_ce_dh(dl_t, w, 0, C, dh_t), exact=True)
    del dh_p, dh_t
    dw_p, dw_t = torch.empty_like(w), torch.empty_like(w)
    turns("vocab_ce_dw/train_chunk_8192",
          on(plib, lambda: kce.vocab_ce_dw(h, dl_t, 0, C, dw_p)[:, :C]),
          lambda: kce.vocab_ce_dw(h, dl_t, 0, C, dw_t)[:, :C], exact=True)
    del dw_p, dw_t, dl_p, dl_t, h, w
    torch.cuda.empty_cache()


def norm_rope_gaps():
    """The RMSNorm and RoPE forwards at their launched shapes (phase 3's
    bf16 rows): time, bound, the launch floor, launches a call of the
    path that runs that shape (a decode step and a prefill of phase 5, a
    step of phase 7 or 9) and launches x the gap to the least time, in
    us. The least time of a decode row is max(bound, floor): its bytes
    take nanoseconds, and no launch takes less than the floor."""
    floor = RESULTS["launch_floor_us"]
    per = {"decode_b8": RESULTS["serving"]["launches_per_call"]
           ["decode_step"],
           "prefill_1024": RESULTS["serving"]["launches_per_call"]
           ["prefill"],
           "train": RESULTS["training"]["launches_per_step"],
           "train_moe": RESULTS["moe_training"]["launches_per_step"]}
    rows = {}
    for c in RESULTS["kernel_cases"]:
        if (c["kernel"] not in ("rms_norm", "fused_rope")
                or c["dtype"] != "bfloat16" or c["ms"] is None):
            continue
        case = c["case"]
        path = ("train_moe" if case.endswith("_moe") else
                "train" if case.startswith("train") else case)
        n = per[path][c["kernel"]]
        bound_us = c["bound_ms"] * 1e3
        least = max(bound_us, floor) if case == "decode_b8" else bound_us
        row = {"us": c["ms"] * 1e3, "bound_us": bound_us, "floor_us": floor,
               "copy_us": c["copy_ms"] * 1e3, "least_us": least,
               "share_of_least": least / (c["ms"] * 1e3),
               "launches": n,
               "launches_x_gap_us": n * (c["ms"] * 1e3 - least)}
        rows[f"{c['kernel']}/{case}"] = row
        log(f"{c['kernel']} [{case}]: {row['us']:.2f} us, bound "
            f"{bound_us:.2f} us, floor {floor:.2f} us, a copy of its bytes "
            f"{row['copy_us']:.2f} us, least "
            f"{least:.2f} us ({row['share_of_least']:.2f} of it), {n} "
            f"launches a call, launches x gap "
            f"{row['launches_x_gap_us']:.1f} us")
    RESULTS["norm_rope_gaps"] = rows


def phase_moe_sync(torch, pt, dev):
    """Phase 8, host syncs: one dropless MoELayer at DeepSeekMoE-16B
    widths (hidden 2048, 64 experts of 1408, top-6, bf16) over 4096
    tokens, forward and backward under
    torch.cuda.set_sync_debug_mode("error") after a warm-up pass: any
    call that makes the host wait for the device raises."""
    from paddle_tpu_torch.parallel.moe import MoELayer
    layer = MoELayer(2048, 1408, 64, top_k=6, capacity_factor=None,
                     dtype="bfloat16", device=dev,
                     generator=pt.generator(11, dev))
    x = torch.randn((1, 4096, 2048), device=dev, dtype=torch.bfloat16,
                    generator=pt.generator(12, dev), requires_grad=True)

    def step():
        out, aux = layer(x)
        (out.float().square().mean() + aux).backward()
    step()
    sync(torch, dev)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step()
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    sync(torch, dev)
    RESULTS["moe_sync_check"] = "no host sync in one MoELayer fwd + bwd"
    log("MoE host-sync check: one dropless MoELayer forward + backward "
        "(DeepSeekMoE-16B widths, 4096 tokens, bf16) ran under "
        "set_sync_debug_mode('error')")
    del layer, x
    empty_cache(torch, dev)


def routing_ids(torch, model):
    """Forward pre-hooks on every MoE layer that keep the top-k expert
    ids each token is routed to, sorted (the order of the choices does
    not matter to the result): returns (ids list, hook handles)."""
    ids, handles = [], []
    for layer in model.layers:
        moe = getattr(layer, "moe", None)
        if moe is None:
            continue

        def hook(mod, args):
            with torch.no_grad():
                z = args[0].reshape(-1, args[0].shape[-1])
                probs = torch.softmax(mod._logits(z), dim=-1)
                ids.append(torch.topk(probs, mod.top_k, dim=-1)[1].sort(
                    -1)[0].cpu())
        handles.append(moe.register_forward_pre_hook(hook))
    return ids, handles


# phase 8 in bf16: the card's and the CPU's bf16 rounding differ, and a
# token whose k-th and (k+1)-th router probabilities are near-equal can
# then take another expert; the loss is held to BF16_LOSS_RTOL and the
# differing routing ids are reported
def phase_moe_equality(torch, pt, dev, make_cfg, dtype):
    """Phase 8: DeepSeekMoE-16B's attention and expert layout (hidden
    2048, 16 heads, 64 experts of 1408, top-6, 2 shared experts) at 2
    layers (1 dense, 1 MoE) with the dense MLP cut to 1024 and the
    vocabulary to 4096, dropless, the same seeded weights and batch
    (2 x 256 tokens) on the card (kernels) and on the CPU (plain
    versions): routing ids, the first step's loss and gradients. fp32:
    no routing id may differ, loss rtol 1e-4, gradients 1e-4 of each
    tensor's largest; bf16: loss rtol BF16_LOSS_RTOL, gradients and
    differing ids reported."""
    from paddle_tpu_torch.models import MoEForCausalLM
    cfg = make_cfg(num_hidden_layers=2, intermediate_size=1024,
                   vocab_size=4096, capacity_factor=None, dtype=dtype)
    t0 = time.perf_counter()
    card = MoEForCausalLM(cfg, device=dev, generator=pt.generator(9, dev))
    cpu = copy.deepcopy(card).to("cpu")
    side = {}
    for name, model in (("card", card), ("cpu", cpu)):
        d = next(model.parameters()).device
        batch = train_batch(torch, cfg.vocab_size, 2, 256, d, 9)
        ids, handles = routing_ids(torch, model)
        loss = model(**batch, return_logits=False)
        for h in handles:
            h.remove()
        loss.backward()
        side[name] = (float(loss.detach()), torch.cat(ids),
                      {n: p.grad.detach().float().cpu()
                       for n, p in model.named_parameters()})
    (lc, ic, gc), (lp, ip, gp) = side["card"], side["cpu"]
    differ = int((ic != ip).any(-1).sum())
    grad_err = {n: float((gc[n] - gp[n]).abs().max()
                         / gp[n].abs().max().clamp_min(1e-30)) for n in gp}
    worst = max(grad_err, key=grad_err.get)
    fp32 = dtype == "float32"
    loss_rtol = 1e-4 if fp32 else BF16_LOSS_RTOL
    loss_ok = abs(lc - lp) <= loss_rtol * abs(lp)
    ok = loss_ok and (not fp32 or (differ == 0 and grad_err[worst] <= 1e-4))
    log(f"MoE equality (deepseek_moe_16b widths, 2 layers, MLP 1024, vocab "
        f"4096, dropless, {dtype}, 2 x 256 tokens): loss card {lc} cpu {lp} "
        f"(rtol {loss_rtol}); tokens whose routing ids differ: {differ} of "
        f"{ip.shape[0]}; first-step gradients: worst max|diff|/max|cpu| "
        f"{grad_err[worst]:.2e} at {worst}"
        f"{' (tol 1e-4)' if fp32 else ' (reported)'}: "
        f"{'ok' if ok else 'FAIL'}; {time.perf_counter() - t0:.1f} s")
    RESULTS.setdefault("moe_equality", {})[dtype] = {
        "loss_card": lc, "loss_cpu": lp, "routing_tokens_differ": differ,
        "tokens": ip.shape[0], "grad_err": grad_err}
    del card, cpu
    empty_cache(torch, dev)
    if not ok:
        raise SystemExit(f"{dtype} MoE training on the card differs from "
                         f"the plain path")


MOE_TRAINING_KERNELS = TRAINING_KERNELS + ("grouped_matmul",
                                           "grouped_matmul_dw")


def phase_moe_train(torch, pt, dev, make_cfg, b=2, s=4096):
    """Phase 9: train DeepSeekMoE-16B widths at 4 layers (1 dense + 3
    MoE), bf16, dropless, fused vocab-CE head, AdamW(1e-4, weight_decay
    0.01), clip 1.0, batch b x s from a numpy seed: 2 warm-up and 8 timed
    steps through Trainer.fit, launch counts reset just before and read
    just after, one step profiled. Then 2 + 4 steps at capacity_factor
    1.25 on the same batch. Every training kernel and both grouped-matmul
    kernels must launch, and the loss must be finite and fall."""
    from paddle_tpu_torch.models import MoEForCausalLM
    cfg = make_cfg(num_hidden_layers=4, capacity_factor=None,
                   dtype="bfloat16")
    batch = train_batch(torch, cfg.vocab_size, b, s, dev, 10)
    info = train_run(torch, pt, dev, cfg, batch, 2, 8, profile=True,
                     model_cls=MoEForCausalLM)
    launches, losses = info["launches"], info["losses"]
    RESULTS["moe_training"] = info
    log(f"MoE training model: deepseek_moe_16b widths, "
        f"{cfg.num_hidden_layers} layers, bf16, dropless, "
        f"{info['params'] / 1e9:.3f} B parameters, built in "
        f"{info['built_s']:.1f} s; card {info['card']}")
    log(f"MoE training: 8 timed steps of {b} x {s} tokens: "
        f"{info['tokens_per_s']:.1f} tokens/s, median step "
        f"{info['median_step_s']:.4f} s, MFU (activated parameters, vs "
        f"{BF16_OPS_PER_S / 1e12:.0f} TFLOP/s bf16, {info['card']}) "
        f"{info['mfu_palm']}, peak memory {info['peak_memory_bytes']} bytes "
        f"(forward + backward alone {info['fwd_bwd_peak_memory_bytes']})")
    log(f"MoE training losses: {losses}")
    log(f"MoE training launches per step: {info['launches_per_step']}")
    log_step_profile("MoE training", info["profile_step"])
    cap = train_run(torch, pt, dev, make_cfg(
        num_hidden_layers=4, capacity_factor=1.25, dtype="bfloat16"),
        batch, 2, 4, model_cls=MoEForCausalLM)
    RESULTS["moe_training_capacity"] = cap
    log(f"MoE training at capacity_factor 1.25: 4 timed steps: "
        f"{cap['tokens_per_s']:.1f} tokens/s, median step "
        f"{cap['median_step_s']:.4f} s, MFU {cap['mfu_palm']}, peak memory "
        f"{cap['peak_memory_bytes']} bytes, losses {cap['losses']}, "
        f"launches per step {cap['launches_per_step']}")
    missing = [k for k in MOE_TRAINING_KERNELS if launches[k] <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the MoE training path: "
                         f"{missing}")
    # every grouped launch of the dropless step on the wgmma route
    off = [k for k in ("grouped_matmul", "grouped_matmul_dw",
                       "vocab_ce_fwd")
           if launches[f"{k}_wgmma"] != launches[k]]
    log(f"MoE training grouped routes per step: "
        f"{info['launches_per_step']['grouped_matmul_wgmma']} + "
        f"{info['launches_per_step']['grouped_matmul_dw_wgmma']} on wgmma "
        f"of {info['launches_per_step']['grouped_matmul']} + "
        f"{info['launches_per_step']['grouped_matmul_dw']}")
    if off:
        raise SystemExit(f"grouped or CE forward launches off the wgmma "
                         f"route: {off}")
    for name, run in (("dropless", info), ("capacity", cap)):
        if not all(math.isfinite(x) for x in run["losses"]):
            raise SystemExit(f"MoE training loss not finite ({name}): "
                             f"{run['losses']}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"MoE training loss did not fall: {losses}")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import (_build, flash_attention,
                                              fused_norm, fused_rope,
                                              fused_vocab_ce, grouped_matmul,
                                              int8_matmul, paged_attention)
    t_start = time.perf_counter()
    # 1. the card
    card = pt.device_info()
    log(card)
    RESULTS["card"] = card
    # 2. build
    t0 = time.perf_counter()
    _build.lib()
    path = _build.library_path()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s -> {path}")
    RESULTS["build"] = {k: v for k, v in _build.BUILD_LOG.items()}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        phase_kernels(torch, pt)
        phase_quant_kernels(torch, pt)
    phase_train_kernels(torch, pt)
    phase_ce_kernels(torch, pt)
    with torch.inference_mode():
        phase_moe_kernels(torch, pt)
        if "--parent" in sys.argv:
            phase_parent_turns(torch, sys.argv[sys.argv.index("--parent")
                                                + 1])
    if FAILED_CASES:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{FAILED_CASES}")
    from paddle_tpu_torch.models import LlamaConfig, MoEConfig
    dev = torch.device("cuda")
    phase_engine_equality(torch, pt, dev, LlamaConfig.llama3_8b)
    phase_quant_engine_equality(torch, pt, dev, LlamaConfig.llama3_8b)
    serve_launches, quant_launches = phase_serving(torch, pt, dev,
                                                   LlamaConfig.llama3_8b)
    ref = phase_train_equality(torch, pt, dev, LlamaConfig.llama3_8b,
                               "float32")
    phase_train_equality(torch, pt, dev, LlamaConfig.llama3_8b, "bfloat16")
    phase_recompute_equality(torch, pt, dev, LlamaConfig.llama3_8b, ref)
    train_launches = phase_train(torch, pt, dev, LlamaConfig.llama3_8b)
    phase_moe_sync(torch, pt, dev)
    for dtype in ("float32", "bfloat16"):
        phase_moe_equality(torch, pt, dev, MoEConfig.deepseek_moe_16b, dtype)
    moe_launches = phase_moe_train(torch, pt, dev, MoEConfig.deepseek_moe_16b)
    norm_rope_gaps()
    cases = RESULTS["kernel_cases"]

    def main_case(kernel, case):
        return next(c for c in cases if c["kernel"] == kernel
                    and c["case"] == case and c["dtype"] == "bfloat16")
    kernels = []
    for name, source, replaces, case in (
            ("rms_norm", fused_norm.SOURCE, fused_norm.REPLACES,
             "prefill_1024"),
            ("rms_norm_bwd", fused_norm.SOURCE, fused_norm.REPLACES_BWD,
             "train_8192"),
            ("fused_rope", fused_rope.SOURCE, fused_rope.REPLACES,
             "prefill_1024"),
            ("flash_fwd", flash_attention.SOURCE,
             flash_attention.REPLACES["flash_fwd"], "train_4096"),
            ("flash_bwd", flash_attention.SOURCE,
             flash_attention.REPLACES["flash_bwd"], "train_4096"),
            ("paged_decode", paged_attention.SOURCE,
             paged_attention.REPLACES, "ctx1024"),
            *((name, fused_vocab_ce.SOURCE, fused_vocab_ce.REPLACES[name],
               "train_chunk_8192" if name == "vocab_ce_dlog"
               else "train_8192") for name in CE_KERNELS),
            ("int8_matmul", int8_matmul.SOURCE, int8_matmul.REPLACES,
             "decode_gate_up"),
            ("paged_decode_int8", paged_attention.SOURCE,
             paged_attention.REPLACES, "ctx1024"),
            ("grouped_matmul", grouped_matmul.SOURCE,
             grouped_matmul.REPLACES, "gate_up_balanced"),
            ("grouped_matmul_dw", grouped_matmul.SOURCE,
             grouped_matmul.REPLACES_DW, "gate_up_balanced")):
        c = main_case(name, case)
        by_path = {"serving": serve_launches[name],
                   "training": train_launches[name],
                   "quantized_serving": quant_launches[name],
                   "moe_training": moe_launches[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            # launches on the main paths: the serving run, the timed
            # training steps, the quantized serving run and the timed MoE
            # training steps, and each path's own count
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["kernel"] == name),
            "ms": c["ms"], "plain_ms": c["plain_ms"],
            "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
            "library_ms": c["library_ms"]})
    RESULTS["seconds"] = time.perf_counter() - t_start
    out_dir = os.path.join(root, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
        json.dump(RESULTS, f, indent=1, default=str)
    log(f"chip_smoke finished in {RESULTS['seconds']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
