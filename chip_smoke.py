#!/usr/bin/env python3
"""Drive the PyTorch/H100 port (``paddle_tpu_torch``) on one CUDA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the result line:
  1. print the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``paddle_tpu_torch/csrc`` and print the
     build seconds;
  3. per kernel: run it and its plain PyTorch version on the serving
     path's shapes in bf16 and fp32, print the errors against the stated
     tolerance, and time kernel, plain version and library call (CUDA
     events, L2 flushed before every launch, median of 25 after warm-up);
  4. engine equality: Llama-3-8B widths at 2 layers, fp32, seeded random
     weights: greedy tokens of the engine on the card equal those of a
     step-by-step plain-version path on the CPU;
  5. the serving run: Llama-3-8B widths, all 32 layers, bf16, seeded
     random weights built on the card; 16 requests (prompts 128-1536
     tokens, 64 new tokens, every 4th sampled) through
     ContinuousBatchingEngine(max_batch=8, page_size=128, max_len=2048,
     decode_block=8, async_depth=2). Kernel launch counts are reset just
     before and read just after; every kernel must have launched.
The line before the last is the ``kernels`` JSON object; the last line is
``{"ok": true, "device": {...}}``. Details go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import copy
import json
import os
import statistics
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
TOL = {"float32": (1e-5, 1e-5),
       # bf16: the kernel and the plain version both compute in fp32 and
       # round once to bf16 (step 2**-8 relative); a different summation
       # order or FMA contraction before that rounding may land one bf16
       # step apart
       "bfloat16": (2e-2, 2e-2)}
RESULTS: dict = {}


def log(*a):
    print(*a, flush=True)


def timed_ms(torch, fn, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of ``fn`` in ms, each launch timed
    alone by CUDA events after the L2 cache was flushed."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
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


def profile_step(torch, dev, step):
    """Device busy time of one call of ``step`` by kernel name, from
    torch.profiler (CUPTI); None where it reports no device time."""
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
    return {"wall_ms_under_profiler": wall_ms, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms,
            "kernels": len(rows),
            "launches": sum(r[2] for r in rows),
            "top": [{"name": k[:90], "ms": ms, "count": n}
                    for k, ms, n in rows[:8]]}


def bound(bytes_, ops):
    tb, to = bytes_ / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
    D, H, HKV, HD = 4096, 32, 8, 128
    cos, sin = rope_ops.rope_freqs(HD, 8192, 500000.0, device=dev)
    cases, failed = [], []

    def us(ms):
        return "-" if ms is None else f"{ms * 1e3:.1f} us"

    def record(kernel, case, dt, err, kms=None, pms=None, lms=None,
               bnd=(None, None)):
        """One checked case; the times are None for a case checked only."""
        max_abs, max_rel, ok = err
        row = dict(kernel=kernel, case=case, dtype=dt, max_abs_err=max_abs,
                   max_rel_err=max_rel, tol=TOL[dt], ok=ok, ms=kms,
                   plain_ms=pms, library_ms=lms, bound_ms=bnd[0],
                   bound_by=bnd[1])
        cases.append(row)
        timing = ("not timed" if kms is None else
                  f"kernel {us(kms)}, plain {us(pms)}, library {us(lms)}, "
                  f"bound {bnd[0] * 1e3:.2f} us ({bnd[1]})")
        log(f"kernel {kernel} [{case} {dt}] max_abs_err={max_abs:.3e} "
            f"max_rel_err={max_rel:.3e} tol(atol,rtol)={TOL[dt]} "
            f"{'ok' if ok else 'FAIL'} | {timing}")
        if not ok:
            failed.append(f"{kernel}/{case}/{dt}")

    # -- RMSNorm: prefill 1024 tokens and decode B=8, fp32 weight ----------
    for case, R in (("prefill_1024", 1024), ("decode_b8", 8)):
        for dt in ((torch.bfloat16, torch.float32) if R == 1024
                   else (torch.bfloat16,)):
            name = str(dt).split(".")[-1]
            x = torch.randn((R, D), generator=g, device=dev).to(dt)
            w = (1 + 0.1 * torch.randn((D,), generator=g, device=dev))
            eps = 1e-5
            got = fused_norm.rms_norm_fwd(x, w, eps)[0]
            want = norm_ops._rms_norm_plain(x, w, eps)
            err = compare(torch, got, want, name)
            wl = w.to(dt)
            e = x.element_size()
            record("rms_norm", case, name, err,
                   timed_ms(torch, lambda: fused_norm.rms_norm_fwd(
                       x, w, eps), flush),
                   timed_ms(torch, lambda: norm_ops._rms_norm_plain(
                       x, w, eps), flush),
                   timed_ms(torch, lambda: F.rms_norm(x, (D,), wl, eps),
                            flush),
                   bound(2 * R * D * e + D * 4, 4 * R * D))

    # -- RoPE: prefill q/k as views of a fused qkv, decode with positions --
    for case, (b, s) in (("prefill_1024", (1, 1024)), ("decode_b8", (8, 1))):
        for dt in ((torch.bfloat16, torch.float32) if s == 1024
                   else (torch.bfloat16,)):
            name = str(dt).split(".")[-1]
            qkv = torch.randn((b, s, (H + 2 * HKV) * HD), generator=g,
                              device=dev).to(dt)
            q = qkv[..., :H * HD].view(b, s, H, HD)
            k = qkv[..., H * HD:(H + HKV) * HD].view(b, s, HKV, HD)
            pos = (None if s > 1 else torch.randint(
                0, 2048, (b, s), generator=g, device=dev))
            gq, gk = fused_rope.fused_rope(q, k, cos, sin, pos)
            wq, wk = rope_ops._rope_plain(q, k, cos, sin, pos)
            ea = compare(torch, gq, wq, name)
            eb = compare(torch, gk, wk, name)
            err = (max(ea[0], eb[0]), max(ea[1], eb[1]), ea[2] and eb[2])
            e = q.element_size()
            nbytes = 2 * b * s * (H + HKV) * HD * e + 2 * b * s * HD * 4
            record("fused_rope", case, name, err,
                   timed_ms(torch, lambda: fused_rope.fused_rope(
                       q, k, cos, sin, pos), flush),
                   timed_ms(torch, lambda: rope_ops._rope_plain(
                       q, k, cos, sin, pos), flush),
                   None, bound(nbytes, 3 * b * s * (H + HKV) * HD))

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
            err = compare(torch, got, want, name)
            if case != "ctx1024":
                record("paged_decode", case, name, err)
                continue
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
    RESULTS["kernel_cases"] = cases
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failed}")
    return cases


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


def phase_serving(torch, pt, dev, make_cfg):
    from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                            GenerationConfig)
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.ops.kernels import _build
    cfg = make_cfg(dtype="bfloat16")
    t0 = time.perf_counter()
    model = LlamaForCausalLM(cfg, device=dev, generator=pt.generator(8, dev))
    sync(torch, dev)
    log(f"serving model: llama3_8b widths, {cfg.num_hidden_layers} layers, "
        f"bf16, built in {time.perf_counter() - t0:.1f} s")
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
    _build.reset_launches()
    t0 = time.perf_counter()
    rids = [eng.submit(p, max_new_tokens=n_new,
                       generation_config=sampled if i % 4 == 3 else None)
            for i, p in enumerate(prompts)]
    out = eng.run()
    sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    lat = eng.latency_stats()
    n_tok = sum(len(out[r]) for r in rids)
    logits_ok = bool(torch.isfinite(eng._state["logits"].float()).all())
    tok_ok = all(len(out[r]) == n_new and int(out[r].min()) >= 0
                 and int(out[r].max()) < cfg.vocab_size for r in rids)
    tps = n_tok / wall
    log(f"serving: {len(rids)} requests, prompt tokens {int(lens.sum())}, "
        f"generated {n_tok} in {wall:.3f} s = {tps:.1f} tokens/s; TTFT "
        f"p50 {lat['ttft_p50_s']*1e3:.1f} ms p99 "
        f"{lat['ttft_p99_s']*1e3:.1f} ms; ITL p50 "
        f"{lat.get('itl_p50_s', float('nan'))*1e3:.2f} ms; "
        f"stats {eng.stats()}")
    log(f"serving launches: {launches}")
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
        prof = profile_step(torch, dev, step)
    weight_bytes = sum(p.numel() * p.element_size()
                       for n, p in model.named_parameters()
                       if n != "model.embed_tokens")
    step_info = {"host_enqueue_ms": statistics.median(host),
                 "device_span_ms": statistics.median(dev_ms),
                 "weight_read_bound_ms": weight_bytes / HBM_BYTES_PER_S
                 * 1e3, "profile": prof}
    log(f"launches per prefill {per['prefill']}, per decode step "
        f"{per['decode_step']}; one decode step at B=8 ctx 1024: "
        f"{step_info}")
    RESULTS["serving"] = {
        "requests": len(rids), "prompt_tokens": int(lens.sum()),
        "generated_tokens": n_tok, "wall_s": wall, "tokens_per_s": tps,
        "latency": lat, "stats": eng.stats(), "launches": launches,
        "launches_per_call": per, "decode_step": step_info}
    del eng, pools, model
    empty_cache(torch, dev)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise SystemExit(f"kernels not launched on the main path: {missing}")
    if not (tok_ok and logits_ok):
        raise SystemExit("serving output malformed "
                         f"(tokens ok {tok_ok}, logits finite {logits_ok})")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops.kernels import (_build, fused_norm,
                                              fused_rope, paged_attention)
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
    with torch.inference_mode():
        cases = phase_kernels(torch, pt)
    from paddle_tpu_torch.models import LlamaConfig
    dev = torch.device("cuda")
    phase_engine_equality(torch, pt, dev, LlamaConfig.llama3_8b)
    launches = phase_serving(torch, pt, dev, LlamaConfig.llama3_8b)

    def main_case(kernel, case):
        return next(c for c in cases if c["kernel"] == kernel
                    and c["case"] == case and c["dtype"] == "bfloat16")
    kernels = []
    for name, mod, key, case in (
            ("rms_norm", fused_norm, "rms_norm", "prefill_1024"),
            ("fused_rope", fused_rope, "fused_rope", "prefill_1024"),
            ("paged_decode", paged_attention, "paged_decode", "ctx1024")):
        c = main_case(key, case)
        kernels.append({
            "name": name, "route": "cuda", "source": mod.SOURCE,
            "replaces": mod.REPLACES, "launches": launches[key],
            "max_abs_err": max(x["max_abs_err"] for x in cases
                               if x["kernel"] == key),
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
