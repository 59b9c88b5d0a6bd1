"""Serving-fabric CLI: drive N in-process replicas through the router
(the port of ``tools/serve_fabric.py``).

Spin up a replica pool over the tiny Llama (seeded random weights, built
on the CUDA card unless ``--device cpu``), feed it a trace
(JSONL, or a synthesized mixed two-tenant trace), and print one JSON
summary of what the fabric did: routing distribution, affinity hits,
handoffs, per-tenant admission, aggregate latency percentiles.

Usage::

    python -m paddle_tpu_torch.tools.serve_fabric \
        --replicas 2 --policy affinity --trace trace.jsonl
    python -m paddle_tpu_torch.tools.serve_fabric --device cpu \
        --replicas 3 --prefill-replicas 1 --disagg-threshold 64

Trace lines are JSON objects::

    {"prompt": [1, 2, 3, ...], "tenant": "a", "max_new_tokens": 8}
    {"prompt_len": 40, "family": "sys-a", "tenant": "b"}

``prompt_len``/``family`` synthesize a deterministic prompt (requests
sharing a ``family`` share a prefix — the affinity router's food).
``main(argv)`` is importable; tests run it in-process.
"""

import argparse
import json


def _synth_prompt(rs_family, rs_tail, length, page_size):
    """family rng drives the shared prefix (all but the last partial
    page), tail rng the divergent suffix."""
    import numpy as np
    shared = (length // page_size) * page_size
    head = rs_family.randint(0, 256, (shared,)).astype(np.int32)
    tail = rs_tail.randint(0, 256, (length - shared,)).astype(np.int32)
    return np.concatenate([head, tail])


def load_trace(path, page_size, seed=0):
    """Trace JSONL → [{"prompt", "tenant", "max_new_tokens"}, ...]."""
    import numpy as np
    fams = {}
    out = []
    rs_tail = np.random.RandomState(seed + 1)
    with open(path, encoding="utf-8") as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if d.get("prompt") is not None:
                prompt = np.asarray(d["prompt"], np.int32)
            else:
                fam = str(d.get("family", f"_line{ln}"))
                if fam not in fams:
                    fams[fam] = len(fams)
                # a family's prefix must be identical per request:
                # re-seed a fresh rng at the family's anchor each line
                anchor = np.random.RandomState(seed + 17 * (fams[fam] + 2))
                prompt = _synth_prompt(anchor, rs_tail,
                                       int(d["prompt_len"]), page_size)
            out.append({"prompt": prompt,
                        "tenant": str(d.get("tenant", "default")),
                        "max_new_tokens": int(d.get("max_new_tokens", 8))})
    return out


def synth_trace(page_size, families=3, per_family=3, cold=2,
                fam_pages=3, cold_pages=8, max_new=6, seed=0):
    """The default mixed two-tenant trace: ``families`` shared-prefix
    populations (tenant "shared") interleaved with ``cold`` long cold
    prompts (tenant "cold")."""
    import numpy as np
    out = []
    rs_tail = np.random.RandomState(seed + 1)
    for j in range(per_family):
        for i in range(families):
            anchor = np.random.RandomState(seed + 17 * (i + 2))
            p = _synth_prompt(anchor, rs_tail,
                              fam_pages * page_size + 3, page_size)
            out.append({"prompt": p, "tenant": "shared",
                        "max_new_tokens": max_new})
    rs_cold = np.random.RandomState(seed + 999)
    for _ in range(cold):
        out.append({"prompt": rs_cold.randint(
            0, 256, (cold_pages * page_size,)).astype(np.int32),
            "tenant": "cold", "max_new_tokens": max_new})
    return out


def tiny_model(seed, device=None):
    """The tiny Llama with weights drawn from ``seed`` on ``device`` (the
    card by default; raises without one unless ``device="cpu"``)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    dev = pt.resolve_device(device)
    return LlamaForCausalLM(LlamaConfig.tiny(), device=dev,
                            generator=pt.generator(seed, dev))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--policy", default="affinity",
                    choices=["affinity", "least-loaded", "round-robin"])
    ap.add_argument("--trace", default=None,
                    help="trace JSONL (default: synthesized mixed "
                         "two-tenant trace)")
    ap.add_argument("--prefill-replicas", type=int, default=0,
                    help="dedicate the first N replicas to prefill "
                         "(disaggregation)")
    ap.add_argument("--disagg-threshold", type=int, default=None,
                    help="uncached-suffix tokens at/over this route "
                         "through a prefill replica")
    ap.add_argument("--page-size", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=None)
    ap.add_argument("--itl-target-ms", type=float, default=None,
                    help="per-replica ITL p99 SLO driving affinity "
                         "hysteresis")
    ap.add_argument("--weight-dtype", default="native",
                    choices=["native", "int8"],
                    help="int8: serve the weight-only quantized twin "
                         "(offline PTQ)")
    ap.add_argument("--kv-dtype", default="native",
                    choices=["native", "int8"],
                    help="int8: KV-cache pages quantize on write with "
                         "per-page scales, dequant fused into decode")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of the model and the replicas' "
                         "pools (default: the CUDA card; 'cpu' to run "
                         "without one)")
    # synthesized-trace shape (ignored with --trace)
    ap.add_argument("--families", type=int, default=3)
    ap.add_argument("--per-family", type=int, default=3)
    ap.add_argument("--cold", type=int, default=2)
    ap.add_argument("--fam-pages", type=int, default=3)
    ap.add_argument("--cold-pages", type=int, default=8)
    args = ap.parse_args(argv)
    if args.prefill_replicas >= args.replicas:
        ap.error("--prefill-replicas must leave at least one "
                 "decode-capable replica")

    from paddle_tpu_torch.inference.generation import GenerationConfig
    from paddle_tpu_torch.serving_fabric import (InProcTransport,
                                                 ServingFabric,
                                                 TenantFairPolicy,
                                                 build_replicas)

    if args.trace:
        trace = load_trace(args.trace, args.page_size, seed=args.seed)
    else:
        trace = synth_trace(args.page_size, families=args.families,
                            per_family=args.per_family, cold=args.cold,
                            fam_pages=args.fam_pages,
                            cold_pages=args.cold_pages, seed=args.seed)
    if not trace:
        raise SystemExit("empty trace")
    max_len = args.max_len
    if max_len is None:
        need = max(len(t["prompt"]) + t["max_new_tokens"]
                   for t in trace)
        max_len = need + 2 * args.page_size

    model = tiny_model(args.seed, args.device)
    if args.weight_dtype == "int8":
        from paddle_tpu_torch.quantization import quantize_model
        model = quantize_model(
            model, kv_dtype=(args.kv_dtype if args.kv_dtype != "native"
                             else None))
    elif args.kv_dtype == "int8":
        # native weights over quantized KV pages: same arch, int8 pool
        import dataclasses

        from paddle_tpu_torch.models import LlamaForCausalLM
        emb = model.model.embed_tokens
        kv8 = LlamaForCausalLM(
            dataclasses.replace(model.cfg, kv_dtype="int8"),
            device=emb.device, dtype=emb.dtype, init_weights=False)
        kv8.load_state_dict(model.state_dict())
        model = kv8
    roles = (["prefill"] * args.prefill_replicas
             + ["both"] * (args.replicas - args.prefill_replicas))
    reps = build_replicas(
        model, args.replicas, roles=roles, page_size=args.page_size,
        max_len=max_len, max_batch=args.max_batch,
        generation_config=GenerationConfig(max_new_tokens=8,
                                           do_sample=False))
    tenants = sorted({t["tenant"] for t in trace})
    fair = TenantFairPolicy() if len(tenants) > 1 else None
    fabric = ServingFabric(
        InProcTransport(reps), policy=args.policy, fair=fair,
        itl_p99_target_s=(None if args.itl_target_ms is None
                          else args.itl_target_ms / 1e3),
        disagg_threshold_tokens=args.disagg_threshold)

    import time
    fids = [fabric.submit(t["prompt"], t["max_new_tokens"],
                          tenant=t["tenant"]) for t in trace]
    t0 = time.perf_counter()
    out = fabric.run()
    dt = time.perf_counter() - t0
    lat = fabric.latency_stats()
    st = fabric.stats()
    served = {f: v for f, v in out.items() if v is not None}
    tokens = int(sum(len(v) for v in served.values()))
    summary = {
        # ok = every request SERVED; a replica-rejected request (None
        # result, reason in fabric.failed) fails the run visibly
        "ok": len(served) == len(fids),
        "rejected": {f: fabric.failed[f] for f in out if f not in
                     served},
        "policy": args.policy,
        "quantization": {"weight_dtype": args.weight_dtype,
                         "kv_dtype": args.kv_dtype},
        "replicas": args.replicas,
        "roles": roles,
        "requests": len(fids),
        "tenants": tenants,
        "tokens": tokens,
        "tokens_per_sec": round(tokens / dt, 1) if dt > 0 else None,
        "routed": st["routed"],
        "affinity_hits": st["affinity_hits"],
        "misrouted": st["misrouted"],
        "cold_routes": st["cold_routes"],
        "handoffs": st["handoffs"],
        "handoff_bytes": st["handoff_bytes"],
        "handoff_failures": st["handoff_failures"],
        "readmitted": st["readmitted"],
        "tenant_admitted": st.get("tenant_admitted"),
        "tenant_admitted_tokens": st.get("tenant_admitted_tokens"),
        "ttft_p50_s": round(lat.get("ttft_p50_s", 0.0), 5),
        "ttft_p99_s": round(lat.get("ttft_p99_s", 0.0), 5),
        "itl_p99_s": round(lat.get("itl_p99_s", 0.0), 5),
    }
    return summary


if __name__ == "__main__":
    print(json.dumps(main()))
