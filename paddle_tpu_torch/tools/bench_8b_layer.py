"""The projection's measured inputs at Llama-3-8B's real shapes, on the
card (counterpart of the JAX repository's ``tools/bench_8b_layer.py``).

At b 1, s 8192, bf16, flash attention:

- ``layer_us``: one decoder layer (h 4096, ffn 14336, 32 / 8 heads)
  forward and backward;
- ``layer_remat_us``: the same under the port's recompute
  (``distributed.recompute``, the 1F1B plan's);
- ``head_us_per_token``: the fused vocab-CE head (vocabulary 128256)
  forward and backward, the slope between s 2048 and 4096 (its fixed
  cost removed), and ``head_linearity`` (time at 4096 over twice the
  time at 2048);
- ``embed_us``: the embedding's forward and backward at s 8192.

Each is the least, over :data:`ROUNDS`, of the mean of several launches
between CUDA events. Every training kernel runs (RMSNorm and its
backward, RoPE, the flash forward and backward, the four vocab-CE
kernels); :func:`measure` returns their launch counts. The inputs feed
``parallel.projection``; ``--link-bw`` (bytes/s a card, from
``tools/mesh_check.py``) prints the projection at 4 and 64 cards.

Usage: python -m paddle_tpu_torch.tools.bench_8b_layer [--link-bw B]
    [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

SEQ = 8192                     # the layer's and the embedding's tokens
HEAD_SEQS = (2048, 4096)       # the head's two lengths (its slope)
ROUNDS = 4                     # each time is the least over these


def _log(m):
    print(m, file=sys.stderr, flush=True)


def _best_ms(torch, fn, iters: int) -> float:
    """The least, over :data:`ROUNDS`, of the mean ms of ``iters`` calls
    between CUDA events (one warm-up call first)."""
    fn()
    best = float("inf")
    for _ in range(ROUNDS):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b) / iters)
    return best


def measure() -> dict:
    """The measured inputs (module docstring) on the current card, the
    launches of each training kernel, and the card."""
    import torch
    from ..device import device_info, generator, resolve_device
    from ..distributed.recompute import recompute
    from ..models.llama import LlamaConfig, LlamaDecoderLayer, _Init
    from ..ops import rope as rope_ops
    from ..ops.kernels import _build
    from ..ops.vocab_ce import fused_linear_cross_entropy

    dev = resolve_device("cuda")
    cfg = LlamaConfig.llama3_8b(dtype="bfloat16")
    S, h = SEQ, cfg.hidden_size
    out = {"config": "llama3_8b", "seq_len": S, "layer_seq": S, "batch": 1,
           "dtype": "bfloat16", "device": device_info()}
    g = generator(0, dev)
    layer = LlamaDecoderLayer(cfg, _Init(cfg, dev, None, g))
    cos, sin = rope_ops.rope_freqs(cfg.head_dim, S, cfg.rope_theta,
                                   device=dev)
    neg_sin = -sin
    x = torch.randn(1, S, h, device=dev, generator=g).to(torch.bfloat16)
    x.requires_grad_(True)
    dy = torch.randn(1, S, h, device=dev, generator=g).to(torch.bfloat16)
    params = list(layer.parameters())

    def layer_step(remat):
        def run():
            for p in params:
                p.grad = None
            x.grad = None
            args = (x, cos, sin, None, None, None, neg_sin)
            y = recompute(layer, *args) if remat else layer(*args)
            y.backward(dy)
        return run

    _build.reset_launches()
    for remat in (False, True):
        key = "layer_remat_us" if remat else "layer_us"
        out[key] = _best_ms(torch, layer_step(remat), 4) * 1e3
        _log(f"bench_8b_layer: {key} {out[key]:.1f}")
    del layer, params, x, dy

    w = (torch.randn(h, cfg.vocab_size, device=dev, generator=g)
         * 0.02).to(torch.bfloat16).requires_grad_(True)
    head_ms = {}
    for sh in HEAD_SEQS:
        hh = torch.randn(1, sh, h, device=dev, generator=g).to(
            torch.bfloat16).requires_grad_(True)
        lbl = torch.randint(0, cfg.vocab_size, (1, sh), device=dev,
                            generator=g)

        def head():
            w.grad = hh.grad = None
            fused_linear_cross_entropy(hh, w, lbl).backward()
        head_ms[sh] = _best_ms(torch, head, 3)
        out[f"head_us_s{sh}"] = head_ms[sh] * 1e3
        del hh, lbl
    lo, hi = HEAD_SEQS
    out["head_us_per_token"] = (head_ms[hi] - head_ms[lo]) * 1e3 / (hi - lo)
    out["head_linearity"] = head_ms[hi] / (2 * head_ms[lo])
    del w

    emb = (torch.randn(cfg.vocab_size, h, device=dev, generator=g)
           * 0.02).to(torch.bfloat16).requires_grad_(True)
    ids = torch.randint(0, cfg.vocab_size, (1, S), device=dev, generator=g)

    def embed():
        emb.grad = None
        torch.nn.functional.embedding(ids, emb).float().mean().backward()
    out["embed_us"] = _best_ms(torch, embed, 6) * 1e3
    out["launches"] = dict(_build.LAUNCHES)
    del emb
    from ..parallel.projection import llama3_8b_counts
    c = llama3_8b_counts(S)
    out["layer_tflops"] = (c["layer_flops_per_token"] * S
                           / (out["layer_us"] * 1e-6) / 1e12)
    return out


def project(measured: dict, link_bw: float, chips=(4, 64)) -> dict:
    """Plan A and B at each card count, on H100s linked at ``link_bw``
    bytes/s a card (a projection, not a measurement)."""
    from ..parallel.projection import H100, project_llama3_8b
    hw = dict(H100, link_bw=link_bw)
    out = {}
    for n in chips:
        p = project_llama3_8b(measured, hw, n_chips=n, pp=min(8, n // 2))
        out[str(n)] = {
            "plan_a_fsdp": {k: p["plan_a_fsdp"][k] for k in (
                "t_step_s", "t_comm_exposed_per_layer_s", "projected_mfu",
                "projected_tokens_per_sec_per_chip")},
            "plan_b_pp_fsdp_1f1b": p["plan_b_pp_fsdp_1f1b"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--link-bw", type=float, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    m = measure()
    res = {"measured": m}
    if args.link_bw:
        res["projection"] = project(m, args.link_bw)
    print(json.dumps(res))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
