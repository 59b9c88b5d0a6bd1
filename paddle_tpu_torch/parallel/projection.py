"""Projection of Llama-3 pretraining over many cards from measurements on
one (counterpart of ``paddle_tpu/parallel/projection.py``).

Every input is measured on the card at the real layer shapes
(``paddle_tpu_torch/tools/bench_8b_layer.py``: one decoder layer forward
and backward, with and without recompute, the fused CE head's cost a
token, the embedding) or is the hardware's: its peak, its memory
bandwidth and the link bandwidth a card, passed in as ``hw``. The
combining arithmetic is JAX's: the FSDP all-gather / reduce-scatter
roofline a layer overlapped against the same layer's compute, and the
1F1B bubble from ``parallel.schedules.schedule_ticks``.

``measured_on`` is the card the inputs were measured on; the compute
times scale by the ratio of its peak to ``hw``'s (1 when they are the
same card) times ``xfer_derate``. :data:`H100` is the port's preset
(NVIDIA's data sheet, SXM part, dense bf16 at 700 W); its link bandwidth
is the one ``tools/mesh_check.py`` measures across the cards of a host,
so pass ``dict(H100, link_bw=...)``. A projection is not a measurement.

The projection is conservative in three places: kernel efficiency may
be derated (``xfer_derate``), the link may be used below the given rate
(``link_efficiency``), and collectives overlap only the same layer's
compute (max(0, t_comm - t_compute) exposes the rest).
"""

from __future__ import annotations

from typing import Dict, Optional

# NVIDIA H100 SXM data sheet: dense bf16 989 TFLOP/s, HBM3 3.35 TB/s;
# link_bw (bytes/s a card, aggregate) comes from a measurement
H100 = {"name": "NVIDIA H100 80GB HBM3", "peak_bf16": 989e12,
        "hbm_bw": 3.35e12, "link_bw": None}


def _llama_counts(v, h, m, L, n_h, n_kv, hd, seq_len) -> Dict[str, float]:
    """Analytic accounting shared by the presets (equal to the model's
    own ``num_params()`` / ``flops_per_token()``)."""
    layer = (h * (n_h + 2 * n_kv) * hd      # fused qkv
             + n_h * hd * h                 # o
             + h * 2 * m                    # fused gate+up
             + m * h                        # down
             + 2 * h)                       # 2 rms norms
    params = L * layer + 2 * v * h + h      # + embed + lm_head + final norm
    n_matmul = params - v * h               # the embedding is a gather
    attn = 12 * L * h * seq_len             # PaLM convention, non-causal
    return {"params": params, "layer_params": layer,
            "flops_per_token": 6 * n_matmul + attn,
            "flops_per_token_causal": 6 * n_matmul
            + attn * (seq_len + 1) / (2 * seq_len),
            "layer_flops_per_token": 6 * layer + attn / L,
            "head_flops_per_token": 6 * v * h,
            "vocab": v, "hidden": h, "num_layers": L,
            "seq_len": seq_len}


def llama3_8b_counts(seq_len: int = 8192) -> Dict[str, float]:
    """Analytic parameter and FLOP accounting of Llama-3-8B."""
    return _llama_counts(128256, 4096, 14336, 32, 32, 8, 128, seq_len)


def llama3_70b_counts(seq_len: int = 8192) -> Dict[str, float]:
    """The same for Llama-3-70B (h 8192, ffn 28672, 80 layers, 64/8 GQA
    heads, vocabulary 128256)."""
    return _llama_counts(128256, 8192, 28672, 80, 64, 8, 128, seq_len)


def _link(hw: Dict, link_efficiency: float) -> float:
    if not hw.get("link_bw"):
        raise ValueError("hw['link_bw'] (bytes/s a card) is needed: "
                         "measure it (tools/mesh_check.py) and pass "
                         "dict(H100, link_bw=...)")
    return hw["link_bw"] * link_efficiency


def _fsdp_roofline(c, t_layer, t_head, t_embed, n_chips, link, hbm_bw):
    """The fsdp axis's comm and optimizer roofline: a layer's 2 x
    all-gather + reduce-scatter of bf16 weights overlapped against the
    same layer's compute, the two v x h tables likewise against the head
    and embedding, the optimizer update bound by memory. Returns
    (t_step, parts)."""
    L = c["num_layers"]
    layer_bytes = c["layer_params"] * 2
    ag_rs = 3 * layer_bytes * (n_chips - 1) / n_chips
    t_comm_layer = ag_rs / link
    exposed = max(0.0, t_comm_layer - t_layer)
    head_embed_bytes = 3 * (2 * c["vocab"] * c["hidden"] * 2) \
        * (n_chips - 1) / n_chips
    exposed_he = max(0.0, head_embed_bytes / link - (t_head + t_embed))
    opt_bytes = c["params"] / n_chips * 16 * 2
    t_opt = opt_bytes / hbm_bw
    t_step = L * (t_layer + exposed) + t_head + t_embed + exposed_he + t_opt
    return t_step, {"t_comm_layer_s": t_comm_layer,
                    "t_comm_exposed_per_layer_s": exposed,
                    "t_opt_s": t_opt}


def _assumptions(hw, src, link_efficiency, xfer_derate, **more):
    return {"peak_bf16": hw["peak_bf16"], "hbm_bw": hw["hbm_bw"],
            "link_bw": hw["link_bw"], "link_efficiency": link_efficiency,
            "peak_bf16_measured_on": src["peak_bf16"],
            "xfer_derate": xfer_derate,
            "target": hw.get("name"), "measured_on": src.get("name"),
            **more}


def project_llama3_8b(measured: Dict[str, float], hw: Dict = H100, *,
                      measured_on: Optional[Dict] = None,
                      n_chips: int = 64, pp: int = 8,
                      seq_len: int = 8192, microbatch: int = 1,
                      xfer_derate: float = 1.0,
                      link_efficiency: float = 1.0) -> Dict:
    """Project a Llama-3-8B pretraining step over ``n_chips`` cards of
    ``hw`` from ``measured`` (``tools/bench_8b_layer.py`` at b 1, s 8192,
    bf16, flash):

      layer_us           one decoder layer forward + backward
      layer_remat_us     the same under recompute (the 1F1B plan's)
      head_us_per_token  the fused CE head's cost a token
      embed_us           the embedding forward + backward at s 8192

    Plan A: FSDP over every card, local batch 1 x 8192, no recompute.
    Plan B: ``pp`` stages x fsdp ``n_chips / pp``, 1F1B with full
    recompute, 2 ``pp`` microbatches, the bubble from
    ``schedule_ticks``."""
    src = measured_on or hw
    c = llama3_8b_counts(seq_len)
    peak_ratio = src["peak_bf16"] / hw["peak_bf16"]
    tokens = microbatch * seq_len

    t_layer = measured["layer_us"] * 1e-6 * peak_ratio * xfer_derate
    t_layer_remat = (measured["layer_remat_us"] * 1e-6 * peak_ratio
                     * xfer_derate)
    t_head = (measured["head_us_per_token"] * 1e-6 * tokens * peak_ratio
              * xfer_derate)
    t_embed = measured["embed_us"] * 1e-6 * peak_ratio * xfer_derate

    L = 32
    link = _link(hw, link_efficiency)

    # plan A: fsdp over every card
    t_step_a, parts_a = _fsdp_roofline(c, t_layer, t_head, t_embed,
                                       n_chips, link, hw["hbm_bw"])
    mfu_a = tokens * c["flops_per_token"] / (t_step_a * hw["peak_bf16"])

    # plan B: pp x fsdp, 1F1B, full recompute, M = 2 S microbatches. Each
    # microbatch is 8192 tokens a card of its fsdp group; the wall time
    # is (M + S - 1) forward+backward slot pairs of the slowest stage
    # (the last: its layers and the CE head every microbatch)
    S, M = pp, 2 * pp
    f = n_chips // pp
    layers_per_stage = L // S
    from .schedules import schedule_ticks
    ticks = schedule_ticks(S, M)
    slot_pairs = ticks["steady"] + ticks["bubble_slot_pairs"]  # M + S - 1
    t_tick = layers_per_stage * t_layer_remat + t_head + t_embed
    ag_rs_f = 3 * (c["layer_params"] * 2) * (f - 1) / f
    exposed_f = max(0.0, ag_rs_f / link - t_layer_remat)
    t_step_b = (slot_pairs * t_tick + M * layers_per_stage * exposed_f
                + parts_a["t_opt_s"])
    tokens_b = M * f * tokens
    mfu_b = (tokens_b * c["flops_per_token"]
             / (t_step_b * n_chips * hw["peak_bf16"]))

    return {
        "counts": c,
        "inputs": dict(measured),
        "assumptions": _assumptions(
            hw, src, link_efficiency, xfer_derate,
            overlap="collectives overlap same-layer compute only"),
        "plan_a_fsdp": {
            "mesh": {"fsdp": n_chips},
            "local_batch": [microbatch, seq_len],
            "t_layer_s": t_layer,
            "t_comm_layer_s": parts_a["t_comm_layer_s"],
            "t_comm_exposed_per_layer_s":
                parts_a["t_comm_exposed_per_layer_s"],
            "t_head_s": t_head,
            "t_opt_s": parts_a["t_opt_s"],
            "t_step_s": t_step_a,
            "tokens_per_step_per_chip": tokens,
            "projected_mfu": mfu_a,
            "projected_tokens_per_sec_per_chip": tokens / t_step_a,
        },
        "plan_b_pp_fsdp_1f1b": {
            "mesh": {"pp": S, "fsdp": f},
            "microbatches": M,
            "bubble_slot_pairs": ticks["bubble_slot_pairs"],
            "t_step_s": t_step_b,
            "projected_mfu": mfu_b,
        },
        "north_star": {
            "target_mfu": 0.40,
            "meets_target": bool(mfu_a >= 0.40),
            "headline_plan": "plan_a_fsdp",
        },
    }


def project_llama3_70b(measured: Dict[str, float], hw: Dict = H100, *,
                       measured_on: Optional[Dict] = None,
                       n_chips: int = 64, seq_len: int = 8192,
                       microbatch: int = 1, xfer_derate: float = 1.0,
                       link_efficiency: float = 1.0) -> Dict:
    """Project Llama-3-70B pretraining over ``n_chips`` cards: fsdp over
    all of them, full recompute, local batch 1 x ``seq_len``. The layer
    is measured at a shorter sequence (``layer_seq``) and rebuilt at
    ``seq_len``: the matmul part a token does not depend on the
    sequence, the attention part grows linearly with it.

      layer_remat_us     one 70B layer forward + backward under recompute
                         at ``layer_seq`` tokens (the slower of it and
                         ``layer_us``: recompute is never cheaper)
      layer_seq          the sequence it was measured at
      head_us_per_token  the CE head's cost a token at h 8192
      embed_us           the embedding forward + backward"""
    src = measured_on or hw
    c = llama3_70b_counts(seq_len)
    peak_ratio = src["peak_bf16"] / hw["peak_bf16"]
    tokens = microbatch * seq_len

    ls = int(measured["layer_seq"])
    c_ls = llama3_70b_counts(ls)
    t_meas = max(measured["layer_remat_us"],
                 measured.get("layer_us", 0.0)) * 1e-6
    attn_frac = (c_ls["layer_flops_per_token"] - 6 * c_ls["layer_params"]) \
        / c_ls["layer_flops_per_token"]
    t_matmul_tok = t_meas * (1 - attn_frac) / ls
    t_attn_tok_ls = t_meas * attn_frac / ls          # at average context
    t_layer = (t_matmul_tok + t_attn_tok_ls * (seq_len / ls)) * tokens \
        * peak_ratio * xfer_derate
    t_head = (measured["head_us_per_token"] * 1e-6 * tokens * peak_ratio
              * xfer_derate)
    t_embed = measured["embed_us"] * 1e-6 * peak_ratio * xfer_derate

    t_step, parts = _fsdp_roofline(c, t_layer, t_head, t_embed, n_chips,
                                   _link(hw, link_efficiency), hw["hbm_bw"])
    mfu = tokens * c["flops_per_token"] / (t_step * hw["peak_bf16"])
    return {
        "counts": c,
        "inputs": dict(measured),
        "assumptions": _assumptions(
            hw, src, link_efficiency, xfer_derate,
            seq_scaling="matmul part independent of s; attention part "
                        "linear in s",
            plan="fsdp over every card, full recompute, local batch 1 x "
                 "seq_len"),
        "plan_fsdp_remat": {
            "mesh": {"fsdp": n_chips},
            "t_layer_s": t_layer,
            "t_comm_exposed_per_layer_s": parts["t_comm_exposed_per_layer_s"],
            "t_head_s": t_head,
            "t_opt_s": parts["t_opt_s"],
            "t_step_s": t_step,
            "tokens_per_step_per_chip": tokens,
            "projected_mfu": mfu,
            "projected_tokens_per_sec_per_chip": tokens / t_step,
        },
        "north_star": {"target_mfu": 0.40,
                       "meets_target": bool(mfu >= 0.40)},
    }


__all__ = ["H100", "llama3_8b_counts", "llama3_70b_counts",
           "project_llama3_8b", "project_llama3_70b"]
