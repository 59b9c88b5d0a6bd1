"""Per-config device-memory model: the planner's feasibility gate
(copy of ``paddle_tpu/distributed/auto_parallel/memory_model.py``; its
closed form unchanged).

Before a candidate ``(dp, fsdp, tp, pp, sep)`` config is worth a
census, it must FIT — params + optimizer state + gradients + activations
under the model's remat policy, per card — priced from the config alone
(no instantiation):

* **params** — analytical count (embedding + L decoder layers + final
  norm + untied lm_head) divided by ``fsdp * tp * pp``;
* **optimizer state** — slot count × fp32 per sharded param (AdamW: two);
* **gradients** — one param-dtype copy sharded like the params;
* **fsdp gather working set** — one decoder layer's params gathered over
  the axis (FSDP2 gathers a layer just in time);
* **activations** — boundary activations per layer of
  ``B/(dp·fsdp) × S/sep × H``, with remat only boundaries plus one
  layer's recompute working set, without it each layer's internals
  (≈ ``4H + 2M`` a token); the fused CE head keeps no ``B×S×V`` logits.

The capacity table carries the H100's 80 GB; on the card
:func:`hbm_capacity` reads ``torch.cuda.get_device_properties`` instead
of the table. ``utilization`` headroom (default 90%) covers the
allocator's workspace and fragmentation.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

__all__ = ["HBM_CAPACITY", "MemoryEstimate", "estimate_hbm",
           "hbm_capacity"]

# bytes per card (data sheets); the TPU rows are the JAX package's
HBM_CAPACITY = {
    "h100": 80e9,            # NVIDIA H100 SXM: 80 GB HBM3
    "tpu v4": 32e9,          # 32 GiB
    "tpu v5 lite": 16e9,     # v5e: 16 GiB
    "tpu v5e": 16e9,
    "tpu v5": 95e9,          # v5p: 95 GiB
    "tpu v5p": 95e9,
    "tpu v6 lite": 32e9,     # v6e (trillium): 32 GiB
    "cpu": 8e9,              # nominal smoke-host tier
}

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8}


def hbm_capacity(kind: Optional[str] = None) -> float:
    """Capacity for ``kind``, longest-substring matched. For this
    process's card (``kind`` None or its name), its ``total_memory`` as
    CUDA reports it; the table only for another kind or where
    there is no card."""
    import torch
    if torch.cuda.is_available():
        dev = torch.cuda.current_device()
        if kind is None or kind.lower() == torch.cuda.get_device_name(
                dev).lower():
            return float(torch.cuda.get_device_properties(dev).total_memory)
    if kind is None:
        kind = "cpu"
    kind = kind.lower()
    best, best_len = HBM_CAPACITY["cpu"], -1
    for k, v in HBM_CAPACITY.items():
        if k in kind and len(k) > best_len:
            best, best_len = v, len(k)
    return best


@dataclass
class MemoryEstimate:
    """Per-chip high-water estimate for one parallel config."""
    params_bytes: float
    opt_bytes: float
    grads_bytes: float
    acts_bytes: float
    budget_bytes: float
    feasible: bool
    detail: Dict[str, float] = field(default_factory=dict)

    @property
    def total_bytes(self) -> float:
        return (self.params_bytes + self.opt_bytes + self.grads_bytes
                + self.acts_bytes)

    def as_dict(self) -> Dict[str, float]:
        return {"params_bytes": self.params_bytes,
                "opt_bytes": self.opt_bytes,
                "grads_bytes": self.grads_bytes,
                "acts_bytes": self.acts_bytes,
                "total_bytes": self.total_bytes,
                "budget_bytes": self.budget_bytes,
                "feasible": self.feasible}


def _param_count(cfg) -> float:
    """Analytical parameter count of a LlamaConfig- or MoEConfig-shaped
    model (matches ``LlamaForCausalLM.num_params`` to the norm vectors;
    for MoE configs the routed/shared expert FFNs replace the dense MLP
    on the non-dense layers)."""
    H, M, L, V = (cfg.hidden_size, cfg.intermediate_size,
                  cfg.num_hidden_layers, cfg.vocab_size)
    hd = H // cfg.num_attention_heads
    qkv = H * (cfg.num_attention_heads + 2 * cfg.num_key_value_heads) * hd
    attn_norms = qkv + H * H + 2 * H                  # attn + norms
    n_exp = int(getattr(cfg, "num_experts", 0) or 0)
    if n_exp:
        k_dense = int(getattr(cfg, "first_k_dense_replace", 0))
        shared_w = (int(getattr(cfg, "num_shared_experts", 0))
                    * cfg.moe_intermediate_size)
        per_moe = (n_exp * 3 * H * cfg.moe_intermediate_size
                   + 3 * H * shared_w + H * n_exp)    # experts+shared+gate
        n = (V * H + H * V + H                        # embed + head + norm
             + k_dense * (attn_norms + 3 * H * M)
             + (L - k_dense) * (attn_norms + per_moe))
        return float(n)
    per_layer = attn_norms + 3 * H * M                # attn + mlp + norms
    n = V * H + L * per_layer + H                     # embed + layers + norm
    if not getattr(cfg, "tie_word_embeddings", True):
        n += H * V
    return float(n)


def _expert_param_count(cfg) -> float:
    """ROUTED expert FFN params only — the slice the ep axis divides
    (shared experts and the router gate replicate over ep)."""
    n_exp = int(getattr(cfg, "num_experts", 0) or 0)
    if not n_exp:
        return 0.0
    L = cfg.num_hidden_layers
    k_dense = int(getattr(cfg, "first_k_dense_replace", 0))
    per_expert = 3 * cfg.hidden_size * cfg.moe_intermediate_size
    return float((L - k_dense) * n_exp * per_expert)


def estimate_hbm(model_cfg, config, *, global_batch: int, seq_len: int,
                 opt_slots: int = 2, budget_bytes: Optional[float] = None,
                 device_kind: Optional[str] = None,
                 utilization: float = 0.9) -> MemoryEstimate:
    """Price one config's per-chip HBM high-water.

    ``config`` carries ``dp/fsdp/tp/pp/sep`` degrees (a planner
    ``ParallelConfig`` or anything duck-shaped like one; ``fsdp``
    defaults to 1 for duck shapes without it). ``opt_slots`` is the
    optimizer's fp32 slot count per param (AdamW m+u = 2).
    ``budget_bytes`` overrides the device capacity lookup — the
    HBM-infeasibility tests pin tiny budgets through it.
    """
    dp, tp, pp, sep = config.dp, config.tp, config.pp, config.sep
    fsdp = int(getattr(config, "fsdp", 1))
    ep = int(getattr(config, "ep", 1))
    dt = _DTYPE_BYTES.get(getattr(model_cfg, "dtype", "float32"), 4)
    H, M, L = (model_cfg.hidden_size, model_cfg.intermediate_size,
               model_cfg.num_hidden_layers)

    shard = float(fsdp * tp * pp)
    # expert FFN params/slots/grads additionally divide by ep (each ep
    # rank stores only its expert slice); everything else replicates
    # over the ep subgroup exactly like plain dp
    total_p = _param_count(model_cfg)
    expert_p = _expert_param_count(model_cfg) if ep > 1 else 0.0
    dense_p = total_p - expert_p
    params_b = (dense_p + expert_p / ep) * dt / shard
    opt_b = (dense_p + expert_p / ep) * 4.0 * opt_slots / shard
    grads_b = params_b

    tokens_local = (global_batch / (dp * fsdp)) * (seq_len / sep)
    boundary = tokens_local * H * dt                  # one layer boundary
    remat = getattr(model_cfg, "recompute", "none") in ("full", "selective")
    layers_local = L / pp
    if remat:
        # boundaries survive the forward; one layer re-runs at a time
        acts_b = layers_local * boundary + (4 * H + 2 * M) / H * boundary
    else:
        # every layer keeps qkv/attn-out/gate/up intermediates
        acts_b = layers_local * (boundary + (4 * H + 2 * M) / H * boundary)

    # fsdp gather working set: one decoder layer's params all-gathered
    # over the axis for compute (still tp-sharded; counted inside
    # acts_bytes because it is transient, not storage)
    gather_b = 0.0
    if fsdp > 1:
        hd = H // model_cfg.num_attention_heads
        qkv = H * (model_cfg.num_attention_heads
                   + 2 * model_cfg.num_key_value_heads) * hd
        per_layer = qkv + H * H + 3 * H * M
        gather_b = per_layer * dt / float(tp)
        acts_b += gather_b

    # expert a2a staging: dispatch + combine each materialize the
    # routed slot buffer (tokens_local × top_k × H) once per moe layer's
    # in-flight window — one layer at a time, so a single ×2 copy
    a2a_b = 0.0
    if ep > 1:
        top_k = int(getattr(model_cfg, "num_experts_per_tok", 1))
        a2a_b = 2.0 * tokens_local * top_k * H * dt
        acts_b += a2a_b

    budget = budget_bytes if budget_bytes is not None else \
        hbm_capacity(device_kind) * utilization
    total = params_b + opt_b + grads_b + acts_b
    return MemoryEstimate(
        params_bytes=params_b, opt_bytes=opt_b, grads_bytes=grads_b,
        acts_bytes=acts_b, budget_bytes=float(budget),
        feasible=total <= budget,
        detail={"tokens_local": tokens_local,
                "layers_local": layers_local, "dtype_bytes": dt,
                "fsdp_gather_bytes": gather_b,
                "expert_params_bytes": expert_p * dt / (shard * ep),
                "moe_a2a_staging_bytes": a2a_b})
