"""MoE causal language models: the DeepSeekMoE / Qwen2-MoE family
(counterpart of ``paddle_tpu/models/moe_lm.py``).

- DeepSeekMoE: fine-grained routed experts plus always-on shared
  experts whose output adds to the routed combine; the first
  ``first_k_dense_replace`` layers stay dense.
- Qwen2-MoE: the same skeleton with top-8 routing and a sigmoid gate on
  the shared expert's output.

Attention and the dense MLP are the port's Llama layers (flash kernels,
fused QKV); the MoE block is ``parallel.moe.MoELayer`` (capacity routing,
or dropless through the grouped-matmul kernel when ``capacity_factor`` is
None). State-dict names and layouts are the JAX model's (no ``model.``
prefix): ``embed_tokens``, ``lm_head``, ``norm.weight``,
``layers.{i}.moe.gate_weight``, ``layers.{i}.moe.experts.w_gate_up``
[e, d, 2f], ``layers.{i}.moe.experts.w_down`` [e, f, d],
``layers.{i}.shared_experts.{gate_up_proj,down_proj,gate}``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.recompute import recompute as run_recomputed
from ..nn import RMSNorm
from ..ops import rope as rope_ops
from ..parallel.moe import MoELayer
from .llama import (LlamaAttention, LlamaConfig, LlamaMLP, _Init,
                    causal_lm_loss, fused_causal_lm_loss, fused_loss_enabled)


@dataclass
class MoEConfig:
    """The fields, defaults and presets of
    ``paddle_tpu.models.moe_lm.MoEConfig`` (a preset's fields may be
    overridden by keyword, e.g. ``deepseek_moe_16b(capacity_factor=None)``).
    ``recompute="full"`` runs each layer under activation recompute; any
    other value none, as in the JAX model. ``sequence_parallel`` is read
    by neither model."""
    vocab_size: int = 32000
    hidden_size: int = 2048
    intermediate_size: int = 5632          # dense-MLP size
    moe_intermediate_size: int = 1408      # per-expert FFN size
    num_hidden_layers: int = 8
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    num_experts: int = 16
    num_experts_per_tok: int = 4
    num_shared_experts: int = 1            # DeepSeekMoE shared experts
    first_k_dense_replace: int = 1         # first k layers dense
    capacity_factor: Optional[float] = 1.25
    aux_loss_weight: float = 0.01
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    use_flash_attention: bool = True
    shared_expert_gate: bool = False       # Qwen2-MoE sigmoid gate
    dtype: str = "float32"
    recompute: str = "none"
    sequence_parallel: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    def _as_llama(self) -> LlamaConfig:
        """Attention and dense-MLP sublayers are config-compatible with
        Llama's."""
        return LlamaConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            intermediate_size=self.intermediate_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            num_key_value_heads=self.num_key_value_heads,
            max_position_embeddings=self.max_position_embeddings,
            rms_norm_eps=self.rms_norm_eps, rope_theta=self.rope_theta,
            initializer_range=self.initializer_range,
            use_flash_attention=self.use_flash_attention, dtype=self.dtype)

    @staticmethod
    def deepseek_moe_16b(**kw) -> "MoEConfig":
        return MoEConfig(**{**dict(
            vocab_size=102400, hidden_size=2048, intermediate_size=10944,
            moe_intermediate_size=1408, num_hidden_layers=28,
            num_attention_heads=16, num_key_value_heads=16, num_experts=64,
            num_experts_per_tok=6, num_shared_experts=2,
            first_k_dense_replace=1), **kw})

    @staticmethod
    def qwen2_moe_a14b(**kw) -> "MoEConfig":
        return MoEConfig(**{**dict(
            vocab_size=151936, hidden_size=3584, intermediate_size=18944,
            moe_intermediate_size=2560, num_hidden_layers=28,
            num_attention_heads=28, num_key_value_heads=4, num_experts=64,
            num_experts_per_tok=8, num_shared_experts=1,
            first_k_dense_replace=0, shared_expert_gate=True), **kw})

    @staticmethod
    def tiny(**kw) -> "MoEConfig":
        return MoEConfig(**{**dict(
            vocab_size=512, hidden_size=128, intermediate_size=256,
            moe_intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, num_experts=4,
            num_experts_per_tok=2, num_shared_experts=1,
            first_k_dense_replace=1, max_position_embeddings=256), **kw})


def parameter_shapes(cfg: MoEConfig):
    """{state_dict name: (shape, kind)} of ``MoEForCausalLM(cfg)``, the
    JAX model's names and shapes; kind "float" (``cfg.dtype``) or "fp32"
    (norm weights and the routers, fp32 whatever ``cfg.dtype`` is)."""
    d, v = cfg.hidden_size, cfg.vocab_size
    n_h, n_kv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
    e, f = cfg.num_experts, cfg.moe_intermediate_size
    shared = cfg.num_shared_experts * f
    out = {"embed_tokens": ((v, d), "float"), "lm_head": ((d, v), "float")}
    for i in range(cfg.num_hidden_layers):
        p = f"layers.{i}."
        out[p + "input_layernorm.weight"] = ((d,), "fp32")
        out[p + "self_attn.qkv_proj"] = ((d, (n_h + 2 * n_kv) * hd), "float")
        out[p + "self_attn.o_proj"] = ((n_h * hd, d), "float")
        out[p + "post_attention_layernorm.weight"] = ((d,), "fp32")
        if i < cfg.first_k_dense_replace:
            out[p + "mlp.gate_up_proj"] = ((d, 2 * cfg.intermediate_size),
                                           "float")
            out[p + "mlp.down_proj"] = ((cfg.intermediate_size, d), "float")
            continue
        out[p + "moe.gate_weight"] = ((d, e), "fp32")
        out[p + "moe.experts.w_gate_up"] = ((e, d, 2 * f), "float")
        out[p + "moe.experts.w_down"] = ((e, f, d), "float")
        if cfg.num_shared_experts > 0:
            out[p + "shared_experts.gate_up_proj"] = ((d, 2 * shared), "float")
            out[p + "shared_experts.down_proj"] = ((shared, d), "float")
            if cfg.shared_expert_gate:
                out[p + "shared_experts.gate"] = ((d, 1), "fp32")
    out["norm.weight"] = ((d,), "fp32")
    return out


class SharedExpertMLP(nn.Module):
    """DeepSeekMoE's always-on shared expert(s): one SwiGLU MLP of width
    num_shared * moe_ffn; Qwen2-MoE multiplies its output by a sigmoid
    gate computed in fp32 (``gate`` [d, 1])."""

    def __init__(self, cfg: MoEConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        width = cfg.num_shared_experts * cfg.moe_intermediate_size
        d = cfg.hidden_size
        self.gate_up_proj = init.weight(d, 2 * width)
        self.down_proj = init.weight(width, d)
        self.gate = (nn.Parameter(init.normal((d, 1), torch.float32,
                                              init.device, init.generator))
                     if cfg.shared_expert_gate else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g, u = torch.matmul(x, self.gate_up_proj.to(x.dtype)).chunk(2, -1)
        out = torch.matmul(F.silu(g) * u, self.down_proj.to(x.dtype))
        if self.gate is not None:
            gate = torch.sigmoid(torch.matmul(x.float(), self.gate))
            out = out * gate.to(out.dtype)
        return out


class MoEDecoderLayer(nn.Module):
    """Attention, then the dense MLP (``dense``) or the routed experts
    plus the shared experts. forward → (hidden, aux_loss)."""

    def __init__(self, cfg: MoEConfig, init: _Init, dense: bool = False):
        super().__init__()
        self.cfg = cfg
        self.dense = dense
        lcfg = cfg._as_llama()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device=init.device, dtype="float32")
        self.self_attn = LlamaAttention(lcfg, init)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, device=init.device,
            dtype="float32")
        if dense:
            self.mlp = LlamaMLP(lcfg, init)
            return
        self.moe = MoELayer(cfg.hidden_size, cfg.moe_intermediate_size,
                            cfg.num_experts, top_k=cfg.num_experts_per_tok,
                            capacity_factor=cfg.capacity_factor,
                            dtype=init.dtype, device=init.device,
                            generator=init.generator)
        self.shared_experts = (SharedExpertMLP(cfg, init)
                               if cfg.num_shared_experts > 0 else None)

    def forward(self, x, cos, sin, neg_sin=None):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin,
                               neg_sin=neg_sin)
        z = self.post_attention_layernorm(h)
        if self.dense:
            return h + self.mlp(z), torch.zeros((), device=x.device)
        routed, aux = self.moe(z)
        if self.shared_experts is not None:
            routed = routed + self.shared_experts(z)
        return h + routed, aux


class MoEForCausalLM(nn.Module):
    """DeepSeekMoE / Qwen2-MoE-style causal LM. ``device`` defaults to the
    CUDA card (raising where there is none); ``dtype`` to ``cfg.dtype``;
    parameters are drawn from ``generator`` (a generator seeded with 0 on
    ``device`` when None)."""

    def __init__(self, cfg: MoEConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        init = _Init(cfg._as_llama(), device, dtype, generator)
        self.cfg = cfg
        self.embed_tokens = init.weight(cfg.vocab_size, cfg.hidden_size)
        self.lm_head = init.weight(cfg.hidden_size, cfg.vocab_size)
        self.layers = nn.ModuleList([
            MoEDecoderLayer(cfg, init, dense=i < cfg.first_k_dense_replace)
            for i in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                            device=init.device, dtype="float32")
        cos, sin = rope_ops.rope_freqs(cfg.head_dim,
                                       cfg.max_position_embeddings,
                                       cfg.rope_theta, device=init.device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        # the RoPE backward's table, kept so no step allocates it
        self.register_buffer("rope_neg_sin", -sin, persistent=False)

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                return_logits: Optional[bool] = None):
        """input_ids [b, s] → logits [b, s, vocab] in the hidden dtype
        without ``labels``. With ``labels`` (-100 = ignored): ``(loss,
        logits)``, or the loss alone when ``return_logits`` is False;
        loss = the causal-LM cross entropy (the fused vocab-CE head by
        default, :func:`~.llama.fused_loss_enabled`) + ``aux_loss_weight``
        × the layers' summed load-balance losses. As for Llama, the
        returned logits are computed only for the caller (a training loop
        asks for the loss alone)."""
        cfg = self.cfg
        x = F.embedding(input_ids, self.embed_tokens)
        aux_total = torch.zeros((), device=x.device)
        remat = cfg.recompute == "full" and torch.is_grad_enabled()
        for layer in self.layers:
            args = (x, self.rope_cos, self.rope_sin, self.rope_neg_sin)
            x, aux = (run_recomputed(layer, *args, policy="full") if remat
                      else layer(*args))
            aux_total = aux_total + aux
        hidden = self.norm(x)
        if labels is None:
            return self.logits(hidden)
        logits = None
        if fused_loss_enabled(cfg):
            ce = fused_causal_lm_loss(hidden, self.lm_head.to(hidden.dtype),
                                      labels)
        else:
            logits = self.logits(hidden)
            ce = causal_lm_loss(logits, labels)
        loss = ce + cfg.aux_loss_weight * aux_total
        if return_logits is False:
            return loss
        return loss, (logits if logits is not None else self.logits(hidden))

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.matmul(hidden, self.lm_head.to(hidden.dtype))

    # -- size accounting (MFU calculator input) ------------------------------

    def num_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def num_activated_params(self) -> int:
        """Parameters a token activates: all but the experts it is not
        routed to (top_k of them, plus the shared experts, count)."""
        cfg = self.cfg
        per_expert = 3 * cfg.hidden_size * cfg.moe_intermediate_size
        n_moe_layers = cfg.num_hidden_layers - cfg.first_k_dense_replace
        inactive = (cfg.num_experts - cfg.num_experts_per_tok) * per_expert
        return self.num_params() - n_moe_layers * inactive

    def flops_per_token(self, seq_len: int) -> float:
        """Forward + backward FLOPs per token on the activated
        parameters: 6 × (activated − embedding table) + 12 × L × H ×
        seq_len, as the JAX model counts them."""
        cfg = self.cfg
        n = self.num_activated_params()
        n -= cfg.vocab_size * cfg.hidden_size  # embedding gather
        attn = 12 * cfg.num_hidden_layers * cfg.hidden_size * seq_len
        return 6 * n + attn


__all__ = ["MoEConfig", "SharedExpertMLP", "MoEDecoderLayer",
           "MoEForCausalLM", "parameter_shapes"]
