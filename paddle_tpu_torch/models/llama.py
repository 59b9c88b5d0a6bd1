"""Llama-family decoder-only transformer (counterpart of
``paddle_tpu/models/llama.py``).

Weights keep the JAX package's ``[in, out]`` layout and names
(``qkv_proj``, ``o_proj``, ``gate_up_proj``, ``down_proj``,
``embed_tokens``, ``lm_head``), so carrying weights across is a copy
(``paddle_tpu_torch.convert``). Activations run in ``cfg.dtype``; norm
weights and statistics stay fp32.

Ported here: ``forward`` (logits, or with ``labels`` the loss through
the fused vocab-CE head by default or the naive head; attention through
the flash kernels; each layer under activation recompute when
``cfg.recompute`` asks), the size accounting ``num_params`` /
``flops_per_token``, the dense-KV entry points ``prefill`` /
``decode_step`` (caches preallocated at ``max_len`` and written in
place; decode attends through ``ops.attention.dense_decode_attention``,
plain PyTorch as JAX computes it in XLA), the paged-KV serving entry
points ``alloc_paged_caches`` / ``prefill_paged`` /
``decode_step_paged`` and the serving engine's
``prefill_chunk_paged`` (chunked prefill, prefix suffixes) /
``decode_verify_paged`` (speculative verify, the prefix cache's
one-token re-forward). The last two attend through
``_paged_ctx_attention``: a gather of the whole page table, fp32 scores
and a masked softmax in plain PyTorch, as the JAX model computes it in
XLA outside any Pallas kernel. The page pools are updated IN PLACE
(``index_put_``) where JAX returns new arrays; the methods still return
the pools so callers read the same.

Quantized serving (``cfg.weight_dtype="int8"``, ``cfg.kv_dtype="int8"``):
every projection and the untied ``lm_head`` is an int8 ``[n, k]`` weight
with an fp32 ``<name>_scale`` ``[n]`` and goes through the int8 matrix
product kernel (:func:`_proj`); int8 page pools carry one fp32 scale per
page and K/V side, and decode reads them through the int8 paged kernel.
Such a model serves only: ``forward(labels=...)`` raises.

On a device mesh (``parallel.api.shard_layer``, which records a
``MeshPlan`` on every module) the same modules run each rank's shards:
tensor parallelism Megatron-style (the input copied into each
attention and MLP block, their outputs all-reduced, the vocabulary of
the embedding and of the head split, the loss through the vocab-
parallel heads of ``parallel.mp_layers``), sequence parallelism over
``sep`` through the ring or Ulysses (``cfg.sp_mode``), and the loss as
the GLOBAL token mean (the sum of each rank's nll over the all-reduced
count of counted labels; its value is the same on every rank, its
gradient each rank's own part).
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..device import dtype_of, generator as make_generator, resolve_device
from ..distributed.recompute import recompute as run_recomputed
from ..nn import RMSNorm
from ..nn import functional as ptF
from ..nn.initializer import Normal
from ..ops import rope as rope_ops
from ..ops.attention import (dense_decode_attention, forced_decode_impl,
                             paged_decode_attention, paged_decode_dense,
                             sdpa_plain)
from ..ops.quant import quantized_matmul
from ..ops.vocab_ce import fused_linear_cross_entropy

# one layer's page pools: (kp, vp) native, or (kp, vp, kscale, vscale)
# int8 with one fp32 scale per physical page
Pool = Tuple[torch.Tensor, ...]


@dataclass
class LlamaConfig:
    """The inference and training fields of
    ``paddle_tpu.models.llama.LlamaConfig`` with the same defaults, checks
    and presets (whose fields a keyword may override, e.g.
    ``llama3_8b(num_hidden_layers=2)``). ``sequence_parallel`` acts
    only on a model sharded over a mesh with a ``sep`` axis above 1
    (``sp_mode`` "ring" or "ulysses"); elsewhere it changes nothing, as
    in JAX."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    max_position_embeddings: int = 4096
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    initializer_range: float = 0.02
    tie_word_embeddings: bool = False
    use_flash_attention: bool = True
    dtype: str = "float32"
    # activation checkpointing: "none" | "selective" | "full"
    recompute: str = "none"
    # shard activations along the sequence over a "sep" mesh axis
    sequence_parallel: bool = False
    sp_mode: str = "ring"
    # training loss head: "fused" (blockwise lm_head + CE, logits never
    # materialised) or "naive" (logits, then causal_lm_loss)
    loss_impl: str = "fused"
    # serving quantization: "int8" weights (projections and lm_head as
    # int8 [n, k] + fp32 scale [n]; serving only) and "int8" KV pages
    # (one fp32 scale per page and K/V side)
    weight_dtype: str = "native"
    kv_dtype: str = "native"

    def __post_init__(self):
        if self.recompute not in ("none", "selective", "full"):
            raise ValueError(f"recompute must be 'none'|'selective'|'full', "
                             f"got {self.recompute!r}")
        if self.sp_mode not in ("ring", "ulysses"):
            raise ValueError(f"sp_mode must be 'ring'|'ulysses', "
                             f"got {self.sp_mode!r}")
        if self.loss_impl not in ("fused", "naive"):
            raise ValueError(f"loss_impl must be 'fused'|'naive', "
                             f"got {self.loss_impl!r}")
        if self.weight_dtype not in ("native", "int8"):
            raise ValueError(f"weight_dtype must be 'native'|'int8', "
                             f"got {self.weight_dtype!r}")
        if self.kv_dtype not in ("native", "int8"):
            raise ValueError(f"kv_dtype must be 'native'|'int8', "
                             f"got {self.kv_dtype!r}")
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must be divisible by "
                             "num_attention_heads")
        if self.num_attention_heads % self.num_key_value_heads:
            raise ValueError("num_attention_heads must be a multiple of "
                             "num_key_value_heads")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @staticmethod
    def llama3_8b(**kw) -> "LlamaConfig":
        defaults = dict(vocab_size=128256, hidden_size=4096,
                        intermediate_size=14336, num_hidden_layers=32,
                        num_attention_heads=32, num_key_value_heads=8,
                        max_position_embeddings=8192, rope_theta=500000.0)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def llama3_70b(**kw) -> "LlamaConfig":
        defaults = dict(vocab_size=128256, hidden_size=8192,
                        intermediate_size=28672, num_hidden_layers=80,
                        num_attention_heads=64, num_key_value_heads=8,
                        max_position_embeddings=8192, rope_theta=500000.0)
        defaults.update(kw)
        return LlamaConfig(**defaults)

    @staticmethod
    def tiny(**kw) -> "LlamaConfig":
        defaults = dict(vocab_size=512, hidden_size=128, intermediate_size=384,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, max_position_embeddings=256)
        defaults.update(kw)
        return LlamaConfig(**defaults)


def parameter_shapes(cfg: LlamaConfig):
    """{state_dict name: (shape, kind)} of ``LlamaForCausalLM(cfg)`` — the
    names and shapes of the JAX model's state_dict. ``kind`` is "float"
    (``cfg.dtype``), "norm" (fp32 whatever ``cfg.dtype`` is), or, for a
    ``weight_dtype="int8"`` config, "int8" (a projection, transposed to
    ``[out, in]``) and "scale" (its fp32 ``<name>_scale`` ``[out]``).
    Native projections keep the ``[in, out]`` layout."""
    d, m, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    n_h, n_kv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
    int8 = cfg.weight_dtype == "int8"
    out = {}

    def proj(name, k, n):
        if int8:
            out[name] = ((n, k), "int8")
            out[name + "_scale"] = ((n,), "scale")
        else:
            out[name] = ((k, n), "float")
    if not cfg.tie_word_embeddings:
        proj("lm_head", d, v)
    out["model.embed_tokens"] = ((v, d), "float")
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = ((d,), "norm")
        proj(p + "self_attn.qkv_proj", d, (n_h + 2 * n_kv) * hd)
        proj(p + "self_attn.o_proj", n_h * hd, d)
        out[p + "post_attention_layernorm.weight"] = ((d,), "norm")
        proj(p + "mlp.gate_up_proj", d, 2 * m)
        proj(p + "mlp.down_proj", m, d)
    out["model.norm.weight"] = ((d,), "norm")
    return out


def sharding_annotations(cfg: LlamaConfig):
    """{state_dict name: (spec, blocks)}: ``spec`` is the JAX model's
    ``sharding=`` annotation of the parameter (a tuple of mesh axes per
    dimension, or None: replicated); ``blocks`` lists the (units, unit
    width) runs of the tensor-parallel dimension of a fused projection
    ([q | k | v] heads, [gate | up] columns), each split over ``tp`` on
    its own so that a rank holds its own heads of each part (None: one
    even split). Float projections only: an int8 model serves only."""
    d, m = cfg.hidden_size, cfg.intermediate_size
    n_h, n_kv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                     cfg.head_dim)
    col, row = ("fsdp", "tp"), ("tp", "fsdp")
    out = {}
    if not cfg.tie_word_embeddings:
        out["lm_head"] = (col, None)
    out["model.embed_tokens"] = (row, None)
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        out[p + "input_layernorm.weight"] = (None, None)
        out[p + "self_attn.qkv_proj"] = (col, [(n_h, hd), (n_kv, hd),
                                               (n_kv, hd)])
        out[p + "self_attn.o_proj"] = (row, [(n_h, hd)])
        out[p + "post_attention_layernorm.weight"] = (None, None)
        out[p + "mlp.gate_up_proj"] = (col, [(m, 1), (m, 1)])
        out[p + "mlp.down_proj"] = (row, None)
    out["model.norm.weight"] = (None, None)
    return out


class _Init:
    """Where, in what type and from which generator a model's parameters
    are drawn: one object threaded through every constructor. With
    ``draw=False`` float weights are left uninitialised (``torch.empty``)
    for a caller that loads a state dict next; on the meta device (shapes
    and dtypes alone, ``parallel.scale``) nothing is drawn."""

    def __init__(self, cfg: LlamaConfig, device, dtype, generator,
                 draw: bool = True):
        self.device = resolve_device(device)
        self.dtype = dtype_of(dtype if dtype is not None else cfg.dtype)
        self.int8 = cfg.weight_dtype == "int8"
        self.draw = draw and self.device.type != "meta"
        self.generator = (generator if generator is not None
                          or not self.draw
                          else make_generator(0, self.device))
        self.normal = Normal(0.0, cfg.initializer_range)

    def weight(self, *shape) -> nn.Parameter:
        if not self.draw:
            return nn.Parameter(torch.empty(shape, dtype=self.dtype,
                                            device=self.device))
        return nn.Parameter(self.normal(shape, self.dtype, self.device,
                                        self.generator))

    def proj(self, module: nn.Module, name: str, k: int, n: int) -> None:
        """Register the projection ``name`` of a [k] -> [n] map on
        ``module`` in the layout ``cfg.weight_dtype`` asks for, as the JAX
        model's ``_make_proj``: native, a float [k, n] weight; int8, an
        int8 [n, k] weight at 0 and an fp32 ``<name>_scale`` [n] at 1.
        Both int8 tensors are parameters without gradient (an int8
        tensor cannot require one), so they sit in ``state_dict()`` under
        the JAX names."""
        if not self.int8:
            module.register_parameter(name, self.weight(k, n))
            return
        module.register_parameter(name, nn.Parameter(
            torch.zeros((n, k), dtype=torch.int8, device=self.device),
            requires_grad=False))
        module.register_parameter(name + "_scale", nn.Parameter(
            torch.ones((n,), dtype=torch.float32, device=self.device),
            requires_grad=False))


def _proj(module: nn.Module, x: torch.Tensor, name: str,
          tp=None) -> torch.Tensor:
    """The one weight product every Llama linear goes through, as in the
    JAX model: a native weight is a dense ``x @ w`` in x's dtype; an int8
    weight (it has a ``<name>_scale`` twin) goes through
    ``ops.quant.quantized_matmul`` — the int8 matrix product kernel on
    the card. ``tp``: the input enters a tensor-parallel region here
    (``distributed.overlap.copy_matmul``: copied in, its gradient
    all-reduced over tp, overlapped with dW's product)."""
    w = getattr(module, name)
    scale = getattr(module, name + "_scale", None)
    if scale is not None:
        return quantized_matmul(x, w, scale)
    if tp is not None:
        from ..distributed.overlap import copy_matmul
        return copy_matmul(x, w.to(x.dtype), tp)
    return torch.matmul(x, w.to(x.dtype))


def _token_mean(nll: torch.Tensor, labels: torch.Tensor,
                ignore_index: int = -100) -> torch.Tensor:
    """Token-weighted mean over per-token nll (ignored rows already 0):
    sum(nll) / max(count of counted labels, 1). The reduction the naive
    head's cross entropy applies, kept as one function for the fused
    vocab-CE head to share (as in ``paddle_tpu``)."""
    cnt = (labels != ignore_index).sum().float()
    return nll.sum() / cnt.clamp_min(1.0)


def fused_loss_enabled(cfg) -> bool:
    """The fused loss head is the default; ``cfg.loss_impl='naive'`` or
    the environment variable ``PT_NAIVE_LOSS_HEAD`` (set and non-empty)
    select the materialised-logits head, as in ``paddle_tpu``. A config
    without ``loss_impl`` (``MoEConfig``) takes the fused head."""
    return (getattr(cfg, "loss_impl", "fused") == "fused"
            and not os.environ.get("PT_NAIVE_LOSS_HEAD"))


def fused_causal_lm_loss(hidden: torch.Tensor, w: torch.Tensor,
                         labels: torch.Tensor,
                         ignore_index: int = -100) -> torch.Tensor:
    """Token-weighted mean CE(hidden @ w, labels) with the [b, s, vocab]
    logits never materialised: the fused vocab-CE head
    (``ops.vocab_ce``), the dense path of ``paddle_tpu``'s function (a
    model sharded over a mesh takes :func:`_mesh_loss`)."""
    nll = fused_linear_cross_entropy(hidden, w, labels,
                                     ignore_index=ignore_index,
                                     reduction="none")
    return _token_mean(nll, labels, ignore_index)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -100) -> torch.Tensor:
    """Token-weighted mean cross entropy of the causal-LM head over fp32
    logits (the dense path of ``paddle_tpu``'s ``causal_lm_loss``; a
    model sharded over a mesh takes :func:`_mesh_loss`)."""
    return ptF.cross_entropy(logits.float(), labels,
                             ignore_index=ignore_index)


def _mesh_loss(plan, hidden: torch.Tensor, w: Optional[torch.Tensor],
               logits: Optional[torch.Tensor], labels: torch.Tensor,
               ignore_index: int = -100) -> torch.Tensor:
    """The loss of a model on a mesh: per-token nll from the fused head
    (``w`` given: this rank's [H, V/tp] shard) or from this rank's
    logits, vocab-parallel over ``tp`` when it is above 1 (JAX's branch
    in ``causal_lm_loss`` / ``fused_causal_lm_loss``), then JAX's GLOBAL
    token mean: this rank's nll sum over the count of counted labels
    all-reduced over the data axes, all-reduced in the forward only, so
    that each rank's gradient is its own part."""
    from ..distributed.communication import all_reduce, reduce_from_group
    nll = (token_nll(plan, hidden, w, labels, True, ignore_index)
           if w is not None else _logits_nll(plan, logits, labels,
                                             ignore_index))
    cnt = all_reduce((labels != ignore_index).sum().float(),
                     group=plan.data)
    return reduce_from_group(nll.sum() / cnt.clamp_min(1.0), plan.data)


# -- int8 paged-KV helpers ----------------------------------------------
#
# kv_dtype="int8" pools hold K/V pages as int8 with ONE fp32 absmax scale
# per physical page and K/V side: a layer's pool entry is the 4-tuple
# (kp, vp, kscale, vscale), kscale/vscale [num_pages], scale 0 meaning a
# page never written (it reads as zeros). Scales only grow: a token write
# that needs a larger scale requantizes its page onto the new grid first.
# Rounding and clipping are the JAX package's, bit for bit.

_KV_EPS = 1e-30      # guards the divides where a scale is 0


def _kv_quantized(kv: Pool) -> bool:
    return len(kv) == 4


def _absmax_scale(amax: torch.Tensor) -> torch.Tensor:
    """amax / 127 as an IEEE division on every device: CUDA divides by a
    Python scalar as a product with its rounded reciprocal, one ulp off
    the CPU's (and JAX's) quotient, so the divisor is a 0-d tensor."""
    return amax / amax.new_full((), 127.0)


def _quantize(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """round-half-to-even(t / max(s, eps)) clipped to ±127, as int8;
    ``s`` broadcasts against ``t``."""
    return torch.round(t / s.clamp_min(_KV_EPS)).clamp_(-127, 127).to(
        torch.int8)


def _kv_scatter_pages(kv: Pool, phys: torch.Tensor, k_tiles: torch.Tensor,
                      v_tiles: torch.Tensor) -> Pool:
    """Full-page write (prefill): ``phys`` [P] physical page ids, tiles
    [n_kv, P, page, hd]. In place. Int8 pools get one absmax scale per
    written page, replacing the old one (the page is rewritten whole)."""
    if not _kv_quantized(kv):
        kp, vp = kv
        kp[:, phys] = k_tiles.to(kp.dtype)
        vp[:, phys] = v_tiles.to(vp.dtype)
        return kv
    kp, vp, ks, vs = kv
    for pool, scale, tiles in ((kp, ks, k_tiles), (vp, vs, v_tiles)):
        t = tiles.float()
        s = _absmax_scale(t.abs().amax(dim=(0, 2, 3)))           # [P]
        pool[:, phys] = _quantize(t, s[None, :, None, None])
        scale[phys] = s
    return kv


def _kv_scatter_tokens(kv: Pool, phys: torch.Tensor, off: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor) -> Pool:
    """Token-slot write (decode, speculative verify): ``phys``/``off``
    [...] (``[b]`` or ``[b, T]``) physical page and in-page offset per
    token; ``k_new``/``v_new`` [n_kv, ..., hd]. In place. Int8 pools
    grow the touched pages' scales to cover the new tokens (a
    scatter-max over the flattened page ids, so several tokens landing
    in one page, as a verify row's tokens or idle slots on the garbage
    page do, agree on its scale, as JAX's ``.at[].max`` does),
    requantize those pages onto the grown scale (a page whose scale did
    not change keeps its codes: the factor is exactly 1; a page named
    twice gets the same codes twice), then write the new codes."""
    if not _kv_quantized(kv):
        kp, vp = kv
        kp[:, phys, off] = k_new.to(kp.dtype)
        vp[:, phys, off] = v_new.to(vp.dtype)
        return kv
    kp, vp, ks, vs = kv
    for pool, scale, new in ((kp, ks, k_new), (vp, vs, v_new)):
        t = new.float()
        amax = t.abs().amax(dim=(0, -1))                         # [...]
        grown = torch.maximum(scale, torch.zeros_like(scale).scatter_reduce(
            0, phys.reshape(-1), _absmax_scale(amax).reshape(-1), "amax"))
        s_w = grown[phys]                                        # [...]
        factor = torch.where(s_w > 0, scale[phys] / s_w.clamp_min(_KV_EPS),
                             0.0)
        pages = pool[:, phys].float()           # [n_kv, ..., page, hd]
        pool[:, phys] = torch.round(
            pages * factor[None, ..., None, None]).clamp_(-127, 127).to(
                torch.int8)
        pool[:, phys, off] = _quantize(t, s_w[None, ..., None])
        scale.copy_(grown)
    return kv


def _kv_gather_ctx(kv: Pool, tables: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Whole-table gather for the context-attention read: (k_ctx, v_ctx)
    [b, n_kv, max_pages * page, hd] fp32 views, int8 pages dequantized
    with their page's scale (copy of the JAX model's ``_kv_gather_ctx``)."""
    flat = tables.reshape(-1).long()
    b, mp = tables.shape

    def one(pool, scale=None):
        n_kv, _, page, hd = pool.shape
        ctx = pool[:, flat].float()                 # [n_kv, b*mp, page, hd]
        if scale is not None:
            ctx.mul_(scale[flat][None, :, None, None])
        return ctx.view(n_kv, b, mp * page, hd).transpose(0, 1)
    if _kv_quantized(kv):
        kp, vp, ks, vs = kv
        return one(kp, ks), one(vp, vs)
    return one(kv[0]), one(kv[1])


def _tp_group(plan):
    """The tensor-parallel group of a model's mesh plan, or None."""
    return plan.tp if plan is not None and plan.tp_size > 1 else None


def vocab_embed(plan, w: torch.Tensor, input_ids: torch.Tensor
                ) -> torch.Tensor:
    """Token embedding; vocab-parallel over ``tp`` on a mesh (this
    rank's rows of ``w``; ids outside them give 0, then a sum over
    tp)."""
    tp = _tp_group(plan)
    if tp is None:
        return F.embedding(input_ids, w)
    from ..distributed.communication import reduce_from_group
    lo = plan.tp_rank * w.shape[0]
    inside = (input_ids >= lo) & (input_ids < lo + w.shape[0])
    out = F.embedding(torch.where(inside, input_ids - lo, 0), w)
    return reduce_from_group(out * inside[..., None].to(out.dtype), tp)


def _logits_nll(plan, logits: torch.Tensor, labels: torch.Tensor,
                ignore_index: int = -100) -> torch.Tensor:
    """Per-token nll of this rank's logits (its vocabulary columns on a
    tensor-parallel mesh)."""
    from ..parallel.mp_layers import parallel_cross_entropy
    if _tp_group(plan) is not None:
        return parallel_cross_entropy(logits, labels, mesh=plan.mesh,
                                      ignore_index=ignore_index)
    return F.cross_entropy(logits.float().reshape(-1, logits.shape[-1]),
                           labels.reshape(-1), ignore_index=ignore_index,
                           reduction="none")


def token_nll(plan, hidden: torch.Tensor, w: torch.Tensor,
              labels: torch.Tensor, fused: bool,
              ignore_index: int = -100) -> torch.Tensor:
    """Per-token nll (0 at ignored labels) of the head ``hidden @ w``:
    the fused vocab-CE head or materialised logits, vocab-parallel over
    ``tp`` on a mesh (``w`` this rank's [H, V/tp] columns)."""
    from ..distributed.communication import copy_to_group
    from ..parallel.mp_layers import parallel_fused_linear_cross_entropy
    tp = _tp_group(plan)
    if fused and tp is not None:
        return parallel_fused_linear_cross_entropy(
            hidden, w, labels, mesh=plan.mesh, ignore_index=ignore_index)
    if fused:
        return fused_linear_cross_entropy(hidden, w, labels,
                                          ignore_index=ignore_index,
                                          reduction="none")
    h = hidden if tp is None else copy_to_group(hidden, tp)
    return _logits_nll(plan, torch.matmul(h, w), labels, ignore_index)


class LlamaAttention(nn.Module):
    # parallel.api.MeshPlan of a model sharded over a mesh
    _mesh_plan = None

    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.head_dim
        n_h, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
        init.proj(self, "qkv_proj", d, (n_h + 2 * n_kv) * hd)
        init.proj(self, "o_proj", n_h * hd, d)

    def _heads(self) -> Tuple[int, int]:
        """(query heads, KV heads) of this rank: a tensor-parallel rank
        holds n_h / tp query heads and n_kv / tp KV heads, or one KV head
        shared with the other ranks of its group when tp > n_kv."""
        cfg = self.cfg
        n_h, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
        tp = self._mesh_plan.tp_size if self._mesh_plan is not None else 1
        return n_h // tp, max(n_kv // tp, 1)

    def _qkv_rope(self, x, cos, sin, position_ids=None, neg_sin=None,
                  tp=None):
        """Fused QKV projection + head split + rotary embedding. q, k and
        v are views of the one projection output; the RoPE kernel reads
        q and k through their strides. ``neg_sin`` is the backward's
        table (the model's buffer); ``tp`` the tensor-parallel group the
        input enters (:func:`_proj`)."""
        cfg = self.cfg
        b, s, _ = x.shape
        n_h, n_kv = self._heads()
        hd = cfg.head_dim
        qkv = _proj(self, x, "qkv_proj", tp)
        q, k, v = torch.split(qkv, [n_h * hd, n_kv * hd, n_kv * hd], dim=-1)
        q = q.view(b, s, n_h, hd)
        k = k.view(b, s, n_kv, hd)
        v = v.view(b, s, n_kv, hd)
        q, k = rope_ops.apply_rotary_pos_emb(q, k, cos, sin, position_ids,
                                             neg_sin)
        return q, k, v

    def _out(self, attn: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """The output projection of this rank's heads, all-reduced over
        ``tp`` on a mesh (every training and inference path)."""
        from ..distributed.communication import reduce_from_group
        tp = _tp_group(self._mesh_plan)
        b, s = attn.shape[:2]
        out = _proj(self, attn.reshape(b, s, -1).to(x.dtype), "o_proj")
        return out if tp is None else reduce_from_group(out, tp)

    def forward(self, x, cos, sin, position_ids=None, attn_mask=None,
                segment_ids=None, neg_sin=None):
        """Causal self-attention: the flash kernels (forward and
        backward) when ``cfg.use_flash_attention``, else ``sdpa_plain``,
        as the JAX model chooses between flash and ``_sdpa_xla``. A dense
        ``attn_mask`` (boolean or additive, broadcast to [b, h, s, s])
        takes ``sdpa_plain`` on either branch, as the JAX dispatch sends
        it to ``_sdpa_xla``. On a mesh: the block is tensor-parallel
        over ``tp`` (input copied in, output all-reduced) and, with
        sequence parallelism, attends through :meth:`_sp_attention`."""
        tp = _tp_group(self._mesh_plan)
        q, k, v = self._qkv_rope(x, cos, sin, position_ids, neg_sin, tp)
        out = self._sp_attention(q, k, v, attn_mask, segment_ids)
        if out is None and self.cfg.use_flash_attention:
            out = ptF.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=True,
                training=self.training, segment_ids=segment_ids)
        elif out is None:
            out = sdpa_plain(q, k, v, causal=True, segment_ids=segment_ids,
                             attn_mask=attn_mask)
        return self._out(out, x)

    def _sp_attention(self, q, k, v, attn_mask, segment_ids=None):
        """Attention over the ``sep`` axis (JAX's ``_sp_attention``): None
        without sequence parallelism or with a ``sep`` axis of 1. Packed
        sequences (``segment_ids``) take the ring, whose KV segment ids
        rotate with their blocks; ``sp_mode="ulysses"`` with them raises,
        as in JAX. Ulysses runs where it splits this rank's heads, the
        ring otherwise."""
        cfg, plan = self.cfg, self._mesh_plan
        if not cfg.sequence_parallel or plan is None or plan.sep_size <= 1:
            return None
        if attn_mask is not None:
            raise NotImplementedError(
                "a dense attn_mask under sequence parallelism: the ring "
                "and Ulysses take causal attention with segment ids")
        if cfg.sp_mode == "ulysses":
            if segment_ids is not None:
                raise NotImplementedError(
                    "segment_ids (packed sequences) with sp_mode='ulysses' "
                    "is not supported: use sp_mode='ring' (the ring "
                    "rotates segment ids with their K/V blocks) or unpack "
                    "the batch.")
            from ..parallel.ulysses import (ulysses_attention,
                                            ulysses_supported)
            if ulysses_supported(q.shape[2], k.shape[2], plan.sep_size):
                return ulysses_attention(q, k, v, causal=True,
                                         mesh=plan.mesh)
        from ..parallel.ring_attention import ring_attention
        return ring_attention(q, k, v, causal=True, mesh=plan.mesh,
                              segment_ids=segment_ids)

    def prefill(self, x, cos, sin, max_len: int):
        """Prompt pass that also builds the dense KV cache: k and v
        [b, max_len, n_kv, hd] in the activations' dtype (n_kv this
        rank's KV heads, :meth:`_heads`), zeros past the prompt, which
        attends to itself through ``sdpa_plain``."""
        b, s, _ = x.shape
        q, k, v = self._qkv_rope(x, cos, sin)
        out = self._out(sdpa_plain(q, k, v, causal=True), x)
        shape = (b, max_len, self._heads()[1], self.cfg.head_dim)
        k_cache, v_cache = k.new_zeros(shape), v.new_zeros(shape)
        k_cache[:, :s] = k
        v_cache[:, :s] = v
        return out, (k_cache, v_cache)

    def decode(self, x, cos, sin, pos: torch.Tensor, kv_cache):
        """One-token step over the dense cache: x [b, 1, d] at positions
        ``pos`` [b]; writes the new K/V row at ``pos`` in place (an
        indexed store: the host never reads ``pos``) and attends rows
        0..pos through :func:`dense_decode_attention`."""
        b = x.shape[0]
        k_cache, v_cache = kv_cache
        q, k, v = self._qkv_rope(x, cos, sin, pos.view(b, 1))
        b_idx = torch.arange(b, device=x.device)
        k_cache[b_idx, pos] = k[:, 0]
        v_cache[b_idx, pos] = v[:, 0]
        out = dense_decode_attention(q[:, 0], k_cache, v_cache, pos)
        return self._out(out.reshape(b, 1, -1), x), kv_cache

    def prefill_paged(self, x, cos, sin, kv: Pool, tables: torch.Tensor):
        """Prompt pass writing K/V into head-major page pools
        [H_kv, num_pages, page_size, hd] through ``tables``
        [b, max_pages]; ``kv`` is the layer's pool entry, native or int8
        (:data:`Pool`). The prompt attends to its own float K/V; the pool
        gets them quantized. The prompt is padded up to a page multiple
        inside the pool; padded slots lie beyond seq_len and are
        overwritten by decode before anything attends to them. On a
        tensor-parallel mesh the pools hold this rank's KV heads."""
        b, s, _ = x.shape
        n_kv, hd = self._heads()[1], self.cfg.head_dim
        page = kv[0].shape[2]
        q, k, v = self._qkv_rope(x, cos, sin)
        out = self._out(sdpa_plain(q, k, v, causal=True), x)
        np_ = -(-s // page)
        pad = np_ * page - s

        def tiles(new):
            padded = F.pad(new, (0, 0, 0, 0, 0, pad))
            return padded.reshape(b, np_, page, n_kv, hd).permute(
                3, 0, 1, 2, 4).reshape(n_kv, b * np_, page, hd)
        kv = _kv_scatter_pages(kv, tables[:, :np_].reshape(-1).long(),
                               tiles(k), tiles(v))
        return out, kv

    def decode_paged(self, x, cos, sin, pos: torch.Tensor, kv: Pool,
                     tables: torch.Tensor):
        """One-token step over the page pools: writes the new K/V into the
        slot for position ``pos`` [b] and attends positions 0..pos through
        the paged decode kernel (its plain version on the CPU), with the
        pages' scales when the pools are int8. Inside a
        ``force_decode_impl("dense")`` scope (the serving engine's choice
        at or below its crossover) the attention takes the dense route,
        ``paged_decode_dense``, on every device."""
        b = x.shape[0]
        page = kv[0].shape[2]
        q, k, v = self._qkv_rope(x, cos, sin, pos.view(b, 1))
        b_idx = torch.arange(b, device=x.device)
        # clamped as a JAX gather clamps: an idle slot whose request ended
        # at max_len sits one position past its last page
        lp = (pos // page).clamp_max(tables.shape[1] - 1)
        phys = tables[b_idx, lp].long()
        off = pos % page
        kv = _kv_scatter_tokens(kv, phys, off, k[:, 0].transpose(0, 1),
                                v[:, 0].transpose(0, 1))
        scales = ({"k_scales": kv[2], "v_scales": kv[3]}
                  if _kv_quantized(kv) else {})
        route = (paged_decode_dense if forced_decode_impl() == "dense"
                 else paged_decode_attention)
        out = route(q[:, 0].contiguous(), kv[0], kv[1], tables, pos,
                    **scales)
        return self._out(out.reshape(b, 1, -1), x), kv

    def _paged_ctx_attention(self, q, positions, kv: Pool, tables):
        """Full-table-span paged attention read (the JAX model's, which
        runs in XLA outside every Pallas kernel, so here it is plain
        PyTorch on every device): queries ``q`` [b, C, n_h, hd] at
        absolute ``positions`` [b, C] attend over the whole gathered
        table (max_pages * page keys) in fp32, masked by key index <=
        position per row. The query heads of one KV head are grouped
        against it, so the gathered K/V are never expanded to n_h heads.
        Returns [b, C, n_h * hd] fp32 (this rank's heads on a mesh)."""
        (n_h, n_kv), hd = self._heads(), self.cfg.head_dim
        b, C = positions.shape
        k_ctx, v_ctx = _kv_gather_ctx(kv, tables)   # [b, n_kv, S, hd]
        S = k_ctx.shape[2]
        qf = q.float().view(b, C, n_kv, n_h // n_kv, hd)
        scores = torch.einsum("bcgrd,bgsd->bgrcs", qf, k_ctx) / (hd ** 0.5)
        del k_ctx
        j = torch.arange(S, device=q.device)
        allowed = j[None, None, None, None, :] <= positions[:, None, None,
                                                            :, None]
        probs = torch.softmax(scores.masked_fill_(~allowed, -1e30), dim=-1)
        out = torch.einsum("bgrcs,bgsd->bcgrd", probs, v_ctx)
        return out.reshape(b, C, n_h * hd)

    def prefill_chunk_paged(self, x, cos, sin, offset, kv: Pool, tables):
        """Chunked-prefill step: a C-token chunk at positions [offset,
        offset + C) writes its K/V pages and attends over the paged
        history plus itself. ``offset`` (an int or a 0-d tensor) is
        page-aligned and C a page multiple; the engine enforces both.
        Tiles past the table go to the garbage page 0 explicitly."""
        b, C, _ = x.shape
        n_kv, hd = self._heads()[1], self.cfg.head_dim
        page = kv[0].shape[2]
        positions = (torch.arange(C, device=x.device) + offset).expand(b, C)
        q, k, v = self._qkv_rope(x, cos, sin, positions)
        npg, mp = C // page, tables.shape[1]
        pidx = torch.arange(npg, device=x.device) + offset // page
        phys = torch.where(pidx[None, :] < mp,
                           tables[:, pidx.clamp_max(mp - 1)].long(), 0)

        def tiles(new):
            return new.reshape(b, npg, page, n_kv, hd).permute(
                3, 0, 1, 2, 4).reshape(n_kv, b * npg, page, hd)
        kv = _kv_scatter_pages(kv, phys.reshape(-1), tiles(k), tiles(v))
        return self._out(self._paged_ctx_attention(q, positions, kv, tables),
                         x), kv

    def decode_verify_paged(self, x, cos, sin, pos: torch.Tensor, kv: Pool,
                            tables):
        """Speculative-verify step: T tokens a row at the row's positions
        ``pos[b] .. pos[b] + T - 1``; writes all T K/V slots (writes past
        a row's table go to the garbage page 0), then attends causally
        over the paged history plus the in-chunk prefix."""
        b, T = x.shape[:2]
        page, mp = kv[0].shape[2], tables.shape[1]
        positions = pos[:, None] + torch.arange(T, device=x.device)[None, :]
        q, k, v = self._qkv_rope(x, cos, sin, positions)
        pidx = positions // page
        phys = torch.where(pidx < mp, torch.gather(
            tables, 1, pidx.clamp_max(mp - 1)).long(), 0)
        kv = _kv_scatter_tokens(kv, phys, positions % page,
                                k.permute(2, 0, 1, 3), v.permute(2, 0, 1, 3))
        return self._out(self._paged_ctx_attention(q, positions, kv, tables),
                         x), kv


class LlamaMLP(nn.Module):
    _mesh_plan = None

    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        d, m = cfg.hidden_size, cfg.intermediate_size
        init.proj(self, "gate_up_proj", d, 2 * m)
        init.proj(self, "down_proj", m, d)

    def forward(self, x):
        """SwiGLU; tensor-parallel on a mesh (this rank's [gate | up]
        columns and down rows, the output all-reduced)."""
        from ..distributed.communication import reduce_from_group
        tp = _tp_group(self._mesh_plan)
        g, u = _proj(self, x, "gate_up_proj", tp).chunk(2, dim=-1)
        y = _proj(self, F.silu(g) * u, "down_proj")
        return y if tp is None else reduce_from_group(y, tp)


class LlamaDecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                                       device=init.device, dtype="float32")
        self.self_attn = LlamaAttention(cfg, init)
        self.post_attention_layernorm = RMSNorm(
            cfg.hidden_size, cfg.rms_norm_eps, device=init.device,
            dtype="float32")
        self.mlp = LlamaMLP(cfg, init)

    def forward(self, x, cos, sin, position_ids=None, attn_mask=None,
                segment_ids=None, neg_sin=None):
        h = x + self.self_attn(self.input_layernorm(x), cos, sin,
                               position_ids, attn_mask, segment_ids, neg_sin)
        return h + self.mlp(self.post_attention_layernorm(h))


    def prefill(self, x, cos, sin, max_len: int):
        a, cache = self.self_attn.prefill(self.input_layernorm(x), cos, sin,
                                          max_len)
        h = x + a
        return h + self.mlp(self.post_attention_layernorm(h)), cache

    def decode(self, x, cos, sin, pos, kv_cache):
        a, cache = self.self_attn.decode(self.input_layernorm(x), cos, sin,
                                         pos, kv_cache)
        h = x + a
        return h + self.mlp(self.post_attention_layernorm(h)), cache


class LlamaModel(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 init: Optional[_Init] = None):
        super().__init__()
        init = init or _Init(cfg, device, dtype, generator)
        self.cfg = cfg
        self.embed_tokens = init.weight(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList([LlamaDecoderLayer(cfg, init)
                                     for _ in range(cfg.num_hidden_layers)])
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
                position_ids: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """input_ids [b, s] → final hidden states [b, s, hidden].
        ``position_ids`` [b, s] (default 0..s-1) index the RoPE tables;
        ``attn_mask`` is a dense mask over [b, h, s, s] (boolean or
        additive; a padding mask is [b, 1, 1, s]) beside the causal one;
        ``segment_ids`` [b, s] restrict attention to equal ids (packed
        sequences). With ``cfg.recompute`` "full" (nothing kept) or
        "selective" (the projections' products kept) and a gradient
        recorded, each layer runs under activation recompute, as the JAX
        model wraps it in ``jax.checkpoint``.

        On a mesh the inputs are this rank's: under sequence parallelism
        its block of the sequence (rank r of ``sep`` block r, the default
        positions offset to match), as the Trainer slices the batch
        (``MeshPlan.local_batch``); JAX's ``_seq_shard`` constraint has
        nothing to do here."""
        cfg, plan = self.cfg, self._mesh_plan
        remat = cfg.recompute != "none" and torch.is_grad_enabled()
        policy = ("dots_with_no_batch_dims_saveable"
                  if cfg.recompute == "selective" else "full")
        x = self._embed(input_ids)
        if plan is not None and plan.seq and position_ids is None:
            b, s = input_ids.shape
            position_ids = (torch.arange(s, device=input_ids.device)
                            + plan.sep_rank * s).expand(b, s)
        for layer in self.layers:
            args = (x, self.rope_cos, self.rope_sin, position_ids,
                    attn_mask, segment_ids, self.rope_neg_sin)
            x = (run_recomputed(layer, *args, policy=policy) if remat
                 else layer(*args))
        return self.norm(x)

    _mesh_plan = None

    def _embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return vocab_embed(self._mesh_plan, self.embed_tokens, input_ids)

    # -- dense-KV inference paths ---------------------------------------------

    def prefill(self, input_ids, max_len: int):
        """Prompt pass: input_ids [b, s] → (hidden [b, s, d], caches), the
        caches a list of per-layer (k, v) [b, max_len, n_kv, hd]. On a
        tensor-parallel mesh each rank holds its heads' caches, the
        embedding is vocab-parallel and each block's output is summed
        over tp, as in training."""
        x = self._embed(input_ids)
        caches = []
        for layer in self.layers:
            x, cache = layer.prefill(x, self.rope_cos, self.rope_sin,
                                     max_len)
            caches.append(cache)
        return self.norm(x), caches

    def decode_step(self, token_ids, pos, caches):
        """token_ids [b], pos [b] int64 → (hidden [b, 1, d], caches), the
        caches written in place."""
        x = self._embed(token_ids[:, None])
        for layer, cache in zip(self.layers, caches):
            x, _ = layer.decode(x, self.rope_cos, self.rope_sin, pos, cache)
        return self.norm(x), caches

    # -- paged-KV (vLLM-style) inference paths ------------------------------

    def alloc_paged_caches(self, batch: int, max_len: int,
                           page_size: int = 128
                           ) -> Tuple[List[Pool], torch.Tensor]:
        """Per-layer head-major page pools (zeros) + a block table that
        gives each sequence its pages contiguously. ``cfg.kv_dtype="int8"``
        pools are 4-tuples: int8 pages and one fp32 scale per page and
        K/V side, starting at 0 (a page that holds nothing, read as the
        zeros a native pool starts with). On a tensor-parallel mesh the
        pools are [n_kv / tp (at least 1), pages, page, hd]: this rank's
        KV heads."""
        cfg = self.cfg
        pages_per_seq = -(-max_len // page_size)
        num_pages = batch * pages_per_seq
        shape = (self.layers[0].self_attn._heads()[1], num_pages, page_size,
                 cfg.head_dim)
        dev, dt = self.embed_tokens.device, self.embed_tokens.dtype
        if cfg.kv_dtype == "int8":
            pools = [(torch.zeros(shape, dtype=torch.int8, device=dev),
                      torch.zeros(shape, dtype=torch.int8, device=dev),
                      torch.zeros((num_pages,), device=dev),
                      torch.zeros((num_pages,), device=dev))
                     for _ in range(cfg.num_hidden_layers)]
        else:
            pools = [(torch.zeros(shape, dtype=dt, device=dev),
                      torch.zeros(shape, dtype=dt, device=dev))
                     for _ in range(cfg.num_hidden_layers)]
        tables = torch.arange(num_pages, dtype=torch.int32,
                              device=dev).reshape(batch, pages_per_seq)
        return pools, tables

    def _paged_pass(self, input_ids, pools: List[Pool], tables, method: str,
                    *lead):
        """Embed ``input_ids`` [b, s] and run every layer with its
        attention's paged ``method`` (called as ``method(x, cos, sin,
        *lead, kv, tables)``), which updates the layer's pools in place."""
        x = self._embed(input_ids)
        for layer, kv in zip(self.layers, pools):
            a, _ = getattr(layer.self_attn, method)(
                layer.input_layernorm(x), self.rope_cos, self.rope_sin,
                *lead, kv, tables)
            h = x + a
            x = h + layer.mlp(layer.post_attention_layernorm(h))
        return self.norm(x), pools

    def prefill_paged(self, input_ids, pools: List[Pool], tables):
        return self._paged_pass(input_ids, pools, tables, "prefill_paged")

    def decode_step_paged(self, token_ids, pos, pools: List[Pool], tables):
        """token_ids [b], pos [b] int64 → (hidden [b, 1, d], pools)."""
        return self._paged_pass(token_ids[:, None], pools, tables,
                                "decode_paged", pos)

    def prefill_chunk_paged(self, input_ids, offset, pools: List[Pool],
                            tables):
        """input_ids [b, C] at positions offset .. offset + C - 1 (offset
        page-aligned, C a page multiple) → (hidden [b, C, d], pools)."""
        return self._paged_pass(input_ids, pools, tables,
                                "prefill_chunk_paged", offset)

    def decode_verify_paged(self, token_ids, pos, pools: List[Pool], tables):
        """Speculative verify: token_ids [b, T] at the rows' positions
        pos[b] .. pos[b] + T - 1 → (hidden [b, T, d], pools); hidden at
        index j scores the token after input j."""
        return self._paged_pass(token_ids, pools, tables,
                                "decode_verify_paged", pos)


class LlamaForCausalLM(nn.Module):
    """Llama with its vocabulary head. ``device`` defaults to the CUDA
    card (raising where there is none); ``dtype`` to ``cfg.dtype``;
    parameters are drawn from ``generator`` (a generator seeded with 0 on
    ``device`` when None). ``init_weights=False`` leaves the float
    weights uninitialised, for a caller that loads a state dict next
    (``quantization.quantize_model``)."""

    def __init__(self, cfg: LlamaConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None,
                 init_weights: bool = True):
        super().__init__()
        init = _Init(cfg, device, dtype, generator, draw=init_weights)
        self.cfg = cfg
        if not cfg.tie_word_embeddings:
            init.proj(self, "lm_head", cfg.hidden_size, cfg.vocab_size)
        else:
            self.lm_head = None
        self.model = LlamaModel(cfg, init=init)

    _mesh_plan = None
    # on a mesh the loss is the global token mean (``_mesh_loss``), as
    # the gradient sums over the data axes assume (``parallel.api``)
    _global_mean_loss = True

    @property
    def _sharding_annotations(self):
        """The parameters' sharding table (:func:`sharding_annotations`),
        which ``parallel.api.shard_layer`` reads."""
        return sharding_annotations(self.cfg)

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Vocabulary projection: the tied embedding's dense product, or
        the ``lm_head`` through :func:`_proj` (int8 in a quantized
        model). Tensor-parallel on a mesh: every rank's vocabulary
        columns gathered."""
        from ..distributed.communication import gather_from_group
        tp = _tp_group(self._mesh_plan)
        out = self._local_logits(hidden)
        return out if tp is None else gather_from_group(out, tp, dim=-1)

    def _local_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """This rank's vocabulary columns of the logits (all of them off
        a tensor-parallel mesh)."""
        from ..distributed.communication import copy_to_group
        tp = _tp_group(self._mesh_plan)
        if tp is not None:
            hidden = copy_to_group(hidden, tp)
        if self.cfg.tie_word_embeddings:
            return torch.matmul(hidden,
                                self.model.embed_tokens.t().to(hidden.dtype))
        return _proj(self, hidden, "lm_head")

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                position_ids: Optional[torch.Tensor] = None,
                attn_mask: Optional[torch.Tensor] = None,
                segment_ids: Optional[torch.Tensor] = None,
                return_logits: Optional[bool] = None):
        """input_ids [b, s] → logits [b, s, vocab] without ``labels``.
        With ``labels`` [b, s] (-100 = ignored): ``(loss, logits)``, or
        the scalar loss alone when ``return_logits`` is False. The loss
        runs the fused vocab-CE head by default (:func:`fused_loss_enabled`):
        blockwise from the hidden states, the logits never materialised.
        Its returned logits are then computed only for the caller: where
        jit would drop them unread, eager PyTorch computes them, so a
        training loop asks for the loss alone (``Trainer`` does). The
        naive head materialises the logits for :func:`causal_lm_loss`.
        An int8-weight model serves only: ``labels`` raise ValueError."""
        if labels is not None and self.cfg.weight_dtype == "int8":
            raise ValueError(
                "weight_dtype='int8' is a serving-only layout (no float "
                "master weights to train); quantize a trained model with "
                "paddle_tpu_torch.quantization.quantize_model instead")
        hidden = self.model(input_ids, position_ids, attn_mask, segment_ids)
        if labels is None:
            return self.logits(hidden)
        logits = None
        plan = self._mesh_plan
        on_mesh = plan is not None and (plan.tp_size > 1
                                        or plan.data_size > 1)
        if fused_loss_enabled(self.cfg):
            w = (self.model.embed_tokens.t() if self.cfg.tie_word_embeddings
                 else self.lm_head)
            loss = (_mesh_loss(plan, hidden, w.to(hidden.dtype), None,
                               labels) if on_mesh else
                    fused_causal_lm_loss(hidden, w.to(hidden.dtype), labels))
        elif on_mesh:
            local = self._local_logits(hidden)
            loss = _mesh_loss(plan, hidden, None, local, labels)
            if plan.tp_size == 1:
                logits = local
        else:
            logits = self.logits(hidden)
            loss = causal_lm_loss(logits, labels)
        if return_logits is False:
            return loss
        return loss, (logits if logits is not None else self.logits(hidden))

    # -- size accounting (MFU calculator input) ------------------------------

    def num_params(self) -> int:
        """The parameters of the whole model (on a mesh, of every rank's
        shards together)."""
        plan = self._mesh_plan
        if plan is not None:
            return sum(math.prod(sh.full_shape)
                       for sh in plan.shards.values())
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len: int, causal: bool = False) -> float:
        """Model forward+backward FLOPs per token by the PaLM appendix-B
        convention: 6 * N_matmul + 12 * L * H * seq_len, with the
        embedding table left out of N unless it is tied (then it is the
        head's matmul). ``causal=True`` counts only the attention a
        causal kernel executes (average context (s + 1) / 2)."""
        cfg = self.cfg
        n = self.num_params()
        if not cfg.tie_word_embeddings:
            n -= cfg.vocab_size * cfg.hidden_size     # gather-only table
        attn = 12 * cfg.num_hidden_layers * cfg.hidden_size * seq_len
        if causal:
            attn *= (seq_len + 1) / (2 * seq_len)
        return 6 * n + attn


def pipe_name(name: str) -> str:
    """The pipelined model's name of ``LlamaForCausalLM`` parameter
    ``name`` (``model.layers.<i>.`` -> ``decoder.layers.<i>.``,
    ``model.embed_tokens`` -> ``embed_tokens``, ``model.norm.weight`` ->
    ``norm.weight``)."""
    if name.startswith("model.layers."):
        return "decoder." + name[len("model."):]
    return name[len("model."):] if name.startswith("model.") else name


class LlamaForCausalLMPipe(nn.Module):
    """Pipeline-parallel Llama (counterpart of JAX's
    ``LlamaForCausalLMPipe``; reference: PaddleNLP's model of that name
    on fleet's PipelineLayer and 1F1B runtime). The decoder is a
    ``parallel.pipeline.PipelineStack`` of ``num_stages`` stages (chunks
    of ``num_chunks`` for ``pp_schedule="interleaved"``) over
    ``num_microbatches`` microbatches; the embedding runs on stage 0,
    the final norm and the head on stage S - 1.

    Parameters: ``embed_tokens``, ``decoder.layers.<i>.<leaf>`` (one
    module a layer where JAX stacks ``decoder.stack__<leaf>``; see
    :meth:`load_jax_state_dict` / :meth:`jax_state_dict`),
    ``norm.weight`` and ``lm_head``, in the JAX layouts.

    Training: ``forward(input_ids, labels)`` gives the loss through
    autograd with every stage in this process (JAX differentiates its
    forward with ``jax.grad``); :meth:`loss_and_grads` is the fused
    step (1F1B for ``pp_schedule="1f1b"``, FThenB otherwise), which the
    Trainer takes for "1f1b" and on a ``pp`` mesh. Sharded by
    ``parallel.api.shard_layer`` over a mesh whose ``pp`` axis is
    ``num_stages``, each rank keeps its stage's parameters; activations
    and cotangents cross ranks by point-to-point exchange."""

    _mesh_plan = None
    _global_mean_loss = True

    def __init__(self, cfg: LlamaConfig, num_stages: int = 1,
                 num_microbatches: int = 1, pp_schedule: str = "gpipe",
                 num_chunks: int = 1, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        from ..parallel.pipeline import PipelineStack
        if pp_schedule not in PipelineStack.SCHEDULES:
            raise ValueError(f"pp_schedule must be one of "
                             f"{PipelineStack.SCHEDULES}, got {pp_schedule!r}")
        if cfg.weight_dtype != "native":
            raise ValueError("LlamaForCausalLMPipe trains: weight_dtype must "
                             "be 'native'")
        init = _Init(cfg, device, dtype, generator)
        self.cfg = cfg
        self.num_stages = num_stages
        self.num_microbatches = num_microbatches
        self.pp_schedule = pp_schedule
        self._dtype = init.dtype
        self.embed_tokens = init.weight(cfg.vocab_size, cfg.hidden_size)
        self.decoder = PipelineStack(
            lambda: LlamaDecoderLayer(cfg, init),
            num_layers=cfg.num_hidden_layers, num_stages=num_stages,
            num_microbatches=num_microbatches,
            remat=cfg.recompute == "full",
            schedule="interleaved" if pp_schedule == "interleaved"
            else "gpipe", num_chunks=num_chunks)
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                            device=init.device, dtype="float32")
        if not cfg.tie_word_embeddings:
            init.proj(self, "lm_head", cfg.hidden_size, cfg.vocab_size)
        else:
            self.lm_head = None
        cos, sin = rope_ops.rope_freqs(cfg.head_dim,
                                       cfg.max_position_embeddings,
                                       cfg.rope_theta, device=init.device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)
        self.register_buffer("rope_neg_sin", -sin, persistent=False)
        #: the last fused step's schedule counts (peak microbatches held
        #: per stage, ticks)
        self.pipe_stats: dict = {}

    # -- placement -------------------------------------------------------------

    @property
    def _sharding_annotations(self):
        return {pipe_name(k): v for k, v in sharding_annotations(
            self.cfg).items()}

    def param_stage(self, name: str) -> int:
        """The pipeline stage that holds parameter ``name`` (a tied
        embedding: stage 0, which counts it; stage S - 1 holds a copy)."""
        if name.startswith("decoder.layers."):
            return self.decoder.stage_of(int(name.split(".")[2]))
        return 0 if name == "embed_tokens" else self.num_stages - 1

    def full_shapes(self):
        """{name: (shape, dtype)} of every parameter of the whole model,
        in the order of its sharding table."""
        return {pipe_name(k): (shape, torch.float32 if kind == "norm"
                               else self._dtype)
                for k, (shape, kind) in parameter_shapes(self.cfg).items()}

    def _keep_stage(self, hm) -> None:
        """``shard_layer``'s hook on a ``pp`` mesh: keep this rank's
        stage and run the schedules over its pp neighbours."""
        from ..parallel.schedules import MeshRuntime
        S, s = hm.axis_size("pp"), hm.coordinate("pp")
        if S != self.num_stages:
            raise ValueError(f"the mesh's pp axis is {S}, the model has "
                             f"num_stages={self.num_stages}")
        self.decoder.keep_stage(s, MeshRuntime(s, hm.group_ranks("pp"),
                                               hm.group("pp")))
        tied = self.cfg.tie_word_embeddings
        if s != 0 and not (tied and s == S - 1):
            self.embed_tokens = None
        if s != S - 1:
            self.norm = None
            self.lm_head = None

    def _stages(self):
        """(holds stage 0, holds stage S - 1, pp mesh plan or None)."""
        rt = self.decoder.runtime
        plan = self._mesh_plan
        pp = plan if plan is not None and plan.pp_size > 1 else None
        return rt.local(0), rt.local(self.num_stages - 1), pp

    def _head_weight(self, dtype) -> torch.Tensor:
        w = (self.embed_tokens.t() if self.cfg.tie_word_embeddings
             else self.lm_head)
        return w.to(dtype)

    def _extras(self):
        return (self.rope_cos, self.rope_sin, None, None, None,
                self.rope_neg_sin)

    def _act(self, input_ids: torch.Tensor) -> torch.Tensor:
        """Stage 0's embedded input; elsewhere an empty tensor of its
        shape and dtype (the schedules read them only)."""
        if self.decoder.runtime.local(0):
            return vocab_embed(self._mesh_plan, self.embed_tokens, input_ids)
        b, s = input_ids.shape
        return torch.empty((b, s, self.cfg.hidden_size), dtype=self._dtype,
                           device=input_ids.device)

    # -- forward ---------------------------------------------------------------

    def forward(self, input_ids: torch.Tensor,
                labels: Optional[torch.Tensor] = None,
                return_logits: Optional[bool] = None):
        """input_ids [b, s] → logits [b, s, vocab]; with ``labels``
        (-100 = ignored) ``(loss, logits)``, or the loss alone when
        ``return_logits`` is False. The loss is the token mean over every
        microbatch (and data rank on a mesh). On a ``pp`` mesh this runs
        without a gradient (train through :meth:`loss_and_grads`); the
        last stage's result is broadcast over pp."""
        from ..distributed.communication import reduce_from_group
        _, last, pp = self._stages()
        plan = self._mesh_plan
        h = self.decoder(self._act(input_ids), *self._extras())
        loss = logits = None
        want_logits = labels is None or return_logits is not False
        if last:
            hidden = self.norm(h)
            w = self._head_weight(hidden.dtype)
            if labels is not None:
                nll = token_nll(plan, hidden, w, labels,
                                fused_loss_enabled(self.cfg))
                loss = nll.sum() / self._count(labels).clamp_min(1.0)
                if pp is None and plan is not None and plan.data_size > 1:
                    loss = reduce_from_group(loss, plan.data)
            if want_logits:
                logits = self._logits(hidden, w)
        if pp is not None:
            if labels is not None:
                loss = self._from_last(pp, loss, input_ids, False)
            if want_logits:
                logits = self._from_last(pp, logits, input_ids, True)
        if labels is None:
            return logits
        return loss if return_logits is False else (loss, logits)

    def _logits(self, hidden, w):
        from ..distributed.communication import (copy_to_group,
                                                 gather_from_group)
        tp = _tp_group(self._mesh_plan)
        if tp is None:
            return torch.matmul(hidden, w)
        return gather_from_group(torch.matmul(copy_to_group(hidden, tp), w),
                                 tp, dim=-1)

    def _count(self, labels: torch.Tensor) -> torch.Tensor:
        """The count of counted labels over every data rank (a 0-d fp32
        tensor on labels' device); on a mesh the loss's value is then
        summed over the data ranks in the forward only."""
        from ..distributed.communication import all_reduce
        cnt = (labels != -100).sum().float()
        plan = self._mesh_plan
        if plan is not None and plan.data_size > 1:
            all_reduce(cnt, group=plan.data)
        return cnt

    def _from_last(self, pp, out, input_ids, logits: bool):
        """Stage S - 1's loss (summed over the data ranks) or logits,
        broadcast over the pp group."""
        from ..distributed.communication import all_reduce, broadcast
        S = self.num_stages
        if logits:
            b, s = input_ids.shape
            buf = (out.contiguous() if out is not None else torch.empty(
                (b, s, self.cfg.vocab_size), dtype=self._dtype,
                device=input_ids.device))
        else:
            buf = (out.detach().float().reshape(()) if out is not None
                   else torch.zeros((), device=input_ids.device))
            if pp.data_size > 1 and out is not None:
                all_reduce(buf, group=pp.data)
        return broadcast(buf, src=S - 1, group=pp.pp)

    # -- the fused step ----------------------------------------------------------

    def loss_and_grads(self, input_ids: torch.Tensor, labels: torch.Tensor):
        """One fused forward+backward over the pipeline (JAX's
        ``loss_and_grads``; reference pipeline_parallel.py:440): 1F1B
        for ``pp_schedule="1f1b"`` (a stage holds at most 2S - 1
        microbatches), FThenB for "gpipe" and "interleaved". The
        embedding runs on stage 0, the final norm and the head (the
        fused vocab-CE head when ``fused_loss_enabled``) on stage S - 1,
        each microbatch's summed nll divided by the GLOBAL count of
        counted labels (every microbatch and, on a mesh, every data
        rank), so uneven padding gives the unpipelined token mean. With
        ``tie_word_embeddings`` on a pp mesh the embedding's gradient is
        summed between the first and the last stage.

        Gradients accumulate into ``.grad``. Returns (loss, grads): the
        loss as a detached 0-d tensor (on a pp mesh the last stage's,
        summed over the data ranks and broadcast over pp, so that every
        rank logs and judges the same value) and {name: gradient} of
        the parameters held here."""
        from ..parallel import schedules
        from ..parallel.pipeline import microbatch, unmicrobatch
        cfg = self.cfg
        M, S = self.num_microbatches, self.num_stages
        first, last, pp = self._stages()
        x = self._act(input_ids)
        x_mb = microbatch(x.detach(), M)
        t_mb = microbatch(labels, M)
        cnt = self._count(labels)
        fused = fused_loss_enabled(cfg)
        plan = self._mesh_plan

        def head(h, tgt):
            hidden = self.norm(h)
            nll = token_nll(plan, hidden, self._head_weight(hidden.dtype),
                            tgt, fused)
            return nll.sum(), None
        kw = dict(num_stages=S, remat=self.decoder.remat, return_dx=True,
                  weighted_loss=True, total_weight=cnt,
                  runtime=self.decoder.runtime, stats=self.pipe_stats)
        fn = self.decoder.stage_fn(*self._extras())
        if self.pp_schedule == "1f1b":
            loss, dx = schedules.pipeline_1f1b(fn, x_mb, t_mb, head, **kw)
        else:
            loss, dx = schedules.pipeline_fthenb(
                fn, x_mb, t_mb, head, num_chunks=self.decoder.num_chunks,
                **kw)
        if first:
            x.backward(unmicrobatch(dx).to(x.dtype))
        if pp is not None:
            if cfg.tie_word_embeddings and pp.tied is not None:
                from ..distributed.communication import all_reduce
                all_reduce(self.embed_tokens.grad, group=pp.tied)
            loss = self._from_last(pp, loss if last else None, input_ids,
                                   False)
        elif plan is not None and plan.data_size > 1:
            from ..distributed.communication import all_reduce
            loss = all_reduce(loss.detach().clone(), group=plan.data)
        grads = {n: p.grad for n, p in self.named_parameters()
                 if p.grad is not None}
        return loss.detach(), grads

    # -- weights ---------------------------------------------------------------

    @torch.no_grad()
    def load_from_unpipelined(self, model: "LlamaForCausalLM") -> None:
        """Copy a ``LlamaForCausalLM``'s weights into the parameters held
        here (JAX's Pipe-partition converter; reference:
        fleet/utils/pp_parallel_adaptor.py)."""
        own = dict(self.named_parameters())
        for name, p in model.named_parameters():
            mine = own.get(pipe_name(name))
            if mine is not None:
                mine.copy_(p)

    @torch.no_grad()
    def load_jax_state_dict(self, sd) -> None:
        """Load the JAX pipe model's state dict (``embed_tokens``,
        ``decoder.stack__<leaf>`` stacked ``[L, ...]`` or ``[V, S, k,
        ...]``, ``norm.weight``, ``lm_head``; numpy or tensors) into the
        parameters held here."""
        own = dict(self.named_parameters())
        for name in ("embed_tokens", "norm.weight", "lm_head"):
            if own.get(name) is not None and name in sd:
                own[name].copy_(torch.as_tensor(sd[name]).to(own[name].dtype))
        pre = "decoder."
        self.decoder.load_stacked({k[len(pre):]: v for k, v in sd.items()
                                   if k.startswith(pre + "stack__")})

    def jax_state_dict(self, grads: bool = False):
        """The parameters (or their gradients), every stage in this
        process, under the JAX pipe model's names and layouts."""
        out = {"decoder." + k: v for k, v in
               self.decoder.stacked_tree(grads=grads).items()}
        for name, p in self.named_parameters():
            if not name.startswith("decoder."):
                t = p.grad if grads else p
                out[name] = None if t is None else t.detach()
        return out

    # -- size accounting (MFU calculator input) ------------------------------

    def num_params(self) -> int:
        """The whole model's parameters, wherever its stages are."""
        return sum(math.prod(shape) for shape, _ in
                   parameter_shapes(self.cfg).values())

    def flops_per_token(self, seq_len: int, causal: bool = False) -> float:
        """As ``LlamaForCausalLM.flops_per_token``."""
        cfg = self.cfg
        n = self.num_params()
        if not cfg.tie_word_embeddings:
            n -= cfg.vocab_size * cfg.hidden_size
        attn = 12 * cfg.num_hidden_layers * cfg.hidden_size * seq_len
        if causal:
            attn *= (seq_len + 1) / (2 * seq_len)
        return 6 * n + attn


__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "LlamaForCausalLMPipe",
           "parameter_shapes", "causal_lm_loss", "fused_causal_lm_loss",
           "fused_loss_enabled"]
