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
``flops_per_token``, and the paged-KV serving trio
``alloc_paged_caches`` / ``prefill_paged`` / ``decode_step_paged``. The
page pools are updated IN PLACE (``index_put_``) where JAX returns new
arrays; the methods still return the pools so callers read the same.

Quantized serving (``cfg.weight_dtype="int8"``, ``cfg.kv_dtype="int8"``):
every projection and the untied ``lm_head`` is an int8 ``[n, k]`` weight
with an fp32 ``<name>_scale`` ``[n]`` and goes through the int8 matrix
product kernel (:func:`_proj`); int8 page pools carry one fp32 scale per
page and K/V side, and decode reads them through the int8 paged kernel.
Such a model serves only: ``forward(labels=...)`` raises.
"""

from __future__ import annotations

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
from ..ops.attention import paged_decode_attention, sdpa_plain
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
    ``llama3_8b(num_hidden_layers=2)``). Of the training fields,
    ``sequence_parallel`` is accepted but raises NotImplementedError
    where it would act, and ``sp_mode`` other than "ring" is refused:
    their machinery comes with the torch.distributed slice."""
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
        if self.sp_mode != "ring":
            raise NotImplementedError(
                f"sp_mode={self.sp_mode!r} selects a sequence-parallel "
                f"attention, which arrives with the torch.distributed slice")
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


class _Init:
    """Where, in what type and from which generator a model's parameters
    are drawn: one object threaded through every constructor. With
    ``draw=False`` float weights are left uninitialised (``torch.empty``)
    for a caller that loads a state dict next."""

    def __init__(self, cfg: LlamaConfig, device, dtype, generator,
                 draw: bool = True):
        self.device = resolve_device(device)
        self.dtype = dtype_of(dtype if dtype is not None else cfg.dtype)
        self.int8 = cfg.weight_dtype == "int8"
        self.draw = draw
        self.generator = (generator if generator is not None or not draw
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


def _proj(module: nn.Module, x: torch.Tensor, name: str) -> torch.Tensor:
    """The one weight product every Llama linear goes through, as in the
    JAX model: a native weight is a dense ``x @ w`` in x's dtype; an int8
    weight (it has a ``<name>_scale`` twin) goes through
    ``ops.quant.quantized_matmul`` — the int8 matrix product kernel on
    the card."""
    w = getattr(module, name)
    scale = getattr(module, name + "_scale", None)
    if scale is not None:
        return quantized_matmul(x, w, scale)
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
    (``ops.vocab_ce``), the dense path of ``paddle_tpu``'s function (the
    port has no tensor-parallel mesh)."""
    nll = fused_linear_cross_entropy(hidden, w, labels,
                                     ignore_index=ignore_index,
                                     reduction="none")
    return _token_mean(nll, labels, ignore_index)


def causal_lm_loss(logits: torch.Tensor, labels: torch.Tensor,
                   ignore_index: int = -100) -> torch.Tensor:
    """Token-weighted mean cross entropy of the causal-LM head over fp32
    logits (the dense path of ``paddle_tpu``'s ``causal_lm_loss``; the
    port has no tensor-parallel mesh)."""
    return ptF.cross_entropy(logits.float(), labels,
                             ignore_index=ignore_index)


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
        s = t.abs().amax(dim=(0, 2, 3)) / 127.0                  # [P]
        pool[:, phys] = _quantize(t, s[None, :, None, None])
        scale[phys] = s
    return kv


def _kv_scatter_tokens(kv: Pool, phys: torch.Tensor, off: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor) -> Pool:
    """Token-slot write (decode): ``phys``/``off`` [b] physical page and
    in-page offset per token; ``k_new``/``v_new`` [n_kv, b, hd]. In
    place. Int8 pools grow the touched pages' scales to cover the new
    token (a scatter-max, so several tokens landing in one page, as idle
    slots do on the garbage page, agree on its scale, as JAX's
    ``.at[].max`` does), requantize those pages onto the grown scale
    (a page whose scale did not change keeps its codes: the factor is
    exactly 1), then write the new codes."""
    if not _kv_quantized(kv):
        kp, vp = kv
        kp[:, phys, off] = k_new.to(kp.dtype)
        vp[:, phys, off] = v_new.to(vp.dtype)
        return kv
    kp, vp, ks, vs = kv
    for pool, scale, new in ((kp, ks, k_new), (vp, vs, v_new)):
        t = new.float()
        amax = t.abs().amax(dim=(0, -1))                         # [b]
        grown = torch.maximum(scale, torch.zeros_like(scale).scatter_reduce(
            0, phys, amax / 127.0, "amax"))
        s_w = grown[phys]                                        # [b]
        factor = torch.where(s_w > 0, scale[phys] / s_w.clamp_min(_KV_EPS),
                             0.0)
        pages = pool[:, phys].float()                # [n_kv, b, page, hd]
        pool[:, phys] = torch.round(
            pages * factor[None, :, None, None]).clamp_(-127, 127).to(
                torch.int8)
        pool[:, phys, off] = _quantize(t, s_w[None, :, None])
        scale.copy_(grown)
    return kv


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        self.cfg = cfg
        d, hd = cfg.hidden_size, cfg.head_dim
        n_h, n_kv = cfg.num_attention_heads, cfg.num_key_value_heads
        init.proj(self, "qkv_proj", d, (n_h + 2 * n_kv) * hd)
        init.proj(self, "o_proj", n_h * hd, d)

    def _qkv_rope(self, x, cos, sin, position_ids=None, neg_sin=None):
        """Fused QKV projection + head split + rotary embedding. q, k and
        v are views of the one projection output; the RoPE kernel reads
        q and k through their strides. ``neg_sin`` is the backward's
        table (the model's buffer)."""
        cfg = self.cfg
        b, s, _ = x.shape
        n_h, n_kv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                         cfg.head_dim)
        qkv = _proj(self, x, "qkv_proj")
        q, k, v = torch.split(qkv, [n_h * hd, n_kv * hd, n_kv * hd], dim=-1)
        q = q.view(b, s, n_h, hd)
        k = k.view(b, s, n_kv, hd)
        v = v.view(b, s, n_kv, hd)
        q, k = rope_ops.apply_rotary_pos_emb(q, k, cos, sin, position_ids,
                                             neg_sin)
        return q, k, v

    def _out(self, attn: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        b, s = attn.shape[:2]
        return _proj(self, attn.reshape(b, s, -1).to(x.dtype), "o_proj")

    def forward(self, x, cos, sin, position_ids=None, attn_mask=None,
                segment_ids=None, neg_sin=None):
        """Causal self-attention: the flash kernels (forward and
        backward) when ``cfg.use_flash_attention``, else ``sdpa_plain``,
        as the JAX model chooses between flash and ``_sdpa_xla``. A dense
        ``attn_mask`` (boolean or additive, broadcast to [b, h, s, s])
        takes ``sdpa_plain`` on either branch, as the JAX dispatch sends
        it to ``_sdpa_xla``."""
        q, k, v = self._qkv_rope(x, cos, sin, position_ids, neg_sin)
        if self.cfg.use_flash_attention:
            out = ptF.scaled_dot_product_attention(
                q, k, v, attn_mask=attn_mask, is_causal=True,
                training=self.training, segment_ids=segment_ids)
        else:
            out = sdpa_plain(q, k, v, causal=True, segment_ids=segment_ids,
                             attn_mask=attn_mask)
        return self._out(out, x)

    def prefill_paged(self, x, cos, sin, kv: Pool, tables: torch.Tensor):
        """Prompt pass writing K/V into head-major page pools
        [H_kv, num_pages, page_size, hd] through ``tables``
        [b, max_pages]; ``kv`` is the layer's pool entry, native or int8
        (:data:`Pool`). The prompt attends to its own float K/V; the pool
        gets them quantized. The prompt is padded up to a page multiple
        inside the pool; padded slots lie beyond seq_len and are
        overwritten by decode before anything attends to them."""
        cfg = self.cfg
        b, s, _ = x.shape
        n_kv, hd = cfg.num_key_value_heads, cfg.head_dim
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
        pages' scales when the pools are int8."""
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
        out = paged_decode_attention(q[:, 0].contiguous(), kv[0], kv[1],
                                     tables, pos, **scales)
        return self._out(out.reshape(b, 1, -1), x), kv


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig, init: _Init):
        super().__init__()
        d, m = cfg.hidden_size, cfg.intermediate_size
        init.proj(self, "gate_up_proj", d, 2 * m)
        init.proj(self, "down_proj", m, d)

    def forward(self, x):
        g, u = _proj(self, x, "gate_up_proj").chunk(2, dim=-1)
        return _proj(self, F.silu(g) * u, "down_proj")


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
        model wraps it in ``jax.checkpoint``."""
        cfg = self.cfg
        if cfg.sequence_parallel:
            raise NotImplementedError(
                "sequence_parallel needs a 'sep' device mesh, which "
                "arrives with the torch.distributed slice")
        remat = cfg.recompute != "none" and torch.is_grad_enabled()
        policy = ("dots_with_no_batch_dims_saveable"
                  if cfg.recompute == "selective" else "full")
        x = F.embedding(input_ids, self.embed_tokens)
        for layer in self.layers:
            args = (x, self.rope_cos, self.rope_sin, position_ids,
                    attn_mask, segment_ids, self.rope_neg_sin)
            x = (run_recomputed(layer, *args, policy=policy) if remat
                 else layer(*args))
        return self.norm(x)

    # -- paged-KV (vLLM-style) inference paths ------------------------------

    def alloc_paged_caches(self, batch: int, max_len: int,
                           page_size: int = 128
                           ) -> Tuple[List[Pool], torch.Tensor]:
        """Per-layer head-major page pools (zeros) + a block table that
        gives each sequence its pages contiguously. ``cfg.kv_dtype="int8"``
        pools are 4-tuples: int8 pages and one fp32 scale per page and
        K/V side, starting at 0 (a page that holds nothing, read as the
        zeros a native pool starts with)."""
        cfg = self.cfg
        pages_per_seq = -(-max_len // page_size)
        num_pages = batch * pages_per_seq
        shape = (cfg.num_key_value_heads, num_pages, page_size,
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

    def prefill_paged(self, input_ids, pools: List[Pool], tables):
        x = F.embedding(input_ids, self.embed_tokens)
        for layer, kv in zip(self.layers, pools):
            a, _ = layer.self_attn.prefill_paged(
                layer.input_layernorm(x), self.rope_cos, self.rope_sin, kv,
                tables)
            h = x + a
            x = h + layer.mlp(layer.post_attention_layernorm(h))
        return self.norm(x), pools

    def decode_step_paged(self, token_ids, pos, pools: List[Pool], tables):
        """token_ids [b], pos [b] int64 → (hidden [b, 1, d], pools)."""
        x = F.embedding(token_ids[:, None], self.embed_tokens)
        for layer, kv in zip(self.layers, pools):
            a, _ = layer.self_attn.decode_paged(
                layer.input_layernorm(x), self.rope_cos, self.rope_sin, pos,
                kv, tables)
            h = x + a
            x = h + layer.mlp(layer.post_attention_layernorm(h))
        return self.norm(x), pools


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

    def logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """Vocabulary projection: the tied embedding's dense product, or
        the ``lm_head`` through :func:`_proj` (int8 in a quantized
        model)."""
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
        if fused_loss_enabled(self.cfg):
            w = (self.model.embed_tokens.t() if self.cfg.tie_word_embeddings
                 else self.lm_head)
            loss = fused_causal_lm_loss(hidden, w.to(hidden.dtype), labels)
        else:
            logits = self.logits(hidden)
            loss = causal_lm_loss(logits, labels)
        if return_logits is False:
            return loss
        return loss, (logits if logits is not None else self.logits(hidden))

    # -- size accounting (MFU calculator input) ------------------------------

    def num_params(self) -> int:
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


__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "parameter_shapes",
           "causal_lm_loss", "fused_causal_lm_loss", "fused_loss_enabled"]
