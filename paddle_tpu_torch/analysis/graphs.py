"""Canonical-graph registry: the calls whose shape the graph contracts
pin (counterpart of ``paddle_tpu/analysis/graphs.py``, under its eleven
names).

Each builder runs the port's REAL entry at a micro size — the
``Trainer``'s step and superstep, the serving engine's decode block,
speculative tick and prefix-hit admit, the fused CE head, the
vocab-parallel head, and the steps emitted through the sharding
planner's plans — once to warm it, then once more under a
:class:`~paddle_tpu_torch.analysis.collectives.StepCensus` that names
the call's inputs, and returns that census with its contract. Builders
reach into the same internals the runtime dispatches through
(``Trainer._dispatch``, ``ContinuousBatchingEngine._decode_block``...),
so a refactor that changes what those paths run changes exactly what
the lint sees.

The micro Llama is the calibration probe's: 2 layers, vocabulary 320,
hidden 128 over 4 heads (JAX's is 64; its head dim of 16 is not one the
flash kernels take, so the same builders run on the card with the
kernels), batch 2 x 20. V = 320 and B*S = 40 collide with no other
buffer's dims, so the logits ban is unambiguous.

Where a graph ends (JAX's boundary is its compiled function):

* ``serving_tick`` / ``_quant`` / ``_spec`` end where the device work
  ends: ``_decode_block`` / ``_spec_tick`` return device tokens and
  masks. The engine's emission after a block (``_start_drain``'s copy of
  them to host buffers, read at ``_reconcile_one``) is outside, as it is
  outside JAX's jitted tick: the host read happens there, once a block.
* ``prefix_admit`` is ``_tail_logits``: the page copy and the one-token
  re-forward, with its host arrays uploaded through ``_to_device``
  (host->card, no sync); the admission bookkeeping is outside.
* ``train_step_moe_ep`` routes at capacity 1.0, the planner census's
  routing: the dropless ep exchange reads its split sizes on the host
  once a MoE layer (``parallel/moe.py`` ``_forward_dropless_ep``), which
  JAX's static-buffer exchange does not (ROADMAP D18, held by
  ``tests/test_torch_graph_contracts_mesh.py``).

The four sharded graphs need a live world of 4 ranks (gloo on the CPU,
NCCL on the cards) and raise :class:`GraphSkipped` below that, as JAX's
raise below 4 devices. ``device`` is the card unless ``"cpu"``.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch

from .collectives import StepCensus
from .contracts import BanRule, GraphContract

__all__ = ["BuiltGraph", "GraphSkipped", "REGISTRY", "SHARDED",
           "build_graph", "graph_names", "MICRO", "MICRO_BATCH"]

#: the micro training step: (batch, sequence), config
MICRO_BATCH = (2, 20)
MICRO = dict(vocab_size=320, hidden_size=128, intermediate_size=192,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128)
_B, _S = MICRO_BATCH
_VOCAB = MICRO["vocab_size"]
#: the graphs that need 4 ranks
SHARDED = ("tp_fused_ce", "planner", "train_step_fsdp", "train_step_moe_ep")


class GraphSkipped(Exception):
    """Raised by a builder whose environment can't host the graph (the
    sharded graphs outside a world of 4 ranks)."""


@dataclass
class BuiltGraph:
    name: str
    census: StepCensus
    contract: GraphContract
    mesh: Optional[object] = None
    #: runs the call once more (the calibration probe times it; the chip
    #: run repeats it under the card's sync-debug mode)
    call: Optional[Callable[[], object]] = None
    #: what the censused call returned and left in its named inputs, as
    #: CPU copies (``out[i]``, then the labels): the card's run is held
    #: against the CPU's, whose inputs are drawn from the same seeds
    outputs: Optional[Dict[str, torch.Tensor]] = None


def _device(device):
    from ..device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _within(modes, fn):
    """``fn()`` inside a context made by each of ``modes``."""
    with contextlib.ExitStack() as st:
        for m in modes:
            st.enter_context(m())
        return fn()


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _census(dev, call, inputs, modes=()):
    """Warm ``call`` once, then take its census naming ``inputs``; each
    of ``modes`` makes a context both passes run in. Returns the census
    and the censused pass's outputs (:attr:`BuiltGraph.outputs`)."""
    _within(modes, call)
    _sync(dev)
    c = StepCensus(inputs=inputs)
    ret = _within(modes + (lambda: c,), call)
    named = (inputs() if callable(inputs) else inputs) or {}
    with torch.no_grad():
        outs = {f"out[{i}]": t.detach().cpu().clone()
                for i, t in enumerate(_leaves(ret))}
        outs.update({k: t.detach().cpu().clone() for k, t in named.items()})
    return c, outs


def _micro_cfg(**kw):
    from ..models.llama import LlamaConfig
    return LlamaConfig(**{**MICRO, **kw})


def _micro_model(dev, **kw):
    """The micro Llama, drawn on the CPU from seed 0 and moved to
    ``dev``: the same weights on the card as on the CPU."""
    from ..device import generator
    from ..models.llama import LlamaForCausalLM
    return LlamaForCausalLM(_micro_cfg(**kw), device="cpu",
                            generator=generator(0, "cpu")).to(dev)


def _batch(dev, b=_B, s=_S, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, _VOCAB, (b, s + 1), generator=g).to(dev)
    return {"input_ids": ids[:, :-1].contiguous(),
            "labels": ids[:, 1:].contiguous()}


def trainer_inputs(tr) -> Dict[str, torch.Tensor]:
    """A trainer's state by JAX's labels: ``params['...']`` and
    ``opt_state['master' | 'slots'][...]``."""
    out = {f"params['{k}']": p for k, p in tr.params.items()}
    st = tr.optimizer._state
    if st is not None:
        for k, t in st["master"].items():
            out[f"opt_state['master']['{k}']"] = t
        for k, slots in st["slots"].items():
            for sk, t in slots.items():
                out[f"opt_state['slots']['{k}']['{sk}']"] = t
    return out


def _trainer(dev, donate=True):
    from ..optimizer import AdamW
    from ..trainer import Trainer
    model = _micro_model(dev)
    return Trainer(model, AdamW(learning_rate=1e-4, parameters=model),
                   donate=donate)


_TRAIN_CONTRACT_KW = dict(
    # no [B, S, V] / [B*S, V] logits buffer, any dtype
    ban_rules=(BanRule(_VOCAB, _B * _S, label="BSV-logits"),),
    require_aliased=("params", "opt_state"),
    max_host_transfers=0,
)


def build_train_step_k1(device=None, donate=True) -> BuiltGraph:
    """One ``Trainer`` step: fused-CE loss + grads + AdamW update, the
    parameters and optimizer state updated in place. ``donate=False``
    runs the step as ``fit`` does under ``AnomalyGuard(policy="skip")``:
    after the pre-step clone of the whole state that undoes a poisoned
    update, the second copy an undonated step keeps."""
    dev = _device(device)
    tr = _trainer(dev, donate)
    batch = _batch(dev)

    def call():
        prev = None if donate else tr._snapshot_state()
        loss = tr.train_step(batch)
        del prev
        return loss
    c, outs = _census(dev, call, lambda: trainer_inputs(tr))
    return BuiltGraph("train_step_k1", c, GraphContract(
        "train_step_k1", notes="per-step trainer dispatch",
        **_TRAIN_CONTRACT_KW), call=call, outputs=outs)


def build_train_step_k4(device=None) -> BuiltGraph:
    """The superstep: K=4 steps in one dispatch, no host read between
    them (JAX: one lax.scan dispatch)."""
    dev = _device(device)
    tr = _trainer(dev)
    batches = [_batch(dev, seed=i) for i in range(4)]

    def call():
        return tr._dispatch(batches)
    c, outs = _census(dev, call, lambda: trainer_inputs(tr))
    return BuiltGraph("train_step_k4", c, GraphContract(
        "train_step_k4", notes="K=4 superstep dispatch",
        **_TRAIN_CONTRACT_KW), call=call, outputs=outs)


def engine_inputs(eng) -> Dict[str, torch.Tensor]:
    """An engine's threaded state by label: ``pools[i][j]``, the
    scheduler ``state[...]`` and, with speculation, ``hist``."""
    out = {f"pools[{i}][{j}]": t for i, entry in enumerate(eng.pools)
           for j, t in enumerate(entry)}
    out.update({f"state['{k}']": t for k, t in eng._state.items()})
    if eng.spec_k:
        out["hist"] = eng._hist
    return out


def _engine(dev, model=None, **kw):
    from ..inference.serving import ContinuousBatchingEngine
    model = model if model is not None else _micro_model(dev)
    eng = ContinuousBatchingEngine(model, max_batch=2, page_size=8,
                                   max_len=64, **kw)
    with torch.inference_mode():
        eng._init_state(torch.zeros((_VOCAB,), device=dev))
        eng._tables_dev = eng._to_device(eng.tables)
    return eng


def _paged_modes():
    """The engine's verbs' mode and the paged decode route."""
    from ..ops.attention import force_decode_impl
    return (torch.inference_mode, lambda: force_decode_impl("paged"))


def _tick_graph(name, eng, contract, call):
    modes = _paged_modes()
    c, outs = _census(eng.device, call, lambda: engine_inputs(eng), modes)
    return BuiltGraph(name, c, contract,
                      call=lambda: _within(modes, call), outputs=outs)


def build_serving_tick(device=None) -> BuiltGraph:
    """The non-speculative decode block (K=4, paged): pools updated in
    place, stop detection on the device, no host sync."""
    eng = _engine(_device(device))
    return _tick_graph("serving_tick", eng, GraphContract(
        "serving_tick", require_aliased=("pools",), max_host_transfers=0,
        notes="decode_block=4 paged, spec off"),
        lambda: eng._decode_block(4, False))


def build_serving_tick_quant(device=None) -> BuiltGraph:
    """The quantized decode block: int8 weights + int8 KV pages. No
    widened pool-shaped fp32/bf16 buffer may exist: the dequant stays in
    the attention read. num_pages is not max_batch x pages_per_seq, so
    the pool's dims collide with no gathered working set."""
    from ..quantization import quantize_model
    dev = _device(device)
    eng = _engine(dev, quantize_model(_micro_model(dev), kv_dtype="int8"),
                  num_pages=24)
    hkv, npages, ps, hd = eng.pools[0][0].shape
    return _tick_graph("serving_tick_quant", eng, GraphContract(
        "serving_tick_quant", require_aliased=("pools",),
        max_host_transfers=0,
        ban_rules=(BanRule(hd, hkv * npages * ps, label="f32-pool",
                           dtype="f32"),
                   BanRule(hd, hkv * npages * ps, label="bf16-pool",
                           dtype="bf16")),
        notes="decode_block=4 paged, int8 weights + int8 KV"),
        lambda: eng._decode_block(4, False))


def build_serving_tick_spec(device=None) -> BuiltGraph:
    """The speculative tick (draft + (k+1)-wide verify + commit): pools
    AND the [B, max_len] history updated in place."""
    eng = _engine(_device(device), spec_k=3)
    return _tick_graph("serving_tick_spec", eng, GraphContract(
        "serving_tick_spec", require_aliased=("pools", "hist"),
        max_host_transfers=0, notes="spec_k=3 draft+verify tick"),
        lambda: eng._spec_tick(False))


def build_prefix_admit(device=None) -> BuiltGraph:
    """The full-prompt hit's admit: the boundary page's copy and the
    one-token re-forward, pools updated in place."""
    eng = _engine(_device(device))
    return _tick_graph("prefix_admit", eng, GraphContract(
        "prefix_admit", require_aliased=("pools",), max_host_transfers=0,
        notes="prefix-hit page copy + 1-token re-forward"),
        lambda: eng._tail_logits(0, 1, 1, 1, 2))


def build_fused_ce(device=None) -> BuiltGraph:
    """The fused vocab-CE head, forward and backward, standalone: the
    op-level version of the train-step ban (no [N, V] block)."""
    from ..ops.vocab_ce import fused_linear_cross_entropy
    dev = _device(device)
    N, H = 64, 32
    g = torch.Generator().manual_seed(0)
    h = torch.randn((N, H), generator=g).to(dev).requires_grad_()
    w = (torch.randn((H, _VOCAB), generator=g) * 0.1).to(dev) \
        .requires_grad_()
    lab = torch.randint(0, _VOCAB, (N,), generator=g).to(dev)

    def call():
        loss = fused_linear_cross_entropy(h, w, lab)
        return torch.autograd.grad(loss, (h, w))
    c, outs = _census(dev, call, {"h": h, "w": w})
    return BuiltGraph("fused_ce", c, GraphContract(
        "fused_ce", ban_rules=(BanRule(_VOCAB, N, label="NV-logits"),),
        max_host_transfers=0, notes="lse_and_target fwd+bwd"), call=call,
        outputs=outs)


# -- the sharded graphs (4 ranks) ----------------------------------------------

def _world4():
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() != 4:
        raise GraphSkipped("needs a world of 4 ranks (python -m "
                           "paddle_tpu_torch.distributed.launch "
                           "--nproc_per_node 4 ...)")


def _mesh_device(dev) -> str:
    return "cuda" if dev.type == "cuda" else "cpu"


def build_tp_fused_ce(device=None, extra_all_reduce=False) -> BuiltGraph:
    """The vocab-parallel fused CE head on a dp=2 x tp=2 mesh, forward:
    exactly one max and two sum all-reduces over tp (global LSE and
    target logit) and no gather of the vocabulary. ``extra_all_reduce``
    plants one more tp sum (the contract must fail)."""
    _world4()
    from ..distributed.communication import Group, all_reduce
    from ..parallel.mesh import HybridMesh
    from ..parallel.mp_layers import parallel_fused_linear_cross_entropy
    dev = _device(device)
    hm = HybridMesh.build(dp=2, tp=2, devices=_mesh_device(dev))
    B, S, H = 2, 16, MICRO["hidden_size"]
    g = torch.Generator().manual_seed(0)
    h = torch.randn((B, S, H), generator=g)
    w = torch.randn((H, _VOCAB), generator=g) * 0.1
    lab = torch.randint(0, _VOCAB, (B, S), generator=g)
    dpr, tpr = hm.coordinate("dp"), hm.coordinate("tp")
    h_l = h.chunk(2, 0)[dpr].contiguous().to(dev)
    lab_l = lab.chunk(2, 0)[dpr].contiguous().to(dev)
    w_l = w.chunk(2, 1)[tpr].contiguous().to(dev)

    def call():
        with torch.no_grad():
            nll = parallel_fused_linear_cross_entropy(h_l, w_l, lab_l,
                                                      mesh=hm)
            if extra_all_reduce:
                all_reduce(nll, group=Group("tp", hm))
            return nll
    with hm:
        c, outs = _census(dev, call, {"h": h_l, "w": w_l})
    return BuiltGraph("tp_fused_ce", c, GraphContract(
        "tp_fused_ce",
        ban_rules=(BanRule(_VOCAB, B * S, label="global-logits"),),
        max_host_transfers=0, expect_collectives={"all-reduce[tp]": 3},
        notes="dp2xtp2 vocab-parallel fused CE: 1 max + 2 sum "
              "all-reduces over tp, no gather"), mesh=hm, call=call,
        outputs=outs)


def _priced(model_cfg, config, dev):
    """The planner's price of ``config`` (rank 0 takes the census in its
    child and prices; every rank gets the plan and the census counts)."""
    import torch.distributed as dist
    from ..distributed.auto_parallel import ParallelConfig, price_config
    cfg = ParallelConfig.parse(config) if isinstance(config, str) else config
    box = [None]
    if dist.get_rank() == 0:
        p = price_config(cfg, model_cfg, global_batch=4, seq_len=32,
                         check_memory=False)
        box[0] = (p.plan.as_dict(), dict(p.graph.census_counts),
                  str(p.config))
    dist.broadcast_object_list(box, src=0, device=(
        dev if dev.type == "cuda" else None))
    return box[0]


def _planned_step(name, model_cfg, config, dev, moe=False, plan=None):
    """The step emitted THROUGH the plan the planner priced for
    ``config`` (``Trainer.apply_plan``), its census against the priced
    census (closed set). ``plan`` (a ``ShardingPlan``) applies another
    plan than the priced one: a drifted emission."""
    from ..device import generator
    from ..distributed.auto_parallel.emit import ShardingPlan
    from ..models.llama import LlamaForCausalLM
    from ..models.moe_lm import MoEForCausalLM
    from ..optimizer import AdamW
    from ..trainer import Trainer
    plan_d, counts, cfg_s = _priced(model_cfg, config, dev)
    emitted = plan if plan is not None else ShardingPlan.from_dict(plan_d)
    model = (MoEForCausalLM if moe else LlamaForCausalLM)(
        model_cfg, device=dev, generator=generator(0, dev))
    tr = Trainer(model, AdamW(learning_rate=1e-3, parameters=model),
                 donate=False)
    hm = tr.apply_plan(emitted, devices=_mesh_device(dev))
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, model_cfg.vocab_size, (4, 33), generator=g)
    batch = {"input_ids": ids[:, :-1].contiguous().to(dev),
             "labels": ids[:, 1:].contiguous().to(dev)}

    def call():
        return tr.train_step(batch)
    with hm:
        c, outs = _census(dev, call, lambda: trainer_inputs(tr))
    return BuiltGraph(name, c, GraphContract(
        name, expect_collectives=counts, max_host_transfers=0,
        notes=f"emitted {cfg_s} plan == priced census (closed set)"),
        mesh=hm, call=call, outputs=outs)


def build_planner(device=None, drift_to: Optional[str] = None
                  ) -> BuiltGraph:
    """The sharding planner's emit/price contract: price the dp2 x tp2
    micro config, run the step THROUGH the emitted plan and require its
    collective census to equal the priced one. ``drift_to`` (a config,
    e.g. "dp4_tp1_pp1_sep1") emits that config's plan instead while the
    contract keeps the priced census: the drift must fail it."""
    _world4()
    from ..distributed.auto_parallel import ParallelConfig
    from ..distributed.auto_parallel.emit import plan_for_config
    dev = _device(device)
    cfg = _micro_cfg()
    plan = None
    if drift_to is not None:
        plan = plan_for_config(cfg, ParallelConfig.parse(drift_to))
    return _planned_step("planner", cfg, ParallelConfig(dp=2, tp=2), dev,
                         plan=plan)


def build_train_step_fsdp(device=None) -> BuiltGraph:
    """The ZeRO-3 step: the fsdp2 x tp2 micro config through its emitted
    plan (FSDP2's parameter gathers and gradient reduce-scatters are in
    the priced census, so dropping the sharding or doubling the gathers
    fails it)."""
    _world4()
    from ..distributed.auto_parallel import ParallelConfig
    return _planned_step("train_step_fsdp", _micro_cfg(),
                         ParallelConfig(fsdp=2, tp=2), _device(device))


def moe_micro_cfg(capacity_factor: Optional[float] = 1.0):
    from ..models.moe_lm import MoEConfig
    return MoEConfig(vocab_size=_VOCAB, hidden_size=MICRO["hidden_size"],
                     intermediate_size=192, moe_intermediate_size=96,
                     num_hidden_layers=2, num_attention_heads=4,
                     num_key_value_heads=2, num_experts=4,
                     num_experts_per_tok=2, num_shared_experts=1,
                     first_k_dense_replace=1,
                     capacity_factor=capacity_factor,
                     max_position_embeddings=128)


def build_train_step_moe_ep(device=None) -> BuiltGraph:
    """The expert-parallel MoE step: the dp4 x ep2 micro config (JAX's
    is dp2 x ep2 on its 2 devices; here the 4 ranks of the other sharded
    graphs, ep 2 inside dp 4) through its emitted plan, the census's
    all-to-all[ep] rows equal to the priced ones. Capacity routing at
    1.0, the planner census's routing (see the module docstring)."""
    _world4()
    from ..distributed.auto_parallel import ParallelConfig
    return _planned_step("train_step_moe_ep", moe_micro_cfg(),
                         ParallelConfig(dp=4, ep=2), _device(device),
                         moe=True)


REGISTRY: Dict[str, Callable[..., BuiltGraph]] = {
    "train_step_k1": build_train_step_k1,
    "train_step_k4": build_train_step_k4,
    "serving_tick": build_serving_tick,
    "serving_tick_quant": build_serving_tick_quant,
    "serving_tick_spec": build_serving_tick_spec,
    "prefix_admit": build_prefix_admit,
    "fused_ce": build_fused_ce,
    "tp_fused_ce": build_tp_fused_ce,
    "planner": build_planner,
    "train_step_fsdp": build_train_step_fsdp,
    "train_step_moe_ep": build_train_step_moe_ep,
}


def graph_names() -> List[str]:
    return list(REGISTRY)


def build_graph(name: str, device=None) -> BuiltGraph:
    return REGISTRY[name](device)
