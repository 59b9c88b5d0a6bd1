"""The planner's census child: ``python -m
paddle_tpu_torch.distributed.auto_parallel._price`` reads one JSON
request on stdin (``{"model": {"kind", "fields"}, "n", "configs",
"global_batch", "seq_len"}``) and prints one ``CENSUS {json}`` line a
config.

It joins a fake world of ``n`` ranks as rank 0
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once and move no data), builds each config's model on the ``meta``
device (shapes, no storage: Llama-3-8B at 32 layers allocates nothing),
shards it as ``ShardingPlan.apply`` does, and dispatches one training
step of the port's ``Trainer`` under ``analysis.collectives.StepCensus``.
FSDP2 runs on meta too: this process gives it the CPU's stream and
event handles for the meta device (:func:`_fsdp_on_meta`), so its
per-unit all-gathers and reduce-scatters are counted at their real
sizes. A pipeline config also takes the census of the rank holding the
last stage (the head and the loss), which the planner prices as the
slower stage (``planner.price_compiled``). A MoE config runs at a
capacity factor of 1 (balanced routing: the dropless and ep paths read
routing counts on the host, which a fake world cannot give).
"""

from __future__ import annotations

import dataclasses
import json
import sys


def _model_cfg(payload):
    from ...models.llama import LlamaConfig
    from ...models.moe_lm import MoEConfig
    cls = MoEConfig if payload["kind"] == "moe" else LlamaConfig
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in payload["fields"].items() if k in names})


def census_one(model_cfg, config, global_batch: int, seq_len: int):
    """One config's census record in this (fake) world."""
    import torch
    from ...analysis.collectives import StepCensus, collective_census
    from ...models.llama import LlamaForCausalLM, LlamaForCausalLMPipe
    from ...models.moe_lm import MoEForCausalLM
    from ...optimizer import AdamW
    from ...trainer import Trainer
    from .emit import emit_plan, mesh_axes
    is_moe = bool(getattr(model_cfg, "num_experts", 0))
    mcfg = dataclasses.replace(model_cfg, sequence_parallel=config.sep > 1)
    if is_moe:
        mcfg = dataclasses.replace(mcfg, capacity_factor=1.0)
    device = "meta"
    if config.pp > 1:
        model = LlamaForCausalLMPipe(mcfg, num_stages=config.pp,
                                     num_microbatches=2, device=device)
    elif is_moe:
        model = MoEForCausalLM(mcfg, device=device)
    else:
        model = LlamaForCausalLM(mcfg, device=device)
    plan = emit_plan(model, mesh_axes(config), config)
    flops_per_token = float(model.flops_per_token(seq_len))
    hm = plan.apply(model, devices="cpu")
    with hm:
        tr = Trainer(model, AdamW(learning_rate=1e-3, parameters=model))
        ids = torch.zeros((global_batch, seq_len), dtype=torch.long,
                          device=device)
        with StepCensus() as c:
            tr._one_step({"input_ids": ids, "labels": ids})
    coll = collective_census(c, hm)
    agg = {}
    for o in c.ops:
        k = (o.name, o.flops, o.bytes, o.kernel)
        agg[k] = agg.get(k, 0) + 1
    rec = {"config": str(config),
           "ops": [[n, f, b, k, cnt] for (n, f, b, k), cnt in agg.items()],
           "dots": [[*key, cnt] for key, cnt in c.dots.items()],
           "collectives": [{"opcode": x.opcode, "bytes": x.bytes,
                            "ranks": list(x.ranks), "axis": x.axis,
                            "op_name": x.op_name} for x in coll["table"]],
           "flops_per_token": flops_per_token, "plan": plan.as_dict()}
    if config.pp > 1:
        rec["pipeline"] = {"stages": config.pp,
                           "microbatches": model.num_microbatches}
    return rec


def _fsdp_on_meta() -> None:
    """Let FSDP2 shard and step a model on the meta device. It refuses
    meta parameters before its first forward, takes its device from the
    mesh (the CPU here) and its streams and events from that device's
    module, which meta lacks. The census never reads a value, so this
    process lifts the check, puts FSDP2 on meta and hands it the CPU's
    stream and event handles (no-ops)."""
    import torch
    from torch.distributed.fsdp._fully_shard import (
        _fsdp_collectives, _fsdp_param_group, _fsdp_state, _fully_shard)
    _fsdp_param_group.FSDPParamGroup._validate_no_meta_params = \
        lambda self: None
    _fully_shard._get_device_from_mesh = lambda mesh: torch.device("meta")
    for m in (_fsdp_collectives, _fsdp_param_group, _fsdp_state):
        m._get_device_handle = (lambda t, _o=m._get_device_handle:
                                torch.cpu if t == "meta" else _o(t))


def _join(rank: int, n: int) -> None:
    """Join a fake world of ``n`` ranks as ``rank`` (leaving the last)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    # the fake backend for meta tensors too (point-to-point ops pick
    # their backend by the tensor's device)
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(),
                            rank=rank, world_size=n)


def main() -> int:
    import torch.distributed as dist
    from .planner import ParallelConfig
    req = json.loads(sys.stdin.read())
    _fsdp_on_meta()
    n = int(req["n"])
    mcfg = _model_cfg(req["model"])
    args = (int(req["global_batch"]), int(req["seq_len"]))
    _join(0, n)
    for text in req["configs"]:
        config = ParallelConfig.parse(text)
        try:
            rec = census_one(mcfg, config, *args)
            if config.pp > 1:
                # the pp axis is the mesh's outermost: the last stage's
                # first rank
                _join((config.pp - 1) * (n // config.pp), n)
                try:
                    last = census_one(mcfg, config, *args)
                finally:
                    _join(0, n)
                rec["pipeline"]["last_stage"] = {
                    "ops": last["ops"], "collectives": last["collectives"],
                    "dots": last["dots"]}
        except Exception as e:  # noqa: BLE001 — reported per config
            rec = {"config": str(config),
                   "error": f"{type(e).__name__}: {str(e)[:400]}"}
        print("CENSUS " + json.dumps(rec), flush=True)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
