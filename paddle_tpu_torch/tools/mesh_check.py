"""SPMD training over several ranks held to one rank's unsharded step.

Run one process a card under torchrun (NCCL)::

    torchrun --standalone --nproc_per_node=N -m \\
        paddle_tpu_torch.tools.mesh_check

(``--device cpu`` runs the ranks under gloo). Every rank:

1. takes one training step of a Llama (the "small" preset: 2 layers at
   hidden 512, 8 / 4 heads, d 64, vocabulary 4096; 4 layers for the
   pipeline layouts; :func:`run` also takes "tiny", the test model) or
   of an MoE LM (the "small" preset: the same attention, 8 experts of
   width 512, top 2, one shared expert, the first layer dense) in fp32
   on one global batch of 4 sequences of 256 tokens with uneven ignored
   labels, alone and unsharded, on its own device: the reference;
2. for each layout of ``--layouts`` (mesh degrees, an fsdp level, the
   sequence-parallel mode, the pipeline schedule, the MoE routing),
   shards the same weights over the mesh and takes the same step
   through ``Trainer`` (SGD with a global-norm clip that acts, so a
   wrong gradient scale or norm shows). A pipeline layout trains
   ``LlamaForCausalLMPipe`` (2 microbatches a data rank) loaded from
   the reference's weights (``load_from_unpipelined``); an ep layout
   the MoE LM with its experts split over ep (capacity routing at a
   capacity factor of 4, at which no token is dropped on either side);
3. gathers the parameters whole (``parallel.api.full_state_dict``).

Rank 0 prints one JSON line a layout: the loss, the reference's, the
largest relative L2 distance of a parameter's update from the
reference's (:func:`update_errors`), and whether both lie within
:data:`TOL`. The exit code is 1 when a layout does not.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

# the same fp32 step split over ranks: summation orders differ, nothing
# else (update_errors)
TOL = 1e-4
BATCH = 4

# name: (mesh degrees, group_sharded_parallel level or None, config
# keywords[, model: "pipe:<schedule>" or "moe"; a Llama otherwise])
LAYOUTS = {
    "dp4": ({"dp": 4}, None, {}),
    "tp4": ({"tp": 4}, None, {}),
    "dp2tp2": ({"dp": 2, "tp": 2}, None, {}),
    "fsdp4": ({"fsdp": 4}, "p_g_os", {}),
    "fsdp4_os_g": ({"fsdp": 4}, "os_g", {}),
    "fsdp2tp2": ({"fsdp": 2, "tp": 2}, "p_g_os", {}),
    "sep4_ring": ({"sep": 4}, None, {"sequence_parallel": True}),
    "dp2sep2_ulysses": ({"dp": 2, "sep": 2}, None,
                        {"sequence_parallel": True, "sp_mode": "ulysses"}),
    "sep2tp2_ring": ({"sep": 2, "tp": 2}, None, {"sequence_parallel": True}),
    "pp4_1f1b": ({"pp": 4}, None, {"num_hidden_layers": 4}, "pipe:1f1b"),
    "pp2dp2_1f1b": ({"pp": 2, "dp": 2}, None, {"num_hidden_layers": 4},
                    "pipe:1f1b"),
    "pp2tp2_1f1b": ({"pp": 2, "tp": 2}, None, {"num_hidden_layers": 4},
                    "pipe:1f1b"),
    "pp4_gpipe": ({"pp": 4}, None, {"num_hidden_layers": 4}, "pipe:gpipe"),
    "pp2dp2_gpipe": ({"pp": 2, "dp": 2}, None, {"num_hidden_layers": 4},
                     "pipe:gpipe"),
    "pp2tp2_gpipe": ({"pp": 2, "tp": 2}, None, {"num_hidden_layers": 4},
                     "pipe:gpipe"),
    "ep4_dropless": ({"dp": 4, "ep": 4}, None, {"capacity_factor": None},
                     "moe"),
    "ep2dp2_dropless": ({"dp": 4, "ep": 2}, None, {"capacity_factor": None},
                        "moe"),
    "ep2dp2_capacity": ({"dp": 4, "ep": 2}, None, {"capacity_factor": 4.0},
                        "moe"),
}
# microbatches a data rank in the pipeline layouts
MICROBATCHES = 2


def _kind(layout: str) -> str:
    spec = LAYOUTS[layout]
    return spec[3] if len(spec) > 3 else "llama"


def _config(preset: str, kind: str = "llama", **kw):
    from ..models.llama import LlamaConfig
    from ..models.moe_lm import MoEConfig
    if preset == "tiny":
        return (MoEConfig if kind == "moe" else LlamaConfig).tiny(
            dtype="float32", **kw)
    small = dict(vocab_size=4096, hidden_size=512, intermediate_size=1408,
                 num_hidden_layers=2, num_attention_heads=8,
                 num_key_value_heads=4, max_position_embeddings=1024,
                 dtype="float32")
    if kind == "moe":
        return MoEConfig(**{**small, **dict(
            moe_intermediate_size=512, num_experts=8, num_experts_per_tok=2,
            num_shared_experts=1, first_k_dense_replace=1), **kw})
    return LlamaConfig(**{**small, **kw})


def _batch(cfg, s: int, device):
    rs = np.random.RandomState(0)
    ids = rs.randint(0, cfg.vocab_size, (BATCH, s + 1))
    labels = ids[:, 1:].copy()
    labels[0, : s // 5] = -100
    labels[-1, s // 2: s // 2 + 3] = -100
    return {"input_ids": torch.tensor(ids[:, :-1], device=device),
            "labels": torch.tensor(labels, device=device)}


def _model(cfg, device, kind="llama"):
    """The Llama (or MoE LM) of ``cfg`` from seed 3; for "pipe:<schedule>"
    the pipelined Llama loaded from that Llama."""
    from ..device import generator
    from ..models.llama import LlamaForCausalLM, LlamaForCausalLMPipe
    if kind == "moe":
        from ..models.moe_lm import MoEForCausalLM
        return MoEForCausalLM(cfg, device=device,
                              generator=generator(3, device))
    model = LlamaForCausalLM(cfg, device=device,
                             generator=generator(3, device))
    if not kind.startswith("pipe:"):
        return model
    pipe = LlamaForCausalLMPipe(cfg, num_stages=1, device=device,
                                pp_schedule=kind.split(":")[1])
    pipe.load_from_unpipelined(model)
    return pipe


def _step(cfg, batch, device, layout=None, kind="llama"):
    """One SGD step (lr 0.1, clip 0.5) of the model of ``kind`` from seed
    3: (loss, the whole parameters before, after), under the plain
    model's names."""
    from ..optimizer import SGD, ClipGradByGlobalNorm
    from ..trainer import Trainer
    model = _model(cfg, device, "moe" if kind == "moe" else "llama")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    if layout is None:
        opt = SGD(learning_rate=0.1, parameters=model,
                  grad_clip=ClipGradByGlobalNorm(0.5))
        loss = float(Trainer(model, opt).train_step(batch))
        return loss, before, {n: p.detach()
                              for n, p in model.named_parameters()}
    from ..distributed.sharding import group_sharded_parallel
    from ..models.llama import pipe_name
    from ..parallel.api import full_state_dict, shard_layer
    from ..parallel.mesh import HybridMesh
    degrees, level = LAYOUTS[layout][:2]
    if kind.startswith("pipe:"):
        from ..models.llama import LlamaForCausalLMPipe
        pipe = LlamaForCausalLMPipe(
            cfg, num_stages=degrees["pp"], num_microbatches=MICROBATCHES,
            pp_schedule=kind.split(":")[1], device=device)
        pipe.load_from_unpipelined(model)
        model = pipe
    hm = HybridMesh.build(devices=device.type, **degrees)
    with hm:
        shard_layer(model, hm)
        opt = SGD(learning_rate=0.1, parameters=model,
                  grad_clip=ClipGradByGlobalNorm(0.5))
        if level:
            model, opt, _ = group_sharded_parallel(model, opt, level=level)
        loss = float(Trainer(model, opt).train_step(batch))
        after = full_state_dict(model)
    if kind.startswith("pipe:"):
        after = {n: after[pipe_name(n)] for n in before}
    return loss, before, after


def update_errors(before, ref, got):
    """{name: (relative error, raw relative error)} of each parameter's
    update ``got - before`` against ``ref - before``, in L2 over the
    parameter. An update is read off two stored fp32 parameters, and the
    step's last add rounds each to the parameter's ulp: two updates that
    differ by less than one ulp may be stored one ulp apart. One ulp of
    a norm weight near 1 (6e-8 or 1.2e-7) is 1e-4 of its whole update in
    the "small" preset. So the relative error counts what exceeds one
    ulp in each element, and the raw one all of it."""
    out = {}
    for n, b in before.items():
        r, g = ref[n].float(), got[n].float()
        upd = r - b.float()
        diff = (g - r).abs()
        big = torch.maximum(r.abs(), g.abs())
        ulp = torch.nextafter(big, torch.full_like(big, float("inf"))) - big
        scale = max(float(upd.norm()), 1e-30)
        out[n] = (float((diff - ulp).clamp_min(0).norm()) / scale,
                  float(diff.norm()) / scale)
    return out


def run(layouts, preset: str, s: int, device):
    """Each layout's result (the dicts rank 0 prints)."""
    results = []
    for name in layouts:
        kind = _kind(name)
        family = "moe" if kind == "moe" else "llama"
        kw = dict(LAYOUTS[name][2])
        cfg = _config(preset, family, **kw)
        batch = _batch(cfg, s, device)
        base = {k: v for k, v in kw.items()
                if k in ("num_hidden_layers", "capacity_factor")}
        ref_loss, before, ref = _step(_config(preset, family, **base),
                                      batch, device, kind=family)
        t0 = time.perf_counter()
        loss, _, got = _step(cfg, batch, device, name, kind)
        secs = time.perf_counter() - t0
        errs = update_errors(before, ref, got)
        worst = max(errs, key=lambda n: errs[n][0])
        raw = max(errs, key=lambda n: errs[n][1])
        rel = errs[worst][0]
        good = abs(loss - ref_loss) <= TOL * max(abs(ref_loss), 1.0) \
            and rel <= TOL
        results.append({
            "layout": name, "world": dist.get_world_size(),
            "backend": dist.get_backend(), "preset": preset,
            "batch": [BATCH, s], "loss": loss, "reference_loss": ref_loss,
            "update_max_rel_err": rel, "worst_parameter": worst,
            "update_norm": float((ref[worst] - before[worst]).norm()),
            "update_max_raw_rel_err": errs[raw][1],
            "raw_worst_parameter": raw, "tol": TOL, "ok": good,
            "seconds": secs})
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layouts", default=",".join(LAYOUTS))
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    from ..parallel.mesh import init_parallel_env
    if args.device == "cpu":
        torch.set_num_threads(1)
    init_parallel_env(dp=int(os.environ.get("WORLD_SIZE", "1")),
                      backend="nccl" if args.device == "cuda" else "gloo",
                      device=args.device)
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device == "cuda" else torch.device("cpu"))
    rank = dist.get_rank()
    try:
        results = run(args.layouts.split(","), "small", 256, device)
    finally:
        dist.destroy_process_group()
    if rank == 0:
        for r in results:
            print(json.dumps(r), flush=True)
    return 0 if all(r["ok"] for r in results) else 1


if __name__ == "__main__":
    sys.exit(main())
