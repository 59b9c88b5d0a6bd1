"""SPMD training over several ranks held to one rank's unsharded step.

Run one process a card under the port's launcher (NCCL)::

    python -m paddle_tpu_torch.distributed.launch --nproc_per_node N \
        paddle_tpu_torch/tools/mesh_check.py

(``--device cpu`` runs the ranks under gloo; ``torchrun`` works too).
Every rank:

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
   capacity factor of 4, at which no token is dropped on either side),
   and takes it again in the serial schedule
   (``distributed.overlap.serial_reference``), which the overlapped
   step must equal bit for bit;
3. gathers the parameters whole (``parallel.api.full_state_dict``).

Rank 0 prints one JSON line a layout: the loss, the reference's, the
largest relative L2 distance of a parameter's update from the
reference's (:func:`update_errors`), and whether both lie within
:data:`TOL`, and whether the overlapped and serial steps are equal. On
the cards, when ``--layouts`` is not given, it then times :data:`TIMED`
(2 layers at Llama-3-8B widths, bf16, AdamW, 4 x 4096 tokens a step,
tp4 then dp4) in the serial schedule ("off") and overlapped ("on"): the
median
step, the NCCL kernel time that overlaps no compute kernel ("exposed
comm") in a profiler trace of one step, and the link bandwidth an
all-gather reaches (:func:`link_bandwidth`, ``parallel.projection``'s
``link_bw``). The exit code is 1 when a layout does not hold.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

if __package__ in (None, ""):
    # run as a script (the launcher's form): the repository is the root
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

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
    from paddle_tpu_torch.models.llama import LlamaConfig
    from paddle_tpu_torch.models.moe_lm import MoEConfig
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
    from paddle_tpu_torch.device import generator
    from paddle_tpu_torch.models.llama import (LlamaForCausalLM,
                                               LlamaForCausalLMPipe)
    if kind == "moe":
        from paddle_tpu_torch.models.moe_lm import MoEForCausalLM
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
    from paddle_tpu_torch.optimizer import SGD, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer
    model = _model(cfg, device, "moe" if kind == "moe" else "llama")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    if layout is None:
        opt = SGD(learning_rate=0.1, parameters=model,
                  grad_clip=ClipGradByGlobalNorm(0.5))
        loss = float(Trainer(model, opt).train_step(batch))
        return loss, before, {n: p.detach()
                              for n, p in model.named_parameters()}
    from paddle_tpu_torch.distributed.sharding import \
        group_sharded_parallel
    from paddle_tpu_torch.models.llama import pipe_name
    from paddle_tpu_torch.parallel.api import full_state_dict, shard_layer
    from paddle_tpu_torch.parallel.mesh import HybridMesh
    degrees, level = LAYOUTS[layout][:2]
    if kind.startswith("pipe:"):
        from paddle_tpu_torch.models.llama import LlamaForCausalLMPipe
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


def _schedule(mode: str):
    """The scope of a step in ``mode``: "on", the port's overlapped
    schedule; "off", the serial reference."""
    from paddle_tpu_torch.distributed.overlap import serial_reference
    return serial_reference() if mode == "off" else contextlib.nullcontext()


def run(layouts, preset: str, s: int, device):
    """Each layout's result (the dicts rank 0 prints): the sharded step
    held to the reference, and to its serial schedule bit for bit."""
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
        steps = {}
        for mode in ("off", "on"):
            with _schedule(mode):
                t0 = time.perf_counter()
                loss, _, got = _step(cfg, batch, device, name, kind)
            steps[mode] = (loss, got, time.perf_counter() - t0)
        loss, got, secs = steps["on"]
        (la, ga, _), (lb, gb, _) = steps.values()
        equal = la == lb and all(torch.equal(ga[n], gb[n]) for n in ga)
        errs = update_errors(before, ref, got)
        worst = max(errs, key=lambda n: errs[n][0])
        raw = max(errs, key=lambda n: errs[n][1])
        rel = errs[worst][0]
        good = abs(loss - ref_loss) <= TOL * max(abs(ref_loss), 1.0) \
            and rel <= TOL and equal
        res = {
            "layout": name, "world": dist.get_world_size(),
            "backend": dist.get_backend(), "preset": preset,
            "batch": [BATCH, s], "loss": loss, "reference_loss": ref_loss,
            "update_max_rel_err": rel, "worst_parameter": worst,
            "update_norm": float((ref[worst] - before[worst]).norm()),
            "update_max_raw_rel_err": errs[raw][1],
            "raw_worst_parameter": raw, "tol": TOL, "overlap_equal": equal,
            "seconds": secs, "ok": good}
        results.append(res)
    return results


# the timed layouts: mesh degrees at Llama-3-8B widths, 2 layers
TIMED = {"tp4_8b": {"tp": 4}, "dp4_8b": {"dp": 4}}
TIMED_TOKENS = (4, 4096)       # the global batch: rows x sequence
TIMED_STEPS = (2, 5)           # warm-up and timed steps


def link_bandwidth(device, mib: int = 512, reps: int = 10) -> dict:
    """The bus bandwidth (bytes/s a card) of an all-gather of ``mib``
    MiB and of an all-reduce of the same bytes over the world: (n - 1)
    / n of the gathered bytes, 2 (n - 1) / n of the reduced ones, over
    the mean time (CUDA events after a warm-up). The all-gather's is
    the ``link_bw`` ``parallel.projection`` takes: its FSDP roofline
    prices all-gathers and reduce-scatters by it."""
    n = dist.get_world_size()
    numel = mib * (1 << 20) // 2
    full = torch.empty(numel, dtype=torch.bfloat16, device=device)
    part = torch.ones(numel // n, dtype=torch.bfloat16, device=device)
    out = {"bytes": numel * 2, "world": n}
    for name, fn, factor in (
            ("all_gather", lambda: dist.all_gather_into_tensor(full, part),
             (n - 1) / n),
            ("all_reduce", lambda: dist.all_reduce(full), 2 * (n - 1) / n)):
        fn()
        torch.cuda.synchronize(device)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        s = a.elapsed_time(b) / reps / 1e3
        out[name + "_s"] = s
        out[name + "_busbw"] = factor * numel * 2 / s
    out["link_bw"] = out["all_gather_busbw"]
    return out


def timed(device, trace_dir=None) -> list:
    """Each :data:`TIMED` layout's steps, serial ("off") and overlapped
    ("on") (bf16
    Llama-3-8B widths, 2 layers, AdamW 1e-4 and a global-norm clip, the
    same seeded weights and batch): median step seconds, the losses
    (equal bit for bit between the two), and the exposed and whole NCCL
    kernel ms of one profiled step (rank 0 writes its chrome trace to
    ``trace_dir``)."""
    from paddle_tpu_torch.device import generator
    from paddle_tpu_torch.distributed.overlap import (
        backward_overlap_independent, exposed_comm)
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.parallel.api import shard_layer
    from paddle_tpu_torch.parallel.mesh import HybridMesh
    from paddle_tpu_torch.trainer import Trainer
    cfg = LlamaConfig.llama3_8b(num_hidden_layers=2, dtype="bfloat16")
    rows, seq = TIMED_TOKENS
    g = generator(7, device)
    ids = torch.randint(0, cfg.vocab_size, (rows, seq + 1), device=device,
                        generator=g)
    batch = {"input_ids": ids[:, :-1], "labels": ids[:, 1:]}
    warm, steps = TIMED_STEPS
    out = []
    for name, degrees in TIMED.items():
        res = {"layout": name, "world": dist.get_world_size(),
               "batch": [rows, seq], "layers": cfg.num_hidden_layers}
        for mode in ("off", "on"):
            model = LlamaForCausalLM(cfg, device=device,
                                     generator=generator(3, device))
            hm = HybridMesh.build(devices=device.type, **degrees)
            with hm, _schedule(mode):
                shard_layer(model, hm)
                tr = Trainer(model, AdamW(
                    learning_rate=1e-4, parameters=model, weight_decay=0.01,
                    grad_clip=ClipGradByGlobalNorm(1.0)))
                losses, times = [], []
                for i in range(warm + steps):
                    torch.cuda.synchronize(device)
                    t0 = time.perf_counter()
                    loss = tr.train_step(batch)
                    torch.cuda.synchronize(device)
                    times.append(time.perf_counter() - t0)
                    losses.append(float(loss))
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    tr.train_step(batch)
                    torch.cuda.synchronize(device)
                path = os.path.join(trace_dir or ".",
                                    f"{name}_{mode}_rank{dist.get_rank()}"
                                    ".json")
                prof.export_chrome_trace(path)
                comm = exposed_comm(path)
                dx = backward_overlap_independent(path)
                if trace_dir is None or dist.get_rank() != 0:
                    os.remove(path)
            res[mode] = {"median_step_s": float(np.median(times[warm:])),
                         "step_times_s": times[warm:], "losses": losses,
                         "nccl_ms": comm["nccl_ms"],
                         "exposed_comm_ms": comm["exposed_ms"],
                         "compute_ms": comm["compute_ms"],
                         "nccl_kernels": comm["nccl_kernels"],
                         "dx_allreduces": dx["allreduces"],
                         "dx_overlapping_gemm": dx["overlapping_gemm"]}
            del tr, model
            torch.cuda.empty_cache()
        res["overlap_equal"] = res["off"]["losses"] == res["on"]["losses"]
        res["ok"] = res["overlap_equal"] and all(
            np.isfinite(res[m]["losses"]).all() for m in ("off", "on"))
        out.append(res)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--layouts", default=None)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--trace-dir", default=None)
    args = p.parse_args(argv)
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    if args.device == "cpu":
        torch.set_num_threads(1)
    init_parallel_env(dp=int(os.environ.get("WORLD_SIZE", "1")),
                      backend="nccl" if args.device == "cuda" else "gloo",
                      device=args.device)
    device = (torch.device("cuda", torch.cuda.current_device())
              if args.device == "cuda" else torch.device("cpu"))
    rank = dist.get_rank()
    layouts = (args.layouts or ",".join(LAYOUTS)).split(",")
    extra = []
    try:
        results = run(layouts, "small", 256, device)
        if rank == 0:
            for r in results:
                print(json.dumps(r), flush=True)
        if args.device == "cuda" and args.layouts is None:
            if args.trace_dir and rank == 0:
                os.makedirs(args.trace_dir, exist_ok=True)
            extra = timed(device, args.trace_dir)
            extra.append({"layout": "link_bandwidth", "ok": True,
                          **link_bandwidth(device)})
            if rank == 0:
                for r in extra:
                    print(json.dumps(r), flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if all(r["ok"] for r in results + extra) else 1


if __name__ == "__main__":
    sys.exit(main())
