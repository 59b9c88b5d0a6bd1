"""Sharding-planner CLI: rank 5D parallel configs for a mesh (counterpart
of the JAX package's ``tools/plan.py``; the same flags and exit codes).

Enumerates legal ``(dp, fsdp, tp, pp, sep)`` configs over the declared
mesh, prunes the ones the per-card memory model rejects, prices each
survivor from the census of one real training step (a fake world of N
ranks on the meta device; ``paddle_tpu_torch.distributed.auto_parallel``),
and prints the ranked table — predicted step time, predicted MFU, memory
high-water, comm seconds — with the winner's plan. Exits 2 on an
infeasible mesh (more devices than ``--available``, or no legal config
survives).

Usage::

    python -m paddle_tpu_torch.tools.plan --mesh 4x2 --model llama-micro
    python -m paddle_tpu_torch.tools.plan --mesh 2x2 --json
    python -m paddle_tpu_torch.tools.plan --mesh 4x2 --out plan.json
    python -m paddle_tpu_torch.tools.plan --mesh 4x2 --config dp2_tp2
    python -m paddle_tpu_torch.distributed.launch --nproc_per_node 4 \\
        paddle_tpu_torch/tools/plan.py --mesh 4 --validate [--device cpu]

``--validate`` runs on every rank of a pod of the mesh's size (the
port's launcher): rank 0 plans and shares the report, every rank builds
and times each ranked config, rank 0 prints the predicted-vs-measured
rank agreement. ``main(argv)`` is importable and returns the exit code.
"""

import argparse
import json
import os
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

MODELS = ("llama-micro", "llama-tiny", "moe-micro", "llama3-8b")


def _model_cfg(name: str, layers=None):
    from paddle_tpu_torch.models import LlamaConfig
    if name == "llama-micro":
        return LlamaConfig(vocab_size=320, hidden_size=64,
                           intermediate_size=96, num_hidden_layers=2,
                           num_attention_heads=4, num_key_value_heads=2,
                           max_position_embeddings=128)
    if name == "llama-tiny":
        return LlamaConfig.tiny()
    if name == "llama3-8b":
        kw = {"dtype": "bfloat16"}
        if layers:
            kw["num_hidden_layers"] = layers
        return LlamaConfig.llama3_8b(**kw)
    if name == "moe-micro":
        from paddle_tpu_torch.models.moe_lm import MoEConfig
        return MoEConfig(vocab_size=320, hidden_size=64,
                         intermediate_size=96, moe_intermediate_size=48,
                         num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, num_experts=4,
                         num_experts_per_tok=2, num_shared_experts=1,
                         first_k_dense_replace=1, capacity_factor=None,
                         max_position_embeddings=128)
    raise SystemExit(f"plan: unknown --model {name!r}; known: "
                     f"{', '.join(MODELS)}")


def _parse_mesh(text: str) -> int:
    """'4x2' → 8 devices (the declared physical grid; the planner
    searches logical factorizations of its size)."""
    try:
        dims = [int(t) for t in text.lower().replace("*", "x").split("x")]
        n = 1
        for d in dims:
            if d < 1:
                raise ValueError
            n *= d
        return n
    except ValueError:
        raise SystemExit(f"plan: bad --mesh {text!r} (want e.g. 4x2)")


def available_devices() -> int:
    """The ranks a pod here could hold: the live world's, else the
    cards', else the CPU cores (a gloo rank a core)."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return dist.get_world_size()
    if torch.cuda.is_available():
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def main(argv=None) -> int:
    ap_ = argparse.ArgumentParser(
        prog="plan", description=__doc__.split("\n")[0])
    ap_.add_argument("--mesh", default=None,
                     help="declared device grid, e.g. 4x2 (product = "
                          "device count)")
    ap_.add_argument("--devices", type=int, default=None,
                     help="device count (alternative to --mesh)")
    ap_.add_argument("--model", default="llama-micro",
                     help=f"model preset: {', '.join(MODELS)}")
    ap_.add_argument("--layers", type=int, default=None,
                     help="layer count of the llama3-8b preset")
    ap_.add_argument("--batch", type=int, default=8,
                     help="global batch the plan targets")
    ap_.add_argument("--seq", type=int, default=64,
                     help="sequence length the plan targets")
    ap_.add_argument("--top", type=int, default=5,
                     help="rows of the ranked table to print")
    ap_.add_argument("--config", default=None,
                     help="price ONE config (e.g. dp2_tp2 or "
                          "dp2_fsdp2_tp2) instead of enumerating")
    ap_.add_argument("--candidates", default=None,
                     help="price these configs (comma-separated) instead "
                          "of enumerating")
    ap_.add_argument("--drift", default="warn",
                     choices=("warn", "refuse", "ignore"),
                     help="what to do when the cost-model drift gauge "
                          "is out of band")
    ap_.add_argument("--hbm-budget-gb", type=float, default=None,
                     help="override the per-card memory budget (GiB)")
    ap_.add_argument("--link-bw", type=float, default=None,
                     help="link bandwidth a card, bytes/s (default: the "
                          "device table's)")
    ap_.add_argument("--validate", action="store_true",
                     help="under the launcher: build and time every "
                          "ranked config, report rank agreement")
    ap_.add_argument("--device", default=None,
                     help="--validate's device: cpu (gloo) or the card")
    ap_.add_argument("--available", "--virtual-devices", type=int,
                     default=None,
                     help="devices that exist (default: the world's, "
                          "the cards', else the CPU cores)")
    ap_.add_argument("--json", action="store_true",
                     help="emit the full report as JSON on stdout")
    ap_.add_argument("--out", default=None,
                     help="persist the plan artifact (ranked table + "
                          "chosen plan) to this path")
    args = ap_.parse_args(argv)

    from paddle_tpu_torch.distributed import auto_parallel as ap_mod
    from paddle_tpu_torch.observability.costs import device_spec
    rank = 0
    if args.validate:
        import torch.distributed as dist
        from paddle_tpu_torch.parallel.mesh import init_parallel_env
        cpu = args.device == "cpu"
        init_parallel_env(dp=int(os.environ.get("WORLD_SIZE", "1")),
                          backend="gloo" if cpu else "nccl",
                          device="cpu" if cpu else "cuda")
        rank = dist.get_rank()
    if args.mesh:
        n = _parse_mesh(args.mesh)
    elif args.devices:
        n = args.devices
    else:
        n = available_devices()
    have = args.available or available_devices()
    cfgs = None
    if args.config:
        cfgs = [ap_mod.ParallelConfig.parse(args.config)]
    elif args.candidates:
        cfgs = [ap_mod.ParallelConfig.parse(c)
                for c in args.candidates.split(",") if c.strip()]
    budget = (args.hbm_budget_gb * 2 ** 30
              if args.hbm_budget_gb is not None else None)
    mcfg = _model_cfg(args.model, args.layers)
    report, err = None, None
    if rank == 0:
        try:
            report = ap_mod.plan(
                mcfg, n_devices=n, devices=list(range(have)),
                mesh_shape=args.mesh or str(n),
                global_batch=args.batch, seq_len=args.seq, configs=cfgs,
                drift=args.drift, hbm_budget_bytes=budget,
                spec=device_spec(link_bw=args.link_bw),
                model_name=args.model)
        except (ap_mod.InfeasibleMeshError,
                ap_mod.StaleCostModelError) as e:
            err = f"plan: {type(e).__name__}: {e}"
    if args.validate:
        import torch.distributed as dist
        box = [(report, err)]
        dist.broadcast_object_list(box, src=0)
        report, err = box[0]
    if err is not None:
        if rank == 0:
            print(err, file=sys.stderr)
        return 2
    if args.validate:
        report.validation = ap_mod.validate_rank_order(
            report, mcfg, device="cpu" if args.device == "cpu" else None)
        if rank != 0:
            return 0
    if args.out:
        report.save(args.out)
    if args.json:
        print(json.dumps(report.as_dict(), sort_keys=True,
                         default=float))
    else:
        print(f"plan: {n} devices ({report.device['kind']}), model "
              f"{args.model}, batch {args.batch} x seq {args.seq}")
        print(report.table(top=args.top))
        chosen = report.chosen
        print(f"\nchosen: {chosen.config}  predicted "
              f"{chosen.predicted_step_s * 1e3:.3f} ms/step, MFU "
              f"{chosen.predicted_mfu:.4f}")
        for nrow in report.notes:
            print(f"note: {nrow}")
        if report.validation:
            v = report.validation
            print(f"validate: agreement={v['agreement']:.3f} "
                  f"top1_in_measured_top2="
                  f"{bool(v['top1_is_measured_top2'])} "
                  f"(predicted {v.get('predicted_best')}, measured "
                  f"{v.get('measured_best')})")
        if args.out:
            print(f"plan artifact -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
