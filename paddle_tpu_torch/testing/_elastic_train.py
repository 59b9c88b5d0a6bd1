"""Deterministic elastic training script (counterpart of
``paddle_tpu/testing/_elastic_train.py``).

``python -m paddle_tpu_torch.testing._elastic_train --ckpt-dir D --steps N
--virtual-devices V --config dp2_tp2 [...]`` is the PARENT: it trains the
llama-micro model (``--preset llama3_8b`` with ``--layers`` and
``--dtype``: Llama-3-8B's widths) on a pod of V ranks that it starts
through the port's launcher (``distributed.launch``; gloo ranks with
``--device cpu``, one card a rank otherwise), with the full elastic stack
wired in on every rank (ShardingPlan via ``Trainer.apply_plan`` +
``CheckpointManager(mesh=, plan=)`` + ``resume="auto"``), and prints one
machine-readable ``ELASTIC_RESULT {...}`` line: the last step, the pod
sizes, each leg's segment (config, world size, steps, losses) and the
digest of the final committed checkpoint, read whole. Elastic knobs:

* ``--hard-exit-at K``     — rank 0 ``os._exit(137)`` when step K
  completes (SIGKILL shape: no final checkpoint); the launcher tears the
  pod down and the parent exits 137. A later invocation with a smaller
  ``--virtual-devices`` is the scale-in resume;
* ``--plan-auto``          — rank 0 asks the auto-parallel planner for the
  best legal config on THIS pod's world (``--candidates`` bounds the
  priced set) and broadcasts it;
* ``--switch-at K --switch-config C --switch-devices W`` — the
  uninterrupted REFERENCE leg: ``ElasticManager.run_elastic`` runs the
  pod, every rank raises ``WorldSizeChanged`` when its data asks for
  step K + 2 (after step K + 1), commits and exits with
  ``WORLD_SIZE_CHANGED_EXIT``; the parent maps that back to
  ``WorldSizeChanged`` and relaunches a pod of W ranks on ``C``, which
  resumes through the resharded restore — the same mesh schedule as a
  killed and resumed run, with no kill;
* ``--probe-reshard``      — no training: the timed mini reshard cycle,
  one ``ELASTIC_PROBE {json}`` line.

A rank is this script with ``--rank-leg A`` (set by the parent).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys


def _parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--save-interval", type=int, default=4)
    p.add_argument("--async-save", action="store_true")
    p.add_argument("--virtual-devices", type=int, default=None)
    p.add_argument("--config", default="dp4_tp2")
    p.add_argument("--plan-auto", action="store_true")
    p.add_argument("--candidates", default="")
    p.add_argument("--switch-at", type=int, default=None)
    p.add_argument("--switch-config", default="dp2_tp2")
    p.add_argument("--switch-devices", type=int, default=None)
    p.add_argument("--hard-exit-at", type=int, default=None)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=16)
    p.add_argument("--probe-reshard", action="store_true",
                   help="no training: run the timed mini reshard cycle "
                        "and print ELASTIC_PROBE {json}")
    p.add_argument("--device", default=None,
                   help="cpu: gloo ranks on the CPU; default: a card a rank")
    p.add_argument("--preset", default="micro",
                   choices=("micro", "llama3_8b"))
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--report", action="store_true",
                   help="rank 0 also records, in its segment, the digest "
                        "of the gathered parameters right after the "
                        "restore and of the restored step's checkpoint, the "
                        "restore's and each save's seconds and bytes, and "
                        "the kernel launches of its steps")
    p.add_argument("--no-digest", action="store_true",
                   help="leave the final checkpoint's digest out of the "
                        "result (it reads the whole state on the host)")
    p.add_argument("--rank-leg", type=int, default=None,
                   help=argparse.SUPPRESS)
    return p.parse_args(argv)


def micro_config(args=None):
    """The llama-micro shape (the JAX script's), or Llama-3-8B's widths."""
    from paddle_tpu_torch.models import LlamaConfig
    if args is not None and args.preset == "llama3_8b":
        kw = {"dtype": args.dtype}
        if args.layers:
            kw["num_hidden_layers"] = args.layers
        return LlamaConfig.llama3_8b(**kw)
    return LlamaConfig(vocab_size=320, hidden_size=64, intermediate_size=96,
                       num_hidden_layers=2, num_attention_heads=4,
                       num_key_value_heads=2, max_position_embeddings=128,
                       dtype=getattr(args, "dtype", "float32"))


def build_data(global_batch: int, seq_len: int, steps: int, vocab: int,
               device=None):
    """The global token stream (the same on every rank): a stateful
    DataLoader whose cursor the checkpoints carry, its batches sent to
    ``device`` ahead of use."""
    import numpy as np
    from paddle_tpu_torch.io import DataLoader, Dataset
    rs = np.random.RandomState(1234)
    toks = rs.randint(0, vocab, (global_batch * (steps + 4), seq_len + 1))

    class Tokens(Dataset):
        def __len__(self):
            return len(toks)

        def __getitem__(self, i):
            return {"input_ids": toks[i, :-1], "labels": toks[i, 1:]}
    return DataLoader(Tokens(), batch_size=global_batch, shuffle=False,
                      drop_last=True, prefetch_to_device=device is not None,
                      device=device)


class SwitchingLoader:
    """The loader, raising ``WorldSizeChanged`` on every rank when a
    batch past ``switch_at + 1`` steps is asked for (the membership
    change every rank sees at once); the cursor protocol forwarded."""

    def __init__(self, inner, switch_at, world, new_world):
        self.inner, self.switch_at = inner, switch_at
        self.world, self.new_world = world, new_world

    def __iter__(self):
        from paddle_tpu_torch.distributed.elastic import WorldSizeChanged
        for b in self.inner:
            served = self.inner.state_dict()["batches_served"]
            if self.switch_at is not None and served > self.switch_at + 1:
                raise WorldSizeChanged(self.world, self.new_world)
            yield b

    def state_dict(self):
        return self.inner.state_dict()

    def set_state_dict(self, sd):
        return self.inner.set_state_dict(sd)


def tree_digest(flat) -> str:
    """sha256 of the params and optimizer state of a flat checkpoint tree
    (``checkpoint.load_flat``), keys sorted."""
    import numpy as np
    import torch
    h = hashlib.sha256()
    for k in sorted(flat):
        if not (k.startswith("params/") or k.startswith("opt_state/")):
            continue
        h.update(k.encode())
        v = flat[k]
        if isinstance(v, torch.Tensor):
            h.update(v.contiguous().view(torch.uint8).numpy().tobytes())
        else:
            h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()[:16]


def _apply_leg_plan(args, mcfg, trainer, attempt: int, dev):
    """Shard ``trainer`` for this leg: the explicit config, the
    reference's switch config after the first leg, or the planner's
    choice over ``--candidates`` (``elastic.replan_and_apply``: rank 0
    plans, every rank applies its choice). Returns (plan, mesh)."""
    from paddle_tpu_torch.distributed.auto_parallel import (
        ParallelConfig, plan_for_config)
    from paddle_tpu_torch.distributed.elastic import replan_and_apply
    if args.plan_auto and not (attempt > 0 and args.switch_at is not None):
        cand = ([ParallelConfig.parse(s) for s in args.candidates.split(",")
                 if s.strip()] or None)
        return replan_and_apply(trainer, mcfg, devices=dev.type,
                                global_batch=args.global_batch,
                                seq_len=args.seq_len, configs=cand)
    text = (args.switch_config if attempt > 0 and args.switch_at is not None
            else args.config)
    plan = plan_for_config(mcfg, ParallelConfig.parse(text))
    return plan, trainer.apply_plan(plan, devices=dev.type)


def rank_main(args) -> int:
    """One rank of one leg."""
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch.device import generator
    from paddle_tpu_torch.distributed.elastic import (
        WORLD_SIZE_CHANGED_EXIT, WorldSizeChanged)
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    from paddle_tpu_torch.resilience import CheckpointManager
    from paddle_tpu_torch.trainer import Trainer

    cpu = args.device == "cpu"
    world = int(os.environ["WORLD_SIZE"])
    init_parallel_env(dp=world, backend="gloo" if cpu else "nccl",
                      device="cpu" if cpu else "cuda")
    dev = torch.device("cpu") if cpu else torch.device(
        "cuda", torch.cuda.current_device())
    attempt = int(args.rank_leg)
    mcfg = micro_config(args)
    model = LlamaForCausalLM(mcfg, device=dev, generator=generator(0, dev))
    trainer = Trainer(model, AdamW(learning_rate=args.lr, parameters=model),
                      donate=False)
    plan, hm = _apply_leg_plan(args, mcfg, trainer, attempt, dev)
    mgr = CheckpointManager(args.ckpt_dir,
                            save_interval_steps=args.save_interval,
                            keep_last_n=4, async_save=args.async_save,
                            mesh=trainer._plan, plan=plan)
    switch = args.switch_at if attempt == 0 else None
    data = SwitchingLoader(build_data(args.global_batch, args.seq_len,
                                      args.steps, mcfg.vocab_size, dev),
                           switch, world, args.switch_devices or world // 2)
    seg = {"attempt": attempt, "world_size": world,
           "config": plan.config_str, "steps": [], "losses": []}

    def write_segment():
        if args.report:
            from paddle_tpu_torch import checkpoint as ckpt
            seg["saves"] = [{k: v for k, v in st.items() if k != "path"}
                            for st in ckpt.writer().saves]
        if dist.get_rank() == 0:
            d = os.path.join(args.ckpt_dir, "_elastic")
            os.makedirs(d, exist_ok=True)
            with open(os.path.join(d, f"segment_{attempt}.json"), "w") as f:
                json.dump(seg, f)

    def cb(m):
        seg["steps"].append(int(m.step))
        seg["losses"].append(float(m.loss))
        if args.report:
            write_segment()     # a leg killed below keeps its losses
        if args.hard_exit_at is not None and m.step >= args.hard_exit_at:
            os._exit(137)
    code = 0
    with hm:
        if args.report:
            _report_restore(args, trainer, mgr, seg, dev)
        try:
            from paddle_tpu_torch.ops.kernels import _build
            _build.reset_launches()
            trainer.fit(data, steps=args.steps, log_every=1, on_metrics=cb,
                        checkpoint_manager=mgr, resume="auto")
            seg["launches"] = {k: v for k, v in _build.LAUNCHES.items()
                               if v}
        except WorldSizeChanged:
            mgr.finalize()                  # the last save is committed
            code = WORLD_SIZE_CHANGED_EXIT
    write_segment()
    mgr.close()
    dist.barrier()
    dist.destroy_process_group()
    return code


def _report_restore(args, trainer, mgr, seg, dev) -> None:
    """``--report``: restore the newest step into the live state (timed:
    verify, the resharded read, the copy into the shards) and record the
    digest of the gathered parameters beside that of the checkpoint's,
    read whole, and the checkpoint's bytes."""
    import time
    import torch
    import torch.distributed as dist
    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch.parallel.api import full_state_dict
    step = mgr.latest_committed()
    if step is None:
        return
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    _, tree = mgr.restore(trainer._ckpt_tree())
    trainer._apply_restored(tree)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    restore_s = time.perf_counter() - t0
    del tree
    gathered = {f"params/{k}": v.detach().cpu()
                for k, v in full_state_dict(trainer.model).items()}
    if dist.get_rank() == 0:
        saved = ckpt.load_flat(mgr.step_dir(step), prefix="params/")
        files = [os.path.join(mgr.step_dir(step), f)
                 for f in os.listdir(mgr.step_dir(step))]
        seg["restore"] = {
            "step": step, "seconds": restore_s,
            "checkpoint_bytes": sum(os.path.getsize(f) for f in files),
            "gathered_digest": tree_digest(gathered),
            "saved_digest": tree_digest(saved),
            "source_plan": (mgr.last_restored_plan.config_str
                            if mgr.last_restored_plan else None)}


def _launch_leg(args, argv, attempt: int, world: int) -> int:
    """A pod of ``world`` ranks of this script for leg ``attempt``,
    through the port's launcher; returns the pod's exit code."""
    from paddle_tpu_torch.distributed.launch.main import LaunchConfig, launch
    cfg = LaunchConfig(nproc_per_node=world, log_dir=os.path.join(
        args.ckpt_dir, "_elastic", f"log_{attempt}"))
    return launch(cfg, os.path.abspath(__file__),
                  list(argv) + ["--rank-leg", str(attempt)])


def reshard_probe(args) -> dict:
    """Timed mini reshard cycle: the llama-micro training state saved by
    one rank under its one-rank plan (sharded format) and read back as
    each rank's slice of a tp2 plan (``load_resharded(coords=)``), the
    ranks computed without being them. ``elastic_reshard_seconds`` is
    the verify + reshard wall time."""
    import shutil
    import tempfile
    import time

    import torch.distributed as dist
    from paddle_tpu_torch.distributed.auto_parallel import (ParallelConfig,
                                                            plan_for_config)
    from paddle_tpu_torch.models import LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.parallel.mesh import init_parallel_env
    from paddle_tpu_torch.resilience import CheckpointManager
    from paddle_tpu_torch.resilience.reshard import load_resharded
    from paddle_tpu_torch.trainer import Trainer
    root = tempfile.mkdtemp(prefix="pt_reshard_probe_")
    try:
        init_parallel_env(backend="gloo", device="cpu")
        mcfg = micro_config(args)
        model = LlamaForCausalLM(mcfg, device="cpu")
        tr = Trainer(model, AdamW(learning_rate=1e-3, parameters=model))
        src = plan_for_config(mcfg, ParallelConfig())
        hm = tr.apply_plan(src, devices="cpu")
        mgr = CheckpointManager(root, mesh=tr._plan, plan=src)
        with hm:
            mgr.save(4, tr._ckpt_tree())
        dst = plan_for_config(mcfg, ParallelConfig(tp=2))
        t0 = time.perf_counter()
        assert mgr.verify(4)
        for r in range(2):
            load_resharded(mgr.step_dir(4), tr._ckpt_tree(), dst,
                           coords={"tp": r})
        dt = time.perf_counter() - t0
        mgr.close()
        dist.destroy_process_group()
        return {"elastic_reshard_seconds": round(dt, 4),
                "elastic_probe_configs": f"{src.config_str}"
                                         f"->{dst.config_str}"}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parse_args(argv)
    if args.rank_leg is not None:
        return rank_main(args)
    if args.probe_reshard:
        print("ELASTIC_PROBE " + json.dumps(reshard_probe(args)),
              flush=True)
        return 0
    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch.distributed.elastic import (ElasticManager,
                                                      raise_for_pod_exit)
    V = int(args.virtual_devices or 1)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    seg_dir = os.path.join(args.ckpt_dir, "_elastic")
    if os.path.isdir(seg_dir):
        for n in os.listdir(seg_dir):
            if n.startswith("segment_"):
                os.remove(os.path.join(seg_dir, n))
    sizes = []
    if args.switch_at is not None:
        em = ElasticManager(np=1, heartbeat_timeout=60.0)
        new = args.switch_devices or V // 2
        schedule = iter([V, new])
        last = [V]

        def ws_fn():
            try:
                last[0] = next(schedule)
            except StopIteration:
                pass
            return last[0]

        def train_leg(attempt, world):
            sizes.append(world)
            raise_for_pod_exit(_launch_leg(args, argv, attempt, world),
                               world, new)
        ok = em.run_elastic(train_leg, world_size_fn=ws_fn,
                            sleep=lambda _s: None)
        em.exit()
        if not ok:
            print("reference elastic run did not complete", file=sys.stderr)
            return 1
    else:
        sizes.append(V)
        code = _launch_leg(args, argv, 0, V)
        if code != 0:
            return code
    segments = []
    for n in sorted(os.listdir(seg_dir)):
        if n.startswith("segment_"):
            with open(os.path.join(seg_dir, n)) as f:
                segments.append(json.load(f))
    segments.sort(key=lambda s: s["attempt"])
    step = ckpt.latest_step(args.ckpt_dir)
    digest = None if args.no_digest else tree_digest(ckpt.load_flat(
        os.path.join(args.ckpt_dir, f"step_{step}")))
    print("ELASTIC_RESULT " + json.dumps({
        "step": int(step), "devices": sizes, "segments": segments,
        "digest": digest}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
