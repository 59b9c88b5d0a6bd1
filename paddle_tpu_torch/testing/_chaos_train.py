"""Deterministic chaos training script (subprocess side of testing.chaos;
counterpart of ``paddle_tpu/testing/_chaos_train.py``).

``python -m paddle_tpu_torch.testing._chaos_train --ckpt-dir D --steps N
[...]`` trains a seeded Llama over a seeded token stream (the port's
DataLoader) with the resilience stack wired in (CheckpointManager +
PreemptionGuard + resume="auto") and prints one machine-readable
``CHAOS_RESULT {...}`` line. It runs on the card unless ``--device cpu``.
The model is ``--preset``'s (``tiny``: ``LlamaConfig.tiny``;
``llama3_8b``: Llama-3-8B's widths) with ``--layers``, ``--mlp`` and
``--vocab`` overriding its depth, MLP width and vocabulary, in
``--dtype``. Fault flags:

* ``--hard-exit-at K``   — SIGKILL to self when step K completes, once
  the in-flight async save is durable (the torn-save shape: payload
  written, no commit marker, no final checkpoint);
* ``--self-sigterm-at K``— SIGTERM to self at step K (preemption shape:
  the guard latches it, fit writes a final sync checkpoint and exits with
  the RESUMABLE status);
* ``--fail-at K``        — raise RuntimeError at step K (plain crash).

Relaunching with the same --ckpt-dir resumes from the newest committed
checkpoint; an uninterrupted run and a killed+resumed run print identical
digests (the bit-exact contract the tests assert on; in fp32, whose
kernel routes are deterministic).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import signal
import sys


def build(args):
    """(trainer, loader) of the run ``args`` describe."""
    import numpy as np
    import torch

    from paddle_tpu_torch.device import generator, resolve_device
    from paddle_tpu_torch.io import DataLoader, Dataset
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.optimizer import AdamW, ClipGradByGlobalNorm
    from paddle_tpu_torch.trainer import Trainer

    dev = resolve_device(args.device)
    kw = {"dtype": args.dtype}
    for name, val in (("num_hidden_layers", args.layers),
                      ("intermediate_size", args.mlp),
                      ("vocab_size", args.vocab)):
        if val is not None:
            kw[name] = val
    cfg = getattr(LlamaConfig, args.preset)(**kw)

    class Tokens(Dataset):
        def __init__(self):
            rs = np.random.RandomState(1234)
            self.ids = rs.randint(0, cfg.vocab_size,
                                  (args.steps * args.batch, args.seq + 1))

        def __len__(self):
            return len(self.ids)

        def __getitem__(self, i):
            return {"input_ids": self.ids[i, :-1], "labels": self.ids[i, 1:]}

    loader = DataLoader(Tokens(), batch_size=args.batch, drop_last=True,
                        prefetch_to_device=True, device=dev)
    model = LlamaForCausalLM(cfg, device=dev,
                             generator=generator(args.seed, dev))
    opt = AdamW(learning_rate=1e-4, parameters=model, weight_decay=0.01,
                grad_clip=ClipGradByGlobalNorm(1.0))
    return Trainer(model, opt), loader


def params_digest(params) -> str:
    import torch
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        t = params[k].detach().contiguous().cpu()
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--ckpt-dir", required=True)
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--save-interval", type=int, default=5)
    p.add_argument("--async-save", action="store_true")
    p.add_argument("--hard-exit-at", type=int, default=None)
    p.add_argument("--self-sigterm-at", type=int, default=None)
    p.add_argument("--fail-at", type=int, default=None)
    p.add_argument("--device", default=None)
    p.add_argument("--preset", default="tiny", choices=("tiny", "llama3_8b"))
    p.add_argument("--layers", type=int, default=None)
    p.add_argument("--mlp", type=int, default=None)
    p.add_argument("--vocab", type=int, default=None)
    p.add_argument("--dtype", default="float32")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seq", type=int, default=32)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    from paddle_tpu_torch import checkpoint as ckpt
    from paddle_tpu_torch.resilience import CheckpointManager, PreemptionGuard
    from paddle_tpu_torch.testing import chaos

    tr, loader = build(args)
    mgr = CheckpointManager(args.ckpt_dir,
                            save_interval_steps=args.save_interval,
                            keep_last_n=3, async_save=args.async_save)

    def cb(m):
        if args.hard_exit_at is not None and m.step >= args.hard_exit_at:
            ckpt.wait_until_finished()     # the payload is durable...
            os.kill(os.getpid(), signal.SIGKILL)   # ...the commit never is
        if args.fail_at is not None and m.step >= args.fail_at:
            raise RuntimeError(f"injected failure at step {m.step}")

    on_metrics = cb if (args.hard_exit_at is not None
                        or args.fail_at is not None) else None
    if args.self_sigterm_at is not None:
        on_metrics = chaos.kill_at_step(args.self_sigterm_at)

    with PreemptionGuard() as guard:
        hist = tr.fit(loader, steps=args.steps, log_every=1,
                      on_metrics=on_metrics, checkpoint_manager=mgr,
                      resume="auto", preemption_guard=guard)

    losses = [m.loss for m in hist]
    print("CHAOS_RESULT " + json.dumps({
        "step": tr._step,
        "final_loss": losses[-1] if losses else None,
        "losses": losses,
        "digest": params_digest(tr.params),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
