"""Op-cost calibration probe: measured latencies for the cost
observatory's OpCostDB (counterpart of the JAX package's
``tools/op_cost_probe.py``).

Times the port's eager training step at a micro size (the JAX probe's
``train_step_k1`` graph of ``paddle_tpu/analysis/graphs.py``: a 2-layer
Llama, vocabulary 320, AdamW, batch 2 x 20, fused CE head; at hidden
128 here, where JAX's is 64, since its head dim of 16 is not one the
flash kernels take) and its dominant matmul shapes (from a census of
the same step, ``analysis.collectives.StepCensus``), each as the
minimum over rounds, and persists the results into the :class:`OpCostDB` under the JAX
package's keys, so the planner's lookups are JAX's unchanged:

* ``graph:train_step_k1|<device kind>|any|`` — ``t_s`` (a step's wall
  time), ``dispatch_floor_s`` (the host seconds that enqueueing one step
  takes, at most ``t_s``: the eager port's per-dispatch host floor, which
  the planner adds to every predicted step), the census's flops, bytes,
  comm bytes and predicted seconds, and ``captured_at``;
* ``dot|<device kind>|<dtype>|k=..,m=..,n=..`` — ``t_s`` of one matmul
  of that shape, which replaces its analytical 2mkn ÷ peak in the
  planner's pricing.

The other graphs of JAX's registry (serving ticks, supersteps, the
sharded steps) wait for the port of ``analysis/graphs`` (ROADMAP.md
A.6.4).

Usage::

    python -m paddle_tpu_torch.tools.op_cost_probe --calibrate
    python -m paddle_tpu_torch.tools.op_cost_probe --calibrate \\
        --db /tmp/op_cost_db.json
    python -m paddle_tpu_torch.tools.op_cost_probe --device cpu

Without ``--device cpu`` it runs on the card. Prints one JSON line.
``calibrate()`` and ``measure_train_step()`` are importable.
"""

import argparse
import gc
import json
import os
import sys
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)

#: the micro training step: (batch, sequence), config (JAX's, but for a
#: head dim of 32: hidden 128 over 4 heads)
MICRO_BATCH = (2, 20)
MICRO = dict(vocab_size=320, hidden_size=128, intermediate_size=192,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128)

_DTYPES = ("float32", "bfloat16", "float16", "float64")


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_train_step(device=None, rounds: int = 3, iters: int = 4,
                       warmup: int = 1):
    """Build, census and time the micro training step on ``device`` (the
    card unless "cpu"). Returns ``(record, cost report)``: the record
    holds ``t_s``, ``dispatch_floor_s``, ``flops``, ``bytes``,
    ``comm_bytes``, ``predicted_s``, ``mfu_measured`` and
    ``device_kind``. Each round runs ``iters`` steps back to back after
    a gc fence; the minimum round wins."""
    import torch
    from paddle_tpu_torch.analysis.collectives import StepCensus
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
    from paddle_tpu_torch.observability import costs
    from paddle_tpu_torch.optimizer import AdamW
    from paddle_tpu_torch.trainer import Trainer

    device = resolve_device(device)
    spec = costs.device_spec()
    g = torch.Generator(device=device).manual_seed(0)
    model = LlamaForCausalLM(LlamaConfig(**MICRO), device=device,
                             generator=g)
    tr = Trainer(model, AdamW(learning_rate=1e-4, parameters=model))
    ids = torch.zeros(MICRO_BATCH, dtype=torch.long, device=device)
    batch = {"input_ids": ids, "labels": ids}
    for _ in range(max(0, warmup)):
        tr.train_step(batch)
    _sync(device)
    with StepCensus() as census:
        tr.train_step(batch)
    _sync(device)
    rep = costs.attribute_costs(census, spec=spec)
    best = floor = float("inf")
    for _ in range(max(1, rounds)):
        gc.collect()
        host = 0.0
        t0 = time.perf_counter()
        for _ in range(max(1, iters)):
            h0 = time.perf_counter()
            tr.train_step(batch)
            host += time.perf_counter() - h0
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / max(1, iters))
        floor = min(floor, host / max(1, iters))
    record = {"t_s": best, "dispatch_floor_s": min(floor, best),
              "flops": rep.total_flops, "bytes": rep.total_bytes,
              "comm_bytes": rep.total_comm_bytes,
              "predicted_s": rep.predicted_step_s,
              "mfu_measured": (rep.total_flops / (best * spec.peak_flops)
                               if best > 0 else 0.0),
              "device_kind": spec.kind}
    return record, rep


def time_dot(m, k, n, dtype: str, device, rounds: int = 3,
             iters: int = 4) -> float:
    """Seconds of one [m, k] x [k, n] product in ``dtype``: the minimum
    over rounds of ``iters`` back-to-back products."""
    import torch
    dt = getattr(torch, dtype)
    a = torch.zeros((m, k), dtype=dt, device=device)
    b = torch.zeros((k, n), dtype=dt, device=device)
    out = a @ b                                   # warm up off the clock
    _sync(device)
    best = float("inf")
    for _ in range(max(1, rounds)):
        t0 = time.perf_counter()
        for _ in range(max(1, iters)):
            out = a @ b
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / max(1, iters))
    del out
    return best


def calibrate(device=None, rounds: int = 3, iters: int = 4, db_path=None,
              top_dots: int = 3, save: bool = True):
    """Measure the micro step and its dominant matmul shapes and persist
    the OpCostDB (``db_path``, else ``PT_OP_COST_DB`` or the user file).
    Returns the summary, with the db path and the recorded keys."""
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.observability import costs

    device = resolve_device(device)
    db = (costs.OpCostDB(user_path=db_path) if db_path
          else costs.get_op_cost_db())
    record, rep = measure_train_step(device, rounds=rounds, iters=iters)
    kind = record.pop("device_kind")
    now = time.strftime("%Y-%m-%dT%H:%M:%S")
    key = costs.OpCostDB.graph_key("train_step_k1", kind)
    db.record(key, {**record, "captured_at": now, "rounds": rounds,
                    "iters": iters})
    recorded = [key]
    for d in costs.dominant_dots(rep, top=top_dots):
        if d["dtype"] not in _DTYPES:
            continue
        t = time_dot(d["m"], d["k"], d["n"], d["dtype"], device, rounds,
                     iters)
        dkey = costs.OpCostDB.dot_key(d["m"], d["k"], d["n"], d["dtype"],
                                      kind)
        db.record(dkey, {"t_s": t, "flops": 2.0 * d["m"] * d["k"] * d["n"],
                         "captured_at": now})
        recorded.append(dkey)
    if save:
        db.save()
    return {"db_path": db.user_path(), "recorded": recorded,
            "graphs": {"train_step_k1": record}, "device_kind": kind}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calibrate", action="store_true",
                    help="measure + persist the OpCostDB (without it the "
                         "probe only measures and prints)")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--db", default=None,
                    help="OpCostDB path (default: PT_OP_COST_DB or "
                         "~/.cache/paddle_tpu_torch/op_cost_db.json)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the card unless cpu")
    args = ap.parse_args(argv)
    if args.calibrate:
        return calibrate(args.device, rounds=args.rounds, iters=args.iters,
                         db_path=args.db)
    record, _ = measure_train_step(args.device, rounds=args.rounds,
                                   iters=args.iters)
    return {"graphs": {"train_step_k1": record}}


if __name__ == "__main__":
    print(json.dumps(main(), default=float))
