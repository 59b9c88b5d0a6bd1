"""Op-cost calibration probe: measured latencies for the cost
observatory's OpCostDB (counterpart of the JAX package's
``tools/op_cost_probe.py``).

Times every single-process graph of the canonical registry
(``analysis.graphs``: ``train_step_k1``, ``train_step_k4``, the serving
ticks, ``prefix_admit``, ``fused_ce``; the micro Llama there is 2
layers, vocabulary 320, hidden 128 — JAX's is 64, whose head dim of 16
no flash kernel takes) and the dominant matmul shapes of their censuses,
each as the minimum over rounds that interleave the graphs, and persists
the results into the :class:`OpCostDB` under the JAX package's keys, so
the planner's lookups are JAX's unchanged:

* ``graph:<name>|<device kind>|any|`` — ``t_s`` (a call's wall time),
  ``dispatch_floor_s`` (the host seconds enqueueing one call takes, at
  most ``t_s``; the eager port has no null executable to time),
  ``dispatch_floor_per_op_s`` (that floor over the census's op count:
  the planner multiplies it by the op count of the graph it prices, so
  a deep model's many launches are priced as many), ``ops``, the
  census's flops, bytes, comm bytes and predicted seconds, and
  ``captured_at``;
* ``dot|<device kind>|<dtype>|k=..,m=..,n=..`` — ``t_s`` of one matmul
  of that shape, which replaces its analytical 2mkn ÷ peak in the
  planner's pricing.

The four sharded graphs need a world of 4 ranks and are not timed here
(``tools/mesh_check.py``'s graph leg checks them on the cards).

Usage::

    python -m paddle_tpu_torch.tools.op_cost_probe --calibrate
    python -m paddle_tpu_torch.tools.op_cost_probe --calibrate \\
        --db /tmp/op_cost_db.json --graphs train_step_k1,serving_tick
    python -m paddle_tpu_torch.tools.op_cost_probe --device cpu

Without ``--device cpu`` it runs on the card. Prints one JSON line.
``calibrate()`` and ``measure_graphs()`` are importable.
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

_DTYPES = ("float32", "bfloat16", "float16", "float64")


def _sync(device):
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_graphs(names=None, device=None, rounds: int = 3,
                   iters: int = 4):
    """Build, census and time the single-process canonical graphs on
    ``device`` (the card unless "cpu"). Returns ``({name: record},
    {name: cost report})``: a record holds ``t_s``,
    ``dispatch_floor_s``, ``dispatch_floor_per_op_s``, ``ops``,
    ``flops``, ``bytes``, ``comm_bytes``, ``predicted_s``,
    ``mfu_measured`` and ``device_kind``. Each round runs each graph
    ``iters`` times back to back after a gc fence, the graphs in turn;
    the minimum round wins."""
    from paddle_tpu_torch import analysis as A
    from paddle_tpu_torch.analysis.graphs import SHARDED, _device
    from paddle_tpu_torch.observability import costs

    device = _device(device)
    spec = costs.device_spec()
    names = [n for n in (names or A.graph_names()) if n not in SHARDED]
    built = {}
    for name in names:
        g = A.build_graph(name, device)
        built[name] = (g, costs.attribute_costs(g.census, spec=spec))
    best = {n: float("inf") for n in built}
    floor = {n: float("inf") for n in built}
    for _ in range(max(1, rounds)):
        for name, (g, _rep) in built.items():
            gc.collect()
            host = 0.0
            t0 = time.perf_counter()
            for _ in range(max(1, iters)):
                h0 = time.perf_counter()
                g.call()
                host += time.perf_counter() - h0
            _sync(device)
            best[name] = min(best[name],
                             (time.perf_counter() - t0) / max(1, iters))
            floor[name] = min(floor[name], host / max(1, iters))
    out = {}
    for name, (g, rep) in built.items():
        t, n_ops = best[name], len(g.census.ops)
        fl = min(floor[name], t)
        out[name] = {"t_s": t, "dispatch_floor_s": fl,
                     "dispatch_floor_per_op_s": fl / max(1, n_ops),
                     "ops": n_ops, "flops": rep.total_flops,
                     "bytes": rep.total_bytes,
                     "comm_bytes": rep.total_comm_bytes,
                     "predicted_s": rep.predicted_step_s,
                     "mfu_measured": (rep.total_flops
                                      / (t * spec.peak_flops)
                                      if t > 0 else 0.0),
                     "device_kind": spec.kind}
    return out, {name: rep for name, (_g, rep) in built.items()}


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
              top_dots: int = 3, save: bool = True, graphs=None):
    """Measure the graphs and their dominant matmul shapes and persist
    the OpCostDB (``db_path``, else ``PT_OP_COST_DB`` or the user file).
    Returns the summary, with the db path and the recorded keys."""
    from paddle_tpu_torch.device import resolve_device
    from paddle_tpu_torch.observability import costs

    device = resolve_device(device)
    db = (costs.OpCostDB(user_path=db_path) if db_path
          else costs.get_op_cost_db())
    measured, reports = measure_graphs(graphs, device, rounds=rounds,
                                       iters=iters)
    now = time.strftime("%Y-%m-%dT%H:%M:%S")
    recorded, kind, shapes = [], None, {}
    for name, record in measured.items():
        kind = record.pop("device_kind")
        key = costs.OpCostDB.graph_key(name, kind)
        db.record(key, {**record, "captured_at": now, "rounds": rounds,
                        "iters": iters})
        recorded.append(key)
        for d in costs.dominant_dots(reports[name], top=top_dots):
            shapes.setdefault((d["m"], d["k"], d["n"], d["dtype"]), d)
    for (m, k, n, dtype), d in sorted(shapes.items(),
                                      key=lambda kv: -kv[1]["flops"]):
        if dtype not in _DTYPES:
            continue
        t = time_dot(m, k, n, dtype, device, rounds, iters)
        dkey = costs.OpCostDB.dot_key(m, k, n, dtype, kind)
        db.record(dkey, {"t_s": t, "flops": 2.0 * m * k * n,
                         "captured_at": now})
        recorded.append(dkey)
    if save:
        db.save()
    return {"db_path": db.user_path(), "recorded": recorded,
            "graphs": measured, "device_kind": kind}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--calibrate", action="store_true",
                    help="measure + persist the OpCostDB (without it the "
                         "probe only measures and prints)")
    ap.add_argument("--graphs", default=None,
                    help="comma-separated canonical graph subset")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--db", default=None,
                    help="OpCostDB path (default: PT_OP_COST_DB or "
                         "~/.cache/paddle_tpu_torch/op_cost_db.json)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="the card unless cpu")
    args = ap.parse_args(argv)
    graphs = ([g.strip() for g in args.graphs.split(",") if g.strip()]
              if args.graphs else None)
    if args.calibrate:
        return calibrate(args.device, rounds=args.rounds, iters=args.iters,
                         db_path=args.db, graphs=graphs)
    measured, _ = measure_graphs(graphs, args.device, rounds=args.rounds,
                                 iters=args.iters)
    return {"graphs": measured}


if __name__ == "__main__":
    print(json.dumps(main(), default=float))
