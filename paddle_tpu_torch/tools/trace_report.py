"""Critical-path report over request traces (counterpart of the JAX
package's ``tools/trace_report.py``).

Reads the trace JSONL a :class:`~paddle_tpu_torch.observability.tracing.
Tracer` writes (``TRACER.enable(dir=...)`` -> ``traces.jsonl``) — a
directory or a single file — and answers *where did the latency go*:

* the per-hop TTFT table — p50 / p99 exclusive self-time per serving hop
  (queue, route, admission, prefill, decode, ...), worst p99 share
  first, with the uncovered residual as the ``untracked`` row;
* the worst traces (highest TTFT) as indented span trees with their
  outcome and replica tags, so the aggregate's guilty hop can be read
  off one concrete request;
* optionally the worst trace as Perfetto / chrome-trace JSON
  (``--chrome out.json``; load it in chrome://tracing or
  ui.perfetto.dev).

Usage::

    python -m paddle_tpu_torch.tools.trace_report /path/to/trace_dir
    python -m paddle_tpu_torch.tools.trace_report traces.jsonl \\
        --worst 3 --chrome w.json
    python -m paddle_tpu_torch.tools.trace_report trace_dir --json

Pure stdlib over the span records: no card, no model, no torch.
"""

import argparse
import json
import os
import sys

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))

from paddle_tpu_torch.analysis import critical_path as cp  # noqa: E402


def report(traces, *, worst_k: int = 1, chrome: str = None) -> dict:
    """The report as a dict; rendering stays in :func:`main`."""
    atts = [cp.attribute_trace(t) for t in traces]
    with_ttft = [(t, a) for t, a in zip(traces, atts)
                 if a["ttft_s"] is not None]
    with_ttft.sort(key=lambda ta: -ta[1]["ttft_s"])
    out = {
        "n_traces": len(traces),
        "n_with_ttft": len(with_ttft),
        "aggregate": cp.aggregate(traces),
        "worst": [{"trace_id": a["trace_id"],
                   "ttft_s": a["ttft_s"],
                   "ttft_frac": a["ttft_frac"],
                   "itl_worst_gap_s": a["itl_worst_gap_s"],
                   "tree": cp.format_span_tree(t)}
                  for t, a in with_ttft[:max(0, worst_k)]],
    }
    if chrome and with_ttft:
        out["chrome_path"] = cp.export_chrome(with_ttft[0][0], chrome)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("path", help="trace JSONL file or tracer dir")
    ap.add_argument("--worst", type=int, default=1, metavar="K",
                    help="show the K worst-TTFT traces as span trees")
    ap.add_argument("--chrome", default=None, metavar="OUT.json",
                    help="export the worst trace as chrome-trace JSON")
    ap.add_argument("--json", action="store_true",
                    help="emit the whole report as JSON instead of text")
    args = ap.parse_args(argv)

    traces = cp.load_trace_dir(args.path)
    if not traces:
        print(f"no traces under {args.path}", file=sys.stderr)
        return 1
    rep = report(traces, worst_k=args.worst, chrome=args.chrome)

    if args.json:
        print(json.dumps(rep))
        return 0
    print(f"{rep['n_traces']} traces "
          f"({rep['n_with_ttft']} with a measured TTFT)\n")
    print(cp.format_table(rep["aggregate"]))
    for w in rep["worst"]:
        print()
        print(w["tree"])
    if "chrome_path" in rep:
        print(f"\nchrome trace -> {rep['chrome_path']}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
