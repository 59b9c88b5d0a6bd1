"""Numerics debugging (counterpart of ``paddle_tpu/amp/debugging.py``):
``TensorCheckerConfig``, ``check_numerics``, ``collect_operator_stats`` /
``record_op_dtype`` and ``compare_accuracy``.

``check_numerics`` is eager: it reads one flag per tensor on the host
and raises or prints. JAX's ``enable_tensor_checker`` also turns on
``jax_debug_nans``, which makes every eager JAX op raise where it makes a
NaN; torch has no such switch, so here the checker acts only where
``check_numerics`` is called.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch

__all__ = ["TensorCheckerConfig", "enable_tensor_checker",
           "disable_tensor_checker", "check_numerics", "DebugMode",
           "collect_operator_stats", "record_op_dtype", "compare_accuracy"]


class DebugMode:
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


@dataclasses.dataclass
class TensorCheckerConfig:
    enable: bool = True
    debug_mode: int = DebugMode.CHECK_NAN_INF_AND_ABORT
    output_dir: Optional[str] = None
    checked_op_list: Optional[list] = None
    skipped_op_list: Optional[list] = None


_checker_abort = False


def enable_tensor_checker(config: TensorCheckerConfig) -> None:
    """Turn the checker on. In ``CHECK_NAN_INF_AND_ABORT`` mode every
    ``check_numerics`` call raises on a NaN or Inf, also one made with
    ``raise_on_nan=False``. Unlike JAX's (``jax_debug_nans``), ops that
    are not checked do not raise: torch has no global NaN trap."""
    global _checker_abort
    _checker_abort = bool(config.enable) and \
        config.debug_mode == DebugMode.CHECK_NAN_INF_AND_ABORT


def disable_tensor_checker() -> None:
    global _checker_abort
    _checker_abort = False


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def check_numerics(x, op_type: str = "", var_name: str = "",
                   raise_on_nan: bool = True):
    """Scan a tensor (or a dict / list / tuple of them) for NaN or Inf;
    raise ``FloatingPointError`` (``raise_on_nan`` or the checker in
    abort mode) or print. Returns ``x`` unchanged:
    ``x = check_numerics(x, "attn", "logits")``."""

    def one(v):
        if not isinstance(v, torch.Tensor) or not v.is_floating_point():
            return v
        if bool(torch.logical_or(torch.isnan(v).any(), torch.isinf(v).any())):
            msg = (f"[check_numerics] nan/inf detected in {op_type or '?'}"
                   f"/{var_name or '?'} shape={tuple(v.shape)}")
            if raise_on_nan or _checker_abort:
                raise FloatingPointError(msg)
            print(msg)
        return v

    return _tree_map(one, x)


class _OpStats:
    def __init__(self):
        self.counts = {"float16": 0, "bfloat16": 0, "float32": 0, "other": 0}

    def record(self, dtype):
        key = str(dtype)
        # bfloat16 before float16: "float16" is a substring of it
        for k in ("bfloat16", "float16", "float32"):
            if k in key:
                self.counts[k] += 1
                return
        self.counts["other"] += 1


_active_stats: Optional[_OpStats] = None


def record_op_dtype(dtype) -> None:
    """Count one op call of ``dtype`` while stats collection is on."""
    if _active_stats is not None:
        _active_stats.record(dtype)


@contextlib.contextmanager
def collect_operator_stats():
    """Count low- and high-precision op calls (``record_op_dtype``) in the
    block, and print the counts on exit."""
    global _active_stats
    _active_stats = _OpStats()
    try:
        yield _active_stats
    finally:
        stats = _active_stats
        _active_stats = None
        total = sum(stats.counts.values())
        print("<------------------------------ op list ------------------"
              "------------>")
        for k, v in stats.counts.items():
            print(f"  {k:<10} calls: {v}")
        print(f"  total      calls: {total}")


def compare_accuracy(dump_path: str, another_dump_path: str,
                     output_filename: str = "compare.csv",
                     loss_scale: float = 1.0, dump_all: bool = False):
    """Compare two runs' tensor dumps (``.npz``) by name: the largest
    absolute and relative difference of each into a CSV; returns the
    rows."""
    import csv

    import numpy as np
    a = np.load(dump_path)
    b = np.load(another_dump_path)
    rows = []
    for k in sorted(set(a.files) & set(b.files)):
        x, y = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        if x.shape != y.shape:
            rows.append((k, "shape_mismatch", x.shape, y.shape, "", ""))
            continue
        diff = np.abs(x - y)
        denom = np.maximum(np.abs(x), 1e-12)
        rows.append((k, "ok", x.shape, y.shape, diff.max(),
                     (diff / denom).max()))
    with open(output_filename, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "status", "shape_a", "shape_b", "max_abs_diff",
                    "max_rel_diff"])
        w.writerows(rows)
    return rows
