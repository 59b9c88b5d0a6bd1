"""Hybrid-parallel auto-tuner (counterpart of
``paddle_tpu/distributed/auto_tuner.py``; reference:
python/paddle/distributed/auto_tuner/{tuner.py:21,search.py,prune.py,
recorder.py}): black-box search over parallelism degrees + micro-batch with
pruning rules and a history recorder, used to hit the throughput target
without hand-tuning.

The rules: tp ("mp") stays within one host's NVLink domain (at most 8
cards) and divides the attention heads; the fsdp axis stands for the
sharding stages; pp multiplies microbatches; the memory model counts
parameters, gradients and optimizer state sharded by (fsdp, tp, pp) plus
activations scaled by the microbatch and recompute. The arithmetic is
JAX's; the default memory is one H100's.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import time
from typing import Callable, Dict, List, Optional

__all__ = ["TunerConfig", "AutoTuner", "Recorder", "default_candidates",
           "prune_by_memory", "estimate_memory_gb"]


@dataclasses.dataclass
class TunerConfig:
    """Search-space description (reference tuner_cfg yaml subset)."""
    num_devices: int = 8
    model_params_b: float = 8.0          # billions of parameters
    hidden_size: int = 4096
    num_layers: int = 32
    seq_len: int = 4096
    global_batch_size: int = 64
    vocab_size: int = 128256
    hbm_gb_per_device: float = 80.0      # one H100 80GB HBM3
    dtype_bytes: int = 2                 # bf16 params
    dp_degree: Optional[List[int]] = None        # "auto" → None
    mp_degree: Optional[List[int]] = None
    pp_degree: Optional[List[int]] = None
    sharding_degree: Optional[List[int]] = None  # fsdp axis
    micro_batch_size: Optional[List[int]] = None
    use_recompute: List[bool] = dataclasses.field(
        default_factory=lambda: [False, True])
    max_trials: int = 50
    metric: str = "tokens_per_sec"       # higher is better


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def default_candidates(cfg: TunerConfig) -> List[Dict]:
    """Cartesian candidates with degree-product and batch divisibility
    constraints (reference search.py all_configs + prune.py rules)."""
    n = cfg.num_devices
    dps = cfg.dp_degree or _divisors(n)
    mps = cfg.mp_degree or [d for d in _divisors(n) if d <= 8]
    pps = cfg.pp_degree or _divisors(min(n, cfg.num_layers))
    shs = cfg.sharding_degree or _divisors(n)
    mbs = cfg.micro_batch_size or [1, 2, 4, 8]
    out = []
    for dp, mp, pp, sh, mb, rc in itertools.product(
            dps, mps, pps, shs, mbs, cfg.use_recompute):
        if dp * mp * pp * sh != n:
            continue
        if cfg.num_layers % pp != 0:
            continue
        # data-batch divisibility: gbs = dp*sh * mb * accum
        replicas = dp * sh
        if cfg.global_batch_size % (replicas * mb) != 0:
            continue
        accum = cfg.global_batch_size // (replicas * mb)
        if pp > 1 and accum < pp:      # pipe needs >= pp microbatches to fill
            continue
        out.append({"dp_degree": dp, "mp_degree": mp, "pp_degree": pp,
                    "sharding_degree": sh, "micro_batch_size": mb,
                    "use_recompute": rc, "accumulate_steps": accum})
    return out


def estimate_memory_gb(cfg: TunerConfig, cand: Dict) -> float:
    """Per-device HBM model (reference prune.py prune_by_memory_estimation):
    params/grads (bf16) + master/adam state (fp32 m,v,master) sharded over
    fsdp*mp*pp, plus activation memory per microbatch."""
    P = cfg.model_params_b * 1e9
    shard = cand["sharding_degree"] * cand["mp_degree"] * cand["pp_degree"]
    weights = P * cfg.dtype_bytes / shard
    grads = P * cfg.dtype_bytes / shard
    opt = P * 12 / (cand["sharding_degree"] * cand["mp_degree"]
                    * cand["pp_degree"])  # fp32 master+m+v
    # activations per layer ~ s*b*h*(34 + 5*a*s/h) bytes/token heuristic
    # (Megatron activation-memory formula, bf16) over the layers resident on
    # this pp stage, divided by tp; recompute keeps ~1 layer live
    b = cand["micro_batch_size"]
    s = cfg.seq_len
    h = cfg.hidden_size
    layers_here = cfg.num_layers / cand["pp_degree"]
    act_per_layer = s * b * h * 34 * cfg.dtype_bytes / 2 / cand["mp_degree"]
    live_layers = 1 if cand["use_recompute"] else layers_here
    acts = act_per_layer * live_layers
    # pp keeps up to pp microbatch activations in flight
    acts *= min(cand["pp_degree"], cand["accumulate_steps"])
    logits = b * s * cfg.vocab_size * 4 / cand["mp_degree"]
    return (weights + grads + opt + acts + logits) / 1e9


def prune_by_memory(cfg: TunerConfig, cands: List[Dict],
                    headroom: float = 0.9) -> List[Dict]:
    return [c for c in cands
            if estimate_memory_gb(cfg, c) <= cfg.hbm_gb_per_device * headroom]


def _comm_cost_key(cfg: TunerConfig, cand: Dict) -> float:
    """Cheap ranking heuristic for trial ordering (reference sorts history
    neighbors first; with no history we order by modeled comm volume):
    tp allreduces activations every layer (expensive, prefer small tp),
    fsdp allgathers weights once per step, pp adds bubble overhead."""
    tp_cost = cand["mp_degree"] ** 0.8
    bubble = (cand["pp_degree"] - 1) / max(cand["accumulate_steps"], 1)
    fsdp_cost = 0.05 * math.log2(max(cand["sharding_degree"], 1) + 1)
    rc_cost = 0.3 if cand["use_recompute"] else 0.0
    return tp_cost + bubble + fsdp_cost + rc_cost


class Recorder:
    """Trial history with the best so far (reference recorder.py)."""

    def __init__(self, metric: str = "tokens_per_sec", higher_better=True):
        self.metric = metric
        self.higher_better = higher_better
        self.history: List[Dict] = []

    def add(self, cand: Dict, result: Optional[float], error: str = ""):
        self.history.append({"config": dict(cand), "metric": result,
                             "error": error, "ts": time.time()})

    def best(self) -> Optional[Dict]:
        ok = [h for h in self.history if h["metric"] is not None]
        if not ok:
            return None
        return (max if self.higher_better else min)(
            ok, key=lambda h: h["metric"])

    def save(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"metric": self.metric, "history": self.history,
                       "best": self.best()}, f, indent=2, default=str)


class AutoTuner:
    """Drive candidate generation → prune → trial loop (reference tuner.py).

        tuner = AutoTuner(cfg)
        best = tuner.tune(run_fn)   # run_fn(config_dict) -> metric or raises
    """

    def __init__(self, cfg: TunerConfig):
        self.cfg = cfg
        self.recorder = Recorder(cfg.metric)
        cands = default_candidates(cfg)
        cands = prune_by_memory(cfg, cands)
        cands.sort(key=lambda c: _comm_cost_key(cfg, c))
        self.candidates = cands[:cfg.max_trials]

    def tune(self, run_fn: Callable[[Dict], float],
             log_path: Optional[str] = None) -> Optional[Dict]:
        for cand in self.candidates:
            try:
                metric = run_fn(cand)
                self.recorder.add(cand, float(metric))
            except Exception as e:  # OOM / compile failure → recorded, skipped
                self.recorder.add(cand, None, error=str(e))
            if log_path:
                self.recorder.save(log_path)
        best = self.recorder.best()
        return best["config"] if best else None
