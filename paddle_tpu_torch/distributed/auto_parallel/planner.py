"""Sharding planner: enumerate, price, and emit the fastest 5D config
(counterpart of ``paddle_tpu/distributed/auto_parallel/planner.py``).

1. **Enumerate** (:func:`enumerate_configs`) — every legal
   ``(dp, fsdp, tp, pp, sep[, ep])`` factorization of the declared
   device count, legality meaning model divisibility (JAX's rules).
2. **Prune** — the closed-form per-card memory model
   (:mod:`memory_model`) before a config earns a census.
3. **Price** (:func:`price_config`) — each survivor's real training step
   (the port's ``Trainer`` over the sharded model) is dispatched once, as
   rank 0 of a world of N ranks that needs neither N processes nor N
   cards: ``torch.distributed``'s fake backend and the ``meta`` device,
   in a child process (``python -m
   paddle_tpu_torch.distributed.auto_parallel._price``) so the caller's
   process group is never replaced; one child prices every candidate of
   one N. Its op stream is the census (``analysis.collectives``): each
   aten op's flops and bytes, each hand-written kernel's own counts, and
   each collective with its bytes and mesh axis. There is deliberately
   no second model of the model: the planner prices the ops the step
   dispatches. The fake backend's collectives move no data, so a MoE
   candidate is priced under balanced routing (a capacity factor of 1:
   no host read of routing counts), its ep all-to-all derated by
   :func:`ep_imbalance` of a measured histogram.
4. **Emit** (:mod:`emit`) — the winner becomes a ``ShardingPlan`` that
   ``Trainer.apply_plan`` consumes.

The formula is JAX's: Σ over ops of max(flops ÷ peak, bytes ÷ memory
bandwidth) + the per-axis priced comm + the collective floor × count +
the dispatch floor. The measured terms come from the
:class:`~paddle_tpu_torch.ops.kernels.autotune.OpCostDB` under the JAX
package's keys (``python -m paddle_tpu_torch.tools.op_cost_probe
--calibrate`` writes them): the train step's per-dispatch host floor
(``graph:train_step_k1``) and each census matmul shape the probe has
timed (``dot``), which replaces that shape's analytical time.

The cost model watches itself: :func:`plan` consults the
``pt_step_time_predicted_over_measured`` drift gauge (the trainer's
and the serving engine's ``observability.costs.CostWatch`` publish it)
and the OpCostDB calibration's age — ``drift="warn"`` annotates the
report, ``drift="refuse"`` raises :class:`StaleCostModelError`.

Prediction convention: serialized upper bound. The acceptance bar is
RANK ORDER against measured step times (:func:`validate_rank_order`,
which builds each ranked config over the live world and times real
steps), not absolute error.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "ParallelConfig", "PricedGraph", "PricedConfig", "PlanReport",
    "StaleCostModelError", "InfeasibleMeshError", "enumerate_configs",
    "price_compiled", "price_config", "plan", "rank_agreement",
    "check_drift", "measure_compiled", "validate_rank_order",
    "ep_imbalance", "census_configs",
]

# per-collective launch floor (seconds): tiny-payload collectives are
# latency-bound, not bandwidth-bound, so bytes ÷ bw alone would call a
# 60-collective step free. Kept SMALL by design (the JAX package's
# values), below the compute signal.
COLLECTIVE_FLOOR_S = {"cpu": 2e-6, "default": 1e-6}

#: acceptable band for the pt_step_time_predicted_over_measured gauge —
#: wide because the serialized roofline legitimately over/under-shoots
#: on overlap-heavy or dispatch-heavy programs; outside
#: it the cost tables themselves are suspect
DRIFT_BAND = (0.2, 5.0)

#: OpCostDB graph records older than this are stale for drift purposes
CALIBRATION_MAX_AGE_S = 30 * 86400.0


class StaleCostModelError(RuntimeError):
    """The drift gauge says the cost tables disagree with reality beyond
    the band — a plan ranked with them would be noise."""


class InfeasibleMeshError(RuntimeError):
    """No legal config fits the declared mesh (wrong device count, or
    every factorization failed the HBM model)."""


@dataclass(frozen=True)
class ParallelConfig:
    """One point in the 5D search space (axis vocabulary of
    ``parallel/mesh.py AXES_ORDER``; ``fsdp`` is ZeRO-3 — params, slots
    and grads sharded over the axis by FSDP2, batch over ``dp×fsdp`` —
    and ``ep`` shards experts over a subgroup of the data ranks: it
    divides ``dp`` rather than multiplying the device count, so ``size``
    is ep-invariant)."""
    dp: int = 1
    tp: int = 1
    pp: int = 1
    sep: int = 1
    fsdp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        # ep carves a subgroup out of dp — it never adds devices
        return self.dp * self.fsdp * self.tp * self.pp * self.sep

    def axes(self) -> Dict[str, int]:
        return {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp,
                "pp": self.pp, "sep": self.sep, "ep": self.ep}

    def __str__(self) -> str:
        # the fsdp/ep segments appear only when the axis is real — plan
        # artifacts, graph-budget pins and elastic sidecars from before
        # the axes existed keep parsing AND printing byte-identically
        fs = f"fsdp{self.fsdp}_" if self.fsdp > 1 else ""
        e = f"ep{self.ep}_" if self.ep > 1 else ""
        return f"dp{self.dp}_{fs}{e}tp{self.tp}_pp{self.pp}_sep{self.sep}"

    @staticmethod
    def parse(s: str) -> "ParallelConfig":
        """Inverse of ``str()`` (also accepts ``dp2xtp2`` / ``dp=2,tp=2``
        forms so the CLI stays forgiving)."""
        import re
        out = {"dp": 1, "tp": 1, "pp": 1, "sep": 1, "fsdp": 1, "ep": 1}
        # the lookbehind keeps the 'dp' inside 'fsdp4' (and the 'ep'
        # inside 'sep2') from matching as a degree of the shorter name
        for m in re.finditer(
                r"(?<![a-z])(fsdp|dp|tp|pp|sep|ep)\s*=?\s*(\d+)",
                s.lower()):
            out[m.group(1)] = int(m.group(2))
        return ParallelConfig(**out)


def _divisors(n: int) -> List[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def enumerate_configs(n_devices: int, model_cfg=None, *,
                      global_batch: int = 8, seq_len: int = 32,
                      max_pp: Optional[int] = None,
                      include_sep: bool = True,
                      include_pp: bool = True,
                      include_fsdp: bool = True,
                      include_ep: bool = True) -> List[ParallelConfig]:
    """Every legal ``(dp, fsdp, tp, pp, sep[, ep])`` with
    ``dp*fsdp*tp*pp*sep == n_devices``. Legality against ``model_cfg``
    (a LlamaConfig shape):

    * ``tp`` divides attention heads, KV heads, intermediate and vocab
      (column/row-parallel projections + vocab-parallel CE);
    * ``fsdp`` divides the hidden size (every projection/embedding is
      annotated with the axis on its H dimension) and, jointly with
      ``dp``, the global batch (batch spec is ``("dp","fsdp")``);
    * ``pp`` divides the layer count (stage stacking), and the
      per-data-rank batch must hold ≥2 microbatches;
    * ``sep`` divides the sequence (ring/GSPMD seq sharding) and the
      KV-head count (the ring exchanges head-sharded KV blocks);
    * ``dp`` divides the global batch;
    * ``ep`` (enumerated only for MoE models — ``model_cfg`` exposes
      ``num_experts``) divides ``dp`` (the expert subgroup is carved out
      of the data ranks, never extra devices) and the expert count, and
      composes with neither ``pp`` nor ``sep`` yet (stated exclusions,
      like pp×sep).

    Without a ``model_cfg`` only the factorization + batch constraints
    apply (the CLI's ``--no-model`` exploration mode); ep stays 1 there
    because its legality is inherently a model property.
    """
    out: List[ParallelConfig] = []
    for dp in _divisors(n_devices):
        if global_batch % dp:
            continue
        rest0 = n_devices // dp
        for fsdp in _divisors(rest0):
            if fsdp > 1 and not include_fsdp:
                continue
            if global_batch % (dp * fsdp):
                continue
            rest1 = rest0 // fsdp
            for tp in _divisors(rest1):
                rest2 = rest1 // tp
                for pp in _divisors(rest2):
                    if not include_pp and pp > 1:
                        continue
                    if max_pp is not None and pp > max_pp:
                        continue
                    sep = rest2 // pp
                    if sep > 1 and not include_sep:
                        continue
                    cfg = ParallelConfig(dp=dp, fsdp=fsdp, tp=tp, pp=pp,
                                         sep=sep)
                    if model_cfg is not None and not _legal(
                            cfg, model_cfg, global_batch, seq_len):
                        continue
                    out.append(cfg)
                    # ep variants: only meaningful for MoE models, and
                    # only dp-divisor degrees — size is ep-invariant so
                    # these share the same device factorization
                    if (include_ep and model_cfg is not None
                            and getattr(model_cfg, "num_experts", 0)):
                        import dataclasses as _dc
                        for ep in _divisors(dp):
                            if ep == 1:
                                continue
                            cfg_ep = _dc.replace(cfg, ep=ep)
                            if _legal(cfg_ep, model_cfg, global_batch,
                                      seq_len):
                                out.append(cfg_ep)
    # stable, human-sensible order: least exotic first
    out.sort(key=lambda c: (c.pp, c.sep, c.fsdp, c.tp, c.dp, c.ep))
    return out


def _legal(cfg: ParallelConfig, m, global_batch: int,
           seq_len: int) -> bool:
    if cfg.tp > 1:
        if (m.num_attention_heads % cfg.tp
                or m.num_key_value_heads % cfg.tp
                or m.intermediate_size % cfg.tp
                or m.vocab_size % cfg.tp):
            return False
    if cfg.fsdp > 1:
        # every fsdp annotation of the Llama lands on the hidden
        # dimension (qkv/gate_up dim0, o/down/embed dim1, lm_head dim0),
        # so H-divisibility is the whole sharding constraint; the batch
        # constraint comes from the ("dp","fsdp") batch spec
        if (m.hidden_size % cfg.fsdp
                or global_batch % (cfg.dp * cfg.fsdp)):
            return False
    if cfg.pp > 1:
        if m.num_hidden_layers % cfg.pp:
            return False
        # the pipe candidate runs num_microbatches=2, so the
        # per-data-rank (dp×fsdp) batch must split into 2 microbatches
        # exactly
        per_dp = global_batch // (cfg.dp * cfg.fsdp)
        if per_dp < 2 or per_dp % 2:
            return False
    if cfg.sep > 1:
        if seq_len % cfg.sep or m.num_key_value_heads % cfg.sep:
            return False
    if cfg.pp > 1 and cfg.sep > 1:
        # pipe stage stacking and the seq-parallel ring are separately
        # tested but their composition is not a supported scenario
        return False
    if cfg.tp > 1 and getattr(m, "num_experts", 0):
        # expert FFN weights carry the tp annotation on their
        # moe_intermediate dimension
        if getattr(m, "moe_intermediate_size", 0) % cfg.tp:
            return False
    if cfg.ep > 1:
        n_exp = int(getattr(m, "num_experts", 0) or 0)
        # the expert subgroup is carved out of the data ranks and must
        # split the expert set evenly across its members
        if not n_exp or n_exp % cfg.ep or cfg.dp % cfg.ep:
            return False
        # explicit composition exclusions, stated like pp×sep: neither
        # the pipe stage stacker nor the sep ring carries the expert
        # all-to-all yet
        if cfg.pp > 1 or cfg.sep > 1:
            return False
    return True


def _port_refuses(cfg: ParallelConfig, m, seq_len: int) -> str:
    """Why the port cannot run a config that JAX's rules allow ("" when
    it can), stated like :func:`_legal`'s exclusions: such a config is
    pruned with this reason before any census."""
    if cfg.pp > 1 and getattr(m, "num_experts", 0):
        return "pp with experts: the port has no pipelined MoE model"
    if cfg.pp > 1 and cfg.fsdp > 1:
        return ("pp with fsdp: the pipelined step runs its stages outside "
                "the root module's forward, so FSDP2 never gathers the "
                "root unit (ROADMAP.md A.4b)")
    if cfg.sep > 1:
        from ...parallel.ring_attention import check_blocks
        try:
            check_blocks(seq_len // cfg.sep, m.num_attention_heads,
                         m.num_key_value_heads, m.head_dim)
        except (ValueError, NotImplementedError) as e:
            return f"sep: {e}"
    return ""


# ---------------------------------------------------------------------------
# pricing
# ---------------------------------------------------------------------------

def ep_imbalance(histogram, ep: int) -> float:
    """Bottleneck factor for the expert all-to-all from a MEASURED
    per-expert token histogram (the routing-entropy term).

    With tokens uniformly spread over source ranks, the *fraction* of
    tokens crossing shards is 1−1/ep regardless of expert popularity —
    skew shows up instead on the bottleneck link: a2a completion time is
    set by the busiest destination shard. Group the histogram into
    ``ep`` contiguous expert shards (the ep-axis layout of the expert
    dimension); the factor is ``ep × max shard share`` — 1.0 when
    routing is balanced, → ep when one shard absorbs everything.
    Dividing the ep-axis bandwidth by this factor makes
    :func:`price_census` charge the busiest link's bytes."""
    import numpy as np
    h = np.asarray(histogram, dtype=float).ravel()
    if ep <= 1 or h.size == 0 or h.size % ep or h.sum() <= 0:
        return 1.0
    shard_share = h.reshape(ep, h.size // ep).sum(axis=1) / h.sum()
    return float(max(ep * shard_share.max(), 1.0))


@dataclass
class PricedGraph:
    """One step's census, priced: the component terms and their sum."""
    compute_s: float              # per-op max(flops/peak, bytes/hbm_bw)
    comm_s: float                 # priced census bytes ÷ per-axis bw
    collective_floor_s: float     # n_collectives × per-tier launch floor
    dispatch_s: float             # measured per-dispatch host floor
    dot_adjust_s: float           # measured-dot correction (OpCostDB)
    predicted_step_s: float
    census_counts: Dict[str, int]
    census_bytes: int
    priced_census: Dict
    total_flops: float
    total_bytes: float
    notes: List[str] = field(default_factory=list)

    def components(self) -> Dict[str, float]:
        return {"compute_s": self.compute_s, "comm_s": self.comm_s,
                "collective_floor_s": self.collective_floor_s,
                "dispatch_s": self.dispatch_s,
                "dot_adjust_s": self.dot_adjust_s,
                "predicted_step_s": self.predicted_step_s}



def _collective_floor(kind: str) -> float:
    return COLLECTIVE_FLOOR_S["cpu" if "cpu" in kind.lower()
                              else "default"]


def _db_dispatch_floor(db, kind: str) -> Tuple[float, List[str]]:
    """Measured per-dispatch host floor: the train step's floor from the
    calibration probe, when this device kind has been calibrated."""
    notes: List[str] = []
    if db is None:
        return 0.0, notes
    from ...ops.kernels.autotune import OpCostDB
    rec = db.lookup(OpCostDB.graph_key("train_step_k1", kind))
    if not rec:
        notes.append(f"OpCostDB has no graph calibration for "
                     f"'{kind}' — dispatch floor 0, analytical only "
                     f"(run python -m paddle_tpu_torch.tools.op_cost_probe "
                     f"--calibrate)")
        return 0.0, notes
    return float(rec.get("dispatch_floor_s", 0.0)), notes


def _db_dispatch_per_op(db, kind: str) -> Optional[float]:
    """The eager port's host floor per dispatched op (the probe's
    enqueue seconds of its micro step over that step's census op
    count), when the calibration recorded one."""
    if db is None:
        return None
    from ...ops.kernels.autotune import OpCostDB
    rec = db.lookup(OpCostDB.graph_key("train_step_k1", kind)) or {}
    per_op = rec.get("dispatch_floor_per_op_s")
    return None if per_op is None else float(per_op)


def _dot_adjust(db, dots, spec) -> float:
    """Measured-dot correction: each matmul shape the calibration probe
    timed on this device kind replaces its analytical 2mkn ÷ peak."""
    if db is None:
        return 0.0
    from ...ops.kernels.autotune import OpCostDB
    adjust = 0.0
    for m_dim, k, n, dtype, count in dots:
        rec = db.lookup(OpCostDB.dot_key(m_dim, k, n, dtype, spec.kind))
        if rec and rec.get("t_s"):
            analytical = 2.0 * m_dim * k * n / spec.peak_flops
            adjust += (float(rec["t_s"]) - analytical) * count
    return adjust


def _record_census(record: Dict):
    """(op list, collective census) of a child's census record."""
    from ...analysis.collectives import CollectiveInstr, OpCost
    ops = []
    for name, fl, nb, kern, count in record["ops"]:
        ops += [OpCost(name, fl, nb, bool(kern))] * int(count)
    table = [CollectiveInstr(c["opcode"], int(c["bytes"]),
                             tuple(c["ranks"]), c["axis"], c["op_name"])
             for c in record["collectives"]]
    counts: Dict[str, int] = {}
    bytes_by_op: Dict[str, int] = {}
    for c in table:
        key = f"{c.opcode}[{c.axis}]" if c.axis != "?" else c.opcode
        counts[key] = counts.get(key, 0) + 1
        bytes_by_op[c.opcode] = bytes_by_op.get(c.opcode, 0) + c.bytes
    return ops, {"table": table, "counts": dict(sorted(counts.items())),
                 "bytes_by_op": dict(sorted(bytes_by_op.items())),
                 "total_collectives": len(table),
                 "total_collective_bytes": sum(c.bytes for c in table)}


class _Ops:
    def __init__(self, ops, dots=()):
        self.ops = ops
        self.dots = {(int(m), int(k), int(n), dt): int(c)
                     for m, k, n, dt, c in dots}


#: mesh axes whose collectives run once a step, after a pipeline drains
#: (the gradient sums): every other collective runs in each tick
_STEP_AXES = frozenset({"dp", "fsdp", "ep"})


def _once_a_step(axis: str) -> bool:
    return bool(set(axis.split("+")) & _STEP_AXES)


def price_compiled(census, mesh=None, *, spec=None,
                   bandwidths: Optional[Dict[str, float]] = None,
                   db=None, dispatch_floor_s: Optional[float] = None,
                   collective_floor_s: Optional[float] = None
                   ) -> PricedGraph:
    """Price ONE step's census: an ``analysis.collectives.StepCensus``
    (its collectives classified over ``mesh``, a ``HybridMesh``), or the
    record a census child returns (:func:`census_configs`). The shared
    core under :func:`price_config`.

    ``bandwidths`` maps mesh-axis name → bytes/s for the census pricing
    (axes it doesn't name fall back to ``spec.link_bw``); a synthetic
    table therefore yields EXACT arithmetic. ``db`` (an ``OpCostDB``)
    supplies the measured dispatch floor when ``dispatch_floor_s`` is
    None, and the measured-dot correction of the census's matmul shapes
    (as JAX's; the sum is floored at 0 before comm is added). An eager
    step enqueues each op from the host, so where the calibration holds
    a floor per dispatched op, the floor is that times the priced
    stage's op count (its ticks included); else the micro step's floor,
    as JAX adds its one dispatch.

    A pipeline record (``pp`` > 1) holds the census of the first and of
    the last stage, each over its M microbatches. A stage's tick is its
    work for one microbatch; the step is M + S - 1 ticks of the slower
    stage (idle ones included, as JAX's compiled pipeline prices every
    tick): that stage's compute, and its collectives other than the
    once-a-step gradient sums over dp / fsdp (the stage exchanges and
    the tensor-parallel sums among them), times (M + S - 1) / M."""
    from ...analysis.collectives import collective_census
    from ...observability.costs import (attribute_costs, device_spec,
                                        price_census)
    spec = spec or device_spec()
    notes: List[str] = []
    per_op = None
    if dispatch_floor_s is None:
        dispatch_floor_s, db_notes = _db_dispatch_floor(db, spec.kind)
        notes += db_notes
        per_op = _db_dispatch_per_op(db, spec.kind)
    if collective_floor_s is None:
        collective_floor_s = _collective_floor(spec.kind)
    stages, scale = [], 1.0
    if isinstance(census, dict):
        stages.append(_record_census(census) + (census.get("dots", []),))
        pipe = census.get("pipeline")
        if pipe:
            S, M = int(pipe["stages"]), int(pipe["microbatches"])
            scale = (M + S - 1) / M
            last = pipe["last_stage"]
            stages.append(_record_census(last) + (last.get("dots", []),))
    else:
        stages.append((census.ops, collective_census(census, mesh=mesh),
                       [(*k, c) for k, c in census.dots.items()]))
    best = None
    for i, (ops, coll, dots) in enumerate(stages):
        report = attribute_costs(_Ops(ops, dots), spec=spec)
        priced = price_census(coll, bandwidths=bandwidths, spec=spec)
        dot_adjust = _dot_adjust(db, report.dots, spec) * scale
        compute_s = report.compute_s
        comm_s = priced["total_comm_s"]
        floor_s = coll["total_collectives"] * collective_floor_s
        if scale != 1.0:
            once = [_once_a_step(c["axis"]) for c in priced["per_op"]]
            tick_comm = sum(c["seconds"] for c, o in
                            zip(priced["per_op"], once) if not o)
            compute_s *= scale
            comm_s = tick_comm * scale + (comm_s - tick_comm)
            floor_s = ((len(once) - sum(once)) * scale + sum(once)) \
                * collective_floor_s
        # compute/memory roofline WITHOUT the comm term — comm is priced
        # per axis by the census
        total = max(compute_s + dot_adjust, 0.0) + comm_s + floor_s
        if best is None or total > best[0]:
            best = (total, i, compute_s, comm_s, floor_s, report, coll,
                    priced, dot_adjust)
    (total, i, compute_s, comm_s, floor_s, report, coll, priced,
     dot_adjust) = best
    if scale != 1.0:
        notes.append(f"pipeline: {S} stages, {M} microbatches: "
                     f"{M + S - 1} ticks of the "
                     f"{'last' if i else 'first'} stage")
    if per_op is not None:
        dispatch_floor_s = per_op * len(report.ops) * scale
        notes.append(f"dispatch floor: {per_op:.3e} s an op x "
                     f"{len(report.ops)} ops")
    return PricedGraph(
        compute_s=compute_s, comm_s=comm_s, collective_floor_s=floor_s,
        dispatch_s=dispatch_floor_s, dot_adjust_s=dot_adjust,
        predicted_step_s=total + dispatch_floor_s,
        census_counts=dict(coll["counts"]),
        census_bytes=int(coll["total_collective_bytes"]),
        priced_census=priced, total_flops=report.total_flops,
        total_bytes=report.total_bytes, notes=notes)


@dataclass
class CandidateBuild:
    """One config built over the live world (``validate_rank_order``
    times the step it priced)."""
    model: object
    mesh: object
    trainer: object
    batch: Dict


@dataclass
class PricedConfig:
    config: ParallelConfig
    feasible: bool
    memory: Optional[object] = None          # MemoryEstimate
    graph: Optional[PricedGraph] = None
    predicted_step_s: float = math.inf
    predicted_mfu: float = 0.0
    hbm_high_water_bytes: float = 0.0
    plan: Optional[object] = None            # emit.ShardingPlan
    measured_step_s: Optional[float] = None
    reason: str = ""

    def as_dict(self) -> Dict:
        out = {"config": str(self.config), "axes": self.config.axes(),
               "feasible": self.feasible,
               "predicted_step_s": self.predicted_step_s,
               "predicted_mfu": self.predicted_mfu,
               "hbm_high_water_bytes": self.hbm_high_water_bytes,
               "reason": self.reason}
        if self.memory is not None:
            out["memory"] = self.memory.as_dict()
        if self.graph is not None:
            out["components"] = self.graph.components()
            out["census_counts"] = self.graph.census_counts
            out["census_bytes"] = self.graph.census_bytes
        if self.measured_step_s is not None:
            out["measured_step_s"] = self.measured_step_s
        if self.plan is not None:
            out["plan"] = self.plan.as_dict()
        return out


def _cfg_payload(model_cfg) -> Dict:
    import dataclasses
    kind = "moe" if getattr(model_cfg, "num_experts", 0) else "llama"
    return {"kind": kind, "fields": dataclasses.asdict(model_cfg)}


#: seconds the census children may take for one N (every candidate)
CENSUS_TIMEOUT_S = 900
#: the most census children of one N that run side by side
CENSUS_CHILDREN = 4


def census_configs(model_cfg, configs: Sequence[ParallelConfig], n: int,
                   *, global_batch: int, seq_len: int) -> Dict[str, Dict]:
    """Take each config's census in a child process (``python -m
    paddle_tpu_torch.distributed.auto_parallel._price``): a fake world
    of ``n`` ranks, the model on the meta device, one training step of
    rank 0 (and of the last stage's rank for a pipeline). The configs
    are dealt to up to :data:`CENSUS_CHILDREN` children, one for each
    two CPU cores, run side by side. Returns ``{str(config): record}``;
    a record holds ``ops``, ``collectives``, ``flops_per_token``,
    ``plan`` (the emitted ``ShardingPlan.as_dict()``) and, for a
    pipeline, ``pipeline``; or ``error``."""
    names = [str(c) for c in configs]
    k = max(1, min(len(names), CENSUS_CHILDREN, (os.cpu_count() or 2) // 2))
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [root, os.environ.get("PYTHONPATH", "")]))
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "PADDLE_TRAINER_ID", "PADDLE_TRAINERS_NUM"):
        env.pop(key, None)
    procs = []
    for i in range(k):
        req = {"model": _cfg_payload(model_cfg), "n": int(n),
               "configs": names[i::k], "global_batch": int(global_batch),
               "seq_len": int(seq_len)}
        proc = subprocess.Popen(
            [sys.executable, "-m",
             "paddle_tpu_torch.distributed.auto_parallel._price"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, env=env)
        procs.append((proc, json.dumps(req)))
    out, errors = {}, []
    try:
        with ThreadPoolExecutor(k) as ex:
            done = list(ex.map(lambda pr: pr[0].communicate(
                pr[1], timeout=CENSUS_TIMEOUT_S), procs))
        for (proc, _), (stdout, stderr) in zip(procs, done):
            for line in stdout.splitlines():
                if line.startswith("CENSUS "):
                    rec = json.loads(line[len("CENSUS "):])
                    out[rec["config"]] = rec
            if proc.returncode:
                errors.append(f"census child exited {proc.returncode}: "
                              f"{stderr[-600:]}")
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for c in names:
        out.setdefault(c, {"config": c, "error": "; ".join(errors) or
                           "the census child printed no record"})
    return out


def price_config(config: ParallelConfig, model_cfg, *, devices=None,
                 global_batch: int = 8, seq_len: int = 32,
                 bandwidths: Optional[Dict[str, float]] = None,
                 spec=None, db=None,
                 dispatch_floor_s: Optional[float] = None,
                 collective_floor_s: Optional[float] = None,
                 hbm_budget_bytes: Optional[float] = None,
                 keep_build: bool = False,
                 check_memory: bool = True,
                 moe_histogram=None, record: Optional[Dict] = None
                 ) -> PricedConfig:
    """Memory-gate, census and price ONE config; emit its plan.
    Infeasible configs return without paying a census. ``record`` is the
    config's census when :func:`plan` took it already (one child for
    every candidate of one N). ``devices``, when given, lists the ranks
    or cards available. ``keep_build`` is accepted for the JAX
    signature: :func:`validate_rank_order` builds over the live world.

    ``moe_histogram`` — measured per-expert token counts. For ep>1
    configs the expert all-to-all is priced from it: the ep-axis
    bandwidth fed to ``price_census`` is divided by
    :func:`ep_imbalance`, so skewed routing raises the predicted price
    (the balanced-routing census cannot see data-dependent skew)."""
    from ...observability.costs import device_spec
    from .emit import ShardingPlan
    from .memory_model import estimate_hbm

    spec = spec or device_spec()
    imb = 1.0
    if moe_histogram is not None and config.ep > 1:
        imb = ep_imbalance(moe_histogram, config.ep)
        bandwidths = dict(bandwidths or {})
        bandwidths["ep"] = bandwidths.get("ep", spec.link_bw) / imb
    mem = None
    if check_memory:
        mem = estimate_hbm(model_cfg, config, global_batch=global_batch,
                           seq_len=seq_len, budget_bytes=hbm_budget_bytes,
                           device_kind=spec.kind)
        if not mem.feasible:
            return PricedConfig(
                config=config, feasible=False, memory=mem,
                hbm_high_water_bytes=mem.total_bytes,
                reason=(f"HBM infeasible: needs "
                        f"{mem.total_bytes / 2**30:.2f} GiB/chip, budget "
                        f"{mem.budget_bytes / 2**30:.2f} GiB"))
    if devices is not None and config.size > len(list(devices)):
        return PricedConfig(
            config=config, feasible=False, memory=mem,
            reason=f"needs {config.size} devices, {len(list(devices))} "
                   f"available")
    refused = _port_refuses(config, model_cfg, seq_len)
    if refused:
        return PricedConfig(config=config, feasible=False, memory=mem,
                            reason=f"not run by the port: {refused}")
    if record is None:
        record = census_configs(model_cfg, [config], config.size,
                                global_batch=global_batch,
                                seq_len=seq_len)[str(config)]
    if record.get("error"):
        raise RuntimeError(record["error"])
    graph = price_compiled(record, spec=spec, bandwidths=bandwidths,
                           db=db, dispatch_floor_s=dispatch_floor_s,
                           collective_floor_s=collective_floor_s)
    if imb > 1.0:
        graph.notes.append(
            f"ep all-to-all priced from measured routing histogram: "
            f"bottleneck imbalance ×{imb:.3f} on the ep axis")
    # MFU from the model's own flop count over every card's peak
    tokens = global_batch * seq_len
    model_flops = record["flops_per_token"] * tokens
    mfu = model_flops / (config.size * spec.peak_flops
                         * graph.predicted_step_s) \
        if graph.predicted_step_s > 0 else 0.0
    return PricedConfig(
        config=config, feasible=True, memory=mem, graph=graph,
        predicted_step_s=graph.predicted_step_s, predicted_mfu=mfu,
        hbm_high_water_bytes=(mem.total_bytes if mem is not None
                              else 0.0),
        plan=ShardingPlan.from_dict(record["plan"]))


# ---------------------------------------------------------------------------
# drift: the planner consults the cost model's own health signal
# ---------------------------------------------------------------------------

def check_drift(band: Tuple[float, float] = DRIFT_BAND,
                db=None, now: Optional[float] = None) -> Dict:
    """Is the cost model currently trustworthy?

    Two signals, both advisory by design (``plan(drift=...)`` decides
    what to do with them):

    * the live ``pt_step_time_predicted_over_measured`` gauge (the
      trainer's and the serving engine's ``CostWatch`` publish it) —
      any published component outside ``band`` means the roofline is
      actively disagreeing with the wall clock;
    * OpCostDB calibration age — graph records older than
      ``CALIBRATION_MAX_AGE_S`` (or absent for this device kind) can't
      anchor measured floors.

    Returns ``{"status": "ok"|"stale"|"uncalibrated", "ratios": {...},
    "notes": [...]}`` — "stale" is the refusal-grade verdict, absence of
    evidence ("uncalibrated") only warns.
    """
    from ...observability.metrics import REGISTRY
    ratios: Dict[str, float] = {}
    notes: List[str] = []
    status = "ok"
    try:
        for row in REGISTRY.collect():
            if row.get("name") != "pt_step_time_predicted_over_measured":
                continue
            comp = row.get("labels", {}).get("component", "?")
            v = float(row.get("value", 0.0))
            ratios[comp] = v
            if v and not (band[0] <= v <= band[1]):
                status = "stale"
                notes.append(
                    f"drift gauge component={comp}: predicted/measured "
                    f"= {v:.3g} outside [{band[0]}, {band[1]}] — "
                    f"recalibrate (tools/op_cost_probe.py --calibrate) "
                    f"before trusting this plan")
    except Exception:
        pass
    if status == "ok" and db is not None:
        from ...observability.costs import device_spec
        from ...ops.kernels.autotune import OpCostDB
        rec = db.lookup(OpCostDB.graph_key("train_step_k1",
                                           device_spec().kind))
        if rec is None:
            status = "uncalibrated"
            notes.append("no OpCostDB calibration for this device kind; "
                         "pricing is analytical-only")
        else:
            try:
                cap = time.mktime(time.strptime(rec["captured_at"],
                                                "%Y-%m-%dT%H:%M:%S"))
                age = (now if now is not None else time.time()) - cap
                if age > CALIBRATION_MAX_AGE_S:
                    status = "uncalibrated"
                    notes.append(f"OpCostDB calibration is "
                                 f"{age / 86400:.0f} days old")
            except (KeyError, ValueError):
                pass
    return {"status": status, "ratios": ratios, "notes": notes}


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

@dataclass
class PlanReport:
    """The full planning result: ranked table + chosen plan + the drift
    verdict the ranking was produced under."""
    n_devices: int
    mesh_shape: str
    device: Dict
    model: str
    global_batch: int
    seq_len: int
    ranked: List[PricedConfig] = field(default_factory=list)
    pruned: List[PricedConfig] = field(default_factory=list)
    drift: Dict = field(default_factory=dict)
    notes: List[str] = field(default_factory=list)
    validation: Optional[Dict] = None

    @property
    def chosen(self) -> Optional[PricedConfig]:
        return self.ranked[0] if self.ranked else None

    def table(self, top: Optional[int] = None) -> str:
        rows = self.ranked[:top] if top else self.ranked
        lines = [f"{'config':<24} {'pred step':>12} {'pred MFU':>9} "
                 f"{'HBM GiB':>8} {'comm':>10} {'collectives':>11}"]
        for pc in rows:
            g = pc.graph
            lines.append(
                f"{str(pc.config):<24} "
                f"{pc.predicted_step_s * 1e3:>10.3f}ms "
                f"{pc.predicted_mfu:>9.4f} "
                f"{pc.hbm_high_water_bytes / 2**30:>8.3f} "
                f"{(g.comm_s * 1e6 if g else 0):>8.1f}us "
                f"{(sum(g.census_counts.values()) if g else 0):>11}")
        for pc in self.pruned:
            lines.append(f"{str(pc.config):<24} PRUNED: {pc.reason}")
        return "\n".join(lines)

    def as_dict(self) -> Dict:
        return {
            "schema": "pt-shard-plan-v1",
            "n_devices": self.n_devices, "mesh_shape": self.mesh_shape,
            "device": self.device, "model": self.model,
            "global_batch": self.global_batch, "seq_len": self.seq_len,
            "drift": self.drift, "notes": self.notes,
            "ranked": [pc.as_dict() for pc in self.ranked],
            "pruned": [pc.as_dict() for pc in self.pruned],
            "chosen": (str(self.chosen.config) if self.chosen else None),
            **({"validation": self.validation} if self.validation
               else {}),
        }

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as f:
            json.dump(self.as_dict(), f, indent=1, sort_keys=True,
                      default=float)
            f.write("\n")
        return path


def plan(model_cfg, *, n_devices: Optional[int] = None, devices=None,
         mesh_shape: str = "", global_batch: int = 8, seq_len: int = 32,
         configs: Optional[Sequence[ParallelConfig]] = None,
         bandwidths: Optional[Dict[str, float]] = None, spec=None,
         db=None, drift: str = "warn",
         hbm_budget_bytes: Optional[float] = None,
         dispatch_floor_s: Optional[float] = None,
         collective_floor_s: Optional[float] = None,
         keep_builds: bool = False,
         model_name: str = "llama",
         moe_histogram=None) -> PlanReport:
    """Enumerate → prune → census → price → rank → emit.

    ``n_devices`` is the mesh to plan (no card or process of it is
    needed: the census runs a fake world); without it, ``devices`` (a
    list of the ranks or cards available), else the live world's size
    (``torch.distributed``), else 1. ``drift`` — "warn" (annotate +
    warnings.warn), "refuse" (raise :class:`StaleCostModelError` when
    the drift gauge is out of band), or "ignore". Raises
    :class:`InfeasibleMeshError` when the mesh can't host any legal
    config, or declares more devices than ``devices`` holds."""
    from ...observability.costs import device_spec, get_op_cost_db
    from .memory_model import estimate_hbm

    if drift not in ("warn", "refuse", "ignore"):
        raise ValueError(f"drift must be warn|refuse|ignore, got "
                         f"{drift!r}")
    spec = spec or device_spec()
    if db is None:
        db = get_op_cost_db()
    if n_devices:
        n = int(n_devices)
    elif devices is not None:
        n = len(list(devices))
    else:
        import torch.distributed as dist
        n = dist.get_world_size() if dist.is_initialized() else 1
    if devices is not None and n > len(list(devices)):
        raise InfeasibleMeshError(
            f"mesh declares {n} devices but only {len(list(devices))} "
            f"exist")

    drift_verdict = {"status": "ignored", "ratios": {}, "notes": []}
    if drift != "ignore":
        drift_verdict = check_drift(db=db)
        if drift_verdict["status"] == "stale":
            msg = "; ".join(drift_verdict["notes"])
            if drift == "refuse":
                raise StaleCostModelError(msg)
            warnings.warn(f"sharding planner: {msg}", RuntimeWarning,
                          stacklevel=2)

    cand = list(configs) if configs is not None else enumerate_configs(
        n, model_cfg, global_batch=global_batch, seq_len=seq_len)
    if not cand:
        raise InfeasibleMeshError(
            f"no legal (dp,fsdp,tp,pp,sep) factorization of {n} devices "
            f"for this model/batch (global_batch={global_batch}, "
            f"seq_len={seq_len})")

    report = PlanReport(
        n_devices=n, mesh_shape=mesh_shape or str(n),
        device=spec.as_dict(), model=model_name,
        global_batch=global_batch, seq_len=seq_len,
        drift=drift_verdict, notes=list(drift_verdict["notes"]))

    kw = dict(global_batch=global_batch, seq_len=seq_len,
              bandwidths=bandwidths, spec=spec, db=db,
              dispatch_floor_s=dispatch_floor_s,
              collective_floor_s=collective_floor_s,
              hbm_budget_bytes=hbm_budget_bytes,
              moe_histogram=moe_histogram, devices=devices)
    survivors = []
    for cfg in cand:
        if cfg.size != n:
            report.pruned.append(PricedConfig(
                config=cfg, feasible=False,
                reason=f"size {cfg.size} != mesh {n}"))
            continue
        mem = estimate_hbm(model_cfg, cfg, global_batch=global_batch,
                           seq_len=seq_len, budget_bytes=hbm_budget_bytes,
                           device_kind=spec.kind)
        if not mem.feasible or _port_refuses(cfg, model_cfg, seq_len):
            report.pruned.append(price_config(cfg, model_cfg, **kw))
            continue
        survivors.append(cfg)
    # one census child for every surviving candidate of this N
    records = (census_configs(model_cfg, survivors, n,
                              global_batch=global_batch, seq_len=seq_len)
               if survivors else {})
    for cfg in survivors:
        try:
            pc = price_config(cfg, model_cfg, record=records[str(cfg)],
                              **kw)
        except Exception as e:       # a config whose step fails is
            pc = PricedConfig(       # pruned evidence, not a crash
                config=cfg, feasible=False,
                reason=f"census failed: {type(e).__name__}: "
                       f"{str(e)[:200]}")
        (report.ranked if pc.feasible else report.pruned).append(pc)

    report.ranked.sort(key=lambda pc: pc.predicted_step_s)
    if not report.ranked:
        raise InfeasibleMeshError(
            "every candidate config was pruned:\n"
            + "\n".join(f"  {pc.config}: {pc.reason}"
                        for pc in report.pruned))
    return report


# ---------------------------------------------------------------------------
# rank-order validation (the acceptance bar)
# ---------------------------------------------------------------------------

def rank_agreement(predicted: Sequence[float],
                   measured: Sequence[float],
                   rel_eps: float = 0.05) -> float:
    """Pairwise (Kendall tau-b-style) concordance between two
    orderings: fraction of index pairs ordered the same way. 1.0 =
    identical order, 0.5 = uncorrelated, 0.0 = reversed.

    Pairs within ``rel_eps`` relative distance in EITHER list are
    statistical ties and drop out of the denominator (tau-b's tie
    handling): min-of-rounds ordering between two configs 1% apart is
    noise, and a cost model should be judged on the orderings it
    actually asserts."""
    assert len(predicted) == len(measured)
    n = len(predicted)
    if n < 2:
        return 1.0

    def _sign(a: float, b: float) -> int:
        if abs(a - b) <= rel_eps * max(abs(a), abs(b)):
            return 0
        return 1 if a > b else -1

    agree = total = 0
    for i in range(n):
        for j in range(i + 1, n):
            sp = _sign(predicted[i], predicted[j])
            sm = _sign(measured[i], measured[j])
            if sp == 0 or sm == 0:
                continue
            total += 1
            agree += (sp == sm)
    return agree / total if total else 1.0


def measure_compiled(step, args=(), *, rounds: int = 3, iters: int = 2,
                     warmup: int = 1) -> float:
    """Min-of-rounds per-call seconds of ``step(*args)`` (the
    bench-variance policy: mins over rounds beat means on a noisy host),
    the card synchronized after each round."""
    import torch

    def _sync():
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    for _ in range(max(0, warmup)):
        step(*args)
    _sync()
    best = float("inf")
    for _ in range(max(1, rounds)):
        t0 = time.perf_counter()
        for _ in range(max(1, iters)):
            step(*args)
        _sync()
        best = min(best, (time.perf_counter() - t0) / max(1, iters))
    return best


def build_live(model_cfg, config, plan_, global_batch: int, seq_len: int,
               device: str, seed: int = 0) -> CandidateBuild:
    """``config`` built over the live world by ``plan_`` (its
    ``ShardingPlan``): the model (weights drawn from ``seed``, the same
    on every rank) sharded, AdamW, a Trainer and a global batch."""
    import dataclasses
    import torch
    from ...device import generator
    from ...models.llama import LlamaForCausalLM, LlamaForCausalLMPipe
    from ...models.moe_lm import MoEForCausalLM
    from ...optimizer import AdamW
    from ...trainer import Trainer
    is_moe = bool(getattr(model_cfg, "num_experts", 0))
    mcfg = model_cfg if is_moe else dataclasses.replace(
        model_cfg, sequence_parallel=config.sep > 1)
    g = generator(seed, device)
    if config.pp > 1:
        model = LlamaForCausalLMPipe(mcfg, num_stages=config.pp,
                                     num_microbatches=2, device=device,
                                     generator=g)
    elif is_moe:
        model = MoEForCausalLM(mcfg, device=device, generator=g)
    else:
        model = LlamaForCausalLM(mcfg, device=device, generator=g)
    hm = plan_.apply(model, devices=torch.device(device).type)
    tr = Trainer(model, AdamW(learning_rate=1e-3, parameters=model))
    ids = torch.randint(0, mcfg.vocab_size, (global_batch, seq_len + 1),
                        generator=generator(seed, "cpu")).to(device)
    return CandidateBuild(model=model, mesh=hm, trainer=tr,
                          batch={"input_ids": ids[:, :-1],
                                 "labels": ids[:, 1:]})


def validate_rank_order(report: PlanReport, model_cfg=None, *,
                        rounds: int = 4, iters: int = 2,
                        device: Optional[str] = None) -> Dict:
    """MEASURE every ranked config and compare the predicted ordering
    with the measured one. Collective over the live world, whose size
    is the report's: every rank calls it (under the port's launcher).
    Each config is built over the world by its plan (``model_cfg``,
    weights from a seed), its real steps timed as min-of-rounds, and
    freed before the next config is built (two builds at Llama-3-8B
    widths need not fit a card together, so rounds are not interleaved
    across configs as in JAX). Rank 0's times are the verdict's. Returns
    the verdict dict: pairwise agreement, whether the predicted winner
    lands in the measured top 2, and the per-config table."""
    import gc
    import torch
    import torch.distributed as dist
    if model_cfg is None:
        raise ValueError("validate_rank_order needs the model_cfg the "
                         "report was planned for")
    device = device or ("cuda" if torch.cuda.is_available() else "cpu")
    rows = [pc for pc in report.ranked if pc.plan is not None]
    best = [float("inf")] * len(rows)
    for i, pc in enumerate(rows):
        b = build_live(model_cfg, pc.config, pc.plan, report.global_batch,
                       report.seq_len, device)
        with b.mesh:
            b.trainer.train_step(b.batch)            # warmup, off-clock
            for _ in range(max(1, rounds)):
                gc.collect()
                if dist.is_initialized():
                    dist.barrier()
                best[i] = min(best[i], measure_compiled(
                    lambda: b.trainer.train_step(b.batch), rounds=1,
                    iters=iters, warmup=0))
        del b
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    for pc, t in zip(rows, best):
        pc.measured_step_s = t
    if len(rows) < 2:
        return {"n_configs": len(rows), "agreement": 1.0,
                "top1_is_measured_top2": 1.0,
                "note": "fewer than 2 measurable configs"}
    pred = [pc.predicted_step_s for pc in rows]
    meas = [pc.measured_step_s for pc in rows]
    agreement = rank_agreement(pred, meas)
    pred_best = min(range(len(rows)), key=lambda i: pred[i])
    meas_rank = sorted(range(len(rows)), key=lambda i: meas[i])
    # "within the measured top 2", with a 10% near-tie tolerance at the
    # boundary: min-of-rounds ordering between statistical ties is
    # arbitrary, and a binary acceptance row must not flap on it
    top2_cut = meas[meas_rank[min(1, len(rows) - 1)]] * 1.10
    top1_ok = (pred_best in meas_rank[:2]
               or meas[pred_best] <= top2_cut)
    verdict = {
        "n_configs": len(rows),
        "agreement": round(agreement, 4),
        "top1_is_measured_top2": 1.0 if top1_ok else 0.0,
        "predicted_best": str(rows[pred_best].config),
        "measured_best": str(rows[meas_rank[0]].config),
        "table": [{"config": str(pc.config),
                   "predicted_s": pc.predicted_step_s,
                   "measured_s": pc.measured_step_s} for pc in rows],
    }
    report.validation = verdict
    return verdict
