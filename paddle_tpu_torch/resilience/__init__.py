"""paddle_tpu_torch.resilience — the fault-tolerant training runtime
(counterpart of ``paddle_tpu/resilience``).

* :class:`CheckpointManager` — periodic + on-demand saves with an atomic
  commit marker, manifest checksums, quarantine, retention, and
  retry-with-backoff;
* :class:`PreemptionGuard` — SIGTERM/SIGINT → final synchronous checkpoint
  at the next step boundary → exit with :data:`RESUMABLE_EXIT_CODE`;
* :class:`AnomalyGuard` — NaN/Inf + EWMA loss-spike detection driving
  skip / rollback-to-checkpoint / abort policies with bounded budgets.

``Trainer.fit(..., checkpoint_manager=..., resume="auto")`` wires all three
into the step loop. Resharding on restore (``load_resharded``,
``check_feasible``) comes with ROADMAP.md A.5; the plan sidecar's
``read_plan`` / ``write_plan`` are here.

Preemption and anomaly are stdlib-only; :class:`CheckpointManager` (which
pulls torch through the storage layer) loads lazily.
"""

from .anomaly import AnomalyGuard, DivergenceError
from .preemption import (RESUMABLE_EXIT_CODE, PreemptionGuard,
                         TrainingPreempted, exit_resumable)

__all__ = ["CheckpointManager", "CheckpointCorruption", "PreemptionGuard",
           "TrainingPreempted", "RESUMABLE_EXIT_CODE", "exit_resumable",
           "AnomalyGuard", "DivergenceError", "read_plan", "PLAN_NAME"]

_RESHARD_NAMES = ("read_plan", "write_plan", "effective_axes", "PLAN_NAME")


def __getattr__(name):
    if name in ("CheckpointManager", "CheckpointCorruption"):
        from . import checkpoint_manager as _cm
        return getattr(_cm, name)
    if name in _RESHARD_NAMES:
        from . import reshard as _rs
        return getattr(_rs, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
