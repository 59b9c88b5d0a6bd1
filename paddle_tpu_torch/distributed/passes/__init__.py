"""``distributed.passes`` (counterpart of
``paddle_tpu/distributed/passes``): the pass registry's shape, with the
JAX package's pass names. A pass rewrites a static program in the
reference; here the strategy's knobs (amp, recompute, sharding, the
pipeline schedule) select the same transformations in eager PyTorch, so
``apply`` validates, records itself in the context and changes nothing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

__all__ = ["new_pass", "PassManager", "PassContext"]

_KNOWN = {
    "auto_parallel_amp", "auto_parallel_fp16", "auto_parallel_recompute",
    "auto_parallel_sharding", "auto_parallel_grad_clip",
    "auto_parallel_gradient_merge", "auto_parallel_pipeline",
    "auto_parallel_sequence_parallel_optimization",
    "auto_parallel_supplement_explicit_dependencies",
    "pipeline_scheduler_FThenB", "pipeline_scheduler_1F1B",
    "pipeline_scheduler_VPP", "fuse_all_reduce",
    "allreduce_matmul_grad_overlapping", "fused_attention", "fused_feedforward",
}


class PassContext:
    def __init__(self):
        self.attrs: Dict = {}


class _Pass:
    def __init__(self, name: str, attrs: Optional[Dict] = None):
        self.name = name
        self.attrs = dict(attrs or {})
        self.applied = False

    def apply(self, main_programs, startup_programs=None, context=None):
        """Record the application in ``context`` (module docstring)."""
        self.applied = True
        if context is not None:
            context.attrs.setdefault("applied_passes", []).append(self.name)
        return context

    def __repr__(self):
        return f"Pass(name={self.name!r}, applied={self.applied})"


def new_pass(name: str, pass_attrs: Optional[Dict] = None) -> _Pass:
    if name not in _KNOWN:
        raise ValueError(f"unknown pass {name!r}; known: {sorted(_KNOWN)}")
    return _Pass(name, pass_attrs)


class PassManager:
    def __init__(self, passes: Optional[List[_Pass]] = None):
        self.passes = list(passes or [])
        self.context = PassContext()

    def append(self, p: _Pass) -> None:
        self.passes.append(p)

    def apply(self, main_programs, startup_programs=None) -> PassContext:
        for p in self.passes:
            p.apply(main_programs, startup_programs, self.context)
        return self.context

    @property
    def names(self) -> List[str]:
        return [p.name for p in self.passes]
