"""Materialization audit: which buffers one call allocates (counterpart
of ``paddle_tpu/analysis/materialization.py``).

The port's wins are *absence* properties too: the fused CE head means no
[N, V] logits buffer exists anywhere in the step, blockwise kernels keep
working sets O(block), and absences are what refactors silently destroy.
The JAX pass walks the optimized HLO's instruction results; this one
walks the census's op outputs (``analysis.collectives``): every buffer an
aten op or an allocation returns, and every buffer a hand-written
kernel's wrapper returns (what the kernel writes on the card; the plain
route's working set beneath it is not the kernel's). Views and in-place
results are no new buffers.

* ``banned_buffers`` — shapes matching a declarative rule (last dim ==
  V, the other dims multiplying to N: the logits signature), each with
  the op that produced it;
* ``largest_buffers`` — the top-k biggest outputs, the number a byte
  budget pins.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

__all__ = ["BanRule", "BufferHit", "materialization_report",
           "banned_buffers"]


@dataclass(frozen=True)
class BanRule:
    """Declarative buffer ban: an array whose LAST dim equals ``last_dim``
    and whose remaining dims multiply to ``leading_product`` — with
    ``last_dim=V`` and ``leading_product=B*S`` this is precisely "a
    logits tensor materialized". Dtype-blind by default; an explicit
    ``dtype`` (XLA element-type name, e.g. "f32") narrows the ban to
    that element type."""
    last_dim: int
    leading_product: int
    label: str = "banned"
    dtype: Optional[str] = None

    def matches(self, dims: Sequence[int],
                dtype: Optional[str] = None) -> bool:
        if self.dtype is not None and dtype is not None \
                and dtype != self.dtype:
            return False
        if len(dims) < 2 or dims[-1] != self.last_dim:
            return False
        prod = 1
        for d in dims[:-1]:
            prod *= d
        return prod == self.leading_product


@dataclass
class BufferHit:
    shape: str
    bytes: int
    index: int          # the op's place in the census
    op_name: str

    def describe(self) -> str:
        return (f"{self.shape} ({self.bytes:,} B) <- op {self.index} "
                f"{self.op_name}")


def _buffers(census):
    for i, op in enumerate(census.ops):
        for leaf in op.outputs:
            yield i, op, leaf
    for op in census.allocs:
        for leaf in op.outputs:
            yield -1, op, leaf


def banned_buffers(census, rules: Sequence[BanRule]) -> List[BufferHit]:
    """All buffers matching any ban rule, largest first."""
    hits: List[BufferHit] = []
    for i, op, leaf in _buffers(census):
        if any(r.matches(leaf.dims, leaf.dtype) for r in rules):
            hits.append(BufferHit(str(leaf), leaf.bytes, i, op.name))
    hits.sort(key=lambda h: -h.bytes)
    return hits


def materialization_report(census, rules: Sequence[BanRule] = (),
                           top_k: int = 5) -> Dict:
    """Summary the contract checker and budget snapshots consume."""
    largest = [BufferHit(str(leaf), leaf.bytes, i, op.name)
               for i, op, leaf in _buffers(census)]
    largest.sort(key=lambda h: -h.bytes)
    return {
        "largest_intermediate_bytes": largest[0].bytes if largest else 0,
        "largest_buffers": [h.describe() for h in largest[:top_k]],
        "banned": banned_buffers(census, rules),
    }
