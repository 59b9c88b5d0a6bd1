"""Donation audit: which named inputs a call updates in place
(counterpart of ``paddle_tpu/analysis/donation.py``).

JAX records buffer donation as the compiled module's input/output alias
table; a dropped donation doubles the memory of what was threaded
(params and optimizer state in training, KV pools and the speculation
history in serving) without failing a numerics test. The eager
counterpart of a donated buffer is an in-place update: the call writes
the input's own storage and keeps no copy of what it held. From the
census (``analysis.collectives``: each op's in-place writes with their
storage, each out-of-place copy's source, and the storage each named
input held before and after the call):

* ``aliased`` — the named inputs written in place (label, shape, bytes),
  with ``donated_bytes`` as the budget-floor metric;
* ``undonated_candidates`` — named inputs the call could have updated in
  place and did not: REPLACED by a new tensor of the same shape and
  dtype (their storage changed between before and after), or written in
  place after the call copied
  them whole (the copy is the second buffer an undonated input is:
  ``Trainer(donate=False)``'s pre-step state). Read-only inputs are
  neither. The budget file's waivers name the ones kept on purpose.

Labels are the builder's (``params['...']``, ``opt_state[...]``,
``pools[i][j]``, ``hist``), so reports name the Python-level input.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

__all__ = ["DonationCandidate", "donation_report"]


@dataclass
class DonationCandidate:
    label: str
    shape: str
    bytes: int
    why: str            # "replaced" or "copied"

    def describe(self) -> str:
        return f"{self.label} ({self.shape}, {self.bytes:,} B, {self.why})"


def donation_report(census) -> Dict:
    """In-place facts + undonated candidates of the census's named
    inputs."""
    first_write: Dict = {}
    for i, op in enumerate(census.ops):
        for key, _leaf in op.mutated:
            if key is not None:
                first_write.setdefault(key, i)
    copied = set()
    for i, op in enumerate(census.ops):
        if op.copied is not None and i < first_write.get(op.copied, -1):
            copied.add(op.copied)

    aliased, candidates = [], []
    for label, rec in sorted(census.inputs.items()):
        key = rec.before
        moved = rec.after is not None and rec.after != key
        # replaced by a new tensor it could have been written into
        replaced = moved and rec.after_leaf == rec.leaf
        written = key is not None and key in first_write and not moved
        if written and key not in copied:
            aliased.append({"label": label, "shape": str(rec.leaf),
                            "bytes": rec.leaf.bytes, "kind": "in-place"})
        elif replaced or written:
            candidates.append(DonationCandidate(
                label, str(rec.leaf), rec.leaf.bytes,
                "replaced" if replaced else "copied"))
    candidates.sort(key=lambda c: -c.bytes)
    return {
        "aliased": aliased,
        "aliased_param_count": len(aliased),
        "donated_bytes": sum(a["bytes"] for a in aliased),
        "undonated_candidates": candidates,
        "undonated_candidate_bytes": sum(c.bytes for c in candidates),
    }
