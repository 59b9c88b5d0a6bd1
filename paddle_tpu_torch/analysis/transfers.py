"""Host-sync detector for hot calls (counterpart of
``paddle_tpu/analysis/transfers.py``).

The JAX train superstep and serving tick exist so that nothing in them
talks to the host; one stray ``io_callback`` or infeed reintroduces a
device->host fence per step, and no numerics test notices. The eager
port's counterparts are the ops that make the host wait for the card:
a scalar read (``.item()``, ``float()`` of a tensor:
``aten._local_scalar_dense``), an op whose output shape depends on the
data (``nonzero``, boolean-mask indexing, ``unique``...), and a copy
from the card to the CPU. The census (``analysis.collectives``) records
each one, beneath a kernel's scope too, with the line of the port that
asked for it, so a failure names the call site.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["host_transfer_report"]


def host_transfer_report(census) -> Dict:
    syncs = [h.describe() for h in census.host_syncs]
    return {"host_syncs": syncs, "host_transfer_count": len(syncs)}
