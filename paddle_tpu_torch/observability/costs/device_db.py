"""Device capability tables: peak FLOP/s, memory bandwidth and link
bandwidth a card (counterpart of
``paddle_tpu/observability/costs/device_db.py``).

The H100 row is NVIDIA's H100 SXM data sheet (dense bf16 989 TFLOP/s,
HBM3 3.35 TB/s; ``parallel.projection.H100``). Its link bandwidth is a
measurement: the all-gather bus bandwidth across the four H100 80GB HBM3
cards (700 W) of one host that ``tools/mesh_check.py`` measured,
308.86 GB/s a card; :func:`device_spec` takes another as
``link_bw=``. Every lookup falls back to a nominal CPU tier, so the
planner runs (and its tests hold) where there is no card: absolute
predictions are then meaningless, ratios are not.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

__all__ = ["DeviceSpec", "device_spec", "current_device_kind",
           "H100_LINK_BW"]

#: bytes/s a card: all-gather bus bandwidth over 4 H100s of one host
#: (tools/mesh_check.py on the card; PERF.md)
H100_LINK_BW = 308.86e9

_PEAK = {"h100": 989e12, "cpu": 1e12}
_HBM = {"h100": 3.35e12, "cpu": 50e9}
_LINK = {"h100": H100_LINK_BW, "cpu": 10e9}


@dataclass(frozen=True)
class DeviceSpec:
    kind: str
    peak_flops: float        # bf16 FLOP/s per card
    hbm_bw: float            # bytes/s per card
    link_bw: float           # bytes/s per card over one mesh axis

    def as_dict(self) -> Dict[str, float]:
        return {"kind": self.kind, "peak_flops": self.peak_flops,
                "hbm_bw": self.hbm_bw, "link_bw": self.link_bw}


def current_device_kind(default: str = "cpu") -> str:
    """The card's name (``torch.cuda.get_device_name``), or ``default``
    without one."""
    import torch
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(torch.cuda.current_device())
    return default


def _match(table: Dict[str, float], kind: str, fallback: float) -> float:
    kind = kind.lower()
    best, best_len = None, -1
    for k, v in table.items():
        if k in kind and len(k) > best_len:
            best, best_len = v, len(k)
    return best if best is not None else fallback


def device_spec(kind: Optional[str] = None,
                link_bw: Optional[float] = None) -> DeviceSpec:
    """Spec for ``kind`` (defaults to this process's card), the nominal
    CPU tier as the fallback; ``link_bw`` overrides the table's."""
    kind = kind or current_device_kind()
    return DeviceSpec(
        kind=kind, peak_flops=_match(_PEAK, kind, _PEAK["cpu"]),
        hbm_bw=_match(_HBM, kind, _HBM["cpu"]),
        link_bw=float(link_bw) if link_bw else _match(_LINK, kind,
                                                      _LINK["cpu"]))
