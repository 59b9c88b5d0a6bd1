"""The kernel-config database and the measured-cost database (counterpart
of ``paddle_tpu/ops/pallas/autotune.py``).

Reference analogue: the PHI runtime autotuner —
paddle/phi/kernels/autotune/auto_tune_base.h, cache.h — plus CINN's
persistent tuning DB. Tuning is offline and its result a JSON database
consulted at dispatch time, keyed as in the JAX package:

    key = op | device_kind | dtype | bucketed shape signature

``device_kind`` is the card's name (``torch.cuda.get_device_name``), or
"cpu" without a card (``observability.costs.current_device_kind``). A user-writable overlay (``PT_TUNE_DB``, else
``~/.cache/paddle_tpu_torch/tune_db.json``) is merged over the shipped
file, and the same for :class:`OpCostDB` (``PT_OP_COST_DB``). The shipped
files hold only entries measured on the port's card, or nothing: no entry
the JAX package measured on a TPU is copied.

What reads them: :func:`paged_decode_crossover` (the serving engine's
dense/paged decode choice, key ``paged_decode_crossover``) and the
sharding planner (the calibration probe's ``graph:train_step_k1``
dispatch floor and ``dot`` records, ``tools/op_cost_probe.py``). The
JAX package's block-size lookups (``flash_attention_config``,
``fused_vocab_ce_config``) pick Pallas block sizes; the port's kernels
have fixed tiles, so those lookups raise (ROADMAP.md B.4).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SHIPPED = os.path.join(_HERE, "tune_db.json")
_COST_SHIPPED = os.path.join(_HERE, "op_cost_db.json")


def _user_dir() -> str:
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "paddle_tpu_torch")


def _user_db_path() -> str:
    return os.environ.get("PT_TUNE_DB") or os.path.join(_user_dir(),
                                                        "tune_db.json")


def _user_cost_db_path() -> str:
    return os.environ.get("PT_OP_COST_DB") or os.path.join(
        _user_dir(), "op_cost_db.json")


class TuneDB:
    """Merged shipped + user kernel-config database.

    ``shipped_path`` / ``user_path`` parameterize the two merge sources so
    the sibling :class:`OpCostDB` shares the load/merge/corrupt-warning
    machinery."""

    #: human label used in the corrupt-file warning
    db_label = "kernel tune DB"

    def __init__(self, shipped_path: Optional[str] = None,
                 user_path: Optional[str] = None):
        self._db: Dict[str, dict] = {}
        self._loaded = False
        self._dirty = False
        self._shipped_path = shipped_path or _SHIPPED
        self._user_path = user_path

    def user_path(self) -> str:
        # resolved per call: an environment variable set after import wins
        return self._user_path or _user_db_path()

    def _load(self):
        if self._loaded:
            return
        for path in (self._shipped_path, self.user_path()):
            try:
                with open(path) as f:
                    self._db.update(json.load(f))
            except OSError:
                pass      # absent DB is normal (no offline sweep run yet)
            except ValueError as e:
                # corrupt JSON: merging nothing SILENTLY would make
                # offline-tuned configs vanish without a trace — say so once
                import warnings
                warnings.warn(
                    f"ignoring corrupt {self.db_label} at {path} ({e}); "
                    f"offline-tuned configs from that file will not be "
                    f"applied", RuntimeWarning, stacklevel=2)
        self._loaded = True

    def reload(self):
        """Forget what was read; the next lookup reads the files again."""
        self._db, self._loaded = {}, False

    @staticmethod
    def bucket(n: int) -> int:
        """Round up to the next power of two (min 128)."""
        b = 128
        while b < n:
            b <<= 1
        return b

    @staticmethod
    def key(op: str, device_kind: str, dtype: str, **dims) -> str:
        sig = ",".join(f"{k}={TuneDB.bucket(v) if k.startswith('s') else v}"
                       for k, v in sorted(dims.items()))
        return f"{op}|{device_kind.lower().replace(' ', '_')}|{dtype}|{sig}"

    def lookup(self, key: str) -> Optional[dict]:
        self._load()
        return self._db.get(key)

    def record(self, key: str, config: dict):
        self._load()
        self._db[key] = config
        self._dirty = True

    def save(self, path: Optional[str] = None):
        path = path or self.user_path()
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        # merge-over-existing so concurrent tuners don't clobber each other
        merged = {}
        try:
            with open(path) as f:
                merged = json.load(f)
        except (OSError, ValueError):
            pass
        merged.update(self._db)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(merged, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        self._dirty = False


_DB = TuneDB()


def get_db() -> TuneDB:
    return _DB


def paged_decode_crossover(default: int = 0) -> int:
    """Context length (tokens) at or below which the serving engine
    decodes through the dense route: a tuned value (op
    "paged_decode_crossover", config key "ctx") for this device kind in
    the TuneDB, else ``default``."""
    from ...observability.costs.device_db import current_device_kind
    key = TuneDB.key("paged_decode_crossover", current_device_kind(), "any")
    hit = _DB.lookup(key)
    if hit:
        try:
            return int(hit["ctx"])
        except (KeyError, ValueError, TypeError):
            pass
    return default


def _no_block_choice(name: str):
    raise NotImplementedError(
        f"{name}: the JAX package's lookup picks Pallas block sizes; the "
        f"port's kernels have fixed tiles and read no tuned block size "
        f"(ROADMAP.md B.4)")


def flash_attention_config(sq: int, sk: int, d: int, dtype: str,
                           causal: bool):
    """Raises: the port's flash kernels take no block size (B.4)."""
    _no_block_choice("flash_attention_config")


def fused_vocab_ce_config(n: int, h: int, v: int, dtype: str):
    """Raises: the port's vocab-CE kernels take no block size (B.4)."""
    _no_block_choice("fused_vocab_ce_config")


class OpCostDB(TuneDB):
    """Measured-latency database the calibration probe writes
    (``python -m paddle_tpu_torch.tools.op_cost_probe --calibrate``) and
    the sharding planner reads: ``graph:<name>|<device_kind>|any|``
    records a graph's min-of-rounds seconds and its dispatch floor,
    ``dot|<device_kind>|<dtype>|k=...,m=...,n=...`` a matmul shape's
    microbench seconds. The JAX package's keys, so its planner's lookups
    read the port's files unchanged."""

    db_label = "op cost DB"

    def __init__(self, user_path: Optional[str] = None):
        super().__init__(shipped_path=_COST_SHIPPED, user_path=user_path)

    def user_path(self) -> str:
        return self._user_path or _user_cost_db_path()

    @staticmethod
    def graph_key(name: str, device_kind: str) -> str:
        return TuneDB.key(f"graph:{name}", device_kind, "any")

    @staticmethod
    def dot_key(m: int, k: int, n: int, dtype: str,
                device_kind: str) -> str:
        return TuneDB.key("dot", device_kind, dtype, m=m, k=k, n=n)


_COST_DB = OpCostDB()


def get_op_cost_db() -> OpCostDB:
    return _COST_DB


__all__ = ["TuneDB", "get_db", "flash_attention_config",
           "fused_vocab_ce_config", "paged_decode_crossover",
           "OpCostDB", "get_op_cost_db"]
