"""Auto-checkpoint: an epoch-range loop with resume (reference:
python/paddle/base/incubate/checkpoint/auto_checkpoint.py:278
``TrainEpochRange`` / ``train_epoch_range:624`` — periodic snapshots keyed
by a training-state hash, resumed transparently on relaunch; FS abstraction
at fleet/utils/fs.py:113 LocalFS / :447 HDFSClient).

Counterpart of ``paddle_tpu/checkpoint/auto_checkpoint.py``: the
snapshot payload is a ``paddle_tpu_torch.checkpoint`` checkpoint (with
``layout=`` — a sharded model or its ``MeshPlan`` — every rank writes its
own shards, and a resume reads each rank's slice); the epoch cursor and
run identity live in a small JSON sidecar, written by rank 0 of a
``torch.distributed`` world. The FS layer keeps the Local implementation
plus the interface.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Iterator, Optional

from . import load_state_dict, save_state_dict

__all__ = ["FS", "LocalFS", "TrainEpochRange", "train_epoch_range"]


# ---------------------------------------------------------------------------
# FS abstraction (reference fleet/utils/fs.py shape)
# ---------------------------------------------------------------------------

class FS:
    def ls_dir(self, path):  # pragma: no cover - interface
        raise NotImplementedError

    def is_exist(self, path):
        raise NotImplementedError

    def mkdirs(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def mv(self, src, dst):
        raise NotImplementedError


class LocalFS(FS):
    """reference: fleet/utils/fs.py:113"""

    def ls_dir(self, path):
        if not os.path.isdir(path):
            return [], []
        dirs, files = [], []
        for e in os.scandir(path):
            (dirs if e.is_dir() else files).append(e.name)
        return sorted(dirs), sorted(files)

    def is_exist(self, path):
        return os.path.exists(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def mkdirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path, ignore_errors=True)
        elif os.path.exists(path):
            os.remove(path)

    def mv(self, src, dst, overwrite: bool = False):
        if overwrite and os.path.exists(dst):
            self.delete(dst)
        shutil.move(src, dst)

    def touch(self, path):
        open(path, "a").close()


# ---------------------------------------------------------------------------
# TrainEpochRange
# ---------------------------------------------------------------------------

class TrainEpochRange:
    """Resumable epoch loop with periodic state snapshots.

        acp = TrainEpochRange(10, "llama-run", save_dir="ckpt",
                              state_provider=lambda: {"params": p, "opt": o},
                              state_setter=apply_state)
        for epoch in acp.get():
            train_one_epoch()

    On relaunch with the same ``name`` (+ same structural hash), iteration
    resumes after the last checkpointed epoch and ``state_setter`` receives
    the restored tree before the first yielded epoch.
    """

    def __init__(self, max_epoch_num: int, name: str, save_dir: str = "acp",
                 state_provider: Optional[Callable[[], Dict[str, Any]]] = None,
                 state_setter: Optional[Callable[[Dict[str, Any]], None]] = None,
                 save_checkpoint_inter: int = 1, keep_last: int = 2,
                 fs: Optional[FS] = None, layout=None):
        self.max_epoch_num = max_epoch_num
        self.name = name
        self.save_dir = os.path.abspath(save_dir)
        self.state_provider = state_provider
        self.state_setter = state_setter
        self.save_checkpoint_inter = max(1, save_checkpoint_inter)
        self.keep_last = max(1, keep_last)
        self.fs = fs or LocalFS()
        self.layout = layout
        self.restored_from: Optional[int] = None
        self._run_dir = os.path.join(self.save_dir, self._job_hash())

    def _job_hash(self) -> str:
        """Identity of this training run (reference ties snapshots to a
        hash of program+strategy so incompatible code never resumes a stale
        checkpoint): the name and the state's structure (keys, shapes,
        dtypes; on a ``torch.distributed`` world, rank 0's, so that every
        rank names the same run)."""
        h = hashlib.sha1(self.name.encode())
        if self.state_provider is not None:
            try:
                from . import _flatten
                struct = [(k, tuple(getattr(v, "shape", ())),
                           str(getattr(v, "dtype", "")))
                          for k, v in _flatten(self.state_provider())]
                h.update(json.dumps(struct, sort_keys=True).encode())
            except Exception:
                pass
        digest = h.hexdigest()[:16]
        import torch.distributed as dist
        if dist.is_initialized() and dist.get_world_size() > 1:
            box = [digest]
            dist.broadcast_object_list(box, src=0)
            digest = box[0]
        return digest

    @staticmethod
    def _lead() -> bool:
        import torch.distributed as dist
        return not dist.is_initialized() or dist.get_rank() == 0

    # -- persistence -------------------------------------------------------

    def _meta_path(self):
        return os.path.join(self._run_dir, "meta.json")

    def _epoch_dir(self, epoch: int):
        return os.path.join(self._run_dir, f"epoch_{epoch}")

    def _load_meta(self) -> Optional[dict]:
        if not self.fs.is_exist(self._meta_path()):
            return None
        with open(self._meta_path()) as f:
            return json.load(f)

    def _save(self, epoch: int):
        if self.state_provider is None:
            state = {}
        else:
            state = self.state_provider()
        ep_dir = self._epoch_dir(epoch)
        if state:
            save_state_dict(state, ep_dir, layout=self.layout)
        elif self._lead():
            self.fs.mkdirs(ep_dir)
        if not self._lead():
            return
        with open(self._meta_path(), "w") as f:
            json.dump({"name": self.name, "epoch": epoch,
                       "ts": time.time(),
                       "max_epoch_num": self.max_epoch_num}, f)
        # GC old snapshots
        dirs, _ = self.fs.ls_dir(self._run_dir)
        epochs = sorted(int(d.split("_", 1)[1]) for d in dirs
                        if d.startswith("epoch_"))
        for old in epochs[:-self.keep_last]:
            self.fs.delete(self._epoch_dir(old))

    def _restore(self, epoch: int):
        if self.state_provider is None or self.state_setter is None:
            return
        like = self.state_provider()
        if not like:
            return
        restored = load_state_dict(self._epoch_dir(epoch), like,
                                   mesh=self.layout)
        self.state_setter(restored)

    # -- iteration ---------------------------------------------------------

    def get(self) -> Iterator[int]:
        if self._lead():
            self.fs.mkdirs(self._run_dir)
        meta = self._load_meta()
        start = 0
        if meta is not None and meta.get("name") == self.name:
            last = int(meta["epoch"])
            if self.fs.is_exist(self._epoch_dir(last)):
                self._restore(last)
                self.restored_from = last
                start = last + 1
        for epoch in range(start, self.max_epoch_num):
            yield epoch
            if (epoch + 1) % self.save_checkpoint_inter == 0 \
                    or epoch == self.max_epoch_num - 1:
                self._save(epoch)


def train_epoch_range(max_epoch_num: int, name: str = "default",
                      **kwargs) -> Iterator[int]:
    """Functional form (reference auto_checkpoint.py:624
    ``_get_train_epoch_range`` usage)."""
    yield from TrainEpochRange(max_epoch_num, name, **kwargs).get()
