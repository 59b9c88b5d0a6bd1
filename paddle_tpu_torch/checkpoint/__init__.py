"""Checkpoint storage (counterpart of ``paddle_tpu/checkpoint/__init__.py``).

The JAX package writes with orbax; here a checkpoint is a directory of
``torch.save`` files of CPU tensors, read back with
``torch.load(weights_only=True, map_location="cpu")``:

    step_N/_TREE.json        the tree's leaves: key -> shard, kind, dtype, shape
    step_N/shard_00000.pt    {key: tensor} for a run of leaves (at most
    step_N/shard_00001.pt    SHARD_BYTES a file, unless one leaf is larger)

Keys are the tree's nested dict keys joined by "/". Leaves that are not
tensors (numpy arrays, Python numbers) are stored as 0-d or n-d tensors
and come back as numpy arrays.

A write goes to ``<path>.pt-tmp-<pid>`` and is renamed to ``path`` once
every shard and the index are durable (the index last), so a directory at
``path`` that holds ``_TREE.json`` is a complete checkpoint.

JAX arrays are immutable; the port's optimizer updates the
parameters, masters and moments in place, so an async save cannot read
them in the background. :func:`save_state_dict` therefore takes the
snapshot synchronously — each tensor copied into a host buffer that the
next async save reuses (pinned for a card tensor), one synchronize before
it returns — and hands only the serialization, the sha256 of each file
and the IO to a background writer thread. The buffers live until a
synchronous save (which writes from plain host copies) or
:meth:`_Writer.release`; a ``CheckpointManager`` releases them when it
closes, and ``Trainer.fit`` when it ends. A background failure is
re-raised by :func:`wait_until_finished` (and by the next save), never
dropped.
"""

from __future__ import annotations

import collections
import hashlib
import json
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_state_dict", "load_state_dict", "wait_until_finished",
           "save_training_state", "load_training_state", "latest_step",
           "is_complete_checkpoint", "file_digests", "INDEX_NAME",
           "SHARD_BYTES"]

INDEX_NAME = "_TREE.json"
_SCHEMA = "pt-torch-ckpt-v1"
TMP_TAG = ".pt-tmp-"
# one file per SHARD_BYTES of leaves: the writer's threads save and hash
# files in parallel, and a restore maps them one at a time
SHARD_BYTES = 1 << 30
WRITE_THREADS = 4


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _flatten(tree, prefix=""):
    """(key, leaf) pairs of a nested dict, keys joined by "/"."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            k = str(k)
            if "/" in k:
                raise ValueError(f"checkpoint key {k!r} holds a '/'")
            yield from _flatten(v, f"{prefix}{k}/")
        return
    yield prefix[:-1], tree


def _unflatten_like(like, leaves: Dict[str, Any], prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, f"{prefix}{k}/")
                for k, v in like.items()}
    return leaves[prefix[:-1]]


class _HashingWriter:
    """A file object for ``torch.save`` that hashes what it writes, so a
    file's sha256 costs no second read."""

    def __init__(self, f):
        self.f = f
        self.sha = hashlib.sha256()

    def write(self, b):
        self.sha.update(b)
        return self.f.write(b)

    def flush(self):
        self.f.flush()


def _write_file(path: str, obj) -> Tuple[int, str]:
    with open(path, "wb") as f:
        w = _HashingWriter(f)
        torch.save(obj, w)
        f.flush()
        os.fsync(f.fileno())
    return os.path.getsize(path), w.sha.hexdigest()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


class _Writer:
    """The background writer: one save in flight at a time, its host
    snapshot in host buffers that the next async save reuses."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._done = threading.Event()
        self._done.set()
        self._buffers: Dict[str, torch.Tensor] = {}
        # (path, {rel: {"size", "sha256"}}) of the last save's files: a
        # manager commits a save before it starts the next one
        self.digests: Tuple[str, Dict[str, Dict[str, Any]]] = ("", {})
        #: one dict a save, newest last: its path, whether it was async,
        #: the seconds of the synchronous snapshot and (once written) of
        #: the write — serialization, sha256 and IO — and its bytes
        self.saves = collections.deque(maxlen=64)

    # -- snapshot -----------------------------------------------------------

    def _host_copy(self, key: str, t: torch.Tensor,
                   reuse: bool) -> torch.Tensor:
        t = t.detach()
        if not reuse:
            return t.to("cpu", copy=True)
        buf = self._buffers.get(key)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = torch.empty(t.shape, dtype=t.dtype,
                              pin_memory=t.device.type == "cuda")
            self._buffers[key] = buf
        buf.copy_(t, non_blocking=True)
        return buf

    def snapshot(self, tree, reuse: bool = False
                 ) -> Tuple[List[Tuple[str, torch.Tensor, str]], float]:
        """Host copies of every leaf, in tree order: (key, tensor, kind),
        kind "tensor" or "value" (a non-tensor leaf). ``reuse`` copies the
        tensors into the writer's buffers (pinned for a card tensor), kept
        for the next async save; else each is a plain host copy. Waits for
        the card's copies before it returns."""
        t0 = time.perf_counter()
        out, devices = [], set()
        for key, leaf in _flatten(tree):
            if isinstance(leaf, torch.Tensor):
                if leaf.device.type == "cuda":
                    devices.add(leaf.device)
                out.append((key, self._host_copy(key, leaf, reuse),
                            "tensor"))
            else:
                arr = np.array(leaf)
                if arr.dtype == object:
                    raise TypeError(f"checkpoint leaf {key!r} is a "
                                    f"{type(leaf).__name__}, not an array")
                out.append((key, torch.from_numpy(arr), "value"))
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        return out, time.perf_counter() - t0

    # -- write --------------------------------------------------------------

    def _write(self, path: str, leaves, stats: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        tmp = f"{path}{TMP_TAG}{os.getpid()}"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        shards: List[Dict[str, torch.Tensor]] = []
        index = {}
        size = SHARD_BYTES
        for key, t, kind in leaves:
            nbytes = t.numel() * t.element_size()
            if size + nbytes > SHARD_BYTES and size > 0:
                shards.append({})
                size = 0
            shards[-1][key] = t
            size += nbytes
            index[key] = {"shard": len(shards) - 1, "kind": kind,
                          "dtype": str(t.dtype).replace("torch.", ""),
                          "shape": list(t.shape)}
        names = [f"shard_{i:05d}.pt" for i in range(len(shards))]
        with ThreadPoolExecutor(WRITE_THREADS) as ex:
            futs = [ex.submit(_write_file, os.path.join(tmp, n), s)
                    for n, s in zip(names, shards)]
            digests = {}
            for n, fut in zip(names, futs):
                nb, sha = fut.result()
                digests[n] = {"size": nb, "sha256": sha}
        payload = json.dumps({"schema": _SCHEMA, "shards": names,
                              "leaves": index}, sort_keys=True).encode()
        ipath = os.path.join(tmp, INDEX_NAME)
        with open(ipath, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        digests[INDEX_NAME] = {"size": len(payload),
                               "sha256": hashlib.sha256(payload).hexdigest()}
        _fsync_dir(tmp)
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path))
        self.digests = (path, digests)
        stats.update(write_s=time.perf_counter() - t0,
                     bytes=sum(d["size"] for d in digests.values()))

    def _run(self, path, leaves, stats):
        try:
            self._write(path, leaves, stats)
        except BaseException as e:  # noqa: BLE001 — carried to the caller
            self._error = e
        finally:
            self._done.set()

    def save(self, tree, path: str, async_save: bool) -> None:
        self.wait()              # the buffers of the previous save are free
        if not async_save:
            # a synchronous save writes from plain host copies: it has no
            # use for the async saves' buffers, and frees them
            self._buffers.clear()
        leaves, snap_s = self.snapshot(tree, reuse=async_save)
        stats = {"path": path, "async": async_save, "snapshot_s": snap_s}
        self.saves.append(stats)
        self.digests = ("", {})
        if not async_save:
            self._write(path, leaves, stats)
            return
        self._done.clear()
        self._thread = threading.Thread(target=self._run,
                                        args=(path, leaves, stats),
                                        daemon=True,
                                        name="pt-ckpt-writer")
        self._thread.start()

    def release(self) -> None:
        """Free the snapshot buffers once the write in flight (if any) is
        done; the next async save allocates them again. A failure of that
        write stays for :meth:`wait` to raise."""
        self._done.wait()
        self._buffers.clear()

    def done(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def wait(self) -> None:
        """Block until the write in flight (if any) is durable; re-raise
        its failure."""
        self._done.wait()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


_WRITER = _Writer()


def writer() -> _Writer:
    """The process's checkpoint writer (its ``saves`` hold each save's
    snapshot and write seconds and bytes)."""
    return _WRITER


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    async_save: bool = False, overwrite: bool = True) -> None:
    """Save a (nested) dict of tensors and arrays to ``path``. The host
    snapshot is taken before this returns; with ``async_save`` the files
    are written by the background thread (see :func:`wait_until_finished`).
    ``overwrite=False`` refuses an existing checkpoint. A sharded state
    (a DTensor in it: FSDP2's parameters, gradients or optimizer state)
    raises: its save needs the sharding plan (ROADMAP.md A.5)."""
    _refuse_sharded(state_dict)
    path = _abs(path)
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    _WRITER.save(state_dict, path, bool(async_save))


def _refuse_sharded(tree) -> None:
    from torch.distributed.tensor import DTensor
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, DTensor):
            raise NotImplementedError(
                "saving a sharded state (DTensor shards) waits for the "
                "plan-aware save (ROADMAP.md A.5); gather it with "
                "parallel.api.full_state_dict first")


def file_digests(path: str) -> Optional[Dict[str, Dict[str, Any]]]:
    """``{file: {"size", "sha256"}}`` of the files the last save wrote, if
    it wrote ``path`` (hashed as they were written), else None."""
    last, digests = _WRITER.digests
    return digests if last == _abs(path) else None


def wait_until_finished(watchdog=None, poll_s: float = 0.5,
                        hang_timeout_s: Optional[float] = None) -> None:
    """Block until the pending async save is durable.

    A background write failure is re-raised HERE — the caller must learn
    the checkpoint is not durable before it matters, not at process exit.
    When ``watchdog`` (a distributed.watchdog.StepWatchdog) is given it is
    ticked every ``poll_s`` while waiting — a slow-but-healthy save must not
    false-trip the hung-step detector — but only up to ``hang_timeout_s``
    (default 4x the watchdog's own step timeout): past that budget the wait
    goes silent, the armed watchdog stops seeing progress and fires, so a
    truly hung write is detected instead of stalling forever behind a
    stream of fake progress ticks."""
    if watchdog is None:
        _WRITER.wait()
        return
    if hang_timeout_s is None:
        wd_t = getattr(watchdog, "timeout_s", None)
        hang_timeout_s = 4.0 * wd_t if wd_t else float("inf")
    start = time.monotonic()
    while not _WRITER.done(poll_s):
        if time.monotonic() - start < hang_timeout_s:
            watchdog.tick()
    _WRITER.wait()


def _refuse_mesh(mesh, spec_tree) -> None:
    if mesh is not None or spec_tree is not None:
        raise NotImplementedError(
            "loading onto a mesh (mesh=/spec_tree=) reshards, which comes "
            "with the elastic and resharding slice (ROADMAP.md, A.5)")


def load_state_dict(path: str, state_dict: Dict[str, Any], mesh=None,
                    spec_tree=None) -> Dict[str, Any]:
    """Restore into the structure of ``state_dict``: tensor leaves come back
    as CPU tensors (memory-mapped from the files), other leaves as numpy
    arrays. Every leaf's shape, and a tensor leaf's dtype, must match
    ``state_dict``'s (its values may be on any device; only their shapes
    and dtypes are read). Raises ValueError naming each mismatch.
    ``mesh``/``spec_tree`` (a reshard on load) are refused until A.5."""
    _refuse_mesh(mesh, spec_tree)
    path = _abs(path)
    with open(os.path.join(path, INDEX_NAME), "rb") as f:
        index = json.loads(f.read())
    if index.get("schema") != _SCHEMA:
        raise ValueError(f"{path}: not a {_SCHEMA} checkpoint")
    like = dict(_flatten(state_dict))
    entries = index["leaves"]
    missing = sorted(set(like) - set(entries))
    extra = sorted(set(entries) - set(like))
    if missing or extra:
        raise ValueError(f"{path}: checkpoint keys differ from the target: "
                         f"missing={missing} extra={extra}")
    shards = [torch.load(os.path.join(path, n), weights_only=True,
                         map_location="cpu", mmap=True)
              for n in index["shards"]]
    leaves, bad = {}, []
    for key, want in like.items():
        t = shards[entries[key]["shard"]][key]
        shape = tuple(want.shape) if hasattr(want, "shape") \
            else np.shape(want)
        if tuple(t.shape) != tuple(shape) or (
                isinstance(want, torch.Tensor) and t.dtype != want.dtype):
            bad.append((key, tuple(t.shape), str(t.dtype), tuple(shape),
                        str(getattr(want, "dtype", type(want).__name__))))
            continue
        leaves[key] = t if isinstance(want, torch.Tensor) else t.numpy()
    if bad:
        raise ValueError(f"{path}: leaves whose shape or dtype differ from "
                         f"the target (key, saved, target): {bad}")
    return _unflatten_like(state_dict, leaves)


# -- whole-training-state checkpoint (step/params/opt/lr) --------------------

def save_training_state(path: str, step: int, params: Dict[str, Any],
                        opt_state: Dict[str, Any], extra: Optional[Dict] = None,
                        async_save: bool = False) -> None:
    """One-call trainer checkpoint (reference analogue: auto_checkpoint's
    TrainEpochRange snapshot)."""
    tree = {"step": np.asarray(step, np.int64), "params": params,
            "opt_state": opt_state}
    if extra:
        tree["extra"] = extra
    save_state_dict(tree, path, async_save=async_save)


def load_training_state(path: str, params_like: Dict[str, Any],
                        opt_state_like: Dict[str, Any], mesh=None,
                        spec_tree=None) -> Dict[str, Any]:
    tree = {"step": np.asarray(0, np.int64), "params": params_like,
            "opt_state": opt_state_like}
    return load_state_dict(path, tree, mesh=mesh, spec_tree=spec_tree)


def is_complete_checkpoint(path: str) -> bool:
    """True when ``path`` holds a fully-written checkpoint.

    Completeness evidence, in order: a CheckpointManager ``_COMMITTED``
    marker wins; a ``<path>.PENDING`` sidecar (manager save in flight or
    died mid-save) disqualifies; a bare directory written by
    :func:`save_state_dict` counts when its index is present — the writer
    renames its temporary directory into place after the index is
    durable, so the index's existence implies the rename happened. An
    empty or unrecognizable dir never qualifies."""
    path = _abs(path)
    if not os.path.isdir(path):
        return False
    if os.path.isfile(os.path.join(path, "_COMMITTED")):
        # marker wins over an orphan .PENDING sidecar: a crash between
        # writing the marker and removing the sidecar leaves both, and the
        # commit happened
        return True
    if os.path.isfile(path + ".PENDING"):
        return False
    return os.path.isfile(os.path.join(path, INDEX_NAME))


def latest_step(root: str) -> Optional[int]:
    """Scan ``root`` for step_N checkpoint dirs; return the largest N whose
    dir is a COMPLETE checkpoint. Incomplete/uncommitted dirs (crash
    mid-save) and in-progress temporary dirs are skipped — auto-resume
    must never pick up a partial write."""
    root = _abs(root)
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if not name.startswith("step_"):
            continue
        try:
            n = int(name.split("_", 1)[1])
        except ValueError:
            continue          # temporary dirs, quarantine tags, etc.
        if is_complete_checkpoint(os.path.join(root, name)):
            steps.append(n)
    return max(steps) if steps else None
