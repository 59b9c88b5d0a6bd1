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

A sharded state (every rank of a mesh calls :func:`save_state_dict`
with ``layout=``, the model's ``parallel.api.MeshPlan``) is written by
every rank at once, each its own local shards:

    step_N/_TREE.json          schema pt-torch-sharded-v1: every leaf's
                               global shape, dtype, fused runs ("blocks")
                               and pieces: which rank's file holds which
                               part of the JAX-layout full tensor (per
                               dimension a list of (start, length) runs,
                               and a flat [lo, hi) chunk of that for the
                               optimizer's os / os_g view)
    step_N/r00002_00000.pt     rank 2's first file

A piece held by several ranks (the dp replicas) is written once, by the
lowest of them. Each rank's files go into ``<path>.pt-tmp-sharded``;
rank 0 writes the index and renames the directory only after every rank
reported its files durable (a collective, on the caller's thread: at
once for a synchronous save, at :func:`wait_until_finished` for an async
one), so a rank killed mid-save leaves a torn temporary directory.

:func:`load_state_dict` with ``mesh=`` (a ``MeshPlan``, a sharded model
or a ``HybridMesh``), ``spec_tree=`` and ``coords=`` reads, one leaf at
a time, only the pieces that intersect the target rank's slice, and
places the slice with the maps ``shard_layer`` uses
(``parallel.api.shard_layout``): a restore onto another mesh is the
same read as one onto the saving mesh. Without them a sharded
checkpoint comes back whole.
"""

from __future__ import annotations

import collections
import hashlib
import itertools
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
           "is_complete_checkpoint", "file_digests", "read_index",
           "load_flat", "unflatten", "write_layout",
           "mesh_coords", "INDEX_NAME", "SHARD_BYTES", "SHARDED_SCHEMA"]

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
        # a sharded save whose collective finish (the index, the rename)
        # is still due: its path, every rank's pieces and this rank's
        # files once written
        self._sharded: Optional[Dict[str, Any]] = None

    # -- snapshot -----------------------------------------------------------

    def _host_copy(self, key: str, t: torch.Tensor,
                   reuse: bool) -> torch.Tensor:
        t = _local(t).detach()
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
        the card's copies before it returns. ``tree`` may also be a list
        of (key, leaf) pairs."""
        t0 = time.perf_counter()
        out, devices = [], set()
        items = tree if isinstance(tree, list) else _flatten(tree)
        for key, leaf in items:
            if isinstance(leaf, torch.Tensor):
                if leaf.device.type == "cuda":
                    devices.add(leaf.device)
                out.append((key, self._host_copy(key, leaf, reuse),
                            "tensor"))
            else:
                out.append((key, torch.from_numpy(_value_array(key, leaf)),
                            "value"))
        for dev in devices:
            torch.cuda.current_stream(dev).synchronize()
        return out, time.perf_counter() - t0

    # -- write --------------------------------------------------------------

    @staticmethod
    def _write_files(tmp: str, leaves, names_of) -> Tuple[
            Dict[str, int], List[str], Dict[str, Dict[str, Any]]]:
        """Write ``leaves`` into files of at most SHARD_BYTES (unless one
        leaf is larger) under ``tmp``, named ``names_of(i)``, on
        WRITE_THREADS threads: (key -> file index, file names, digests)."""
        shards: List[Dict[str, torch.Tensor]] = []
        where = {}
        size = SHARD_BYTES
        for key, t, _kind in leaves:
            nbytes = t.numel() * t.element_size()
            if size + nbytes > SHARD_BYTES and size > 0:
                shards.append({})
                size = 0
            shards[-1][key] = t
            size += nbytes
            where[key] = len(shards) - 1
        names = [names_of(i) for i in range(len(shards))]
        digests = {}
        with ThreadPoolExecutor(WRITE_THREADS) as ex:
            futs = [ex.submit(_write_file, os.path.join(tmp, n), sh)
                    for n, sh in zip(names, shards)]
            for n, fut in zip(names, futs):
                nb, sha = fut.result()
                digests[n] = {"size": nb, "sha256": sha}
        return where, names, digests

    def _write(self, path: str, leaves, stats: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        if self._sharded is not None:
            st = self._sharded
            os.makedirs(st["tmp"], exist_ok=True)
            where, names, digests = self._write_files(
                st["tmp"], leaves, lambda i: f"r{st['rank']:05d}_{i:05d}.pt")
            st["files"] = {k: names[i] for k, i in where.items()}
            st["digests"] = digests
            _fsync_dir(st["tmp"])
            stats.update(write_s=time.perf_counter() - t0,
                         bytes=sum(d["size"] for d in digests.values()))
            return
        tmp = f"{path}{TMP_TAG}{os.getpid()}"
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        where, names, digests = self._write_files(
            tmp, leaves, lambda i: f"shard_{i:05d}.pt")
        index = {key: {"shard": where[key], "kind": kind,
                       "dtype": str(t.dtype).replace("torch.", ""),
                       "shape": list(t.shape)} for key, t, kind in leaves}
        payload = json.dumps({"schema": _SCHEMA, "shards": names,
                              "leaves": index}, sort_keys=True).encode()
        digests[INDEX_NAME] = _write_index(tmp, payload)
        _commit_dir(tmp, path)
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

    def _start(self, path, leaves, stats, async_save: bool) -> None:
        if not async_save:
            self._write(path, leaves, stats)
            return
        self._done.clear()
        self._thread = threading.Thread(target=self._run,
                                        args=(path, leaves, stats),
                                        daemon=True,
                                        name="pt-ckpt-writer")
        self._thread.start()

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
        self._start(path, leaves, stats, async_save)

    def save_sharded(self, tree, path: str, layout, async_save: bool) -> None:
        """Every rank's half of a sharded save (module docstring): the
        pieces agreed over the world, this rank's own written (in the
        background when ``async_save``); the index follows in
        :meth:`wait`, or at once for a synchronous save."""
        import torch.distributed as dist
        self.wait()
        if not async_save:
            self._buffers.clear()
        rank = dist.get_rank() if dist.is_initialized() else 0
        tmp = path + SHARDED_TMP
        if rank == 0:
            if os.path.isdir(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
        metas = [(key, _piece_meta(key, leaf, layout))
                 for key, leaf in _flatten(tree)]
        # one collective: every rank's pieces (and rank 0's clean-up is
        # done before anyone writes)
        every = _all_gather_object(metas)
        first = {}
        for r, rm in enumerate(every):
            for key, m in rm:
                first.setdefault((key, _piece_id(m)), r)
        mine = [(key, leaf) for (key, leaf), (_, m) in zip(
            _flatten(tree), metas) if first[(key, _piece_id(m))] == rank]
        leaves, snap_s = self.snapshot(mine, reuse=async_save)
        stats = {"path": path, "async": async_save, "snapshot_s": snap_s,
                 "sharded": True}
        self.saves.append(stats)
        self.digests = ("", {})
        self._sharded = {"path": path, "tmp": tmp, "rank": rank,
                         "every": every, "first": first, "files": {},
                         "digests": {}}
        self._start(path, leaves, stats, async_save)
        if not async_save:
            self._finish_sharded(None)

    def _finish_sharded(self, err: Optional[BaseException]) -> None:
        """The collective end of a sharded save: every rank reports its
        files (or its failure); rank 0 writes the index and renames the
        directory into place; a barrier before anyone returns."""
        import torch.distributed as dist
        st, self._sharded = self._sharded, None
        got = _all_gather_object({"ok": err is None,
                                  "error": repr(err) if err else "",
                                  "files": st["files"],
                                  "digests": st["digests"]})
        bad = [(r, g["error"]) for r, g in enumerate(got) if not g["ok"]]
        if bad:
            if err is not None:
                raise err
            raise RuntimeError(f"sharded save of {st['path']}: ranks "
                               f"failed: {bad}")
        digests = {}
        for g in got:
            digests.update(g["digests"])
        if st["rank"] == 0:
            payload = _sharded_index(st["every"], st["first"],
                                     [g["files"] for g in got])
            digests[INDEX_NAME] = _write_index(st["tmp"], payload)
            _commit_dir(st["tmp"], st["path"])
        if dist.is_initialized():
            dist.barrier()
        self.digests = (st["path"], digests)

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
        its failure. A sharded save ends here with its collective finish,
        so every rank calls this."""
        self._done.wait()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self._sharded is not None:
            self._finish_sharded(err)
        elif err is not None:
            raise err


SHARDED_SCHEMA = "pt-torch-sharded-v1"
SHARDED_TMP = TMP_TAG + "sharded"


def _local(t):
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _value_array(key: str, leaf) -> np.ndarray:
    arr = np.array(leaf)
    if arr.dtype == object:
        raise TypeError(f"checkpoint leaf {key!r} is a "
                        f"{type(leaf).__name__}, not an array")
    return arr


def _sharded_index(every, first, files) -> bytes:
    """The sharded index of every rank's pieces (``every[r]``: (key,
    meta) pairs), each distinct piece at its writer ``first`` names, in
    the file ``files[r][key]``."""
    leaves: Dict[str, Dict[str, Any]] = {}
    for r, rm in enumerate(every):
        for key, m in rm:
            e = leaves.setdefault(key, {
                "kind": m["kind"], "dtype": m["dtype"],
                "shape": m["shape"], "blocks": m["blocks"], "pieces": []})
            if first[(key, _piece_id(m))] == r:
                e["pieces"].append({
                    "rank": r, "file": files[r][key], "runs": m["runs"],
                    "flat": m["flat"], "shape": m["local"]})
    return json.dumps({"schema": SHARDED_SCHEMA, "world": len(every),
                       "leaves": leaves}, sort_keys=True).encode()


def _write_index(tmp: str, payload: bytes) -> Dict[str, Any]:
    ipath = os.path.join(tmp, INDEX_NAME)
    with open(ipath, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    return {"size": len(payload),
            "sha256": hashlib.sha256(payload).hexdigest()}


def _commit_dir(tmp: str, path: str) -> None:
    """Rename the written directory into place once it is durable."""
    _fsync_dir(tmp)
    if os.path.isdir(path):
        shutil.rmtree(path)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))


def _all_gather_object(obj) -> List[Any]:
    import torch.distributed as dist
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def _resolve(keys: List[str], table) -> Optional[str]:
    """The table entry a leaf at path ``keys`` takes: its full "/" path,
    its last key, then the innermost enclosing key (JAX's resolution, so
    ``opt_state/slots/<param>/m`` takes the parameter's entry)."""
    full = "/".join(keys)
    if full in table:
        return full
    if keys and keys[-1] in table:
        return keys[-1]
    for k in reversed(keys[:-1]):
        if k in table:
            return k
    return None


def _whole(shape) -> Dict[str, Any]:
    return {"runs": [[[0, int(n)]] for n in shape], "flat": None}


def _local_shape(lay: Dict[str, Any]) -> Tuple[int, ...]:
    if lay["flat"] is not None:
        return (lay["flat"][1] - lay["flat"][0],)
    return tuple(sum(n for _, n in r) for r in lay["runs"])


def _plan_of(layout):
    """The ``parallel.api.MeshPlan`` of ``layout`` (a plan, or a model
    sharded by ``shard_layer``), or None."""
    if layout is None or hasattr(layout, "shards"):
        return layout
    from ..parallel.api import mesh_plan_of
    return mesh_plan_of(layout)


def _plan_leaf(plan, key: str, shape) -> Optional[Tuple[str, Dict]]:
    """(parameter, layout) of the leaf at ``key`` whose local shape is
    ``shape``: the parameter's shard, or its optimizer view (an os /
    os_g chunk); None for a leaf outside the plan's parameters."""
    from ..parallel.api import plan_layout
    name = _resolve(key.split("/"), plan.shards)
    if name is None:
        return None
    for view in (False, True):
        lay = plan_layout(plan, name, view)
        if _local_shape(lay) == tuple(shape):
            return name, lay
    local = _local_shape(plan_layout(plan, name))
    raise ValueError(
        f"checkpoint leaf {key!r} of shape {tuple(shape)} is neither "
        f"parameter {name}'s local shard {local} nor its optimizer view")


def _piece_meta(key: str, leaf, layout) -> Dict[str, Any]:
    """What a rank holds of one leaf: kind, dtype, global shape, fused
    runs, and its piece (runs, flat chunk, local shape)."""
    plan = _plan_of(layout)
    if not isinstance(leaf, torch.Tensor):
        arr = _value_array(key, leaf)
        return {"kind": "value", "dtype": str(torch.from_numpy(arr).dtype
                                              ).replace("torch.", ""),
                "shape": list(arr.shape), "blocks": None,
                "local": list(arr.shape), **_whole(arr.shape)}
    t = _local(leaf)
    dtype = str(t.dtype).replace("torch.", "")
    hit = _plan_leaf(plan, key, t.shape) if plan is not None else None
    if hit is None:
        return {"kind": "tensor", "dtype": dtype, "shape": list(t.shape),
                "blocks": None, "local": list(t.shape), **_whole(t.shape)}
    name, lay = hit
    sh = plan.shards[name]
    return {"kind": "tensor", "dtype": dtype, "shape": list(sh.full_shape),
            "blocks": [list(b) for b in sh.blocks] if sh.blocks else None,
            "local": list(t.shape), **lay}


def _piece_id(m: Dict[str, Any]) -> str:
    return json.dumps([m["runs"], m["flat"]])


_WRITER = _Writer()


def writer() -> _Writer:
    """The process's checkpoint writer (its ``saves`` hold each save's
    snapshot and write seconds and bytes)."""
    return _WRITER


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    async_save: bool = False, overwrite: bool = True,
                    layout=None) -> None:
    """Save a (nested) dict of tensors and arrays to ``path``. The host
    snapshot is taken before this returns; with ``async_save`` the files
    are written by the background thread (see :func:`wait_until_finished`).
    ``overwrite=False`` refuses an existing checkpoint.

    ``layout`` (a ``parallel.api.MeshPlan``, or the model ``shard_layer``
    cut) makes it the sharded save of the module docstring: a collective
    that every rank of the world calls with its own local tree (FSDP2's
    DTensors included). A state holding DTensors needs it."""
    path = _abs(path)
    if not overwrite and os.path.exists(path):
        raise FileExistsError(path)
    if layout is None:
        _require_layout(state_dict)
        _WRITER.save(state_dict, path, bool(async_save))
        return
    if _plan_of(layout) is None:
        raise ValueError("save_state_dict(layout=): the model is not "
                         "sharded (parallel.api.shard_layer)")
    _WRITER.save_sharded(state_dict, path, layout, bool(async_save))


def _require_layout(tree) -> None:
    from torch.distributed.tensor import DTensor
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, DTensor):
            raise ValueError(
                "a sharded state (DTensor shards) saves through the sharded "
                "save: pass layout= (the model's MeshPlan, or the sharded "
                "model) on every rank")


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
    stream of fake progress ticks. A sharded save's index is written here
    (a collective: every rank calls it)."""
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


# -- load ---------------------------------------------------------------------

def read_index(path: str) -> Dict[str, Dict[str, Any]]:
    """Every leaf of the checkpoint at ``path``: ``{key: {"kind",
    "dtype", "shape" (global), "blocks", "pieces": [{"file", "runs",
    "flat", ...}]}}``, for either format (an unsharded leaf is one
    piece, and has no "blocks": its fused runs are not recorded)."""
    path = _abs(path)
    with open(os.path.join(path, INDEX_NAME), "rb") as f:
        index = json.loads(f.read())
    schema = index.get("schema")
    if schema == SHARDED_SCHEMA:
        return index["leaves"]
    if schema != _SCHEMA:
        raise ValueError(f"{path}: not a {_SCHEMA} checkpoint")
    out = {}
    for key, e in index["leaves"].items():
        # no "blocks": an unsharded save records no fused runs
        out[key] = {"kind": e["kind"], "dtype": e["dtype"],
                    "shape": e["shape"],
                    "pieces": [{"file": index["shards"][e["shard"]],
                                "rank": 0, "shape": e["shape"],
                                **_whole(e["shape"])}]}
    return out


def mesh_coords(axes: Dict[str, int], rank: int) -> Dict[str, int]:
    """The coordinates of world rank ``rank`` on a mesh of ``axes``
    (sizes), row-major over the mesh's axis order, as ``HybridMesh``
    places it."""
    from ..parallel.mesh import AXES_ORDER, AXES_ORDER_EP
    order = AXES_ORDER_EP if int(axes.get("ep", 1)) > 1 else AXES_ORDER
    sizes = [int(axes.get(a, 1)) for a in order]
    idx = np.unravel_index(int(rank), sizes)
    return {a: int(i) for a, i in zip(order, idx)}


class _Target:
    """Where each leaf of a load lands: whole (no mesh), a MeshPlan's
    shard or view, or a spec table's shard on a mesh of given sizes."""

    def __init__(self, mesh, spec_tree, coords):
        self.plan = _plan_of(mesh) if mesh is not None and not isinstance(
            mesh, dict) and not hasattr(mesh, "device_mesh") else None
        self.spec_tree = spec_tree
        self.whole = mesh is None and spec_tree is None and coords is None
        self.coords = coords
        if self.plan is not None:
            self.axes = dict(self.plan.mesh.shape)
        elif isinstance(mesh, dict):
            self.axes = {k: int(v) for k, v in mesh.items()}
        elif mesh is not None:
            self.axes = dict(mesh.shape)
            if coords is None:
                self.coords = dict(mesh._coord)
        else:
            self.axes = {}
        if self.coords is None and not self.whole and self.plan is None:
            import torch.distributed as dist
            self.coords = mesh_coords(self.axes, dist.get_rank()
                                      if dist.is_initialized() else 0)

    def layout(self, key: str, entry: Dict[str, Any], want) -> Dict:
        shape = entry["shape"]
        if self.whole or entry["kind"] != "tensor":
            return _whole(shape)
        if self.plan is not None:
            from ..parallel.api import plan_layout
            name = _resolve(key.split("/"), self.plan.shards)
            if name is None:
                return _whole(shape)
            wshape = tuple(_local(want).shape) if hasattr(
                want, "shape") else None
            lays = [plan_layout(self.plan, name, v, self.coords)
                    for v in (False, True)]
            return next((lay for lay in lays
                         if _local_shape(lay) == wshape), lays[0])
        from ..parallel.api import shard_layout
        name = _resolve(key.split("/"), self.spec_tree or {})
        if name is None:
            return _whole(shape)
        spec = tuple(tuple(e) if isinstance(e, list) else e
                     for e in self.spec_tree[name])
        if len(spec) > len(shape):
            return _whole(shape)
        level = "fsdp2" if self.axes.get("fsdp", 1) > 1 else "none"
        tp_split = any(e == "tp" or (isinstance(e, tuple) and "tp" in e)
                       for e in spec) and self.axes.get("tp", 1) > 1
        if tp_split and "blocks" not in entry and len(shape) > 1:
            raise ValueError(
                f"{key}: the checkpoint records no fused runs for this leaf "
                f"(an unsharded save), so its tp split is unknown; save it "
                f"through save_state_dict(layout=) or load it whole")
        return shard_layout(shape, spec, entry.get("blocks"), self.axes,
                            self.coords, level)


def _segments(t_runs, p_runs) -> List[Tuple[int, int, int]]:
    """(target offset, piece offset, length) of every overlap of two run
    lists along one dimension."""
    out, tpos = [], 0
    for ts, tn in t_runs:
        ppos = 0
        for ps, pn in p_runs:
            a, b = max(ts, ps), min(ts + tn, ps + pn)
            if a < b:
                out.append((tpos + a - ts, ppos + a - ps, b - a))
            ppos += pn
        tpos += tn
    return out


def _assemble(key: str, entry: Dict[str, Any], lay: Dict[str, Any],
              opener) -> torch.Tensor:
    """The leaf's tensor at ``lay`` from the pieces that intersect it
    (a piece of the same place is returned as read)."""
    for pc in entry["pieces"]:
        if pc["runs"] == lay["runs"] and pc["flat"] == lay["flat"]:
            return opener(pc)
    dtype = getattr(torch, entry["dtype"])
    shape = tuple(sum(n for _, n in r) for r in lay["runs"])
    out = torch.empty(shape, dtype=dtype)
    sources, groups = [], {}
    for pc in entry["pieces"]:
        if pc["flat"] is None:
            sources.append((pc["runs"], lambda pc=pc: opener(pc)))
        else:
            groups.setdefault(json.dumps(pc["runs"]), []).append(pc)
    for rk, grp in groups.items():
        runs = json.loads(rk)
        sources.append((runs, lambda grp=grp, runs=runs: _unflat(
            key, grp, runs, dtype, opener)))
    covered = 0
    for runs, get in sources:
        segs = [_segments(t, p) for t, p in zip(lay["runs"], runs)]
        if any(not s for s in segs):
            continue
        src = get()
        for combo in itertools.product(*segs):
            d_, s_ = out, src
            for d, (to, po, n) in enumerate(combo):
                d_, s_ = d_.narrow(d, to, n), s_.narrow(d, po, n)
            d_.copy_(s_)
            covered += int(np.prod([n for *_, n in combo]))
    if covered < out.numel():
        raise ValueError(f"checkpoint leaf {key!r}: its pieces cover "
                         f"{covered} of the {out.numel()} elements asked")
    if lay["flat"] is not None:
        lo, hi = lay["flat"]
        out = out.reshape(-1)[lo:hi].clone()
    return out


def _unflat(key, grp, runs, dtype, opener) -> torch.Tensor:
    """A piece saved as flat chunks (the os / os_g view), put back."""
    shape = tuple(sum(n for _, n in r) for r in runs)
    flat = torch.empty(int(np.prod(shape)), dtype=dtype)
    covered = 0
    for pc in grp:
        lo, hi = pc["flat"]
        flat[lo:hi] = opener(pc).reshape(-1)
        covered += hi - lo
    if covered < flat.numel():
        raise ValueError(f"checkpoint leaf {key!r}: its optimizer chunks "
                         f"cover {covered} of {flat.numel()} elements")
    return flat.reshape(shape)


def load_state_dict(path: str, state_dict: Dict[str, Any], mesh=None,
                    spec_tree=None, coords=None) -> Dict[str, Any]:
    """Restore into the structure of ``state_dict``: tensor leaves come back
    as CPU tensors (memory-mapped from the files when read whole), other
    leaves as numpy arrays. Every leaf's shape, and a tensor leaf's dtype,
    must match ``state_dict``'s (its values may be on any device; only
    their shapes and dtypes are read). Raises ValueError naming each
    mismatch.

    With ``mesh`` (a ``MeshPlan`` or a model sharded by ``shard_layer``:
    each parameter, master and slot as the plan cuts it; a
    ``HybridMesh``, or a dict of axis sizes, with ``spec_tree`` name →
    spec: the parameters and, by path, their slots as ``shard_layer``
    would cut them, FSDP2's rows when the mesh has an fsdp axis), each
    leaf is this rank's slice, or that of the rank at ``coords`` (mesh
    coordinates), read from only the pieces that intersect it, and
    placed on the device of its ``state_dict`` leaf. A target leaf may
    be given at its local shape or at its global one."""
    path = _abs(path)
    entries = read_index(path)
    like = dict(_flatten(state_dict))
    missing = sorted(set(like) - set(entries))
    extra = sorted(set(entries) - set(like))
    if missing or extra:
        raise ValueError(f"{path}: checkpoint keys differ from the target: "
                         f"missing={missing} extra={extra}")
    target = _Target(mesh, spec_tree, coords)
    files: Dict[str, Any] = {}

    def opener_of(key):
        def opener(pc):
            f = pc["file"]
            if f not in files:
                files[f] = torch.load(os.path.join(path, f),
                                      weights_only=True, map_location="cpu",
                                      mmap=True)
            return files[f][key]
        return opener
    leaves, bad = {}, []
    for key, want in like.items():
        e = entries[key]
        lay = target.layout(key, e, want)
        t = _assemble(key, e, lay, opener_of(key))
        wshape = (tuple(_local(want).shape) if hasattr(want, "shape")
                  else np.shape(want))
        ok_shape = tuple(t.shape) == tuple(wshape) or (
            not target.whole and tuple(wshape) == tuple(e["shape"]))
        if not ok_shape or (isinstance(want, torch.Tensor)
                            and t.dtype != want.dtype):
            bad.append((key, tuple(t.shape), str(t.dtype), tuple(wshape),
                        str(getattr(want, "dtype", type(want).__name__))))
            continue
        if not isinstance(want, torch.Tensor):
            leaves[key] = t.numpy()
        elif not target.whole and _local(want).device.type not in (
                "cpu", "meta"):
            leaves[key] = t.to(_local(want).device)
        else:
            leaves[key] = t
    if bad:
        raise ValueError(f"{path}: leaves whose shape or dtype differ from "
                         f"the target (key, saved, target): {bad}")
    return _unflatten_like(state_dict, leaves)


def load_flat(path: str, prefix: str = "") -> Dict[str, Any]:
    """Every leaf of the checkpoint at ``path`` whose key starts with
    ``prefix``, whole, by its "/"-joined key (a tensor, or a numpy array
    for a non-tensor leaf), without a target tree: the offline tools'
    and digests' read."""
    path = _abs(path)
    out = {}
    files: Dict[str, Any] = {}
    for key, e in read_index(path).items():
        if not key.startswith(prefix):
            continue
        def opener(pc, key=key):
            f = pc["file"]
            if f not in files:
                files[f] = torch.load(os.path.join(path, f),
                                      weights_only=True, map_location="cpu",
                                      mmap=True)
            return files[f][key]
        t = _assemble(key, e, _whole(e["shape"]), opener)
        out[key] = t if e["kind"] == "tensor" else t.numpy()
    return out


def write_layout(src: str, dst: str, axes: Dict[str, int],
                 spec_tree: Dict[str, Any],
                 coords: List[Dict[str, int]]) -> Dict[str, Dict[str, Any]]:
    """Write the checkpoint at ``src`` to ``dst`` as the ranks at
    ``coords`` would hold it on a mesh of ``axes`` under ``spec_tree``
    (the sharded format: each distinct piece once, in its first holder's
    files), from one process — the offline reshard. Each leaf is read
    from only the source pieces its target slices intersect. Returns the
    files' digests."""
    src, dst = _abs(src), _abs(dst)
    entries = read_index(src)
    every = []
    for c in coords:
        tgt = _Target(dict(axes), spec_tree, dict(c))
        rm = []
        for key, e in entries.items():
            lay = tgt.layout(key, e, None)
            rm.append((key, {"kind": e["kind"], "dtype": e["dtype"],
                             "shape": e["shape"], "blocks": e.get("blocks"),
                             "local": list(_local_shape(lay)), **lay}))
        every.append(rm)
    first = {}
    for r, rm in enumerate(every):
        for key, m in rm:
            first.setdefault((key, _piece_id(m)), r)
    tmp = dst + SHARDED_TMP
    if os.path.isdir(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    handles: Dict[str, Any] = {}

    def opener_of(key):
        def opener(pc):
            f = pc["file"]
            if f not in handles:
                handles[f] = torch.load(os.path.join(src, f),
                                        weights_only=True,
                                        map_location="cpu", mmap=True)
            return handles[f][key]
        return opener
    files, digests = [], {}
    for r, rm in enumerate(every):
        leaves = [(key, _assemble(key, entries[key], m, opener_of(key)),
                   entries[key]["kind"]) for key, m in rm
                  if first[(key, _piece_id(m))] == r]
        where, names, dg = _Writer._write_files(
            tmp, leaves, lambda i, r=r: f"r{r:05d}_{i:05d}.pt")
        files.append({k: names[i] for k, i in where.items()})
        digests.update(dg)
    digests[INDEX_NAME] = _write_index(tmp, _sharded_index(every, first,
                                                           files))
    _commit_dir(tmp, dst)
    return digests


def unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    """The nested tree of a "/"-keyed flat dict (:func:`load_flat`)."""
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


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
