"""CheckpointManager — crash-safe periodic checkpointing with retention
(copy of ``paddle_tpu/resilience/checkpoint_manager.py``).

Reference analogue: python/paddle/base/incubate/checkpoint/auto_checkpoint.py
(``TrainEpochRange`` periodic snapshots + GC) hardened for the preemption
realities of a multi-day run. The manager wraps
``paddle_tpu_torch.checkpoint`` (``torch.save`` storage) with:

* an **atomic commit protocol** — a ``step_N.PENDING`` sidecar is created
  before the write and a ``_COMMITTED`` marker (carrying the manifest
  checksum) is written inside the step dir only after the write is durable,
  so a crash at ANY point mid-save can never be mistaken for a valid
  checkpoint;
* a **manifest** (`_MANIFEST.json`): every file's size + sha256, verified on
  restore — bit-rot or a torn write quarantines the step instead of loading
  garbage into a 8B-param run;
* **retention**: keep-last-N (rolling window) plus keep-every-M (permanent
  milestones for post-hoc eval);
* **quarantine** of corrupt/uncommitted step dirs under ``_quarantine/`` —
  evidence is preserved, resume falls back to the previous good step;
* **retry with jittered exponential backoff** on transient I/O failures
  (GCS 5xx, NFS hiccups) — a single flaky write must not kill the run.

Single-writer assumption: one manager instance owns ``root``.

What differs from the JAX manager: the manifest takes each file's sha256
from the storage layer, which hashed the bytes as its writer thread wrote
them (``checkpoint.file_digests``), so a commit re-reads nothing it wrote
itself; :meth:`verify` hashes a step's files on several threads.

On a mesh (``mesh=`` the model's ``parallel.api.MeshPlan``, the sharded
model, or a ``HybridMesh``; ``plan=`` the ``ShardingPlan`` recorded as
``_PLAN.json``) every rank runs its own manager over the SAME root, and
the manager is collective over the world: each rank writes its own
shards (``checkpoint``'s sharded save); rank 0 alone sweeps, writes the
``.PENDING`` sidecar, verifies, quarantines, commits (the plan sidecar,
the manifest over every rank's files, the marker) and collects garbage,
after every rank's files are durable; a restore takes the step rank 0
verified, and each rank reads its own slice, resharded when the saved
plan's axes differ. A collective save is not retried (a retry on one
rank alone would desynchronize the world).
"""

from __future__ import annotations

import hashlib
import json
import os
import random
import re
import shutil
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional

from .. import checkpoint as _ckpt
from . import reshard as _reshard
from ..observability.goodput import ledger as _ledger
from ..observability.metrics import REGISTRY as _REG

__all__ = ["CheckpointManager", "CheckpointCorruption"]

_STEP_RE = re.compile(r"^step_(\d+)$")
MANIFEST_NAME = "_MANIFEST.json"
COMMIT_MARKER = "_COMMITTED"
QUARANTINE_DIR = "_quarantine"
VERIFY_THREADS = 8


def backoff_delays(base: float, cap: float, attempts: int,
                   rng: Optional[random.Random] = None):
    """Jittered exponential backoff schedule ("full jitter": U(0, base·2^k),
    capped; copy of ``paddle_tpu.distributed.elastic.backoff_delays``)."""
    rng = rng or random.Random()
    delay = float(base)
    for _ in range(attempts):
        yield rng.uniform(0.0, min(delay, cap))
        delay = min(delay * 2.0, cap)


class CheckpointCorruption(RuntimeError):
    """A checkpoint failed manifest verification (and was quarantined)."""


def _sha256_file(path: str, chunk: int = 1 << 20,
                 watchdog=None) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
            if watchdog is not None:
                watchdog.tick()    # a multi-GB shard hashes for minutes
    return h.hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


class CheckpointManager:
    """Crash-safe checkpoint directory of ``step_N`` checkpoints.

    Layout under ``root``::

        step_300/            committed checkpoint (has _MANIFEST + _COMMITTED)
        step_400.PENDING     sidecar: step_400 save is in flight / died
        step_400/            NOT valid until _COMMITTED exists
        _quarantine/         corrupt or uncommitted dirs moved aside

    ``save`` is synchronous by default; with ``async_save=True`` the
    snapshot is taken at once and the write happens on a background thread and the commit marker is written by
    :meth:`finalize` (called automatically at the next save/restore/close).
    """

    def __init__(self, root: str, *, save_interval_steps: int = 100,
                 keep_last_n: int = 3, keep_every_m: int = 0,
                 async_save: bool = False, max_retries: int = 3,
                 backoff_base_s: float = 0.25, backoff_max_s: float = 30.0,
                 mesh=None, spec_tree=None, plan=None):
        self.root = os.path.abspath(os.path.expanduser(root))
        self.save_interval_steps = max(1, int(save_interval_steps))
        self.keep_last_n = max(1, int(keep_last_n))
        self.keep_every_m = max(0, int(keep_every_m))
        self.async_save = bool(async_save)
        self.max_retries = max(0, int(max_retries))
        self.backoff_base_s = float(backoff_base_s)
        self.backoff_max_s = float(backoff_max_s)
        self.mesh = mesh
        self.spec_tree = spec_tree
        # active ShardingPlan: recorded as _PLAN.json in every save; on
        # restore, a saved plan with DIFFERENT axes triggers the reshard
        # path (resilience/reshard.py). None = implicit single-device plan.
        self.plan = plan
        self.last_restored_plan = None
        self._pending: Optional[int] = None
        self._rng = random.Random()
        if self._rank() == 0:
            os.makedirs(self.root, exist_ok=True)
            self._sweep_stale()
        self._barrier()

    # -- the world -----------------------------------------------------------

    @staticmethod
    def _world() -> int:
        import torch.distributed as dist
        return dist.get_world_size() if dist.is_initialized() else 1

    def _collective(self) -> bool:
        """Whether saves and restores are collective over the world: a
        mesh or a plan is set and the world has more than one rank."""
        return (self.mesh is not None or self.plan is not None) and \
            self._world() > 1

    def _rank(self) -> int:
        """This process's rank where the manager is collective (or may
        become so: a process group of more than one rank is up and a
        mesh or plan is set), else 0: every rank of a world that keeps
        its own manager acts alone."""
        import torch.distributed as dist
        if not self._collective():
            return 0
        return dist.get_rank()

    def _barrier(self) -> None:
        if self._collective():
            import torch.distributed as dist
            dist.barrier()

    def _bcast(self, obj):
        """Rank 0's ``obj`` on every rank."""
        if not self._collective():
            return obj
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def _layout(self):
        """The MeshPlan the sharded save cuts by, or None."""
        from ..checkpoint import _plan_of
        m = self.mesh
        if m is None or hasattr(m, "device_mesh"):
            return None
        return _plan_of(m)

    # -- paths -------------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"step_{int(step)}")

    def _pending_path(self, step: int) -> str:
        return self.step_dir(step) + ".PENDING"

    # -- inventory ---------------------------------------------------------

    def committed_steps(self) -> List[int]:
        """Steps with a commit marker, ascending (uncommitted dirs from a
        crashed save are invisible here by construction)."""
        steps = []
        if not os.path.isdir(self.root):
            return steps
        for name in os.listdir(self.root):
            m = _STEP_RE.match(name)
            if not m:
                continue
            d = os.path.join(self.root, name)
            if os.path.isfile(os.path.join(d, COMMIT_MARKER)):
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_committed(self) -> Optional[int]:
        steps = self.committed_steps()
        return steps[-1] if steps else None

    # -- save --------------------------------------------------------------

    def save(self, step: int, tree: Dict[str, Any], *,
             async_save: Optional[bool] = None, force: bool = False,
             watchdog=None) -> bool:
        """Checkpoint ``tree`` as ``step_N``. Returns False if the step is
        already committed (and ``force`` is unset). Async saves are
        committed by the next :meth:`finalize`. ``watchdog`` is ticked
        through the synchronous commit (manifest hashing) so a large sync
        save — notably the final preemption save — is not misread as a
        hung step and killed mid-checkpoint."""
        step = int(step)
        t0 = time.perf_counter()
        # host-blocking extent books as checkpoint_save in the goodput
        # ledger (async saves: only the enqueue + previous-save drain —
        # the background write itself never owns the step loop's clock)
        with _ledger().span("checkpoint_save"):
            self.finalize(watchdog=watchdog)    # previous async save first
            done = self._bcast(not force and os.path.isfile(
                os.path.join(self.step_dir(step), COMMIT_MARKER)))
            if done:
                return False
            use_async = (self.async_save if async_save is None
                         else bool(async_save))
            sdir = self.step_dir(step)
            if self._rank() == 0:
                if os.path.isdir(sdir):  # failed earlier attempt: clear it
                    shutil.rmtree(sdir, ignore_errors=True)
                _atomic_write(
                    self._pending_path(step),
                    json.dumps({"step": step, "ts": time.time()}).encode())
            layout = self._layout()
            if self._collective():
                if layout is None:
                    raise ValueError(
                        "CheckpointManager: a save over a world of several "
                        "ranks needs mesh= the model's MeshPlan (or the "
                        "sharded model), which says where each rank's "
                        "shards sit")
                # every rank's shards, the index once all are durable
                _ckpt.writer().save_sharded(tree, sdir, layout, use_async)
            else:
                self._with_retries(
                    lambda: _ckpt.save_state_dict(tree, sdir,
                                                  async_save=use_async,
                                                  layout=layout),
                    what=f"save step_{step}")
            if use_async:
                self._pending = step
            else:
                self._commit(step, watchdog=watchdog)
        if _REG.enabled:
            mode = "async" if use_async else "sync"
            _REG.counter("pt_checkpoint_saves_total",
                         "checkpoints written").inc(mode=mode)
            _REG.histogram("pt_checkpoint_save_seconds",
                           "host-blocking save duration", "s").observe(
                time.perf_counter() - t0, mode=mode)
        return True

    def finalize(self, watchdog=None) -> Optional[int]:
        """Commit the in-flight async save (if any): wait for durability,
        then write manifest + marker. A background write failure is
        re-raised here (never swallowed) after quarantining the partial
        step dir. ``watchdog`` (a StepWatchdog) is ticked across the wait
        so a hung remote write is still detected as a stall."""
        if self._pending is None:
            return None
        step, self._pending = self._pending, None
        with _ledger().span("checkpoint_save"):
            try:
                _ckpt.wait_until_finished(watchdog=watchdog)
            except Exception:
                if self._rank() == 0:
                    self._quarantine(step, "async-save-failed")
                raise
            self._commit(step, watchdog=watchdog)
        return step

    def wait(self, watchdog=None) -> Optional[int]:
        """Alias for :meth:`finalize` (drain pending writes)."""
        return self.finalize(watchdog=watchdog)

    def close(self) -> None:
        """Commit the in-flight save and free the storage layer's snapshot
        buffers (the host copy of the whole state an async save keeps for
        the next one)."""
        try:
            self.finalize()
        finally:
            _ckpt.writer().release()

    def _commit(self, step: int, watchdog=None) -> None:
        """Rank 0 commits (every rank's files are durable by now); the
        others wait for it."""
        if self._rank() == 0:
            self._commit_files(step, watchdog)
        self._barrier()

    def _commit_files(self, step: int, watchdog=None) -> None:
        sdir = self.step_dir(step)
        # record the active plan BEFORE the manifest walk so _PLAN.json is
        # hashed + verified like every other payload file
        self._with_retries(
            lambda: _reshard.write_plan(sdir, self.plan, step),
            what=f"plan step_{step}")
        manifest = self._build_manifest(sdir, step, watchdog=watchdog,
                                        known=_ckpt.file_digests(sdir))
        payload = json.dumps(manifest, sort_keys=True).encode()
        self._with_retries(
            lambda: _atomic_write(os.path.join(sdir, MANIFEST_NAME), payload),
            what=f"manifest step_{step}")
        marker = json.dumps({
            "step": step, "ts": time.time(),
            "manifest_sha256": hashlib.sha256(payload).hexdigest(),
        }, sort_keys=True).encode()
        self._with_retries(
            lambda: _atomic_write(os.path.join(sdir, COMMIT_MARKER), marker),
            what=f"commit step_{step}")
        try:
            os.remove(self._pending_path(step))
        except FileNotFoundError:
            pass
        self._gc()

    @staticmethod
    def _build_manifest(sdir: str, step: int, watchdog=None,
                        known: Optional[Dict[str, Dict[str, Any]]] = None
                        ) -> Dict[str, Any]:
        """Size + sha256 of every payload file. ``known`` holds the digests
        the storage layer's writer took as it wrote (a file of the same
        size takes its digest from there); the rest (the plan sidecar, a
        step written by another process) are hashed here, on the CALLING
        thread, the watchdog ticked per file so the stall is never misread
        as a hung step."""
        known = known or {}
        files = {}
        for dirpath, _dirs, names in os.walk(sdir):
            for name in names:
                if name in (MANIFEST_NAME, COMMIT_MARKER):
                    continue
                if watchdog is not None:
                    watchdog.tick()
                full = os.path.join(dirpath, name)
                rel = os.path.relpath(full, sdir)
                size = os.path.getsize(full)
                got = known.get(rel)
                sha = (got["sha256"] if got is not None
                       and got["size"] == size
                       else _sha256_file(full, watchdog=watchdog))
                files[rel] = {"size": size, "sha256": sha}
        return {"step": step, "files": files}

    # -- verify / quarantine ------------------------------------------------

    def verify(self, step: int, watchdog=None) -> bool:
        """Recheck a committed step against its manifest: marker parses,
        manifest bytes match the marker's checksum, every listed file exists
        with matching size + sha256. ``watchdog`` is ticked through the
        hashing (mid-fit rollback restores run with the step watchdog
        armed)."""
        sdir = self.step_dir(step)
        try:
            with open(os.path.join(sdir, COMMIT_MARKER), "rb") as f:
                marker = json.loads(f.read())
            with open(os.path.join(sdir, MANIFEST_NAME), "rb") as f:
                payload = f.read()
            if hashlib.sha256(payload).hexdigest() != marker["manifest_sha256"]:
                return False
            manifest = json.loads(payload)
            files = manifest["files"]
            for rel, meta in files.items():
                full = os.path.join(sdir, rel)
                if not os.path.isfile(full):
                    return False
                if os.path.getsize(full) != meta["size"]:
                    return False
            # the hashes on several threads (hashlib releases the GIL): a
            # multi-GB step verifies at the disk's rate, not one core's
            with ThreadPoolExecutor(VERIFY_THREADS) as ex:
                futs = {rel: ex.submit(_sha256_file, os.path.join(sdir, rel),
                                       watchdog=watchdog)
                        for rel in files}
                for rel, fut in futs.items():
                    if fut.result() != files[rel]["sha256"]:
                        return False
            return True
        except (OSError, ValueError, KeyError, TypeError):
            return False

    def _quarantine(self, step: int, reason: str) -> None:
        self._quarantine_path(self.step_dir(step), f"step_{step}-{reason}",
                              reason)
        try:
            os.remove(self._pending_path(step))
        except FileNotFoundError:
            pass

    def _quarantine_path(self, path: str, tag: str, reason: str) -> None:
        if not os.path.isdir(path):
            return
        qroot = os.path.join(self.root, QUARANTINE_DIR)
        os.makedirs(qroot, exist_ok=True)
        base = os.path.join(qroot, tag)
        dst, k = base, 0
        while os.path.exists(dst):
            k += 1
            dst = f"{base}-{k}"
        shutil.move(path, dst)
        if _REG.enabled:
            _REG.counter("pt_checkpoint_quarantines_total",
                         "step dirs moved aside as suspect").inc(
                reason=reason)

    def quarantined(self) -> List[str]:
        qroot = os.path.join(self.root, QUARANTINE_DIR)
        if not os.path.isdir(qroot):
            return []
        return sorted(os.listdir(qroot))

    def _sweep_stale(self) -> None:
        """At startup, clean what a crashed predecessor left behind so
        restores see only committed checkpoints:

        * step dirs with a PENDING sidecar and no commit marker
          (crash between write and commit) → quarantine;
        * orphan sidecars (dir never materialized) → delete;
        * torn dirs from a SIGKILL mid-async-save — the writer's tmp dir
          (``step_N.pt-tmp-*``) that never got renamed, or a ``step_N``
          dir with neither commit marker nor the storage layer's index
          → quarantine if non-empty (evidence), delete if empty — with a
          single aggregate warning, not silent skipping by latest_step."""
        torn: List[str] = []
        for name in list(os.listdir(self.root)):
            if not name.endswith(".PENDING"):
                continue
            stem = name[:-len(".PENDING")]
            m = _STEP_RE.match(stem)
            if m is None:
                continue
            step = int(m.group(1))
            sdir = self.step_dir(step)
            if os.path.isdir(sdir) and not os.path.isfile(
                    os.path.join(sdir, COMMIT_MARKER)):
                self._quarantine(step, "uncommitted")
            else:
                try:
                    os.remove(os.path.join(self.root, name))
                except FileNotFoundError:
                    pass
        for name in list(os.listdir(self.root)):
            full = os.path.join(self.root, name)
            if not (name.startswith("step_") and os.path.isdir(full)):
                continue
            if _STEP_RE.match(name):
                # plain step_N: torn only when neither our commit marker
                # nor the storage layer's index exists (a complete-but-
                # uncommitted dir still has its sidecar and was handled
                # above; a bare complete dir is left alone)
                if (os.path.isfile(os.path.join(full, COMMIT_MARKER))
                        or _ckpt.is_complete_checkpoint(full)
                        or os.path.isfile(self._pending_path(
                            int(name.split("_", 1)[1])))):
                    continue
            elif _ckpt.TMP_TAG not in name:
                continue            # quarantine tags etc. — not ours
            torn.append(name)
            try:
                empty = not os.listdir(full)
            except OSError:
                empty = False
            if empty:
                shutil.rmtree(full, ignore_errors=True)
            else:
                self._quarantine_path(full, f"{name}-torn", "torn")
        if torn:
            warnings.warn(
                f"CheckpointManager({self.root}): swept {len(torn)} torn "
                f"dir(s) left by a killed save: {sorted(torn)} — "
                f"non-empty ones preserved under {QUARANTINE_DIR}/",
                RuntimeWarning, stacklevel=2)

    # -- restore -----------------------------------------------------------

    def restore(self, like_tree: Dict[str, Any], *, step: Optional[int] = None,
                mesh=None, spec_tree=None, watchdog=None, plan=None):
        """Load the newest committed checkpoint (or ``step``) into the
        structure of ``like_tree`` (CPU tensors; see
        ``checkpoint.load_state_dict``; on a mesh, each rank's slice on
        its leaves' devices). A step failing manifest verification is
        quarantined and the previous committed step is tried — resume
        after corruption degrades, it does not crash. When the step's
        recorded ``_PLAN.json`` differs from the target plan (``plan`` or
        ``self.plan``), the load goes through the reshard path
        (resilience/reshard.py); the saved plan is surfaced as
        ``self.last_restored_plan``. A ReshardError (infeasible target
        mesh) is permanent and raises — an older step cannot fix an
        indivisible axis. Collective on a mesh: rank 0 verifies and
        chooses the step. Returns ``(step, tree)`` or ``None`` when
        nothing valid exists."""
        self.finalize(watchdog=watchdog)
        mesh = mesh if mesh is not None else self.mesh
        spec_tree = spec_tree if spec_tree is not None else self.spec_tree
        target_plan = plan if plan is not None else self.plan
        layout = self._layout() if mesh is self.mesh else mesh
        candidates = ([int(step)] if step is not None
                      else list(reversed(self.committed_steps())))
        t0 = time.perf_counter()
        with _ledger().span("restore"):
            chosen = None
            if self._rank() == 0:
                for s in candidates:
                    if self.verify(s, watchdog=watchdog):
                        chosen = s
                        break
                    self._quarantine(s, "corrupt")
            chosen = self._bcast(chosen)
            for s in ([] if chosen is None else [chosen]):
                saved_plan = _reshard.read_plan(self.step_dir(s))
                permanent = (ValueError, NotImplementedError,
                             _reshard.ReshardError)
                if (target_plan is not None and not _reshard.plans_equivalent(
                        saved_plan, target_plan)):
                    tree = self._with_retries(
                        lambda s=s, sp=saved_plan: _reshard.load_resharded(
                            self.step_dir(s), like_tree, target_plan,
                            mesh=layout, source_plan=sp),
                        what=f"reshard step_{s}", no_retry=permanent)
                else:
                    target = layout if layout is not None else mesh
                    tree = self._with_retries(
                        lambda s=s: _ckpt.load_state_dict(
                            self.step_dir(s), like_tree, mesh=target,
                            spec_tree=spec_tree),
                        what=f"restore step_{s}", no_retry=permanent)
                self.last_restored_plan = saved_plan
                if _REG.enabled:
                    _REG.counter("pt_checkpoint_restores_total",
                                 "checkpoint restores").inc()
                    _REG.histogram("pt_checkpoint_restore_seconds",
                                   "verify+load duration", "s").observe(
                        time.perf_counter() - t0)
                return s, tree
        return None

    # -- retention ----------------------------------------------------------

    def _gc(self) -> None:
        if self._rank() != 0:
            return
        steps = self.committed_steps()
        keep = set(steps[-self.keep_last_n:])
        if self.keep_every_m:
            keep.update(s for s in steps if s % self.keep_every_m == 0)
        for s in steps:
            if s not in keep:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)

    # -- retry --------------------------------------------------------------

    def _with_retries(self, fn, what: str = "io", no_retry=()):
        """Run ``fn`` retrying transient failures with jittered exponential
        backoff (:func:`backoff_delays`). ``no_retry`` exception types are
        permanent (e.g. a tree that does not match the checkpoint) and
        re-raise immediately."""
        delays = backoff_delays(self.backoff_base_s, self.backoff_max_s,
                                self.max_retries, rng=self._rng)
        for attempt in range(self.max_retries + 1):
            try:
                return fn()
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception as e:
                if isinstance(e, no_retry) or attempt >= self.max_retries:
                    raise
                time.sleep(next(delays))
