"""DataLoader: batched, prefetching host→device input pipeline (counterpart
of ``paddle_tpu/io/dataloader.py``).

Reference: python/paddle/io/dataloader/dataloader_iter.py:150,358 —
single-process and multi-process iterators with a prefetch depth of
``num_workers * prefetch_factor``.

As in the JAX package: worker parallelism uses a thread pool by default
(numpy slicing releases the GIL) and a process pool
(``multiprocessing_context='spawn'``) when the per-sample transform is
Python-bound; samples and collated batches are numpy. The loader hands
its consumer torch tensors: each collated batch's numpy leaves become CPU
tensors (``torch.from_numpy``, no copy). ``prefetch_to_device`` moves
finished batches to ``device`` (the card unless ``device="cpu"``) ahead of
the consumer on a producer thread: each leaf is copied into pinned host
memory, then sent with ``non_blocking=True`` on a copy stream of its own;
an event recorded there orders the consumer's stream after the copy, and
``record_stream`` tells the allocator the consumer's stream uses it.

``sharding`` (a ``ShardingPlan`` or a ``MeshPlan``) hands each rank its
slice of every global batch, cut before the device copy.

``use_shared_memory=True`` with workers takes the JAX package's transport
when the native library is available (``paddle_tpu_torch.native``, built
with g++ at first use): worker processes push pickled batches through a
``ShmRing`` and the loader re-orders them by sequence number; otherwise
the worker pool, exactly as JAX chooses. ``DataLoader.transport`` counts
the batches each transport delivered.
"""

from __future__ import annotations

import collections
import itertools
import queue
import threading
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..device import resolve_device
from .dataset import Dataset, IterableDataset
from .sampler import BatchSampler, RandomSampler


def default_collate_fn(batch):
    """Stack samples into batch arrays (reference:
    dataloader/collate.py default_collate_fn): dict → dict of stacked,
    tuple/list → tuple of stacked, scalars/arrays → stacked ndarray. The
    DataLoader turns the arrays into torch tensors."""
    sample = batch[0]
    if isinstance(sample, np.ndarray):
        return np.stack(batch)
    if isinstance(sample, (int, float, np.number)):
        return np.asarray(batch)
    if isinstance(sample, (str, bytes)):
        return list(batch)
    if isinstance(sample, collections.abc.Mapping):
        return {k: default_collate_fn([b[k] for b in batch]) for k in sample}
    if isinstance(sample, collections.abc.Sequence):
        transposed = list(zip(*batch))
        return tuple(default_collate_fn(list(f)) for f in transposed)
    # tensors / arbitrary array-likes
    try:
        return np.stack([np.asarray(b) for b in batch])
    except Exception:
        return list(batch)


def _map_tree(fn, tree):
    """``fn`` over the leaves of nested dicts, tuples and lists of arrays
    (strings and other leaves pass through ``fn`` too)."""
    if isinstance(tree, collections.abc.Mapping):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_map_tree(fn, v) for v in tree)
    if isinstance(tree, list) and tree and not isinstance(
            tree[0], (str, bytes)):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def _leaves(tree):
    out = []
    _map_tree(lambda x: out.append(x), tree)
    return out


def _to_torch(x):
    if isinstance(x, np.ndarray) and x.dtype != object:
        return torch.from_numpy(np.ascontiguousarray(x))
    if isinstance(x, np.generic):
        return torch.from_numpy(np.asarray(x))
    return x


def stack_batches(batches):
    """Stack a list of per-step batches into one superstep feed: every leaf
    gains a leading ``[K, ...]`` dispatch dimension (the trainer's
    ``fit(steps_per_dispatch=K)`` takes its slices in turn). Stacking is
    ``torch.stack`` on the leaves' device, so device-prefetched batches stay
    on the card. Composes with gradient accumulation: ``[A, ...]``
    microbatch tensors stack to ``[K, A, ...]``."""
    if not batches:
        raise ValueError("stack_batches needs at least one batch")
    first = batches[0]
    if isinstance(first, collections.abc.Mapping):
        return {k: stack_batches([b[k] for b in batches]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_batches(list(f)) for f in zip(*batches))
    return torch.stack([_to_torch(b) if not isinstance(b, torch.Tensor)
                        else b for b in batches])


def superbatches(iterable, k: int, drop_last: bool = False):
    """Group an iterable of batches into stacked superstep feeds of ``k``
    (the final partial group is yielded unstacked-shorter unless
    ``drop_last``)."""
    buf = []
    for b in iterable:
        buf.append(b)
        if len(buf) == k:
            yield stack_batches(buf)
            buf = []
    if buf and not drop_last:
        yield stack_batches(buf)


def _fetch_map(dataset, indices, collate_fn):
    return collate_fn([dataset[i] for i in indices])


_WORKER_STATE = {}


_WORKER_ID_LOCK = threading.Lock()


def _worker_init(dataset, collate_fn, num_workers=0):
    _WORKER_STATE["dataset"] = dataset
    _WORKER_STATE["collate_fn"] = collate_fn
    import multiprocessing as mp
    ident = mp.current_process()._identity
    if ident:  # pool worker process: 1-based fork-order id
        worker_id = (ident[0] - 1) % max(num_workers, 1)
    else:  # thread pool: processwide counter + lock
        with _WORKER_ID_LOCK:
            worker_id = _WORKER_STATE.setdefault("_next_id", 0)
            _WORKER_STATE["_next_id"] = worker_id + 1
    _set_worker_info(WorkerInfo(id=worker_id, num_workers=num_workers,
                                dataset=dataset))


def _worker_fetch(indices):
    return _fetch_map(_WORKER_STATE["dataset"], indices,
                      _WORKER_STATE["collate_fn"])


def _shm_worker_loop(ring_name, index_queue, dataset, collate_fn):
    """Worker-process loop for the native shared-memory transport: pop
    (seq, indices) work items, fetch+collate, push pickled batches into the
    ShmRing (reference: the mmap-allocator path of dataloader_iter.py:358)."""
    import pickle
    from ..native import ShmRing
    ring = ShmRing.open(ring_name)
    try:
        while True:
            item = index_queue.get()
            if item is None:
                ring.push(pickle.dumps(("__worker_done__", None)), timeout=600)
                return
            seq, indices = item
            try:
                batch = _fetch_map(dataset, indices, collate_fn)
                payload = pickle.dumps((seq, batch), protocol=4)
            except BaseException as e:  # surface in the parent
                payload = pickle.dumps((seq, e), protocol=4)
            ring.push(payload, timeout=600)
    finally:
        ring._h = None  # opener must never shm_unlink; the parent owns it


class _PrefetchIterator:
    """Pulls batches from an executor pipeline with bounded depth."""

    def __init__(self, submit_iter: Iterator, depth: int):
        self._submit_iter = submit_iter
        self._pending = collections.deque()
        self._depth = max(depth, 1)
        self._fill()

    def _fill(self):
        while len(self._pending) < self._depth:
            try:
                self._pending.append(next(self._submit_iter))
            except StopIteration:
                break

    def __iter__(self):
        return self

    def __next__(self):
        if not self._pending:
            raise StopIteration
        fut = self._pending.popleft()
        self._fill()
        return fut.result() if hasattr(fut, "result") else fut


class LocalBatch(dict):
    """A batch already cut to this rank's slice of the global batch
    (``DataLoader(sharding=)``): the Trainer on a mesh takes it as it
    is."""

    is_local = True


class DataLoader:
    """Reference-shaped DataLoader (paddle.io.DataLoader).

    Args mirror the reference: dataset, batch_size, shuffle, drop_last,
    collate_fn, num_workers, prefetch_factor, batch_sampler. Additions:
    ``prefetch_to_device`` (send finished batches to ``device`` ahead of
    use; ``device`` defaults to the card and is only read when prefetching)
    and ``sharding`` (a ``ShardingPlan``, or the live ``MeshPlan`` of a
    sharded model): the dataset's batches are GLOBAL and each rank gets
    its slice (``MeshPlan.local_batch``'s cut: rows over the data axes,
    with sequence parallelism the sequence over sep), cut on the host
    before the device copy, as a :class:`LocalBatch` the Trainer takes
    as already sliced.
    """

    def __init__(self, dataset: Dataset, batch_size: Optional[int] = 1,
                 shuffle: bool = False, drop_last: bool = False,
                 collate_fn: Optional[Callable] = None, num_workers: int = 0,
                 prefetch_factor: int = 2,
                 batch_sampler: Optional[BatchSampler] = None,
                 use_shared_memory: bool = False,
                 multiprocessing_context: Optional[str] = None,
                 prefetch_to_device: bool = False, sharding=None,
                 return_list: bool = True, device=None):
        if sharding is not None and not (hasattr(sharding, "local_batch")
                                         or hasattr(sharding, "shard_batch")):
            raise TypeError("DataLoader(sharding=) takes a ShardingPlan or "
                            "a MeshPlan")
        self.sharding = sharding
        self.num_workers = max(0, int(num_workers))
        self.dataset = dataset
        self.collate_fn = collate_fn or default_collate_fn
        self.use_shared_memory = use_shared_memory
        self.prefetch_factor = max(1, int(prefetch_factor))
        self.prefetch_to_device = bool(prefetch_to_device)
        self.device = (resolve_device(device) if self.prefetch_to_device
                       else None)
        self._copy_stream = None
        self.multiprocessing_context = multiprocessing_context
        self._iterable = isinstance(dataset, IterableDataset)
        if self._iterable:
            if batch_sampler is not None:
                raise ValueError("batch_sampler is invalid for IterableDataset")
            self.batch_size = batch_size
            self.drop_last = drop_last
            self.batch_sampler = None
        elif batch_sampler is not None:
            self.batch_sampler = batch_sampler
            self.batch_size = batch_sampler.batch_size
        else:
            if batch_size is None:
                raise ValueError("batch_size or batch_sampler required for "
                                 "map-style datasets")
            self.batch_size = batch_size
            self.batch_sampler = BatchSampler(dataset, shuffle=shuffle,
                                              batch_size=batch_size,
                                              drop_last=drop_last)
        self._batches_served = 0
        self._skip_batches = 0
        #: host batches each transport delivered: the main process
        #: ("main"), the worker pool ("workers") or the native
        #: shared-memory ring ("shm_ring")
        self.transport = {"main": 0, "workers": 0, "shm_ring": 0}

    # -- iteration cursor (resilience: resume/rollback positions the loader)

    def state_dict(self):
        """Cursor of the current iteration pass: how many batches have been
        handed out (skipped-on-resume batches included, so a resumed pass
        continues the count). Checkpointed by Trainer.fit as the
        data-iterator cursor."""
        return {"batches_served": self._batches_served}

    def set_state_dict(self, sd) -> None:
        """Fast-forward the NEXT iteration pass past ``batches_served``
        batches. Batches are still fetched and dropped (not re-indexed), so
        for DETERMINISTIC samplers the resumed pass is bit-identical to an
        uninterrupted one. An unseeded shuffle draws a fresh permutation per
        pass — the skip-ahead then replays a different order (warned below);
        pass a seeded ``RandomSampler(data, generator=...)`` via
        ``batch_sampler`` for bit-exact shuffled resume."""
        self._skip_batches = max(0, int(sd.get("batches_served", 0)))
        # baseline the cursor NOW, not lazily at the pass's first next():
        # a checkpoint taken before the resumed pass yields its first batch
        # (e.g. preemption latched during restore) must not persist a stale
        # count from before this call
        self._batches_served = self._skip_batches
        samp = getattr(self.batch_sampler, "sampler", None)
        if self._skip_batches > 0 and isinstance(samp, RandomSampler):
            import warnings
            # unseeded: each pass draws fresh OS entropy. Seeded: the shared
            # generator's state advanced during the interrupted pass, so a
            # new pass STILL permutes differently. Either way the skip-ahead
            # replays a different order.
            warnings.warn(
                "resuming a shuffle=True DataLoader: a new pass draws a new "
                "permutation (RandomSampler state is not checkpointed), so "
                f"skipping the first {self._skip_batches} batches does not "
                "reproduce the pre-crash order — already-seen samples may "
                "repeat this epoch. Use shuffle=False (or a deterministic "
                "per-epoch sampler) for bit-exact resume.",
                RuntimeWarning, stacklevel=2)

    # -- iteration ---------------------------------------------------------

    def __len__(self):
        if self._iterable:
            raise TypeError("IterableDataset DataLoader has no len()")
        return len(self.batch_sampler)

    def _device_put(self, batch):
        """(batch on ``self.device``, the copy stream's event or None).
        Runs on the producer thread."""
        batch = _map_tree(_to_torch, batch)
        if not self.prefetch_to_device or self.device.type != "cuda":
            return batch, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            out = _map_tree(
                lambda t: t.pin_memory().to(self.device, non_blocking=True)
                if isinstance(t, torch.Tensor) else t, batch)
            ev = torch.cuda.Event()
            ev.record(self._copy_stream)
        return out, ev

    def _ready(self, batch, ev):
        """Order the consumer's stream after the batch's copy (consumer
        thread)."""
        if ev is None:
            return batch
        cur = torch.cuda.current_stream(self.device)
        cur.wait_event(ev)
        for t in _leaves(batch):
            if isinstance(t, torch.Tensor):
                t.record_stream(cur)
        return batch

    def _iter_batches_host(self):
        if self._iterable:
            it = iter(self.dataset)
            if self.batch_size is None:
                yield from it
                return
            while True:
                chunk = list(itertools.islice(it, self.batch_size))
                if not chunk:
                    return
                if len(chunk) < self.batch_size and self.drop_last:
                    return
                yield self.collate_fn(chunk)
            return
        if self.num_workers == 0:
            for indices in self.batch_sampler:
                self.transport["main"] += 1
                yield _fetch_map(self.dataset, indices, self.collate_fn)
            return
        if self.use_shared_memory:
            from .. import native
            if native.is_available():
                for b in self._iter_batches_shm():
                    self.transport["shm_ring"] += 1
                    yield b
                return
        # worker pool: submit index lists, consume in order with prefetch
        if self.multiprocessing_context is not None:
            import multiprocessing as mp
            # dataset/collate_fn ship ONCE via the initializer (worker
            # globals), not per submit — per-batch pickling of an in-memory
            # dataset would dwarf the fetch itself.
            pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context(self.multiprocessing_context),
                initializer=_worker_init,
                initargs=(self.dataset, self.collate_fn, self.num_workers))
            fetch = _worker_fetch
            submit_args = lambda idx: (idx,)  # noqa: E731
        else:
            _WORKER_STATE.pop("_next_id", None)  # fresh ids per loader
            pool = ThreadPoolExecutor(
                max_workers=self.num_workers,
                initializer=_worker_init,
                initargs=(self.dataset, self.collate_fn, self.num_workers))
            fetch = _fetch_map
            submit_args = lambda idx: (self.dataset, idx,  # noqa: E731
                                       self.collate_fn)
        try:
            submits = (pool.submit(fetch, *submit_args(idx))
                       for idx in self.batch_sampler)
            for b in _PrefetchIterator(
                    submits, self.num_workers * self.prefetch_factor):
                self.transport["workers"] += 1
                yield b
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    def _iter_batches_shm(self):
        """Multi-process fetch over the native shared-memory ring (the
        JAX package's transport): workers pickle batches straight into a
        process-shared ring buffer instead of the multiprocessing pipe,
        and the parent re-orders by sequence number."""
        import pickle
        import multiprocessing as mp
        from ..native import ShmRing

        ctx = mp.get_context(self.multiprocessing_context or "spawn")
        ring = ShmRing(capacity=128 << 20)
        index_queue = ctx.Queue()
        procs = [ctx.Process(target=_shm_worker_loop,
                             args=(ring.name, index_queue, self.dataset,
                                   self.collate_fn), daemon=True)
                 for _ in range(self.num_workers)]
        for p in procs:
            p.start()
        try:
            total = 0
            depth = self.num_workers * self.prefetch_factor
            sampler_it = iter(self.batch_sampler)
            in_flight = 0
            for _ in range(depth):
                try:
                    index_queue.put((total, next(sampler_it)))
                    total += 1
                    in_flight += 1
                except StopIteration:
                    break
            next_seq = 0
            stash = {}
            while in_flight > 0 or stash:
                while next_seq in stash:
                    item = stash.pop(next_seq)
                    next_seq += 1
                    if isinstance(item, BaseException):
                        raise item
                    yield item
                if in_flight == 0:
                    continue
                payload = None
                while payload is None:
                    try:
                        payload = ring.pop(timeout=5)
                        if payload is None:  # ring closed & drained
                            raise RuntimeError(
                                "DataLoader shared-memory ring closed with "
                                f"{in_flight} batches still pending")
                    except TimeoutError:
                        # a worker that crashed (unclean exit) takes its
                        # in-flight batch with it — even one such death means
                        # the missing seq will never arrive
                        dead = [p for p in procs
                                if not p.is_alive() and p.exitcode not in (0, None)]
                        if dead or not any(p.is_alive() for p in procs):
                            codes = [p.exitcode for p in procs]
                            raise RuntimeError(
                                "DataLoader shared-memory worker(s) died "
                                f"unexpectedly (exit codes {codes}) with "
                                f"{in_flight} batches still pending") from None
                seq, item = pickle.loads(payload)
                if seq == "__worker_done__":
                    continue
                in_flight -= 1
                stash[seq] = item
                try:
                    index_queue.put((total, next(sampler_it)))
                    total += 1
                    in_flight += 1
                except StopIteration:
                    pass
        finally:
            for _ in procs:
                index_queue.put(None)
            for p in procs:
                p.join(timeout=5)
                if p.is_alive():
                    p.terminate()
            ring.destroy()

    def __call__(self):
        """Legacy idiom parity: ``for batch in loader():`` — the reference
        DataLoader is callable and returns its iterator."""
        return iter(self)

    def superbatches(self, k: int, drop_last: bool = False):
        """Iterate stacked superstep feeds of ``k`` batches each (see
        :func:`stack_batches`). The cursor (``batches_served``) still counts
        MICRObatches, so checkpoint resume positions are step-granular."""
        return superbatches(iter(self), k, drop_last=drop_last)

    def __iter__(self):
        skip = self._skip_batches
        self._skip_batches = 0
        # the replayed prefix counts as served so a resumed pass continues
        # the cursor; the per-yield increment below counts only batches the
        # CONSUMER actually received (prefetched-but-unconsumed batches in
        # the device queue must not advance the checkpointed cursor)
        self._batches_served = skip

        def host_skipped():
            n = 0
            for b in self._iter_batches_host():
                n += 1
                if n <= skip:
                    continue   # fast-forward host-side: no device transfer
                yield self._local(b) if self.sharding is not None else b

        for batch in self._iter_all(host_skipped()):
            self._batches_served += 1
            yield LocalBatch(batch) if self.sharding is not None else batch

    def _local(self, batch):
        """This rank's slice of a global batch (host side)."""
        batch = _map_tree(_to_torch, batch)
        sh = self.sharding
        if hasattr(sh, "local_batch"):
            return sh.local_batch(batch)
        return sh.shard_batch(batch)

    def _iter_all(self, host):
        if not self.prefetch_to_device:
            for b in host:
                yield _map_tree(_to_torch, b)
            return
        # async device prefetch: keep `prefetch_factor` batches in flight
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch_factor)
        _END = object()
        stop = threading.Event()

        def bounded_put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for b in host:
                    if not bounded_put(self._device_put(b)):
                        return             # consumer gone (close/rollback)
                bounded_put(_END)
            except BaseException as e:  # propagate into the consumer
                bounded_put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield self._ready(*item)
        finally:
            # abandoned mid-pass (generator .close(), trainer rollback):
            # unblock and retire the producer so it cannot keep device
            # buffers pinned for the rest of the run
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            t.join(timeout=5.0)


class WorkerInfo:
    """Worker context for IterableDataset sharding (reference:
    python/paddle/io/dataloader/worker.py WorkerInfo/get_worker_info)."""

    def __init__(self, id: int, num_workers: int, dataset=None, seed=0):
        self.id = id
        self.num_workers = num_workers
        self.dataset = dataset
        self.seed = seed


_WORKER_INFO = threading.local()


def get_worker_info() -> Optional[WorkerInfo]:
    """Inside a DataLoader worker returns its WorkerInfo; None in the main
    process (reference: io/dataloader/worker.py get_worker_info)."""
    return getattr(_WORKER_INFO, "info", None)


def _set_worker_info(info: Optional[WorkerInfo]) -> None:
    _WORKER_INFO.info = info
