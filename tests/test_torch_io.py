"""The port's data pipeline against the JAX package's, on the CPU: the
same datasets, samplers and DataLoader settings give the same batches
(values equal exactly; the port's are torch tensors) and the same
cursors, with and without workers, with device prefetch on the CPU, and
after a resume's fast-forward.
"""

import numpy as np
import pytest
import torch

from paddle_tpu import io as jio
from paddle_tpu_torch import io as tio


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same_batches(ours, theirs):
    ours, theirs = list(ours), list(theirs)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        if isinstance(b, dict):
            assert set(a) == set(b)
            for k in b:
                assert isinstance(a[k], torch.Tensor)
                np.testing.assert_array_equal(_np(a[k]), np.asarray(b[k]))
        elif isinstance(b, (tuple, list)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                assert isinstance(x, torch.Tensor)
                np.testing.assert_array_equal(_np(x), np.asarray(y))
        else:
            assert isinstance(a, torch.Tensor)
            np.testing.assert_array_equal(_np(a), np.asarray(b))


class Squares:
    """Map-style dataset usable by both packages (duck-typed)."""

    def __init__(self, n):
        self.n = n

    def __getitem__(self, i):
        return np.asarray([i, i * i], dtype=np.float32)

    def __len__(self):
        return self.n


class Tokens:
    def __init__(self, n=40, s=8, seed=3):
        self.ids = np.random.RandomState(seed).randint(0, 100, (n, s + 1))

    def __getitem__(self, i):
        return {"input_ids": self.ids[i, :-1], "labels": self.ids[i, 1:]}

    def __len__(self):
        return len(self.ids)


def _pair(make):
    return make(tio), make(jio)


LOADERS = {
    "tensor_tail": lambda m: m.DataLoader(m.TensorDataset(
        [np.arange(20).reshape(10, 2).astype(np.float32), np.arange(10)]),
        batch_size=4),
    "dict_drop_last": lambda m: m.DataLoader(Tokens(), batch_size=6,
                                             drop_last=True),
    "threads": lambda m: m.DataLoader(Squares(23), batch_size=4,
                                      num_workers=2),
    "seeded_shuffle": lambda m: m.DataLoader(
        Squares(17), batch_sampler=m.BatchSampler(
            sampler=m.RandomSampler(Squares(17),
                                    generator=np.random.default_rng(7)),
            batch_size=5)),
    "replacement": lambda m: m.DataLoader(
        Squares(9), batch_sampler=m.BatchSampler(
            sampler=m.RandomSampler(Squares(9), replacement=True,
                                    num_samples=12,
                                    generator=np.random.default_rng(8)),
            batch_size=4)),
    "distributed_rank1": lambda m: m.DataLoader(
        Squares(23), batch_sampler=m.DistributedBatchSampler(
            Squares(23), batch_size=3, num_replicas=2, rank=1, shuffle=True,
            seed=4)),
    "concat_compose_subset": lambda m: m.DataLoader(m.ConcatDataset([
        m.Subset(Squares(9), [8, 1, 4]),
        m.ComposeDataset([Squares(5), Squares(5)])]), batch_size=2,
        collate_fn=lambda items: [np.asarray(i, dtype=np.float32).ravel()
                                  for i in items]),
    "iterable": lambda m: m.DataLoader(Stream(m, 7), batch_size=3),
}


def Stream(m, n):
    class _S(m.IterableDataset):
        def __iter__(self):
            for i in range(n):
                yield {"x": np.float32(i), "y": np.float32(-i)}
    return _S()


@pytest.mark.parametrize("name", sorted(LOADERS))
def test_loader_batches_match_jax(name):
    ours, theirs = _pair(LOADERS[name])
    _same_batches(ours, theirs)


def test_process_workers_match_jax():
    ds = [np.arange(36).reshape(12, 3).astype(np.float32)]
    ours = tio.DataLoader(tio.TensorDataset(ds), batch_size=5, num_workers=2,
                          multiprocessing_context="spawn")
    theirs = jio.DataLoader(jio.TensorDataset(ds), batch_size=5)
    _same_batches(ours, theirs)


def test_random_split_and_samplers_match_jax():
    for m in (tio, jio):
        m._parts = [list(p.indices) for p in m.random_split(
            Squares(10), [0.7, 0.3], generator=np.random.default_rng(3))]
    assert tio._parts == jio._parts
    for kw in (dict(shuffle=False), dict(shuffle=True, seed=9),
               dict(shuffle=True, seed=9, drop_last=True)):
        for rank in (0, 1, 2):
            ours, theirs = _pair(lambda m: m.DistributedBatchSampler(
                Squares(23), batch_size=4, num_replicas=3, rank=rank, **kw))
            ours.set_epoch(2)
            theirs.set_epoch(2)
            assert list(ours) == list(theirs)
            assert len(ours) == len(theirs)
    assert list(tio.SequenceSampler(Squares(4))) == [0, 1, 2, 3]
    sub = tio.SubsetRandomSampler([5, 7, 9], seed=1)
    assert sorted(sub) == [5, 7, 9] and list(sub) == list(sub)
    # no process group: one replica of rank 0, as the JAX default on one host
    s = tio.DistributedBatchSampler(Squares(6), batch_size=2)
    assert (s.nranks, s.local_rank) == (1, 0)


def test_cursor_fast_forward_matches_jax():
    """set_state_dict skips the first batches of the next pass; the cursor
    counts them, is visible at once, and runs on to the pass's end."""
    full = list(tio.DataLoader(Tokens(), batch_size=4))
    for m in (tio, jio):
        dl = m.DataLoader(Tokens(), batch_size=4)
        dl.set_state_dict({"batches_served": 5})
        assert dl.state_dict() == {"batches_served": 5}
        rest = list(dl)
        assert len(rest) == len(full) - 5
        np.testing.assert_array_equal(_np(rest[0]["input_ids"]),
                                      _np(full[5]["input_ids"]))
        assert dl.state_dict() == {"batches_served": len(full)}


def test_device_prefetch_counts_consumed_batches_only():
    """Prefetched batches waiting in the queue do not advance the cursor;
    closing the pass retires the producer; a resume replays from it."""
    def mk():
        return tio.DataLoader(Tokens(), batch_size=4, prefetch_to_device=True,
                              device="cpu", prefetch_factor=3)
    full = list(mk())
    dl = mk()
    it = iter(dl)
    for _ in range(3):
        next(it)
    assert dl.state_dict() == {"batches_served": 3}
    it.close()
    dl2 = mk()
    dl2.set_state_dict({"batches_served": 3})
    rest = list(dl2)
    assert len(rest) == len(full) - 3
    for a, b in zip(rest, full[3:]):
        assert torch.equal(a["input_ids"], b["input_ids"])
    assert dl2.state_dict() == {"batches_served": len(full)}


def test_stack_batches_and_superbatches_match_jax():
    batches = list(tio.DataLoader(Tokens(), batch_size=4))
    jbatches = list(jio.DataLoader(Tokens(), batch_size=4))
    ours = tio.stack_batches(batches[:3])
    theirs = jio.stack_batches(jbatches[:3])
    assert ours["input_ids"].shape == (3, 4, 8)
    np.testing.assert_array_equal(_np(ours["labels"]),
                                  np.asarray(theirs["labels"]))
    got = list(tio.superbatches(iter(batches), 4))
    want = list(jio.superbatches(iter(jbatches), 4))
    assert [g["input_ids"].shape[0] for g in got] == [
        w["input_ids"].shape[0] for w in want] == [4, 4, 2]
    dl = tio.DataLoader(Tokens(), batch_size=4)
    assert len(list(dl.superbatches(3))) == 4
    assert dl.state_dict() == {"batches_served": 10}
    with pytest.raises(ValueError):
        tio.stack_batches([])


def test_worker_info_and_collate():
    seen = []

    class Probe:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            info = tio.get_worker_info()
            seen.append(None if info is None else info.num_workers)
            return np.float32(i)

    list(tio.DataLoader(Probe(), batch_size=2))
    list(tio.DataLoader(Probe(), batch_size=2, num_workers=2))
    assert seen[:8] == [None] * 8 and set(seen[8:]) == {2}
    out = tio.default_collate_fn([{"a": 1, "b": "x"}, {"a": 2, "b": "y"}])
    ref = jio.default_collate_fn([{"a": 1, "b": "x"}, {"a": 2, "b": "y"}])
    np.testing.assert_array_equal(out["a"], ref["a"])
    assert out["b"] == ref["b"] == ["x", "y"]


def test_loader_refusals_and_default_device():
    # shared memory with workers is the native ring's transport now
    # (test_torch_native.py iterates it): built, nothing delivered yet
    shm = tio.DataLoader(Squares(4), num_workers=2, use_shared_memory=True)
    assert shm.transport == {"main": 0, "workers": 0, "shm_ring": 0}
    # sharding= takes a plan: each batch comes as this rank's slice (a
    # stand-in MeshPlan keeping the second half of the rows here), marked
    # as already local for the Trainer
    with pytest.raises(TypeError, match="ShardingPlan"):
        tio.DataLoader(Squares(4), sharding=object())

    class SecondHalf:
        def local_batch(self, batch):
            return {k: v.chunk(2)[1] for k, v in batch.items()}

    class Rows(Squares):
        def __getitem__(self, i):
            return {"x": super().__getitem__(i)}
    whole = list(tio.DataLoader(Rows(4), batch_size=4))
    local = list(tio.DataLoader(Rows(4), batch_size=4,
                                sharding=SecondHalf()))
    assert len(local) == 1 and getattr(local[0], "is_local", False)
    assert not getattr(whole[0], "is_local", False)
    for k in whole[0]:
        assert torch.equal(local[0][k], whole[0][k][2:])
    # shared memory without workers is accepted, as in JAX
    assert len(list(tio.DataLoader(Squares(4), use_shared_memory=True))) == 4
    if torch.cuda.is_available():
        dl = tio.DataLoader(Squares(4), prefetch_to_device=True)
        assert dl.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tio.DataLoader(Squares(4), prefetch_to_device=True)
