"""Samplers (copy of ``paddle_tpu/io/sampler.py``: numpy's generators, so
the port and the JAX package draw the same indices from the same seed).

Reference: python/paddle/io/dataloader/{sampler.py,batch_sampler.py} —
Sampler / SequenceSampler / RandomSampler / WeightedRandomSampler /
BatchSampler / DistributedBatchSampler. DistributedBatchSampler shards the
index stream per data-parallel rank.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Sequence

import numpy as np


class Sampler:
    def __init__(self, data_source=None):
        self.data_source = data_source

    def __iter__(self) -> Iterator[int]:
        raise NotImplementedError

    def __len__(self):
        return len(self.data_source)


class SequenceSampler(Sampler):
    def __iter__(self):
        return iter(range(len(self.data_source)))


class RandomSampler(Sampler):
    def __init__(self, data_source, replacement: bool = False,
                 num_samples: Optional[int] = None, generator=None):
        super().__init__(data_source)
        self.replacement = replacement
        self._num_samples = num_samples
        self.generator = generator

    @property
    def num_samples(self):
        return self._num_samples if self._num_samples is not None \
            else len(self.data_source)

    def __iter__(self):
        n = len(self.data_source)
        rng = self.generator if self.generator is not None \
            else np.random.default_rng()
        if self.replacement:
            yield from rng.integers(0, n, size=self.num_samples).tolist()
        else:
            yield from rng.permutation(n)[:self.num_samples].tolist()

    def __len__(self):
        return self.num_samples


class WeightedRandomSampler(Sampler):
    def __init__(self, weights: Sequence[float], num_samples: int,
                 replacement: bool = True):
        super().__init__(None)
        self.weights = np.asarray(weights, dtype=np.float64)
        if (self.weights < 0).any():
            raise ValueError("weights must be non-negative")
        self.num_samples = num_samples
        self.replacement = replacement
        if not replacement and num_samples > len(self.weights):
            raise ValueError("cannot draw more samples than weights without "
                             "replacement")

    def __iter__(self):
        p = self.weights / self.weights.sum()
        rng = np.random.default_rng()
        idx = rng.choice(len(p), size=self.num_samples, p=p,
                         replace=self.replacement)
        yield from idx.tolist()

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Groups sampler indices into batches (reference: batch_sampler.py)."""

    def __init__(self, dataset=None, sampler: Optional[Sampler] = None,
                 shuffle: bool = False, batch_size: int = 1,
                 drop_last: bool = False):
        super().__init__(dataset)
        if sampler is not None:
            self.sampler = sampler
        elif shuffle:
            self.sampler = RandomSampler(dataset)
        else:
            self.sampler = SequenceSampler(dataset)
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = batch_size
        self.drop_last = drop_last

    def __iter__(self):
        batch: List[int] = []
        for idx in self.sampler:
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        n = len(self.sampler)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size


class DistributedBatchSampler(BatchSampler):
    """Per-rank sharded batches (reference:
    dataloader/batch_sampler.py DistributedBatchSampler — pads the index
    list to a multiple of nranks*batch_size, then strides by rank).

    nranks/rank default to the world size and rank of an initialized
    ``torch.distributed`` process group (1 and 0 without one), so each
    process loads only its shard of the global batch.
    """

    def __init__(self, dataset, batch_size: int, num_replicas: Optional[int] = None,
                 rank: Optional[int] = None, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0):
        self.dataset = dataset
        if batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.batch_size = batch_size
        import torch.distributed as dist
        group = dist.is_available() and dist.is_initialized()
        self.nranks = num_replicas if num_replicas is not None \
            else (dist.get_world_size() if group else 1)
        self.local_rank = rank if rank is not None \
            else (dist.get_rank() if group else 0)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.epoch = 0
        self.seed = seed
        n = len(dataset)
        self.num_samples = int(np.ceil(n / self.nranks))
        self.total_size = self.num_samples * self.nranks

    def set_epoch(self, epoch: int):
        """Reshuffle deterministically per epoch (reference API)."""
        self.epoch = epoch

    def __iter__(self):
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            indices = rng.permutation(n)
        # pad to make it evenly divisible
        pad = self.total_size - n
        if pad > 0:
            indices = np.concatenate([indices, indices[:pad]])
        local = indices[self.local_rank::self.nranks]
        batch: List[int] = []
        for idx in local.tolist():
            batch.append(idx)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        if self.drop_last:
            return self.num_samples // self.batch_size
        return (self.num_samples + self.batch_size - 1) // self.batch_size


class SubsetRandomSampler(Sampler):
    """Random permutation over a fixed index subset (reference:
    python/paddle/io/sampler.py SubsetRandomSampler). The JAX package
    seeds it from its global random stream when one is set; the port has
    no global stream, so ``seed`` (None: fresh entropy each pass) seeds
    numpy's RandomState."""

    def __init__(self, indices, seed: Optional[int] = None):
        self.indices = list(indices)
        self.seed = seed

    def __iter__(self):
        order = np.random.RandomState(self.seed).permutation(
            len(self.indices))
        return iter(self.indices[i] for i in order)

    def __len__(self):
        return len(self.indices)
