"""Datasets (copy of ``paddle_tpu/io/dataset.py``).

Reference: python/paddle/io/ (Dataset / IterableDataset / TensorDataset /
ComposeDataset / ChainDataset / Subset / random_split — dataloader/dataset.py).
Semantics preserved; items are numpy arrays (the DataLoader hands torch
tensors to its consumer).
"""

from __future__ import annotations

import bisect
from typing import Any, Iterable, List, Sequence

import numpy as np


class Dataset:
    """Map-style dataset (reference: paddle.io.Dataset)."""

    def __getitem__(self, idx):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __getitem__")

    def __len__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __len__")


class IterableDataset(Dataset):
    """Stream-style dataset (reference: paddle.io.IterableDataset)."""

    def __iter__(self):
        raise NotImplementedError(
            f"{type(self).__name__} must implement __iter__")

    def __getitem__(self, idx):
        raise RuntimeError("IterableDataset is not subscriptable")

    def __len__(self):
        raise RuntimeError("IterableDataset has no len()")


class TensorDataset(Dataset):
    """Wrap equal-length arrays; item i is the tuple of i-th slices."""

    def __init__(self, tensors: Sequence):
        tensors = [np.asarray(t) for t in tensors]
        if not tensors:
            raise ValueError("TensorDataset needs at least one tensor")
        n = tensors[0].shape[0]
        for t in tensors:
            if t.shape[0] != n:
                raise ValueError("all tensors must share dim-0 length")
        self.tensors = tensors

    def __getitem__(self, idx):
        return tuple(t[idx] for t in self.tensors)

    def __len__(self):
        return self.tensors[0].shape[0]


class ComposeDataset(Dataset):
    """Zip several map-datasets: item i concatenates their fields."""

    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ComposeDataset needs at least one dataset")
        n = len(self.datasets[0])
        for d in self.datasets:
            if len(d) != n:
                raise ValueError("all datasets must have equal length")

    def __getitem__(self, idx):
        out = []
        for d in self.datasets:
            item = d[idx]
            out.extend(item if isinstance(item, (tuple, list)) else [item])
        return tuple(out)

    def __len__(self):
        return len(self.datasets[0])


class ChainDataset(IterableDataset):
    """Concatenate iterable datasets end-to-end."""

    def __init__(self, datasets: Sequence[IterableDataset]):
        self.datasets = list(datasets)

    def __iter__(self):
        for d in self.datasets:
            yield from d


class ConcatDataset(Dataset):
    """Concatenate map datasets (reference: paddle.io.ConcatDataset)."""

    def __init__(self, datasets: Sequence[Dataset]):
        self.datasets = list(datasets)
        if not self.datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.cumulative_sizes = np.cumsum([len(d) for d in self.datasets]).tolist()

    def __len__(self):
        return self.cumulative_sizes[-1]

    def __getitem__(self, idx):
        if idx < 0:
            idx += len(self)
        ds_idx = bisect.bisect_right(self.cumulative_sizes, idx)
        prev = 0 if ds_idx == 0 else self.cumulative_sizes[ds_idx - 1]
        return self.datasets[ds_idx][idx - prev]


class Subset(Dataset):
    def __init__(self, dataset: Dataset, indices: Sequence[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __getitem__(self, idx):
        return self.dataset[self.indices[idx]]

    def __len__(self):
        return len(self.indices)


def random_split(dataset: Dataset, lengths: Sequence, generator=None):
    """Split into non-overlapping subsets (reference: paddle.io.random_split;
    fractional lengths accepted like the reference's newer behavior)."""
    if all(0.0 <= float(l) <= 1.0 for l in lengths) and \
            abs(sum(float(l) for l in lengths) - 1.0) < 1e-6:
        n = len(dataset)
        sizes = [int(np.floor(n * float(l))) for l in lengths]
        for i in range(n - sum(sizes)):
            sizes[i % len(sizes)] += 1
        lengths = sizes
    lengths = [int(l) for l in lengths]
    if sum(lengths) != len(dataset):
        raise ValueError(f"sum of lengths {sum(lengths)} != dataset size "
                         f"{len(dataset)}")
    rng = generator if generator is not None else np.random.default_rng()
    perm = rng.permutation(len(dataset))
    out, ofs = [], 0
    for l in lengths:
        out.append(Subset(dataset, perm[ofs:ofs + l].tolist()))
        ofs += l
    return out
