"""paddle_tpu_torch.io — the data input pipeline (counterpart of
``paddle_tpu/io``): datasets, samplers and the DataLoader, whose batches
are torch tensors (on the card with ``prefetch_to_device=True``)."""

from .dataloader import (DataLoader, WorkerInfo, default_collate_fn,
                         get_worker_info, stack_batches, superbatches)
from .dataset import (ChainDataset, ComposeDataset, ConcatDataset, Dataset,
                      IterableDataset, Subset, TensorDataset, random_split)
from .sampler import (BatchSampler, DistributedBatchSampler, RandomSampler,
                      Sampler, SequenceSampler, SubsetRandomSampler,
                      WeightedRandomSampler)

__all__ = [
    "Dataset", "IterableDataset", "TensorDataset", "ComposeDataset",
    "ChainDataset", "ConcatDataset", "Subset", "random_split",
    "Sampler", "SequenceSampler", "RandomSampler", "WeightedRandomSampler",
    "SubsetRandomSampler", "BatchSampler", "DistributedBatchSampler",
    "DataLoader", "default_collate_fn", "get_worker_info", "WorkerInfo",
    "stack_batches", "superbatches",
]
