"""Batches of one rank: the ``DataLoader`` of the reference workload.

Counterpart of ``distributed_pytorch_tpu/data/loader.py:26-124``. The
reference iterates ``DataLoader(dataset, batch_size, sampler)`` in every
rank (``min_DDP.py:65-66``); so does the port. With a sampler each batch
is this rank's local batch: its strided indices in order, ``batch_size``
at a time. The JAX loader's global batch at step t is exactly these
local batches of ranks 0..W-1 concatenated in rank order. Without a
sampler it batches the whole set, shuffled with ``default_rng(seed +
epoch)`` when asked: the reference's non-distributed runs shuffle
where its distributed ones do not (``min_DDP.py:64-66``).
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from .sampler import ShardedSampler


class DataLoader:
    """Map-style loader: dataset + optional sampler -> collated batches.

    ``dataset`` supports ``len()`` and integer indexing returning a
    tuple of numpy-convertible leaves. ``collate`` (default: stack each
    leaf into a CPU tensor) turns a list of items into a batch."""

    def __init__(self, dataset, batch_size: int,
                 sampler: Optional[ShardedSampler] = None,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False,
                 collate: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.sampler = sampler
        self.shuffle = shuffle and sampler is None
        self.seed = seed
        self.drop_last = drop_last
        self.collate = collate or default_collate
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        if self.sampler is not None:
            return self.sampler.local_indices()
        n = len(self.dataset)
        if self.shuffle:
            return np.random.default_rng(self.seed + self._epoch
                                         ).permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator:
        idx, b = self._indices(), self.batch_size
        for t in range(len(self)):
            yield self.collate([self.dataset[int(i)]
                                for i in idx[t * b:(t + 1) * b]])

    def __len__(self) -> int:
        n = (len(self.sampler) if self.sampler is not None
             else len(self.dataset))
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)


def default_collate(items):
    """Stack tuple-of-leaves items into a tuple of batched CPU tensors."""
    first = items[0]
    if isinstance(first, (tuple, list)):
        return tuple(torch.from_numpy(np.stack([np.asarray(it[k])
                                                for it in items]))
                     for k in range(len(first)))
    return torch.from_numpy(np.stack([np.asarray(it) for it in items]))
